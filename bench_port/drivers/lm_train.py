"""Driver of LM training (``fl/round.py::make_train_step`` over
``torch.func.functional_call`` of ``models/model.py::LM``): plain SGD
steps of a dense decoder on uniform random tokens.

Set-up makes the weights and a pool of distinct token batches from the
seed, builds the program's model around the weights and its train step,
and drives that step through its first ``CHECK_STEPS`` steps on the
pool's first batches (which also warms every shape): it keeps each
step's loss, the norm of each weight's first gradient as SGD applied it,
(w0 - w1) / gamma, and the norm of each weight's change after the last
of them. The window steps on from there, back to back on the next
batches, losses left on the device, until ``--seconds`` have passed,
then syncs; ``train_tokens_per_s`` is its tokens over its seconds.
Afterwards, with the program's state freed, the plain reference makes
the same weights again and takes the same steps.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import data  # noqa: E402
import harness  # noqa: E402
from reference import lm_ref  # noqa: E402

# distinct token batches the steps cycle through
BATCHES = 64
# steps that set-up drives and the reference follows
CHECK_STEPS = 3
# window steps before the traced stretch, and its steps (each also run
# untraced just before it)
TRACE_AFTER = 2
TRACE_STEPS = 2


def program_name(name: str) -> str:
    """The program's parameter name of a benchmark weight name."""
    top = {"embed": "embed.emb", "head": "lm_head.w",
           "final_norm": "final_norm.g"}
    if name in top:
        return top[name]
    i, leaf = name.split(".")
    sub = {"norm1": "norm1.g", "norm2": "norm2.g", "wq": "mixer.wq.w",
           "wk": "mixer.wk.w", "wv": "mixer.wv.w", "wo": "mixer.wo.w",
           "wi": "mlp.wi.w", "wg": "mlp.wg.w", "wo_mlp": "mlp.wo.w"}
    return f"layers.{i}.{sub[leaf]}"


def build(ctx, weights):
    """The program's model around ``weights`` and its SGD step."""
    from repro_torch.fl.round import make_train_step
    from repro_torch.models.attention import Attention
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import Dense, Embedding, RMSNorm, SwiGLU
    from repro_torch.models.model import LM, Layer

    cfg, tr = ctx.cfg, ctx.traffic
    eps, n_layers = cfg["rms_norm_eps"], cfg["num_hidden_layers"]
    mcfg = ModelConfig(
        name=cfg["name"], arch_type="dense", n_layers=n_layers,
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], rmsnorm_eps=eps,
        param_dtype=cfg["precision"])
    w = weights
    layers = [Layer(RMSNorm(w[f"{i}.norm1"], eps),
                    Attention(w[f"{i}.wq"], w[f"{i}.wk"], w[f"{i}.wv"],
                              w[f"{i}.wo"], mcfg),
                    norm2=RMSNorm(w[f"{i}.norm2"], eps),
                    mlp=SwiGLU(w[f"{i}.wi"], w[f"{i}.wg"], w[f"{i}.wo_mlp"]))
              for i in range(n_layers)]
    model = LM(Embedding(w["embed"]), layers, RMSNorm(w["final_norm"], eps),
               Dense(w["head"]))

    def loss_fn(p, b):
        return ctx.torch.func.functional_call(model, p, (b, mcfg))

    return model, mcfg, make_train_step(loss_fn, tr["gamma"])


def launches():
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    return {"flash_attention_bhsd": flash_attention_bhsd.launches,
            "flash_attention_bwd": flash_attention_bwd.launches}


def leaf_norms(torch, fn, names):
    return torch.stack([fn(n).norm() for n in names])


def run(ctx, fault=None) -> harness.Outcome:
    torch, cfg, tr, dev = ctx.torch, ctx.cfg, ctx.traffic, ctx.device
    from repro_torch.models.model import Batch
    harness.set_precision(torch, cfg["precision"])
    n_layers, gamma = cfg["num_hidden_layers"], tr["gamma"]
    weights = data.lm_weights(data.seeded(dev, ctx.seed, 1), cfg, n_layers,
                              dev)
    names = list(weights)
    tokens, labels = data.token_batches(
        data.seeded(dev, ctx.seed, 2), BATCHES, tr["batch"],
        tr["seq"], cfg["vocab_size"], dev)
    model, mcfg, step = build(ctx, weights)
    if fault is not None:
        step = fault(step)
    params = {k: p.detach() for k, p in model.named_parameters()}
    p0 = {n: params[program_name(n)] for n in names}

    def batch(i):
        i %= tokens.shape[0]
        return Batch(tokens=tokens[i], labels=labels[i])

    losses, first = [], None
    for i in range(CHECK_STEPS):
        params, loss = step(params, batch(i))
        losses.append(loss)
        if i == 0:
            first = leaf_norms(torch, lambda n: (
                p0[n] - params[program_name(n)]) / gamma, names)
    change = leaf_norms(torch, lambda n: params[program_name(n)] - p0[n],
                        names)
    del p0
    if ctx.trace:
        harness.warm_profiler(torch)
    harness.sync(torch, dev)

    t0 = ctx.start_window()
    steps, record, window_losses = 0, None, []
    while True:
        i = CHECK_STEPS + steps
        if ctx.trace and steps == TRACE_AFTER:
            # the same steps untraced, between syncs, then traced
            harness.sync(torch, dev)
            plain_t0 = harness.clock()
            params, loss = _steps(step, params, batch, i, TRACE_STEPS,
                                  window_losses)
            harness.sync(torch, dev)
            plain_s = harness.clock() - plain_t0
            i += TRACE_STEPS
            before = launches()
            (params, loss), record = harness.profile_stretch(
                torch, lambda: _steps(step, params, batch, i,
                                      TRACE_STEPS, window_losses))
            after = launches()
            record["launches"] = {k: after[k] - before[k] for k in after}
            record["steps"], record["plain_s"] = TRACE_STEPS, plain_s
            steps += 2 * TRACE_STEPS
        else:
            params, loss = step(params, batch(i))
            window_losses.append(loss)
            steps += 1
        if harness.clock() - t0 >= ctx.seconds:
            break
    harness.sync(torch, dev)
    window = harness.clock() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    prog = dict(losses=[float(x) for x in losses],
                first=dict(zip(names, first.tolist())),
                change=dict(zip(names, change.tolist())))
    del params, model, step, weights, loss, window_losses
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(ctx, tokens, labels)
    tokens_per_step = tr["batch"] * tr["seq"]
    return harness.Outcome(
        end_to_end={"train_tokens_per_s": steps * tokens_per_step / window},
        attempted=steps, failed=failed,
        checks=checks(ctx, prog, ref), memory_peak_bytes=peak,
        record=record)


def _steps(step, params, batch, i, n, losses):
    for j in range(n):
        params, loss = step(params, batch(i + j))
        losses.append(loss)
    return params, loss


def reference(ctx, tokens, labels, precision=None, rows=None):
    """The plain reference's ``CHECK_STEPS`` steps from the seed's
    weights: losses, first-gradient norms and change norms by weight."""
    torch, cfg, tr, dev = ctx.torch, ctx.cfg, ctx.traffic, ctx.device
    harness.set_precision(torch, precision or cfg["precision"])
    n_layers, gamma = cfg["num_hidden_layers"], tr["gamma"]
    w0 = data.lm_weights(data.seeded(dev, ctx.seed, 1), cfg, n_layers, dev)
    names = list(w0)
    w, losses, first = w0, [], None
    for i in range(CHECK_STEPS):
        w, loss = lm_ref.sgd_step(w, tokens[i], labels[i], cfg, n_layers,
                                  gamma, rows)
        losses.append(loss)
        if i == 0:
            first = leaf_norms(torch, lambda n: (w0[n] - w[n]) / gamma,
                               names)
    change = leaf_norms(torch, lambda n: w[n] - w0[n], names)
    harness.set_precision(torch, cfg["precision"])
    return dict(losses=losses, first=dict(zip(names, first.tolist())),
                change=dict(zip(names, change.tolist())))


def numbers(prog, ref):
    """loss_gap: the widest relative gap of a step's loss; grad_gap and
    change_gap: the worst leaf's gap of the first gradient's norm and of
    the change's norm (``harness.worst_leaf_gap``)."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap = harness.worst_leaf_gap(prog["first"], ref["first"])[0]
    change_gap = harness.worst_leaf_gap(prog["change"], ref["change"])[0]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def checks(ctx, prog, ref):
    nums = numbers(prog, ref)
    return [harness.Check(k, nums[k], v)
            for k, v in ctx.traffic["limits"].items()]


def control_readings(ctx):
    """The cell's numbers for the control, the reference in TF32, and
    for two faults: each minibatch's first half alone, and the state
    left unchanged (``controls.py``)."""
    torch, tr = ctx.torch, ctx.traffic
    tokens, labels = data.token_batches(
        data.seeded(ctx.device, ctx.seed, 2), CHECK_STEPS, tr["batch"],
        tr["seq"], ctx.cfg["vocab_size"], ctx.device)
    ref = reference(ctx, tokens, labels)
    out = {"tf32": numbers(reference(ctx, tokens, labels,
                                     precision="tf32"), ref),
           "half_batch": numbers(reference(ctx, tokens, labels,
                                           rows=tr["batch"] // 2), ref)}
    zero = {k: 0.0 for k in ref["first"]}
    out["unchanged"] = numbers(
        dict(losses=ref["losses"], first=zero, change=zero), ref)
    del tokens, labels
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    return out
