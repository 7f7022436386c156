"""The program's spans on the device trace's clock, and the arithmetic of
the LM step's phases.

A span stretch runs steps with the program's telemetry on
(``repro_torch.obs.configure(True)``: its ``trace_span`` ranges) under
``torch.profiler`` with host and device activity (host activity, since
the profiler records no ``record_function`` range without it), then off
again, and reduces the trace (its Chrome-trace form, whose events carry
a category and the profiler's correlation id):

- each device operation goes to the innermost program span whose
  interval holds the start of the runtime call that launched it (matched
  by correlation id, on whatever thread the call ran); a span's device
  seconds are thus its self part, and operations launched outside every
  span are ``unattributed``;
- a span's host seconds are its duration less its child spans';
- the idle gaps are named by the innermost span open at their midpoint,
  then by the runtime call that ran through it.

``lm_train_spans`` runs such a stretch of the LM training cells' step
(``fl/round.py::make_train_step``: ``train_step``, holding
``train_step.forward`` and ``train_step.update``; the backward is
``train_step``'s self part) once a traced run, for the metrics that read
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import data  # noqa: E402
import harness  # noqa: E402
import roofline  # noqa: E402

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver", "overhead")
SPAN = "user_annotation"
UNATTRIBUTED = "unattributed"
# steps of the LM span stretch, after one warm step and as many untraced
STEPS = 2


# ------------------------------------------------------------ arithmetic

def lm_fwd_flops(cfg: dict, n_layers: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step's forward: 2 per token and matmul
    weight, and causal attention's q k^T and p v at the live pairs (half
    of S^2), 4 D a pair and head; a third of
    ``roofline.lm_step_flops``."""
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    live = seq * (seq + 1) / 2
    attn = 4.0 * hd * live * cfg["num_attention_heads"] * batch
    return (2.0 * batch * seq * roofline.lm_matmul_params(cfg, n_layers)
            + n_layers * attn)


def lm_update_bytes(cfg: dict, n_layers: int) -> int:
    """Least bytes of one SGD update of every parameter: read the weight
    and its gradient, write the weight, float32, 12 B a parameter. The
    parameters: the matmul weights (``roofline.lm_matmul_params``), the
    embedding (its gradient is dense) and the 2 L + 1 RMSNorm gains."""
    d = cfg["hidden_size"]
    params = (roofline.lm_matmul_params(cfg, n_layers)
              + cfg["vocab_size"] * d + (2 * n_layers + 1) * d)
    return 12 * params


# ------------------------------------------------------------- reduction

def _kinds(events):
    """The trace's complete events split into spans, device operations and
    runtime calls, each (start us, end us, event)."""
    out = {"span": [], "device": [], "runtime": []}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        kind = ("span" if cat == SPAN else "device" if cat in DEVICE
                else "runtime" if cat in RUNTIME else None)
        if kind:
            out[kind].append((float(e["ts"]), float(e["ts"]) + float(
                e["dur"]), e))
    return out


def _innermost(spans, t):
    """The innermost span open at ``t`` (the latest to start, the shortest
    of those), on any thread; None if none."""
    best = None
    for s, end, e in spans:
        if s <= t <= end and (best is None
                              or (s, -end) > (best[0], -best[1])):
            best = (s, end, e)
    return best


def _parent(spans, s, end, e):
    """The innermost other span on ``e``'s thread holding [s, end]."""
    best = None
    for x in spans:
        if (x[2] is not e and x[0] <= s and end <= x[1]
                and x[2].get("tid") == e.get("tid")
                and (best is None or (x[0], -x[1]) > (best[0], -best[1]))):
            best = x
    return best


def attribute(events):
    """Each device operation with the span it goes to: a list of (span
    name or ``unattributed``, operation name, device seconds)."""
    k = _kinds(events)
    launch = {}
    for s, _, e in k["runtime"]:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launch.setdefault(corr, s)
    out = []
    for s, end, e in k["device"]:
        t = launch.get(e.get("args", {}).get("correlation"))
        span = None if t is None else _innermost(k["span"], t)
        out.append((span[2]["name"] if span else UNATTRIBUTED, e["name"],
                    (end - s) / 1e6))
    return out


def reduce(events, steps: int) -> dict:
    """The stretch by span, a step: device seconds (self; ``unattributed``
    for launches outside every span), host seconds (self), the device's
    busy seconds (union of its operations) and the operations by name in
    each span ([name, launches, seconds], longest first); and the
    stretch's 10 longest idle gaps, each [name, seconds]."""
    k = _kinds(events)
    device, ops = {}, {}
    for span, name, secs in attribute(events):
        device[span] = device.get(span, 0.0) + secs / steps
        c = ops.setdefault(span, {}).setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += secs / steps
    host = {}
    for s, end, e in k["span"]:
        host[e["name"]] = host.get(e["name"], 0.0) + (end - s) / 1e6 / steps
        parent = _parent(k["span"], s, end, e)
        if parent:
            name = parent[2]["name"]
            host[name] = host.get(name, 0.0) - (end - s) / 1e6 / steps
    everything = k["span"] + k["device"] + k["runtime"]
    gaps = []
    if everything:
        t0 = min(x[0] for x in everything)
        t1 = max(x[1] for x in everything)
        edge = t0
        for s, e in sorted((x[0], x[1]) for x in k["device"]):
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if t1 > edge:
            gaps.append((edge, t1))
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        span = _innermost(k["span"], mid)
        call = _innermost(k["runtime"], mid)
        name = call[2]["name"] if call else "host between runtime calls"
        named.append([f"{span[2]['name']}: {name}" if span else name,
                      (e - s) / 1e6])
    return dict(steps=steps, device_s=device, host_s=host,
                busy_s=sum(e - s for s, e in harness._union(
                    [(x[0], x[1]) for x in k["device"]])) / 1e6 / steps,
                ops={span: sorted(([n, c, s] for n, (c, s) in by.items()),
                                  key=lambda r: -r[2])
                     for span, by in ops.items()},
                idle_gaps=named)


def profile_events(torch, fn):
    """Run ``fn`` and a device sync under ``torch.profiler`` with host and
    device activity; returns (fn's value, the trace's events)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return out, trace["traceEvents"]


# ------------------------------------------------------- the LM stretch

def run_seed(default: int = 0) -> int:
    """The run's ``--seed`` (``run.py``'s command line), else ``default``."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=default)
    return ap.parse_known_args()[0].seed


def lm_stretch(ctx, steps: int = STEPS) -> dict:
    """The LM cells' step (the driver's ``build``) on weights and batches
    from ``ctx.seed``, with telemetry on: one warm step, ``steps`` steps
    untraced between syncs (``plain_s``, seconds a step), then ``steps``
    under the profiler (``step_s``, seconds a step from the first step's
    call to the sync after the last, inside the profiled region), reduced
    by :func:`reduce`; telemetry off again afterwards."""
    torch, cfg, tr, dev = ctx.torch, ctx.cfg, ctx.traffic, ctx.device
    from repro_torch import obs
    from repro_torch.models.model import Batch
    driver = harness.load_module("drivers", cfg["driver"])
    harness.set_precision(torch, cfg["precision"])
    weights = data.lm_weights(data.seeded(dev, ctx.seed, 3), cfg,
                              cfg["num_hidden_layers"], dev)
    tokens, labels = data.token_batches(
        data.seeded(dev, ctx.seed, 4), 1 + 2 * steps, tr["batch"],
        tr["seq"], cfg["vocab_size"], dev)
    model, _, step = driver.build(ctx, weights)
    params = {k: p.detach() for k, p in model.named_parameters()}

    def run(first, n):
        p = params
        for i in range(first, first + n):
            p, _ = step(p, Batch(tokens=tokens[i], labels=labels[i]))
        return p

    def timed(first):
        t = harness.clock()
        p = run(first, steps)
        harness.sync(torch, dev)
        return p, (harness.clock() - t) / steps

    obs.configure(True)
    try:
        params = run(0, 1)
        harness.sync(torch, dev)
        params, plain_s = timed(1)
        (params, step_s), events = profile_events(
            torch, lambda: timed(1 + steps))
    finally:
        obs.configure(False)
    del params, model, step, weights, tokens, labels
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    return dict(reduce(events, steps), plain_s=plain_s, step_s=step_s)


def lm_train_spans(record, cfg, traffic):
    """``record["spans"]``: the LM span stretch of a traced run, made by
    the first metric that asks (on the card only) and printed to standard
    error; None outside a traced run or without a card."""
    if not record:
        return None
    if "spans" not in record:
        import torch
        if not torch.cuda.is_available():
            return None
        ctx = harness.Context(torch=torch, device="cuda", cfg=cfg,
                              traffic=traffic, seed=run_seed(), seconds=0.0,
                              trace=True, start_window=harness.clock)
        record["spans"] = lm_stretch(ctx)
        short = dict(record["spans"], ops={
            k: v[:6] for k, v in record["spans"]["ops"].items()})
        print("spans " + json.dumps(short), file=sys.stderr, flush=True)
    return record["spans"]
