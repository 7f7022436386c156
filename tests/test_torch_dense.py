"""The port's dense GQA model (``yi-6b``) against the reference, on the CPU.

The reference initialises its parameters; ``convert.lm_params_from_jax``
carries them across, and seeded numpy tokens go to both packages. On CPU
tensors the port's attention runs the flash kernel's plain version
(``tests/test_torch_attention.py`` holds it against the Pallas kernel),
the reference its jnp grouped attention.

Tolerances, each with its reason: the two sides sum float32 products in
other orders (XLA's dot against PyTorch's matmul, over d_model = 256 and
d_ff = 512 terms; the port's attention scales q before the product, the
reference the scores). Logits atol 2e-5 / rtol 1e-4 (measured max |d|
9.5e-7 at |logit| up to 1.2 in the forward, 8.0e-7 in prefill and
decode); the loss rtol 1e-5; cached keys and values rtol 1e-4 / atol 2e-5
(measured 7.2e-7 at |k| up to 1.3). Greedy tokens are exact
wherever every earlier step's top-2 logit margin exceeds 1e-4, five times
the logits' tolerance. Prefill plus decode against the port's own
teacher-forced forward: < 2e-4, the bound of
``tests/test_arch_smoke.py::test_decode_matches_forward``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
CACHE_TOL = dict(rtol=1e-4, atol=2e-5)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def lm(ref):
    """Reduced yi-6b (2 layers, d_model 256, 4 query heads sharing one KV
    head of 64, untied head): the reference's parameters and the port's
    copy of them."""
    cfg = configs.get_config("yi-6b").reduced()
    rcfg = ref.configs.get_config("yi-6b").reduced()
    rparams = ref.model.init_params(ref.jax.random.PRNGKey(0), rcfg)
    tree = ref.jax.tree.map(np.asarray, rparams)
    return cfg, rcfg, rparams, lm_params_from_jax(tree, cfg, device="cpu")


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_yi_config_matches_reference(ref):
    port = configs.get_config("yi-6b")
    want = ref.configs.get_config("yi-6b")
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    for kw in ({}, dict(n_layers=2, d_model=512), dict(n_layers=1)):
        assert (dataclasses.asdict(port.reduced(**kw))
                == dataclasses.asdict(want.reduced(**kw)))
    assert port.param_count() == want.param_count()
    # 6.06 B float32 parameters: 24.2 GB, one H100 at full width
    assert 6.0e9 < port.param_count() < 6.1e9
    assert ([dataclasses.astuple(s) for s in port.layer_specs()]
            == [dataclasses.astuple(s) for s in want.layer_specs()])
    assert port.resolved_head_dim == 128 and not port.tie_embeddings


def test_init_params_matches_reference_layout(ref, lm):
    """The port's own init: the reference's parameter names, shapes and
    count (the analytic ``param_count`` within 1%, as
    ``test_arch_smoke.py::test_param_count_formula`` holds it)."""
    cfg, _, rparams, carried = lm
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    got = {k: tuple(v.shape) for k, v in params.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in carried.named_parameters()}
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(x.size for x in ref.jax.tree.leaves(rparams))
    assert abs(count - cfg.param_count()) / count < 0.01
    for name in ("lm_head.w", "layers.1.mixer.wk.w", "layers.1.mlp.wg.w",
                 "layers.0.norm2.g"):
        assert name in got
    assert got["layers.0.mixer.wk.w"] == (256, 64)     # one KV head of 64
    w = params.state_dict()["layers.0.mlp.wi.w"]
    assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02


def test_lm_params_from_jax_carries_every_leaf(ref, lm):
    """Every reference leaf lands in the port's module: period-stacked
    layer leaves unstacked by layer, the rest unchanged."""
    cfg, _, rparams, params = lm
    sd = params.state_dict()
    layer = rparams["period"]["layer0"]
    # embed, final_norm, lm_head, and each stacked leaf once per layer
    assert len(sd) == 3 + cfg.n_layers * len(ref.jax.tree.leaves(layer))
    for i in range(cfg.n_layers):
        for path in (("mixer", "wq", "w"), ("mixer", "wo", "w"),
                     ("mlp", "wg", "w"), ("norm2", "g")):
            leaf = layer
            for key in path:
                leaf = leaf[key]
            np.testing.assert_array_equal(
                sd[f"layers.{i}.{'.'.join(path)}"].numpy(),
                np.asarray(leaf[i]))
    np.testing.assert_array_equal(sd["lm_head.w"].numpy(),
                                  np.asarray(rparams["lm_head"]["w"]))


def test_lm_forward_and_loss_match_reference(ref, lm):
    cfg, rcfg, rparams, params = lm
    tok = tokens(cfg, 2, 70)
    lab = np.roll(tok, -1, axis=1)
    jt, jl = ref.jnp.asarray(tok), ref.jnp.asarray(lab)
    tt, tl = torch.from_numpy(tok).long(), torch.from_numpy(lab).long()
    want, raux = ref.model.forward(rparams, ref.model.Batch(tokens=jt), rcfg)
    got, aux = M.forward(params, M.Batch(tokens=tt), cfg)
    assert got.shape == (2, 70, cfg.vocab_size)
    assert torch.isfinite(got).all() and float(aux) == float(raux) == 0.0
    close(got, want, LOGIT_TOL)
    rloss = ref.model.loss_fn(rparams, ref.model.Batch(tokens=jt, labels=jl),
                              rcfg)
    loss = M.loss_fn(params, M.Batch(tokens=tt, labels=tl), cfg)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)


@pytest.mark.parametrize("prompt,cache_len", [(60, 68), (60, 32)])
def test_lm_prefill_and_decode_match_reference(ref, lm, prompt, cache_len):
    """prefill, then 8 decode steps: logits and every layer's KV cache
    against the reference's, with a cache longer than the prompt and a
    rolling one shorter than it."""
    cfg, rcfg, rparams, params = lm
    tok = tokens(cfg, 2, prompt + 8, seed=2)
    rl, rst = ref.model.prefill(
        rparams, ref.model.Batch(tokens=ref.jnp.asarray(tok[:, :prompt])),
        rcfg, cache_len=cache_len)
    pl, st = M.prefill(params, M.Batch(tokens=torch.from_numpy(
        tok[:, :prompt]).long()), cfg, cache_len=cache_len)
    assert pl.shape == (2, 1, cfg.vocab_size) and st.position == prompt
    close(pl, rl, LOGIT_TOL)
    for t in range(prompt, prompt + 8):
        rl, rst = ref.model.decode_step(
            rparams, ref.jnp.asarray(tok[:, t:t + 1]), rst, rcfg)
        pl, st = M.decode_step(params, torch.from_numpy(
            tok[:, t:t + 1]).long(), st, cfg)
        close(pl, rl, LOGIT_TOL)
    assert st.position == int(rst.position) == prompt + 8
    rcache = rst.period["layer0"]
    for i, cache in enumerate(st.layers):
        close(cache.k, rcache.k[i], CACHE_TOL)
        close(cache.v, rcache.v[i], CACHE_TOL)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(rcache.slot_pos[i]))
        assert cache.length == int(rcache.length[i])
    want = ref.model._layer_cache_init(rcfg.layer_specs()[0], rcfg, 2,
                                       cache_len, ref.jnp.float32)
    got = M._layer_cache_init(cfg.layer_specs()[0], cfg, 2, cache_len,
                              torch.float32, "cpu")
    assert [tuple(t.shape) for t in got[:3]] == [t.shape for t in want[:3]]


def test_generate_matches_reference_greedy_loop(ref, lm):
    """``serve.generate``'s tokens against the reference serve loop's
    (prefill, then argmax fed back), exact while the margins allow."""
    cfg, rcfg, rparams, params = lm
    gen = 8
    tok = tokens(cfg, 3, 24, seed=5)
    out = serve.generate(params, M.Batch(tokens=torch.from_numpy(tok).long()),
                         cfg, gen)
    assert out.tokens.shape == (3, gen) and out.prefill_s > 0
    logits, st = ref.model.prefill(
        rparams, ref.model.Batch(tokens=ref.jnp.asarray(tok)), rcfg,
        cache_len=24 + gen)
    want, margins = [], []
    for _ in range(gen):
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        nxt = last.argmax(-1)
        want.append(nxt)
        logits, st = ref.model.decode_step(
            rparams, ref.jnp.asarray(nxt[:, None].astype(np.int32)), st, rcfg)
    want, margins = np.stack(want, 1), np.stack(margins, 1)
    trusted = np.cumprod(margins > MARGIN, axis=1).astype(bool)
    assert trusted[:, 0].all()
    np.testing.assert_array_equal(out.tokens.numpy()[trusted],
                                  want[trusted])


@pytest.mark.parametrize("window", [None, 8])
def test_decode_matches_forward(window):
    """The port's twin of ``test_arch_smoke.py::test_decode_matches_forward``
    at ``reduced()`` yi-6b, and of ``test_sliding_window_decode_rolls``
    with a window of 8 (the cache rolls past it): prefill plus decode steps
    reproduce the teacher-forced logits."""
    cfg = dataclasses.replace(configs.get_config("yi-6b").reduced(),
                              sliding_window=window)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    b, s, pre = 2, 24, 4 if window else 16
    tok = torch.from_numpy(tokens(cfg, b, s)).long()
    full, _ = M.forward(params, M.Batch(tokens=tok), cfg)
    lg, st = M.prefill(params, M.Batch(tokens=tok[:, :pre]), cfg,
                       cache_len=s)
    if window:
        assert st.layers[0].k.shape[1] == window
    errs = [float((lg[:, 0] - full[:, pre - 1]).abs().max())]
    for i in range(pre, s - 1):
        lg, st = M.decode_step(params, tok[:, i:i + 1], st, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_decode_twice_from_one_state():
    """Decoding from one prefilled state twice, the second run after a
    first one whose keys still sit in the later slots of the shared cache
    (caches are written in place): the second run's logits equal those of
    a fresh prefill's, bit for bit, since the later slots are masked to a
    weight of exactly 0."""
    cfg = configs.get_config("yi-6b").reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tok = torch.from_numpy(tokens(cfg, 2, 24, seed=3)).long()
    other = torch.from_numpy(tokens(cfg, 2, 24, seed=4)).long()
    prompt = M.Batch(tokens=tok[:, :16])

    def decode(st, toks):
        out = []
        for t in range(toks.shape[1]):
            lg, st = M.decode_step(params, toks[:, t:t + 1], st, cfg)
            out.append(lg)
        return torch.cat(out, 1)

    _, st = M.prefill(params, prompt, cfg, 24)
    decode(st, other[:, 16:22])
    again = decode(st, tok[:, 16:20])
    _, fresh = M.prefill(params, prompt, cfg, 24)
    assert torch.equal(again, decode(fresh, tok[:, 16:20]))


def test_attention_routes_through_the_flash_entry(monkeypatch, lm):
    """Forward and prefill call ``ops.flash_attention`` once per layer on
    q (B Hq, S, hd) and the unexpanded k (B KV, S, hd) with ``kv_group =
    Hq / KV``; decode never does."""
    cfg, _, _, params = lm
    calls = []
    flash = attn.kops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["kv_group"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attn.kops, "flash_attention", counting)
    tok = torch.from_numpy(tokens(cfg, 2, 30)).long()
    M.forward(params, M.Batch(tokens=tok), cfg)
    group = cfg.n_heads // cfg.n_kv_heads
    assert calls == [((2 * cfg.n_heads, 30, 64),
                      (2 * cfg.n_kv_heads, 30, 64), group)] * cfg.n_layers
    assert group > 1
    _, st = M.prefill(params, M.Batch(tokens=tok[:, :20]), cfg, 30)
    assert len(calls) == 2 * cfg.n_layers
    for t in range(20, 23):
        _, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
    assert len(calls) == 2 * cfg.n_layers


def test_serve_main_yi_on_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "yi-6b", "--gen", "4",
                "--prompt-len", "40"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "yi-6b-reduced" and out["generated"] == 4
    assert len(out["sample_output"]) == 4
