"""The port's model zoo beyond yi-6b against the reference, on the CPU:
``chatglm3-6b`` (partial rotary, GQA 16), ``minicpm-2b`` (full MHA at
head dim 64, tied head), ``granite-20b`` (MQA), ``llama-3.2-vision-11b``
(a cross-attention layer over media embeddings) and
``seamless-m4t-large-v2`` (the encoder-decoder: bidirectional encoder
layers and a cross block in each decoder layer), each at ``reduced()``.

The reference initialises its parameters; ``convert.lm_params_from_jax``
carries them across, and seeded numpy tokens, media (B, 16, d) and frames
(B, 32, d) go to both packages. On CPU tensors the port's attention runs
the flash kernel's plain version (``tests/test_torch_attention.py``
holds it against the Pallas kernel), the reference its jnp grouped
attention; decode attends plainly on both sides.

Tolerances, each with its reason (``tests/test_torch_dense.py``'s): the
two sides sum float32 products in other orders (XLA's dot against
PyTorch's matmul, over d_model = 256 and d_ff = 512 terms; the port's
attention scales q before the product, the reference the scores).
Logits atol 2e-5 / rtol 1e-4 (measured max |d| 8.9e-7 at |logit| up to
2.0 in the forward, 8.3e-7 in prefill and decode, over the five ids);
the loss rtol 1e-5; cached keys and values, self and cross, rtol 1e-4 /
atol 2e-5 (measured 1.3e-6 at |k| up to 1.3). Greedy tokens are exact wherever
every earlier step's top-2 logit margin exceeds 1e-4, five times the
logits' tolerance. Prefill plus decode against the port's own
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

IDS = ["chatglm3-6b", "minicpm-2b", "granite-20b", "llama-3.2-vision-11b",
       "seamless-m4t-large-v2"]
# full-size float32 parameters (param_count() x 4 bytes), head dim, query
# heads per KV head, and the reduced model's flash calls per forward
FULL = {"chatglm3-6b": (25.0e9, 128, 16, 2),
        "minicpm-2b": (10.9e9, 64, 1, 2),
        "granite-20b": (112.7e9, 128, 48, 2),
        "llama-3.2-vision-11b": (39.1e9, 128, 4, 2),
        "seamless-m4t-large-v2": (8.1e9, 64, 1, 6)}
STILL_RAISING = ("mixtral-8x22b", "jamba-v0.1-52b", "kimi-k2-1t-a32b")


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module", params=IDS)
def lm(request, ref):
    """The reduced id (2 layers, d_model 256, 4 query heads of 64): the
    reference's parameters and the port's copy of them."""
    cfg = configs.get_config(request.param).reduced()
    rcfg = ref.configs.get_config(request.param).reduced()
    rparams = ref.model.init_params(ref.jax.random.PRNGKey(0), rcfg)
    tree = ref.jax.tree.map(np.asarray, rparams)
    return cfg, rcfg, rparams, lm_params_from_jax(tree, cfg, device="cpu")


def inputs(cfg, b, s, seed=1):
    """Seeded tokens (b, s) and, where the model reads them, media (b, 16,
    d) and frames (b, 32, d), as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    media = (rng.standard_normal((b, cfg.n_media_tokens, cfg.d_model))
             .astype(np.float32) if cfg.cross_attn_every else None)
    frames = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32) if cfg.is_encoder_decoder else None)
    return tok, media, frames


def batches(ref, tok, media, frames, labels=None):
    """The same inputs as the reference's and the port's batches."""
    def j(a):
        return None if a is None else ref.jnp.asarray(a)

    def t(a, long=False):
        if a is None:
            return None
        a = torch.from_numpy(a)
        return a.long() if long else a

    return (ref.model.Batch(tokens=j(tok), labels=j(labels), media=j(media),
                            frames=j(frames)),
            M.Batch(tokens=t(tok, True), labels=t(labels, True),
                    media=t(media), frames=t(frames)))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def ref_leaves(ref, rparams, cfg):
    """Every reference leaf with the port's name of it: period-stacked
    leaves by layer, encoder-stacked leaves by encoder layer."""
    _, period, n_periods = cfg.period_decomposition()
    out = {}
    for path, leaf in ref.jax.tree_util.tree_leaves_with_path(rparams):
        keys = [p.key for p in path]
        if keys[0] == "period":
            i = int(keys[1].removeprefix("layer"))
            for k in range(n_periods):
                out[".".join(["layers", str(k * len(period) + i)]
                             + keys[2:])] = np.asarray(leaf[k])
        elif keys[0] == "encoder":
            for k in range(cfg.n_encoder_layers):
                out[".".join(["encoder", str(k)] + keys[2:])] = \
                    np.asarray(leaf[k])
        else:
            out[".".join(keys)] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("arch", IDS)
def test_config_matches_reference(ref, arch):
    port = configs.get_config(arch)
    want = ref.configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    for kw in ({}, dict(n_layers=2, d_model=512), dict(n_layers=1)):
        assert (dataclasses.asdict(port.reduced(**kw))
                == dataclasses.asdict(want.reduced(**kw)))
    assert port.param_count() == want.param_count()
    assert ([dataclasses.astuple(s) for s in port.layer_specs()]
            == [dataclasses.astuple(s) for s in want.layer_specs()])
    assert port.encoder_period()[1] == want.encoder_period()[1]
    size, hd, group, _ = FULL[arch]
    assert abs(4 * port.param_count() - size) < 0.05e9
    assert port.resolved_head_dim == hd
    assert port.n_heads // port.n_kv_heads == group
    assert port.tie_embeddings == (arch == "minicpm-2b")
    assert arch in configs.all_configs()


def test_unported_ids_still_raise():
    assert set(configs.PORTED_IDS) | set(STILL_RAISING) == set(
        configs.ARCH_IDS)
    for name in STILL_RAISING:
        with pytest.raises(NotImplementedError, match="§A item 10"):
            configs.get_config(name)


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
    assert ("lm_head.w" in got) == (not cfg.tie_embeddings)
    hd = cfg.resolved_head_dim
    assert got["layers.0.mixer.wk.w"] == (cfg.d_model, cfg.n_kv_heads * hd)
    specs = cfg.layer_specs()
    for i, spec in enumerate(specs):
        mixer = params.layers[i].mixer
        assert isinstance(mixer, attn.CrossAttention) == (
            spec.mixer == "cross_attn")
        assert (f"layers.{i}.cross.wq.w" in got) == cfg.is_encoder_decoder
    if cfg.is_encoder_decoder:
        assert len(params.encoder) == cfg.n_encoder_layers
        assert not any(layer.mixer.causal for layer in params.encoder)
        assert "enc_norm.g" in got and "encoder.1.mlp.wo.w" in got
    else:
        assert params.encoder is None
    w = params.state_dict()["layers.0.mlp.wi.w"]
    assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02


def test_lm_params_from_jax_carries_every_leaf(ref, lm):
    """Every reference leaf lands in the port's module, bit for bit:
    period-stacked layer leaves unstacked by layer, the encoder's by
    encoder layer, the rest unchanged; a tied head has no ``lm_head``."""
    cfg, _, rparams, params = lm
    sd = params.state_dict()
    want = ref_leaves(ref, rparams, cfg)
    assert set(sd) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)
    enc = [layer.mixer.causal for layer in params.encoder or ()]
    assert enc == [False] * cfg.n_encoder_layers


def test_lm_forward_and_loss_match_reference(ref, lm):
    cfg, rcfg, rparams, params = lm
    tok, media, frames = inputs(cfg, 2, 40)
    rb, pb = batches(ref, tok, media, frames, np.roll(tok, -1, axis=1))
    want, raux = ref.model.forward(rparams, rb, rcfg)
    got, aux = M.forward(params, pb, cfg)
    assert got.shape == (2, 40, cfg.vocab_size)
    assert torch.isfinite(got).all() and float(aux) == float(raux) == 0.0
    close(got, want, LOGIT_TOL)
    rloss = ref.model.loss_fn(rparams, rb, rcfg)
    loss = M.loss_fn(params, pb, cfg)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)


def check_cross_kv(ref, cfg, st, rst):
    """The port's per-layer cross K / V against the reference's
    period-stacked (encoder K / V, media K / V) of ``ServeState``."""
    _, period, _ = cfg.period_decomposition()
    _, enc_per, _, med_per = rst.cross_kv
    n_cross = 0
    for j, (media_kv, enc_kv) in enumerate(st.cross_kv):
        k, i = divmod(j, len(period))
        for got, tree in ((media_kv, med_per), (enc_kv, enc_per)):
            want = None if tree is None else tree[f"layer{i}"]
            assert (got is None) == (want is None)
            if got is not None:
                n_cross += 1
                for g, w in zip(got, want):
                    assert tuple(g.shape) == w.shape[1:]
                    close(g, w[k], CACHE_TOL)
    assert n_cross == sum(s.mixer == "cross_attn"
                          for s in cfg.layer_specs()) + (
        cfg.n_layers if cfg.is_encoder_decoder else 0)


@pytest.mark.parametrize("prompt,cache_len", [(30, 38), (30, 16)])
def test_lm_prefill_and_decode_match_reference(ref, lm, prompt, cache_len):
    """prefill, then 8 decode steps: logits, every self-attention layer's
    KV cache and every cross K / V against the reference's, with a cache
    longer than the prompt and a rolling one shorter than it."""
    cfg, rcfg, rparams, params = lm
    tok, media, frames = inputs(cfg, 2, prompt + 8, seed=2)
    rb, pb = batches(ref, tok[:, :prompt], media, frames)
    rl, rst = ref.model.prefill(rparams, rb, rcfg, cache_len=cache_len)
    pl, st = M.prefill(params, pb, cfg, cache_len=cache_len)
    assert pl.shape == (2, 1, cfg.vocab_size) and st.position == prompt
    close(pl, rl, LOGIT_TOL)
    prefill_kv = st.cross_kv
    for t in range(prompt, prompt + 8):
        rl, rst = ref.model.decode_step(
            rparams, ref.jnp.asarray(tok[:, t:t + 1]), rst, rcfg)
        pl, st = M.decode_step(params, torch.from_numpy(
            tok[:, t:t + 1]).long(), st, cfg)
        close(pl, rl, LOGIT_TOL)
    assert st.position == int(rst.position) == prompt + 8
    assert st.cross_kv is prefill_kv     # carried, never recomputed
    _, period, _ = cfg.period_decomposition()
    for j, cache in enumerate(st.layers):
        k, i = divmod(j, len(period))
        rcache = rst.period[f"layer{i}"]
        if period[i].mixer == "cross_attn":
            assert cache is None and rcache is None
            continue
        close(cache.k, rcache.k[k], CACHE_TOL)
        close(cache.v, rcache.v[k], CACHE_TOL)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(rcache.slot_pos[k]))
        assert cache.length == int(rcache.length[k])
    check_cross_kv(ref, cfg, st, rst)
    for spec in period:
        want = ref.model._layer_cache_init(spec, rcfg, 2, cache_len,
                                           ref.jnp.float32)
        got = M._layer_cache_init(spec, cfg, 2, cache_len, torch.float32,
                                  "cpu")
        assert (got is None) == (want is None)
        if got is not None:
            assert ([tuple(t.shape) for t in got[:3]]
                    == [t.shape for t in want[:3]])


def test_generate_matches_reference_greedy_loop(ref, lm):
    """``serve.generate``'s tokens against the reference serve loop's
    (prefill, then argmax fed back), exact while the margins allow."""
    cfg, rcfg, rparams, params = lm
    gen = 8
    tok, media, frames = inputs(cfg, 3, 24, seed=5)
    rb, pb = batches(ref, tok, media, frames)
    out = serve.generate(params, pb, cfg, gen)
    assert out.tokens.shape == (3, gen) and out.prefill_s > 0
    logits, st = ref.model.prefill(rparams, rb, rcfg, cache_len=24 + gen)
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


@pytest.mark.parametrize("arch", IDS)
def test_decode_matches_forward(arch):
    """The port's twin of ``test_arch_smoke.py::test_decode_matches_forward``
    (which runs chatglm3, seamless and llama-vision): prefill plus decode
    steps reproduce the teacher-forced logits."""
    cfg = configs.get_config(arch).reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    b, s, pre = 2, 20, 16
    tok, media, frames = (None if a is None else torch.from_numpy(a)
                          for a in inputs(cfg, b, s))
    tok = tok.long()
    full, _ = M.forward(params, M.Batch(tok, media=media, frames=frames),
                        cfg)
    lg, st = M.prefill(params, M.Batch(tok[:, :pre], media=media,
                                       frames=frames), cfg, cache_len=s)
    errs = [float((lg[:, 0] - full[:, pre - 1]).abs().max())]
    for i in range(pre, s - 1):
        lg, st = M.decode_step(params, tok[:, i:i + 1], st, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 2e-4, errs


def flash_calls(cfg, s):
    """The (Sq, Sk, causal, kv_group) of each flash call of a forward or
    prefill over ``s`` tokens: the encoder's layers first, then per decoder
    layer its mixer's and its cross block's."""
    group = cfg.n_heads // cfg.n_kv_heads
    se = cfg.encoder_seq
    out = [(se, se, False, group)] * cfg.n_encoder_layers
    for spec in cfg.layer_specs():
        if spec.mixer == "cross_attn":
            out.append((s, cfg.n_media_tokens, False, group))
        else:
            out.append((s, s, True, group))
        if cfg.is_encoder_decoder:
            out.append((s, se, False, group))
    return out


def test_attention_routes_through_the_flash_entry(monkeypatch, lm):
    """Forward and prefill call ``ops.flash_attention`` once per
    self-attention layer, cross-attention layer and encoder layer (and
    once per decoder layer's cross block) on the unexpanded K / V with
    ``kv_group = Hq / KV``; cross and encoder calls are non-causal, over
    the media's or the frames' keys; decode never calls it."""
    cfg, _, _, params = lm
    calls = []
    flash = attn.kops.flash_attention

    def counting(q, k, v, **kw):
        assert kw["window"] is None
        calls.append((q.shape[1], k.shape[1], kw["causal"], kw["kv_group"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attn.kops, "flash_attention", counting)
    tok, media, frames = (None if a is None else torch.from_numpy(a)
                          for a in inputs(cfg, 2, 30))
    tok = tok.long()
    M.forward(params, M.Batch(tok, media=media, frames=frames), cfg)
    assert calls == flash_calls(cfg, 30)
    assert len(calls) == FULL[cfg.name.removesuffix("-reduced")][3]
    calls.clear()
    _, st = M.prefill(params, M.Batch(tok[:, :20], media=media,
                                      frames=frames), cfg, 30)
    assert calls == flash_calls(cfg, 20)
    for t in range(20, 23):
        _, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
    assert calls == flash_calls(cfg, 20)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_serve_main_on_cpu(capsys, arch):
    serve.main(["--device", "cpu", "--arch", arch, "--gen", "4",
                "--prompt-len", "40"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == f"{arch}-reduced" and out["generated"] == 4
    assert len(out["sample_output"]) == 4


def test_models_need_their_media_and_frames():
    """A VLM without media, an encoder-decoder without frames: a clear
    error, not a silent self-attention (the reference's forward runs its
    cross-attention layers as causal self-attention without media)."""
    for arch, field in (("llama-3.2-vision-11b", "media"),
                        ("seamless-m4t-large-v2", "frames")):
        cfg = configs.get_config(arch).reduced()
        params = M.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
        tok = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(ValueError, match=field):
            M.forward(params, M.Batch(tok), cfg)
        with pytest.raises(ValueError, match=field):
            M.prefill(params, M.Batch(tok), cfg, 8)
