"""The dry run's spec machinery (``repro_torch.launch.specs``): the mirror
of ``tests/test_specs.py`` on the port, then parity with the reference's
``repro.launch.specs``.

The parity tests plan on a duck-typed mesh (``axis_names`` and
``devices.shape``, all the reference's functions read), so no jax devices
are forced and no process group is made: the production meshes (16, 16)
and (2, 16, 16) and the debug ones (2, 4) and (2, 2, 2). For every id x
input shape: ``batch_pspecs`` (single and client-dim batches),
``token_pspec``, and ``serve_state_pspecs`` of the serving state that a
short prefill leaves in a cache of the case's length (the dry run's
decode state; a prefill case's state has the same cache shapes). The
reference's state is ``jax.eval_shape`` of its ``prefill``, the port's
``prefill`` run on ``meta`` at full size. A period layer's cache is a
slice of the reference's stacked leaf: its spec is the reference's with
the stacked entry (None) dropped. Specs are compared entry for entry.
Tokens are int64 in the port (the embedding's index type), int32 in the
reference; shapes are compared.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding.rules import PartitionSpec as P  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def mesh_of(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))


@pytest.fixture(scope="module")
def ref():
    r = reference()
    import importlib
    r.specs = importlib.import_module("repro.launch.specs")
    return r


# ------------------------------------------------- tests/test_specs.py's

def test_input_shape_catalog():
    assert set(S.INPUT_SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"}
    assert S.INPUT_SHAPES["train_4k"].global_batch == 256
    assert S.INPUT_SHAPES["long_500k"].seq_len == 524288
    assert S.INPUT_SHAPES["long_500k"].kind == "decode"


def test_long_context_policy():
    assert S.LONG_CONTEXT_ARCHS == {"mamba2-130m", "jamba-v0.1-52b",
                                    "mixtral-8x22b"}


def test_assign_respects_divisibility():
    ax = {"data": 16, "model": 16, "pod": 2}
    # batch 1 cannot take 'data'; falls to the 524288 slot dim
    spec = S._assign((1, 524288, 8, 128),
                     [("model", [2, 3]), ("data", [0, 1])], ax)
    assert spec == P(None, "data", None, "model")
    # kv=8 not divisible by 16 -> model lands on head_dim
    spec = S._assign((128, 32768, 8, 128), [("model", [2, 3])], ax)
    assert spec == P(None, None, None, "model")


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(S.INPUT_SHAPES))
def test_batch_specs_consistent(arch, shape):
    cfg = get_config(arch)
    case = S.INPUT_SHAPES[shape]
    b = S.batch_specs(cfg, case)
    assert b.tokens.dtype == torch.int64 and b.tokens.device.type == "meta"
    expect_s = 1 if case.kind == "decode" else case.seq_len
    assert b.tokens.shape == (case.global_batch, expect_s)
    if case.kind == "train":
        assert b.labels.shape == b.tokens.shape
    if cfg.cross_attn_every:
        assert b.media.shape[1] == cfg.n_media_tokens
    if cfg.is_encoder_decoder:
        assert b.frames is not None and b.frames.shape[2] == cfg.d_model


def test_client_dim_batches():
    cfg = get_config("yi-6b")
    case = S.INPUT_SHAPES["train_4k"]
    b = S.batch_specs(cfg, case, client_dim=2)
    assert b.tokens.shape == (2, 128, 4096)   # 256 split across 2 pods


def test_period_decomposition_patterns():
    jamba = get_config("jamba-v0.1-52b")
    prefix, period, n = jamba.period_decomposition()
    assert len(prefix) == 0 and len(period) == 8 and n == 4
    mixers = [p.mixer for p in period]
    assert mixers.count("attn") == 1 and mixers[4] == "attn"
    assert [p.mlp for p in period].count("moe") == 4
    kimi = get_config("kimi-k2-1t-a32b")
    prefix, period, n = kimi.period_decomposition()
    assert len(prefix) == 1 and prefix[0].mlp == "dense"
    assert len(period) == 1 and n == 60 and period[0].mlp == "moe"
    vlm = get_config("llama-3.2-vision-11b")
    _, period, n = vlm.period_decomposition()
    assert len(period) == 5 and n == 8 and period[4].mixer == "cross_attn"


def test_param_counts_scale():
    """Full-size parameter counts in the reference's ranges, the port's
    meta-built LM within 0.1% of ``param_count()`` (which leaves out the
    SSM's and the norms' small vectors)."""
    expected = {
        "mamba2-130m": (0.10e9, 0.2e9), "chatglm3-6b": (5e9, 8e9),
        "yi-6b": (5e9, 8e9), "mixtral-8x22b": (120e9, 160e9),
        "kimi-k2-1t-a32b": (0.9e12, 1.2e12), "jamba-v0.1-52b": (40e9, 60e9),
        "granite-20b": (18e9, 30e9), "minicpm-2b": (2e9, 3.5e9),
    }
    for arch, (lo, hi) in expected.items():
        cfg = get_config(arch)
        n = cfg.param_count()
        assert lo <= n <= hi, (arch, n)
        lm = M.init_params(torch.Generator(), cfg, device="meta")
        assert abs(sum(p.numel() for p in lm.parameters()) - n) < 1e-3 * n
    kimi = get_config("kimi-k2-1t-a32b")
    assert kimi.active_param_count() < 0.06 * kimi.param_count()


# ------------------------------------------------------ parity, per case

def port_state(cfg, case, b):
    """The port's serving state after an 8-token prefill into a cache of
    the case's length (the window where shorter), on meta."""
    lm = M.init_params(torch.Generator(), cfg, device="meta")
    cache_len = (min(case.seq_len, cfg.sliding_window)
                 if cfg.sliding_window else case.seq_len)
    short = S.batch_specs(cfg, dataclasses.replace(case, seq_len=8))
    pb = M.Batch(tokens=torch.empty((b, 8), dtype=torch.int64,
                                    device="meta"),
                 media=short.media, frames=short.frames)
    return M.prefill(lm, pb, cfg, cache_len=cache_len)[1], cache_len


def ref_state(ref, rcfg, case, b, cache_len):
    jnp = ref.jnp
    short = ref.specs.batch_specs(rcfg, dataclasses.replace(case,
                                                            seq_len=8))
    sds = ref.jax.ShapeDtypeStruct
    pb = ref.model.Batch(
        tokens=sds((b, 8), jnp.int32), labels=None,
        media=None if short.media is None else sds(
            (b,) + short.media.shape[1:], short.media.dtype),
        frames=None if short.frames is None else sds(
            (b,) + short.frames.shape[1:], short.frames.dtype))
    params = ref.jax.eval_shape(
        lambda key: ref.model.init_params(key, rcfg),
        ref.jax.random.PRNGKey(0))
    return ref.jax.eval_shape(
        lambda p, bt: ref.model.prefill(p, bt, rcfg, cache_len),
        params, pb)[1]


def spec_t(spec, ndim):
    s = tuple(spec)
    return s + (None,) * (ndim - len(s))


def check_cache(got, want, ndim_of, stacked):
    """One layer's cache specs (a KVCache or MambaState of specs, None)
    against the reference's, the stacked entry dropped."""
    if want is None:
        assert got is None
        return
    assert type(got).__name__ == type(want).__name__
    for g, w, n in zip(got, want, ndim_of):
        w = spec_t(w, n)
        if stacked and n:
            assert w[0] is None
            w = w[1:]
        assert spec_t(g, len(w)) == w, (g, w)


def ndims(tree):
    return [0 if isinstance(x, int) or not hasattr(x, "shape")
            else len(x.shape) for x in tree]


@pytest.mark.parametrize("shape", list(S.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_match_reference(ref, arch, shape):
    check_pspecs(ref, get_config(arch), ref.configs.get_config(arch),
                 S.INPUT_SHAPES[shape], ref.specs.INPUT_SHAPES[shape])


def check_pspecs(ref, cfg, rcfg, case, rcase):
    """Batch, token and serving-state specs of ``cfg`` at ``case`` against
    the reference's on ``rcfg`` at ``rcase``, on every mesh of
    ``MESHES``."""
    b = case.global_batch
    state, cache_len = port_state(cfg, case, b)
    rstate = ref_state(ref, rcfg, rcase, b, cache_len)
    prefix, period, n_per = cfg.period_decomposition()
    for name in MESHES:
        mesh = mesh_of(name)
        multi = "pod" in MESHES[name][1]
        # batches, single and (on a pod axis) client-dim
        for client in ((0, 2) if multi else (0,)):
            batch = S.batch_specs(cfg, case, client_dim=client)
            rbatch = ref.specs.batch_specs(rcfg, rcase, client_dim=client)
            for t, r in zip(batch, rbatch):
                assert (t is None) == (r is None)
                if t is not None:
                    assert tuple(t.shape) == tuple(r.shape)
            got = S.batch_pspecs(batch, mesh, client_dim=bool(client))
            want = ref.specs.batch_pspecs(rbatch, mesh,
                                          client_dim=bool(client))
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    assert tuple(g) == tuple(w), (name, g, w)
        assert tuple(S.token_pspec(b, mesh)) == tuple(
            ref.specs.token_pspec(b, mesh))
        assert S.mesh_axis_sizes(mesh) == ref.specs.mesh_axis_sizes(mesh)
        assert S.data_axes(mesh) == ref.specs.data_axes(mesh)
        # the serving state; where the reference's plan shards a stacked
        # leaf's period axis (long_500k's batch of 1 on the debug mesh:
        # 'data' finds no other dim), the port raises by name
        want = ref.specs.serve_state_pspecs(rstate, rcfg, mesh)
        period_specs = ref.jax.tree_util.tree_leaves(
            (want.period, want.cross_kv[1], want.cross_kv[3]),
            is_leaf=lambda x: isinstance(x, ref.specs.P))
        if any(len(tuple(sp)) and tuple(sp)[0] is not None
               for sp in period_specs):
            with pytest.raises(ValueError, match="stacked axis of"):
                S.serve_state_pspecs(state, cfg, mesh)
            continue
        got = S.serve_state_pspecs(state, cfg, mesh)
        assert tuple(got.position) == tuple(want.position) == ()
        enc_pre, enc_per, med_pre, med_per = want.cross_kv
        renc_pre, renc_per, rmed_pre, rmed_per = rstate.cross_kv
        for i, (g, layer) in enumerate(zip(got.layers, state.layers)):
            stacked = i >= len(prefix)
            k = (i - len(prefix)) % max(len(period), 1)
            w = (want.period[f"layer{k}"] if stacked else want.prefix[i])
            r = (rstate.period[f"layer{k}"] if stacked
                 else rstate.prefix[i])
            check_cache(g, w, ndims(r) if r is not None else [], stacked)
            gm, ge = got.cross_kv[i]
            wm = (None if (med_per if stacked else med_pre) is None else
                  (med_per[f"layer{k}"] if stacked else med_pre[i]))
            we = (None if (enc_per if stacked else enc_pre) is None else
                  (enc_per[f"layer{k}"] if stacked else enc_pre[i]))
            rm = (None if wm is None else
                  (rmed_per[f"layer{k}"] if stacked else rmed_pre[i]))
            re_ = (None if we is None else
                   (renc_per[f"layer{k}"] if stacked else renc_pre[i]))
            for gg, ww, rr in ((gm, wm, rm), (ge, we, re_)):
                assert (gg is None) == (ww is None), (i, gg, ww)
                if gg is not None:
                    for a, c, t in zip(gg, ww, rr):
                        c = spec_t(c, len(t.shape))
                        if stacked:
                            assert c[0] is None
                            c = c[1:]
                        assert spec_t(a, len(c)) == c, (i, a, c)


def test_stacked_state_plan_is_refused():
    """A plan that puts a mesh axis on the reference's stacked period axis
    raises by name: a (7,) float leaf of a 32-period stack under 'model'
    of 16 (the axis can only land on the 32)."""
    with pytest.raises(ValueError, match="stacked axis of 32"):
        S._stacked_spec((7,), False, {"data": 16, "model": 16}, "data", 32,
                        "a leaf")
