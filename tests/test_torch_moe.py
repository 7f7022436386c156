"""The port's MoE (``models/moe.py``) and the MoE zoo (``mixtral-8x22b``,
``jamba-v0.1-52b``, ``kimi-k2-1t-a32b``) against the reference, on the
CPU.

``apply_moe`` runs on the reference's ``init_moe`` parameters and seeded
numpy tokens: at 4 experts top-2 and a kimi-like 16 experts top-8, at the
configs' capacity factor 1.25 and at 0.5, where tokens drop (the dropped
(token, k) pairs must be the reference's exactly), and on an exact
router tie, which goes to the lower expert index as ``jax.lax.top_k``
gives it. Outputs and the aux loss rtol 1e-5 / atol 1e-5: float32 sums
of d = 32 .. 64 products in another order, and the softmax in another
library.

The three ids run ``reduced()`` (2 layers, jamba its first period of 8,
kimi its dense prefix layer and one MoE layer; d_model 256, 4 experts
top-2, sliding window 64): ``convert`` carries the reference's
parameters across, and the port's forward logits and aux, its loss,
prefill of 48 tokens and 32 decode steps with ``cache_len`` 128 (64
window slots for mixtral, so its cache wraps at position 64) and its
greedy tokens are held against the reference's at 2e-4 (logits rtol
1e-4 / atol 2e-4, the aux rtol 1e-5). Expert choices are exact on every
token whose k-th / (k+1)-th router probability margin exceeds 1e-5: each
MoE call of the port's runs is recorded, and the reference's router on
the same input picks the same experts for every such token (margins go
down to ~1e-6 here; those tokens agree too, or the logits would not).

Prefill plus decode reproduce the port's own forward only where no
(token, k) pair drops: a forward and a prefill over other token counts
have other capacities, and a pair dropped in one but not the other
changes that token's output (the reference computes the same function).
``test_decode_matches_forward`` therefore runs at a capacity factor of
E / k, where the capacity is at least the token count.
"""

import dataclasses
import types

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
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import truncated_normal  # noqa: E402

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-4)
CACHE_TOL = dict(rtol=1e-4, atol=2e-5)
MARGIN = 1e-5          # router probability margin that fixes a choice
TOKEN_MARGIN = 1e-4    # greedy top-2 logit margin (tests/test_torch_zoo.py)
IDS = ["mixtral-8x22b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]
# full-size float32 parameters (param_count() x 4 bytes), experts, top-k,
# dense prefix layers
FULL = {"mixtral-8x22b": (562.5e9, 8, 2, 0),
        "jamba-v0.1-52b": (205.8e9, 16, 2, 0),
        "kimi-k2-1t-a32b": (4.10e12, 384, 8, 1)}


@pytest.fixture(scope="module")
def ref():
    return reference()


def moe_cfg(e, k, cf=1.25, d=32, ff=64):
    """The reference tests' MoE config (tests/test_moe.py::_cfg)."""
    return ModelConfig(name="t", arch_type="moe", n_layers=1, d_model=d,
                       n_heads=2, n_kv_heads=2, d_ff=ff, vocab_size=64,
                       n_experts=e, top_k=k, moe_d_ff=ff, capacity_factor=cf)


def port_moe(ref, rp, cfg):
    leaves = ref.jax.tree.map(np.asarray, rp)
    return moe.MoE(*(torch.from_numpy(np.array(w)) for w in (
        leaves["router"]["w"], leaves["wi"], leaves["wg"], leaves["wo"])),
        cfg)


def ref_kept(ref, rp, x, cfg):
    """The reference's routing on x, and which flat (token, k) pairs its
    dispatch keeps, from its own top-k with numpy's stable sort."""
    xt = x.reshape(-1, cfg.d_model)
    probs = np.asarray(ref.jax.nn.softmax(
        ref.jnp.asarray(xt) @ rp["router"]["w"], axis=-1))
    _, ids = ref.jax.lax.top_k(ref.jnp.asarray(probs), cfg.top_k)
    flat = np.asarray(ids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    for e in range(cfg.n_experts):
        mine = order[flat[order] == e]
        rank[mine] = np.arange(mine.size)
    return probs, np.asarray(ids), rank < ref.moe.capacity(xt.shape[0], cfg)


def margins(probs, k):
    """Each token's k-th minus (k+1)-th largest router probability."""
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (4, 2, 0.5),
                                    (16, 8, 1.25), (16, 8, 0.5)])
def test_apply_moe_matches_reference(ref, e, k, cf):
    cfg = moe_cfg(e, k, cf)
    rp = ref.moe.init_moe(ref.jax.random.PRNGKey(e + k), cfg,
                          ref.jnp.float32)
    x = np.random.default_rng(e * k).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32)
    probs, ids, kept = ref_kept(ref, rp, x, cfg)
    want, raux = ref.moe.apply_moe(rp, ref.jnp.asarray(x), cfg)
    p = port_moe(ref, rp, cfg)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    r = moe.route(p, xt, cfg)
    trusted = margins(probs, k) > MARGIN
    np.testing.assert_array_equal(r.ids.numpy()[trusted], ids[trusted])
    # the rest (margins down to 3.6e-6 here, against probabilities that
    # differ by ~1e-8) agree too, so the dropped pairs and every output
    # compare
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    cap = moe.capacity(xt.shape[0], cfg)
    disp = moe.dispatch(r, cap, cfg)
    np.testing.assert_array_equal(disp.dest.numpy() < e * cap, kept)
    assert kept.all() == (cf > 1)   # the low factor drops, 1.25 does not
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(raux), **MOE_TOL)
    # prefill and decode drop the aux loss, and skip computing it
    y, none = moe.apply_moe(p, torch.from_numpy(x), cfg, aux=False)
    assert none is None and torch.equal(y, got)


def test_router_tie_goes_to_the_lower_expert(ref):
    """Experts 1 and 2 (and 5 and 6) get the same router column, so their
    probabilities tie exactly on every token: the lower index wins, as in
    ``jax.lax.top_k``, and the outputs agree."""
    cfg = moe_cfg(8, 2, 4.0)
    rp = ref.moe.init_moe(ref.jax.random.PRNGKey(3), cfg, ref.jnp.float32)
    w = np.array(rp["router"]["w"])
    w[:, 2], w[:, 6] = w[:, 1], w[:, 5]
    w[:, (1, 2)] += 10.0 * np.abs(w).max()     # 1 and 2 lead everywhere
    rp = dict(rp, router={"w": ref.jnp.asarray(w)})
    x = np.abs(np.random.default_rng(4).standard_normal(
        (1, 24, cfg.d_model))).astype(np.float32)
    p = port_moe(ref, rp, cfg)
    r = moe.route(p, torch.from_numpy(x[0]), cfg)
    probs = r.probs.numpy()
    np.testing.assert_array_equal(probs[:, 1], probs[:, 2])
    np.testing.assert_array_equal(r.ids.numpy(), np.tile([1, 2], (24, 1)))
    _, ids, _ = ref_kept(ref, rp, x, cfg)
    np.testing.assert_array_equal(r.ids.numpy(), ids)
    want, raux = ref.moe.apply_moe(rp, ref.jnp.asarray(x), cfg)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(raux), **MOE_TOL)


def test_capacity_matches_reference(ref):
    for e, k, cf in ((4, 2, 1.25), (8, 2, 1.25), (16, 2, 1.25),
                     (384, 8, 1.25), (16, 8, 0.5), (3, 1, 1.0)):
        cfg = moe_cfg(e, k, cf)
        for t in (1, 2, 7, 8, 40, 64, 120, 255, 256, 1000, 1024, 8000,
                  16384):
            assert moe.capacity(t, cfg) == ref.moe.capacity(t, cfg), (
                e, k, cf, t)


def test_high_capacity_equals_dense_mixture():
    """The reference's own check (tests/test_moe.py): with capacity >>
    tokens, the MoE is the explicit weighted mixture of each token's
    top-k experts."""
    cfg = moe_cfg(4, 2, 64.0)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.randn((3, 7, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y, aux = moe.apply_moe(p, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    r = moe.route(p, xt, cfg)
    expect = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(cfg.top_k):
            e = int(r.ids[t, j])
            h = torch.nn.functional.silu(xt[t] @ p.wg[e]) * (xt[t] @ p.wi[e])
            expect[t] += r.weights[t, j] * (h @ p.wo[e])
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               expect.numpy(), rtol=1e-4, atol=1e-4)
    assert float(aux) >= 0.0


def test_truncated_normal_scales_in_place(monkeypatch):
    """A float32 draw is scaled in place: the same bits as ``w * scale``
    (the earlier code), and no second full-size tensor."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        w = torch.empty((5, 64, 48))
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
        return w

    for scale in (0.02, 0.1):
        got = truncated_normal(torch.Generator().manual_seed(7), (5, 64, 48),
                               scale, torch.float32, "cpu")
        assert got.dtype == torch.float32
        assert torch.equal(got, (draw(7) * scale).to(torch.float32))
        bf = truncated_normal(torch.Generator().manual_seed(7), (5, 64, 48),
                              scale, torch.bfloat16, "cpu")
        assert torch.equal(bf, (draw(7) * scale).to(torch.bfloat16))
    # drawn straight into the result: the draw's storage is the output's
    seen = []
    init = torch.nn.init.trunc_normal_

    def spy(w, *a, **kw):
        seen.append(w.data_ptr())
        return init(w, *a, **kw)

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", spy)
    p = moe.init_moe(torch.Generator().manual_seed(0), moe_cfg(4, 2),
                     torch.float32, "cpu")
    assert seen == [p.router.w.data_ptr(), p.wi.data_ptr(),
                    p.wg.data_ptr(), p.wo.data_ptr()]


# ---------------------------------------------------------------- the ids

@pytest.fixture(scope="module", params=IDS)
def lm(request, ref):
    """The reduced id: the reference's parameters and the port's copy."""
    cfg = configs.get_config(request.param).reduced()
    rcfg = ref.configs.get_config(request.param).reduced()
    rparams = ref.model.init_params(ref.jax.random.PRNGKey(0), rcfg)
    tree = ref.jax.tree.map(np.asarray, rparams)
    return cfg, rcfg, rparams, lm_params_from_jax(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def ref_decode(ref):
    """The reference's ``decode_step``, jitted (the same function, one
    compile instead of op-by-op dispatch at every step)."""
    return ref.jax.jit(ref.model.decode_step, static_argnums=3)


@pytest.fixture
def router_margins(monkeypatch, ref):
    """Records every MoE call of the port's forward, prefill and decode;
    ``check()`` holds the port's expert choices against the reference's
    router on the same input at every token whose margin exceeds 1e-5,
    and returns how many tokens that covered."""
    seen = []
    apply = moe.apply_moe

    def recording(p, x, cfg, aux=True):
        seen.append((p, x.reshape(-1, x.shape[-1]).clone(), cfg))
        return apply(p, x, cfg, aux)

    def check():
        n = 0
        for p, xt, cfg in seen:
            rprobs = ref.jax.nn.softmax(ref.jnp.asarray(xt.numpy())
                                        @ p.router.w.numpy(), axis=-1)
            _, rids = ref.jax.lax.top_k(rprobs, cfg.top_k)
            trusted = margins(np.asarray(rprobs), cfg.top_k) > MARGIN
            np.testing.assert_array_equal(
                moe.route(p, xt, cfg).ids.numpy()[trusted],
                np.asarray(rids)[trusted])
            n += int(trusted.sum())
        return n

    monkeypatch.setattr(moe, "apply_moe", recording)
    return types.SimpleNamespace(calls=seen, check=check)


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


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
    (pre, per, n), (rpre, rper, rn) = (port.period_decomposition(),
                                       want.period_decomposition())
    assert ([dataclasses.astuple(s) for s in pre + per], n) == (
        [dataclasses.astuple(s) for s in rpre + rper], rn)
    size, e, k, prefix = FULL[arch]
    assert abs(4 * port.param_count() - size) / size < 0.01
    assert (port.n_experts, port.top_k, port.n_dense_prefix) == (e, k,
                                                                  prefix)
    assert arch in configs.all_configs()


def test_init_params_matches_reference_layout(ref, lm):
    """The port's own init: the reference's leaf names and shapes (the
    prefix layer first), its parameter count, float32 routers, and the
    expert stacks' truncated-normal scale."""
    cfg, _, rparams, carried = lm
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    got = {k: tuple(v.shape) for k, v in params.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in carried.named_parameters()}
    assert sum(v.numel() for v in params.parameters()) == sum(
        x.size for x in ref.jax.tree.leaves(rparams))
    for i, spec in enumerate(cfg.layer_specs()):
        layer = params.layers[i]
        assert isinstance(layer.mlp, moe.MoE) == (spec.mlp == "moe")
        assert (layer.mlp is None) == (spec.mlp == "none")
        if spec.mlp == "moe":
            e, d, ff = cfg.n_experts, cfg.d_model, cfg.resolved_moe_ff
            assert got[f"layers.{i}.mlp.wi"] == (e, d, ff)
            assert got[f"layers.{i}.mlp.wo"] == (e, ff, d)
            assert got[f"layers.{i}.mlp.router.w"] == (d, e)
            w = layer.mlp.wg
            assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02
    if cfg.n_dense_prefix:
        assert not isinstance(params.layers[0].mlp, moe.MoE)
        assert got["layers.0.mlp.wi.w"] == (cfg.d_model, cfg.d_ff)


def test_lm_params_from_jax_carries_every_leaf(ref, lm):
    """Every reference leaf lands in the port's module bit for bit: the
    prefix list first, the period-stacked leaves unstacked by layer, the
    MoE's router and expert stacks as they are."""
    cfg, _, rparams, params = lm
    prefix, period, n_periods = cfg.period_decomposition()
    want = {}
    for path, leaf in ref.jax.tree_util.tree_leaves_with_path(rparams):
        keys = [str(getattr(p, "key", getattr(p, "idx", None)))
                for p in path]
        if keys[0] == "period":
            i = int(keys[1].removeprefix("layer"))
            for k in range(n_periods):
                j = len(prefix) + k * len(period) + i
                want[".".join(["layers", str(j)] + keys[2:])] = \
                    np.asarray(leaf[k])
        elif keys[0] == "prefix":
            want[".".join(["layers"] + keys[1:])] = np.asarray(leaf)
        else:
            want[".".join(keys)] = np.asarray(leaf)
    sd = params.state_dict()
    assert set(sd) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)
    assert len(params.layers) == cfg.n_layers


def test_lm_forward_and_loss_match_reference(ref, lm, router_margins):
    cfg, rcfg, rparams, params = lm
    tok = tokens(cfg, 2, 40, 1)
    labels = np.roll(tok, -1, axis=1)
    rb = ref.model.Batch(tokens=ref.jnp.asarray(tok),
                         labels=ref.jnp.asarray(labels))
    pb = M.Batch(tokens=torch.from_numpy(tok).long(),
                 labels=torch.from_numpy(labels).long())
    want, raux = ref.model.forward(rparams, rb, rcfg)
    got, aux = M.forward(params, pb, cfg)
    n_moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
    assert len(router_margins.calls) == n_moe
    assert router_margins.check() > 0.9 * 80 * n_moe
    assert got.shape == (2, 40, cfg.vocab_size) and torch.isfinite(got).all()
    close(got, want, LOGIT_TOL)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    rloss = ref.model.loss_fn(rparams, rb, rcfg)
    loss = M.loss_fn(params, pb, cfg)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    np.testing.assert_allclose(
        float(loss) - float(aux), float(torch.nn.functional.cross_entropy(
            got.reshape(-1, cfg.vocab_size), pb.labels.reshape(-1))),
        rtol=1e-5)


def test_lm_prefill_and_decode_match_reference(ref, lm, router_margins,
                                               ref_decode):
    """Prefill 48 tokens, then 32 decode steps with ``cache_len`` 128:
    logits at every step, and every attention layer's cache (keys,
    values, slot positions) at the end, against the reference's. Mixtral's
    window of 64 makes its cache 64 slots, which the decode wraps."""
    cfg, rcfg, rparams, params = lm
    prompt, steps, cache_len = 48, 32, 128
    tok = tokens(cfg, 2, prompt + steps, 2)
    rl, rst = ref.model.prefill(
        rparams, ref.model.Batch(tokens=ref.jnp.asarray(tok[:, :prompt])),
        rcfg, cache_len=cache_len)
    pl, st = M.prefill(params, M.Batch(
        tokens=torch.from_numpy(tok[:, :prompt]).long()), cfg, cache_len)
    close(pl, rl, LOGIT_TOL)
    for t in range(prompt, prompt + steps):
        rl, rst = ref_decode(
            rparams, ref.jnp.asarray(tok[:, t:t + 1]), rst, rcfg)
        pl, st = M.decode_step(params, torch.from_numpy(
            tok[:, t:t + 1]).long(), st, cfg)
        close(pl, rl, LOGIT_TOL)
    assert router_margins.check() > 0
    assert st.position == int(rst.position) == prompt + steps
    prefix, period, _ = cfg.period_decomposition()
    slots = attn.cache_slots(cfg, cache_len)
    wrapped = 0
    for j, cache in enumerate(st.layers):
        if j < len(prefix):
            rcache = rst.prefix[j]
        else:
            k, i = divmod(j - len(prefix), len(period))
            rcache = ref.jax.tree.map(lambda a: a[k],
                                      rst.period[f"layer{i}"])
        spec = cfg.layer_specs()[j]
        if spec.mixer == "mamba":
            close(cache.conv, rcache.conv, CACHE_TOL)
            close(cache.ssm, rcache.ssm, CACHE_TOL)
            continue
        assert cache.k.shape[1] == slots
        close(cache.k, rcache.k, CACHE_TOL)
        close(cache.v, rcache.v, CACHE_TOL)
        np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                      np.asarray(rcache.slot_pos))
        wrapped += int(cache.slot_pos.max()) >= slots
    if cfg.sliding_window:
        assert slots == cfg.sliding_window == 64 and wrapped


def test_generate_matches_reference_greedy_loop(ref, lm, router_margins,
                                                ref_decode):
    """``serve.generate``'s tokens against the reference serve loop's,
    exact while every earlier step's top-2 logit margin exceeds 1e-4."""
    cfg, rcfg, rparams, params = lm
    gen = 8
    tok = tokens(cfg, 3, 24, 5)
    out = serve.generate(params, M.Batch(tokens=torch.from_numpy(tok)
                                         .long()), cfg, gen)
    assert out.tokens.shape == (3, gen)
    logits, st = ref.model.prefill(
        rparams, ref.model.Batch(tokens=ref.jnp.asarray(tok)), rcfg,
        cache_len=24 + gen)
    want, gaps = [], []
    for _ in range(gen):
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        nxt = last.argmax(-1)
        want.append(nxt)
        logits, st = ref_decode(
            rparams, ref.jnp.asarray(nxt[:, None].astype(np.int32)), st,
            rcfg)
    want, gaps = np.stack(want, 1), np.stack(gaps, 1)
    trusted = np.cumprod(gaps > TOKEN_MARGIN, axis=1).astype(bool)
    assert trusted[:, 0].all() and router_margins.check() > 0
    np.testing.assert_array_equal(out.tokens.numpy()[trusted],
                                  want[trusted])


@pytest.mark.parametrize("arch", IDS)
def test_decode_matches_forward(arch):
    """Prefill plus decode reproduce the teacher-forced logits (< 2e-4,
    ``tests/test_arch_smoke.py::test_decode_matches_forward``'s bound),
    mixtral's past its window: 16 prompt tokens, window 8, 24 steps. The
    capacity factor is E / k, so no pair drops (module docstring)."""
    cfg = configs.get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                              / cfg.top_k)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=8)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    b, s, pre = 2, 40, 16
    tok = torch.from_numpy(tokens(cfg, b, s, 3)).long()
    full, _ = M.forward(params, M.Batch(tok), cfg)
    lg, st = M.prefill(params, M.Batch(tok[:, :pre]), cfg, cache_len=s)
    errs = [float((lg[:, 0] - full[:, pre - 1]).abs().max())]
    for i in range(pre, s - 1):
        lg, st = M.decode_step(params, tok[:, i:i + 1], st, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_attention_routes_through_the_flash_entry(monkeypatch, lm):
    """Forward and prefill call ``ops.flash_attention`` once per attention
    layer, with the config's window over the whole sequence and ``kv_group
    = Hq / KV``; decode never calls it."""
    cfg, _, _, params = lm
    calls = []
    flash = attn.kops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"], kw["window"],
                      kw["kv_group"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(attn.kops, "flash_attention", counting)
    tok = torch.from_numpy(tokens(cfg, 2, 30, 6)).long()
    group = cfg.n_heads // cfg.n_kv_heads
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    M.forward(params, M.Batch(tok), cfg)
    assert calls == [(30, 30, True, cfg.sliding_window, group)] * n_attn
    calls.clear()
    _, st = M.prefill(params, M.Batch(tok[:, :20]), cfg, 30)
    for t in range(20, 23):
        _, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
    assert calls == [(20, 20, True, cfg.sliding_window, group)] * n_attn


@pytest.mark.parametrize("arch", IDS)
def test_serve_main_on_cpu(capsys, arch):
    import json
    serve.main(["--device", "cpu", "--arch", arch, "--gen", "4",
                "--prompt-len", "40"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == f"{arch}-reduced" and out["generated"] == 4
    assert len(out["sample_output"]) == 4
