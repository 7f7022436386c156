"""Every layer spec the reference runs, in the port: the layer is generic
over mixer (attn, mamba, cross_attn) x mlp (dense, moe, none), as the
reference's ``_init_layer``, ``_apply_layer``, ``_prefill_layer`` and
``_decode_layer`` are.

No id of the zoo has a cross-attention mixer with an MoE mlp, nor an
attention mixer without an mlp; a VLM with experts does
(``ModelConfig(arch_type="vlm", n_experts=4, top_k=2,
cross_attn_every=2, n_media_tokens=5)``, its ``layer_specs()`` alternate
``attn`` + ``moe`` and ``cross_attn`` + ``moe``). That model, at
``reduced(n_layers=4)`` (d_model 256, 4 query heads of 64 over 2 KV
heads, 4 experts of 256, top-2), from the reference's ``init_params``
carried across by ``convert.lm_params_from_jax``, on seeded numpy tokens
and media (B, 5, d):

- the port's own init has the reference's names and shapes; every
  converted leaf lands bit for bit;
- forward (logits and the MoE aux loss) and the loss against the
  reference's, the port's expert choices against the reference's router
  wherever the top-k margin exceeds 1e-5 (tests/test_torch_moe.py's
  fixture and tolerances: logits rtol 1e-4 / atol 2e-4, aux and loss
  rtol 1e-5);
- the loss's gradient against ``jax.grad`` of the reference's
  ``loss_fn``, each leaf within 1e-4 of its largest |reference| entry
  (tests/test_torch_train_dense.py's tolerance: the two sides sum
  float32 products in other orders);
- prefill plus 8 decode steps (logits, the self-attention KV caches, the
  media K / V) and ``serve.generate``'s greedy tokens against the
  reference's, exact while every earlier step's top-2 logit margin
  exceeds 1e-4;
- ``sharding.param_pspecs`` and ``launch.specs.serve_state_pspecs`` for
  its leaves and caches against the reference's rules and specs
  (tests/test_torch_sharding_rules.py's and tests/test_torch_specs.py's
  checks, run on this config).

Then the mlp-less specs (``attn`` / ``none``, ``cross_attn`` / ``none``)
and ``cross_attn`` / ``moe``, each one layer fed through the layer
functions directly: the reference's ``_init_layer`` carried across,
``_apply_layer``, ``_prefill_layer`` and ``_decode_layer`` against
``Layer.forward``, ``prefill`` and ``decode``.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_moe import (CACHE_TOL, LOGIT_TOL,  # noqa: E402,F401
                            TOKEN_MARGIN, router_margins)
from test_torch_reference import reference  # noqa: E402
from test_torch_sharding_rules import check_param_pspecs  # noqa: E402
from test_torch_specs import check_pspecs  # noqa: E402
from test_torch_train_dense import GRAD_TOL, step_inputs  # noqa: E402
from test_torch_zoo import batches, check_cross_kv, ref_leaves  # noqa: E402

from repro_torch.convert import _layer, lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: E402

VLM_MOE = dict(name="vlm-moe", arch_type="vlm", n_layers=4, d_model=32,
               n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64, n_experts=4,
               top_k=2, cross_attn_every=2, n_media_tokens=5)


@pytest.fixture(scope="module")
def ref():
    return reference()


def configs_of(ref):
    return (ModelConfig(**VLM_MOE).reduced(n_layers=4),
            ref.config.ModelConfig(**VLM_MOE).reduced(n_layers=4))


@pytest.fixture(scope="module")
def ref_decode(ref):
    """The reference's ``decode_step``, jitted (one compile instead of
    op-by-op dispatch at every step)."""
    return ref.jax.jit(ref.model.decode_step, static_argnums=3)


@pytest.fixture(scope="module")
def lm(ref):
    """The reduced VLM-MoE: its configs, the reference's parameters and
    the port's copy of them."""
    cfg, rcfg = configs_of(ref)
    rparams = ref.model.init_params(ref.jax.random.PRNGKey(0), rcfg)
    tree = ref.jax.tree.map(np.asarray, rparams)
    return cfg, rcfg, rparams, lm_params_from_jax(tree, cfg, device="cpu")


def inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    media = rng.standard_normal((b, cfg.n_media_tokens, cfg.d_model)).astype(
        np.float32)
    return tok, media


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_config_has_the_cross_attention_moe_layer(ref):
    cfg, rcfg = configs_of(ref)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert ([dataclasses.astuple(s) for s in cfg.layer_specs()]
            == [dataclasses.astuple(s) for s in rcfg.layer_specs()]
            == [("attn", "moe"), ("cross_attn", "moe")] * 2)
    assert not hasattr(M, "PORTED_LAYERS")


def test_init_params_matches_reference_layout(ref, lm):
    """The port's own init: the reference's names, shapes and count; a
    cross-attention mixer and an MoE mlp in every second layer."""
    cfg, _, rparams, carried = lm
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    got = {k: tuple(v.shape) for k, v in params.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in carried.named_parameters()}
    assert sum(v.numel() for v in params.parameters()) == sum(
        x.size for x in ref.jax.tree.leaves(rparams))
    for i, spec in enumerate(cfg.layer_specs()):
        layer = params.layers[i]
        assert layer.cross_mixer == (spec.mixer == "cross_attn")
        assert isinstance(layer.mlp, moe.MoE)
    e, d = cfg.n_experts, cfg.d_model
    assert got["layers.1.mlp.wi"] == (e, d, cfg.resolved_moe_ff)
    assert got["layers.1.mlp.router.w"] == (d, e)


def test_lm_params_from_jax_carries_every_leaf(ref, lm):
    cfg, _, rparams, params = lm
    sd = params.state_dict()
    want = ref_leaves(ref, rparams, cfg)
    assert set(sd) == set(want)
    assert {"layers.1.mlp.router.w", "layers.3.mlp.wo",
            "layers.3.mixer.wq.w"} <= set(sd)
    for name, value in want.items():
        np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)


def test_forward_aux_and_loss_match_reference(ref, lm, router_margins):
    cfg, rcfg, rparams, params = lm
    tok, media = inputs(cfg, 2, 40, 1)
    rb, pb = batches(ref, tok, media, None, np.roll(tok, -1, axis=1))
    want, raux = ref.model.forward(rparams, rb, rcfg)
    got, aux = M.forward(params, pb, cfg)
    assert len(router_margins.calls) == cfg.n_layers
    assert router_margins.check() > 0.9 * 80 * cfg.n_layers
    assert got.shape == (2, 40, cfg.vocab_size) and torch.isfinite(got).all()
    close(got, want, LOGIT_TOL)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    rloss = ref.model.loss_fn(rparams, rb, rcfg)
    np.testing.assert_allclose(float(M.loss_fn(params, pb, cfg)),
                               float(rloss), rtol=1e-5)


def test_loss_gradient_matches_jax_grad(ref, lm):
    """Every leaf's gradient, the cross-attention layers' experts and
    routers included, within 1e-4 of its largest |reference| entry."""
    jax = ref.jax
    cfg, rcfg, rparams, model = lm
    rbatch, batch = step_inputs(ref, cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.model.loss_fn(p, b, rcfg)))(rparams, rbatch)
    params = {k: v.detach() for k, v in model.named_parameters()}
    grads, loss = torch.func.grad_and_value(
        lambda p, b: torch.func.functional_call(model, p, (b, cfg)))(
            params, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = dict(lm_params_from_jax(jax.tree.map(np.asarray, rgrads), cfg,
                                   device="cpu").named_parameters())
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        scale = float(w.abs().max())
        assert scale > 0, f"no gradient reaches {name}"
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
    for i in (1, 3):      # the cross-attention layers' routers learn
        assert float(grads[f"layers.{i}.mlp.router.w"].abs().sum()) > 0


def test_prefill_and_decode_match_reference(ref, lm, router_margins,
                                            ref_decode):
    """prefill, then 8 decode steps: logits, the self-attention layers' KV
    caches and the media K / V against the reference's."""
    cfg, rcfg, rparams, params = lm
    prompt, cache_len = 30, 38
    tok, media = inputs(cfg, 2, prompt + 8, 2)
    rb, pb = batches(ref, tok[:, :prompt], media, None)
    rl, rst = ref.model.prefill(rparams, rb, rcfg, cache_len=cache_len)
    pl, st = M.prefill(params, pb, cfg, cache_len=cache_len)
    close(pl, rl, LOGIT_TOL)
    for t in range(prompt, prompt + 8):
        rl, rst = ref_decode(rparams, ref.jnp.asarray(tok[:, t:t + 1]),
                             rst, rcfg)
        pl, st = M.decode_step(params, torch.from_numpy(
            tok[:, t:t + 1]).long(), st, cfg)
        close(pl, rl, LOGIT_TOL)
    assert router_margins.check() > 0
    assert st.position == int(rst.position) == prompt + 8
    _, period, _ = cfg.period_decomposition()
    for j, cache in enumerate(st.layers):
        k, i = divmod(j, len(period))
        rcache = rst.period[f"layer{i}"]
        if period[i].mixer == "cross_attn":
            assert cache is None and rcache is None
            continue
        close(cache.k, rcache.k[k], CACHE_TOL)
        close(cache.v, rcache.v[k], CACHE_TOL)
    check_cross_kv(ref, cfg, st, rst)


def test_generate_matches_reference_greedy_loop(ref, lm, router_margins,
                                                ref_decode):
    cfg, rcfg, rparams, params = lm
    gen = 8
    tok, media = inputs(cfg, 3, 24, 5)
    rb, pb = batches(ref, tok, media, None)
    out = serve.generate(params, pb, cfg, gen)
    assert out.tokens.shape == (3, gen)
    logits, st = ref.model.prefill(rparams, rb, rcfg, cache_len=24 + gen)
    want, gaps = [], []
    for _ in range(gen):
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        nxt = last.argmax(-1)
        want.append(nxt)
        logits, st = ref_decode(
            rparams, ref.jnp.asarray(nxt[:, None].astype(np.int32)), st, rcfg)
    want, gaps = np.stack(want, 1), np.stack(gaps, 1)
    trusted = np.cumprod(gaps > TOKEN_MARGIN, axis=1).astype(bool)
    assert trusted[:, 0].all() and router_margins.check() > 0
    np.testing.assert_array_equal(out.tokens.numpy()[trusted],
                                  want[trusted])


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_pspecs_match_reference(ref, fsdp):
    """The rules' entries for every leaf, the cross-attention layers'
    expert banks and routers included."""
    cfg, rcfg = configs_of(ref)
    import importlib
    ref.rules = importlib.import_module("repro.sharding.rules")
    seen = check_param_pspecs(ref, cfg, rcfg, fsdp)
    assert {"layers.1.mlp.wi", "layers.1.mlp.router.w"} <= seen


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_serve_state_pspecs_match_reference(ref, shape):
    import importlib
    ref.specs = importlib.import_module("repro.launch.specs")
    cfg, rcfg = configs_of(ref)
    check_pspecs(ref, cfg, rcfg, S.INPUT_SHAPES[shape],
                 ref.specs.INPUT_SHAPES[shape])


# ------------------------------------------------- one layer, each spec

@pytest.mark.parametrize("mixer,mlp", [("attn", "none"),
                                       ("cross_attn", "none"),
                                       ("cross_attn", "moe")])
def test_layer_functions_match_reference(ref, mixer, mlp):
    """One layer of each spec through the layer functions: the
    reference's init carried across (its leaves, and the port's own
    init's names and shapes), then the forward (with its aux), prefill
    into a cache and 4 decode steps against the reference's."""
    jax, jnp = ref.jax, ref.jnp
    cfg, rcfg = configs_of(ref)
    spec, rspec = LayerSpec(mixer, mlp), ref.config.LayerSpec(mixer, mlp)
    rp = ref.model._init_layer(jax.random.PRNGKey(3), rspec, rcfg,
                               jnp.float32, False)
    layer = _layer(jax.tree.map(np.asarray, rp), None, spec, cfg, "cpu")
    own = M._init_layer(torch.Generator().manual_seed(0), spec, cfg,
                        torch.float32, "cpu")
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(rp)}
    sd = layer.state_dict()
    assert set(sd) == set(flat) == set(own.state_dict())
    assert ("norm2.g" in sd) == (mlp != "none")
    for name, value in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), value, err_msg=name)

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    media = rng.standard_normal((2, cfg.n_media_tokens, cfg.d_model)).astype(
        np.float32)
    kv_x = media if mixer == "cross_attn" else None
    want, raux = ref.model._apply_layer(rp, jnp.asarray(x), rspec, rcfg,
                                        media=jnp.asarray(media))
    got, aux = layer(torch.from_numpy(x), torch.from_numpy(media))
    close(got.detach(), want, LOGIT_TOL)
    if mlp == "moe":
        np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    else:
        assert aux is None and float(raux) == 0.0

    prompt, cache_len = 8, 16
    rcache = ref.model._layer_cache_init(rspec, rcfg, 2, cache_len,
                                         jnp.float32)
    rkv = (None if kv_x is None else
           ref.attention.precompute_cross_kv(rp["mixer"], jnp.asarray(kv_x),
                                             rcfg))
    pkv = (None if kv_x is None else
           attn.precompute_cross_kv(layer.mixer, torch.from_numpy(kv_x),
                                    cfg))
    prefill_layer, decode_layer = (jax.jit(
        lambda p, x, c, kv, f=f: f(p, x, rspec, rcfg, c, cross_kv=kv))
        for f in (ref.model._prefill_layer, ref.model._decode_layer))
    with torch.inference_mode():
        want, rcache = prefill_layer(rp, jnp.asarray(x[:, :prompt]), rcache,
                                     rkv)
        got, cache = layer.prefill(torch.from_numpy(x[:, :prompt]),
                                   cache_len, pkv)
        close(got, want, LOGIT_TOL)
        assert (cache is None) == (rcache is None) == (mixer == "cross_attn")
        for t in range(prompt, prompt + 4):
            want, rcache = decode_layer(rp, jnp.asarray(x[:, t:t + 1]),
                                        rcache, rkv)
            got, cache = layer.decode(torch.from_numpy(x[:, t:t + 1]), cache,
                                      pkv)
            close(got, want, LOGIT_TOL)
        if cache is not None:
            close(cache.k, rcache.k, CACHE_TOL)
            close(cache.v, rcache.v, CACHE_TOL)
