"""K5's gradient on the CPU: the backward kernel's plain version and the
autograd wiring (``kernels/flash_attention.py``, ``kernels/ops.py``).

* ``flash_attention_bwd_ref`` (the function ``csrc/flash_attention_bwd.cu``
  computes) against autograd of ``flash_attention_ref`` (K5's plain
  twin) over causal, windowed, non-causal, ragged (Sq != Sk) and grouped
  (``kv_group`` > 1) shapes, and against ``jax.grad`` of the reference's
  dense ``attention_ref`` where the two define the same function (Sq ==
  Sk causal, with and without a window; unmasked);
* ``ops.flash_attention`` through ``FlashAttention``: its gradient (on
  the forward's lse) against autograd and against ``jax.grad``, the
  head-dim padding (16 -> 32, the scale of the unpadded D), and
  ``torch.func.grad`` and ``torch.func.vmap(torch.func.grad(...))``
  against per-sample gradients (the FL engine's participants);
* the reference's MoE gradient test
  (``tests/test_moe.py::test_moe_grads_flow_to_router_and_experts``) on
  the port's ``apply_moe``, and the CPU SSD path differentiating.

Tolerances: float32 gradients relative to the largest |reference| of
each tensor, 1e-5 against autograd of the same torch function (measured
~5e-7: the same products summed in another order) and 2e-5 against JAX
(another library's softmax and sums); the vmapped gradients are bit-equal
to the per-sample ones (the fold runs the same products per row-block).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention_bwd)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_ref)

# (BH, Sq, Sk, D, causal, window, kv_group)
SHAPES = [(4, 37, 37, 32, True, None, 1), (6, 64, 64, 64, True, 16, 3),
          (4, 50, 70, 32, False, None, 2), (2, 40, 30, 64, False, 20, 1),
          (4, 30, 50, 128, True, None, 4), (2, 70, 40, 32, True, None, 1)]


@pytest.fixture(scope="module")
def ref():
    return reference()


def lanes(bh, sq, sk, d, group, seed):
    rng = np.random.default_rng(seed)
    shapes = ((bh, sq, d), (bh // group, sk, d), (bh // group, sk, d),
              (bh, sq, d))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def rel_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_ref_is_the_gradient_of_flash_attention_ref(shape):
    bh, sq, sk, d, causal, window, group = shape
    q, k, v, do = (torch.from_numpy(a) for a in lanes(bh, sq, sk, d, group,
                                                      bh * sq))
    kw = dict(causal=causal, window=window, kv_group=group)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_ref(*qkv, **kw)
    want = torch.autograd.grad(o, qkv, do)
    got = flash_attention_bwd_ref(q, k, v, o.detach(), do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        rel_close(g.numpy(), w.numpy(), 1e-5)
    # the wrapper runs the plain version on CPU tensors, and skip_tiles
    # changes nothing
    for skip in (True, False):
        wrapped = flash_attention_bwd(q, k, v, o.detach(), do,
                                      skip_tiles=skip, **kw)
        for g, w in zip(wrapped, got):
            assert torch.equal(g, w)


@pytest.mark.parametrize("causal,window,sq", [(True, None, 48),
                                              (True, 12, 48),
                                              (False, None, 33)])
def test_bwd_ref_matches_jax_grad(ref, causal, window, sq):
    """Where K5's function and the reference's dense oracle agree (Sq ==
    Sk causal, a causal window; no mask at all), the plain backward
    equals jax.grad of ``attention_ref``."""
    bh, d = 3, 64
    q, k, v, do = lanes(bh, sq, sq, d, 1, sq)
    jnp = ref.jnp

    def f(q, k, v):
        o = ref.ref.attention_ref(q, k, v, causal=causal, window=window)
        return jnp.sum(o * jnp.asarray(do))

    want = ref.jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    got = flash_attention_bwd_ref(tq, tk, tv, o, torch.from_numpy(do),
                                  causal=causal, window=window)
    for g, w in zip(got, want):
        rel_close(g.numpy(), w, 2e-5)


@pytest.mark.parametrize("causal,window,sq", [(True, None, 48),
                                              (True, 12, 48),
                                              (False, None, 33)])
def test_flash_attention_function_matches_jax_grad(ref, causal, window, sq):
    """Autograd through ``ops.flash_attention`` on CPU tensors, whose
    backward takes the forward's lse (``FlashAttentionWithLse``), equals
    jax.grad of the reference's ``attention_ref`` where the two define the
    same function."""
    bh, d = 3, 64
    q, k, v, do = lanes(bh, sq, sq, d, 1, sq + 1)
    jnp = ref.jnp

    def f(q, k, v):
        o = ref.ref.attention_ref(q, k, v, causal=causal, window=window)
        return jnp.sum(o * jnp.asarray(do))

    want = ref.jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    a = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*a, causal=causal,
                                                  window=window), a,
                              torch.from_numpy(do))
    for g, w in zip(got, want):
        rel_close(g.numpy(), w, 2e-5)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_ops_flash_attention_differentiates(shape):
    """``ops.flash_attention`` (FlashAttention on CPU tensors) gives
    autograd's gradient of the plain function."""
    bh, sq, sk, d, causal, window, group = shape
    arrays = lanes(bh, sq, sk, d, group, 7)
    kw = dict(causal=causal, window=window, kv_group=group)
    a = [torch.from_numpy(x[...]).requires_grad_() for x in arrays[:3]]
    b = [torch.from_numpy(x.copy()).requires_grad_() for x in arrays[:3]]
    do = torch.from_numpy(arrays[3])
    got = torch.autograd.grad(ops.flash_attention(*a, **kw), a, do)
    want = torch.autograd.grad(flash_attention_ref(*b, **kw), b, do)
    for g, w in zip(got, want):
        rel_close(g.numpy(), w.numpy(), 1e-5)


def test_head_dim_16_is_padded_exactly():
    """D = 16 (the registry's transformer_lm) runs at 32 with zero columns
    and the scale of D = 16: the output and gradients are the unpadded
    function's."""
    bh, s, d = 4, 24, 16
    arrays = lanes(bh, s, s, d, 2, 3)
    a = [torch.from_numpy(x).requires_grad_() for x in arrays[:3]]
    b = [torch.from_numpy(x.copy()).requires_grad_() for x in arrays[:3]]
    out = ops.flash_attention(*a, kv_group=2)
    want = flash_attention_ref(*b, kv_group=2)
    assert out.shape == (bh, s, d)
    rel_close(out.detach().numpy(), want.detach().numpy(), 1e-6)
    do = torch.from_numpy(arrays[3])
    for g, w in zip(torch.autograd.grad(out, a, do),
                    torch.autograd.grad(want, b, do)):
        rel_close(g.numpy(), w.numpy(), 1e-5)
    assert ops.padded_head_dim(16) == 32 and ops.padded_head_dim(48) == 64
    assert ops.padded_head_dim(64) == 64 and ops.padded_head_dim(256) == 256


def _loss(w, x, k, v):
    o = ops.flash_attention(x @ w, k @ w, v, causal=True, kv_group=2)
    return (o * o).sum()


def test_vmap_of_grad_matches_per_sample_grads():
    """The participants' pattern, vmap(grad): batched and unbatched
    inputs fold into BH in both Functions' vmap rules."""
    rng = np.random.default_rng(0)
    m, bh, s, d = 3, 4, 20, 16
    w = torch.from_numpy(rng.standard_normal((m, d, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((m, bh, s, d))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((bh // 2, s, d))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((bh // 2, s, d))
                         .astype(np.float32))
    grad = torch.func.grad(_loss)
    per_sample = torch.stack([grad(w[i], x[i], k, v) for i in range(m)])
    batched = torch.func.vmap(grad, in_dims=(0, 0, None, None))(w, x, k, v)
    assert torch.equal(batched, per_sample)
    shared = torch.func.vmap(grad, in_dims=(None, 0, None, None))(w[0], x, k,
                                                                  v)
    assert torch.equal(shared, torch.stack([grad(w[0], x[i], k, v)
                                            for i in range(m)]))
    # and the per-sample gradient is autograd's
    wi = w[1].clone().requires_grad_()
    (want,) = torch.autograd.grad(_loss(wi, x[1], k, v), wi)
    rel_close(per_sample[1].numpy(), want.numpy(), 1e-6)


def test_function_vmap_folds_into_bh():
    """FlashAttention under vmap equals the call on the folded heads."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 4, 10, 32))
                         .astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 10, 32)).astype(np.float32))
    args = (True, None, 32 ** -0.5, 2)
    got = torch.func.vmap(lambda t: FlashAttention.apply(t, kv, kv, *args))(q)
    for i in range(3):
        assert torch.equal(got[i], flash_attention_ref(
            q[i], kv, kv, kv_group=2))


def test_moe_grads_flow_to_router_and_experts():
    """The reference's test (tests/test_moe.py) on the port's MoE, with
    torch.func.grad over its parameters."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="t", arch_type="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                      n_experts=4, top_k=2, moe_d_ff=64,
                      capacity_factor=1.25)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))

    def loss(params):
        y, aux = torch.func.functional_call(p, params, (x,))
        return torch.mean(y * y) + aux

    g = torch.func.grad(loss)(dict(p.named_parameters()))
    for name in ("router.w", "wi", "wo"):
        assert float(g[name].abs().sum()) > 0, name


def test_ssd_differentiates_on_the_cpu():
    """On CPU tensors ``ops.ssd`` runs the plain chunked scan, which
    autograd differentiates (on the card it raises under grad)."""
    rng = np.random.default_rng(2)
    b, s, h, p, n = 1, 40, 2, 8, 4
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.05, 0.2, (b, s, h))
                          .astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 1.5, h).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, s, n))
                               .astype(np.float32)) for _ in range(2))
    x.requires_grad_()
    y = ops.ssd(x, dt, a, bm, cm, chunk=16)
    (g,) = torch.autograd.grad(y.square().sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
    assert float(g.abs().sum()) > 0
