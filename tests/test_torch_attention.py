"""The port's attention (the flash kernel's plain version, RoPE, SwiGLU and
the ``Attention`` mixer) against the reference, on the CPU.

Inputs come from numpy with a seed and go to both packages. On CPU
tensors the port's ``flash_attention_bhsd`` runs its plain version (the
function ``csrc/flash_attention.cu`` computes, held against it on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``); the reference runs
its Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it.

Tolerances, each with its reason:

- the plain kernel against the Pallas kernel and against
  ``ref.attention_ref``: the reference tests' own, 2e-5 in float32 and
  2e-2 in bfloat16. The port's plain version is dense where the Pallas
  kernel carries an online softmax over blocks of 128, and scales q before
  the product where the oracle scales the scores, so the two round
  differently (measured max |d| 3.6e-7 against the kernel, |out| up to
  2.6, and 1.2e-6 against the oracle); in bfloat16 one rounding of the
  output may land on the neighbouring bfloat16 value (measured 2.0e-3);
- ``ops.attention_auto`` against the reference's: 2e-5, as above. Off
  the accelerator both run the dense oracle, the same einsums and softmax
  in float32 (measured max |d| 6.6e-7, |out| up to 2.5);
- RoPE: the inverse frequencies bit for bit; rtol 1e-6 / atol 1e-6 on the
  rotated vectors (measured 4.8e-7 at |x| up to 4.1, positions up to
  2,063: the angles are the same float32 products, cos and sin differ in
  the last ulp);
- SwiGLU and the ``Attention`` mixer: rtol 1e-4 / atol 2e-5 on outputs
  and on the cached keys and values. The two sides sum float32 products
  in other orders, over up to 4,096 terms at yi-6b's width: measured max
  |d| 4.4e-6 at |out| up to 5.0 (full width, apply and prefill), 2.4e-6
  in decode, 2.9e-6 in the cached keys (|k| up to 5.2).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tally  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_kernel_shape, flash_attention_bhsd, flash_attention_bwd,
    smem_bytes)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import (SwiGLU, apply_rope,  # noqa: E402
                                       rope_frequencies)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
OUT_TOL = dict(rtol=1e-4, atol=2e-5)

# (bh, Sq, Sk, D, causal, window): tests/test_kernels.py's six shapes
# (Sq == Sk), then Sq != Sk and non-causal windows
KERNEL_SHAPES = [
    (2, 256, 256, 64, True, None),
    (1, 200, 200, 64, True, None),     # not a multiple of a block
    (2, 384, 384, 64, True, 128),      # sliding window
    (3, 64, 64, 128, False, None),     # bidirectional
    (1, 128, 128, 32, True, 32),       # window < block
    (2, 256, 256, 64, True, None),     # (bfloat16 in the reference test)
]
OTHER_SHAPES = [
    (2, 100, 300, 64, True, None),     # Sq < Sk
    (2, 300, 100, 64, True, None),     # Sq > Sk
    (1, 150, 130, 128, True, 40),      # Sq > Sk with a window
    (2, 256, 256, 64, False, 48),      # non-causal window
    (1, 70, 200, 32, False, 100),      # non-causal window, Sq < Sk
    (2, 48, 37, 64, False, None),      # non-causal, Sq > Sk, a ragged tile
    (2, 70, 150, 64, False, None),     # non-causal, Sq < Sk, no window
]


@pytest.fixture(scope="module")
def ref():
    return reference()


def qkv(bh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d)).astype(np.float32),
            rng.standard_normal((bh, sk, d)).astype(np.float32),
            rng.standard_normal((bh, sk, d)).astype(np.float32))


def both(ref, arrs, dtype):
    """The arrays as the reference's and the port's tensors of ``dtype``."""
    jd = ref.jnp.bfloat16 if dtype == torch.bfloat16 else ref.jnp.float32
    return ([ref.jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(dtype) for a in arrs])


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# --------------------------------------------------------------- the kernel

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,window",
                         KERNEL_SHAPES + OTHER_SHAPES)
def test_flash_matches_pallas_kernel(ref, bh, sq, sk, d, causal, window,
                                     dtype):
    """The plain K5 against the reference's Pallas kernel in interpret
    mode (which pads to blocks of 128 where the port bounds-checks)."""
    (jq, jk, jv), (q, k, v) = both(ref, qkv(bh, sq, sk, d), dtype)
    want = ref.flash_attention.flash_attention_bhsd(
        jq, jk, jv, causal=causal, window=window, interpret=True)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.shape == (bh, sq, d) and got.dtype == dtype
    tol = TOL[dtype]
    close(got.float(), want, dict(rtol=tol, atol=tol))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,window", KERNEL_SHAPES + [
    (1, 77, 77, 32, True, None), (3, 300, 300, 64, True, None),
    (2, 16, 16, 64, True, 5)])
def test_flash_matches_attention_ref(ref, bh, sq, sk, d, causal, window,
                                     dtype):
    """The plain K5 against the reference's dense oracle where the two
    define the same function (Sq == Sk; a window only with causal), and
    against the port's twin of that oracle."""
    (jq, jk, jv), (q, k, v) = both(ref, qkv(bh, sq, sk, d, seed=1), dtype)
    want = ref.ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    close(got.float(), want, dict(rtol=tol, atol=tol))
    twin = tref.attention_ref(q, k, v, causal=causal, window=window)
    close(twin.float(), want, dict(rtol=tol, atol=tol))


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 192, True, None),    # the oracle puts the queries at the end
    (128, 128, False, 32),    # the oracle's window is two-sided
])
def test_reference_kernel_and_oracle_disagree(ref, sq, sk, causal, window):
    """Where the reference's kernel and its oracle define different
    functions (ROADMAP §C), the port's kernel follows the kernel, and
    ``tref.attention_ref`` the oracle."""
    (jq, jk, jv), (q, k, v) = both(ref, qkv(2, sq, sk, 64, seed=2),
                                   torch.float32)
    kernel = ref.flash_attention.flash_attention_bhsd(
        jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = ref.ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    assert np.abs(np.asarray(kernel) - np.asarray(oracle)).max() > 0.1
    close(flash_attention_bhsd(q, k, v, causal=causal, window=window),
          kernel, dict(rtol=2e-5, atol=2e-5))
    close(tref.attention_ref(q, k, v, causal=causal, window=window), oracle,
          dict(rtol=2e-5, atol=2e-5))


@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 192, True, None),    # where the kernel's function differs
    (128, 128, False, 32),    # where the kernel's function differs
    (100, 300, True, 40),
    (96, 96, True, None),
])
def test_attention_auto_matches_reference(ref, sq, sk, causal, window):
    """The port's ``ops.attention_auto`` on CPU tensors against the
    reference's on the same arrays: both run the dense oracle off the
    accelerator, so they agree where K5's function does not."""
    (jq, jk, jv), (q, k, v) = both(ref, qkv(2, sq, sk, 32, seed=3),
                                   torch.float32)
    want = ref.ops.attention_auto(jq, jk, jv, causal=causal, window=window)
    got = ops.attention_auto(q, k, v, causal=causal, window=window)
    assert got.shape == (2, sq, 32) and got.dtype == torch.float32
    close(got, want, dict(rtol=2e-5, atol=2e-5))


def test_flash_wrapper_checks():
    q = torch.zeros((2, 8, 32))
    with pytest.raises(TypeError):
        flash_attention_bhsd(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention_bhsd(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, q[:1], q[:1])
    with pytest.raises(ValueError):
        flash_attention_bhsd(q[:, :0], q, q)
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, q, q, window=0)
    with pytest.raises(ValueError, match="sees no key"):
        flash_attention_bhsd(torch.zeros((2, 20, 32)), q, q, window=12)
    # meta tensors: the kernel's shapes, no kernel and no plain version run,
    # its operations tallied for the dry run
    meta = q.to("meta")
    tally.reset()
    o, lse = flash_attention_bhsd(meta, meta, meta, return_lse=True)
    assert o.device.type == lse.device.type == "meta"
    assert (o.shape, lse.shape, lse.dtype) == (q.shape, (2, 8),
                                               torch.float32)
    assert tally.read()["flash_attention_bhsd"] == tally.flash_flops(
        2, 8, 8, 32, True, None) == 2 * 36 * 4 * 32 + 2 * (36 * 3 + 2 * 8 * 32)
    # any other device is refused by name, forward and backward
    from test_torch_ssd import Elsewhere
    other = q.as_subclass(Elsewhere)
    with pytest.raises(ValueError, match="tensors on xpu.*CUDA"):
        flash_attention_bhsd(other, other, other)
    with pytest.raises(ValueError, match="tensors on xpu.*CUDA"):
        flash_attention_bwd(other, other, other, other, other)
    for d in (32, 64, 128):
        check_kernel_shape(128, d)
        check_kernel_shape(128, d, 2048, 2048, 8)
    for bh, d in ((1, 96), (1, 256), (1 << 31, 64)):
        with pytest.raises(ValueError):
            check_kernel_shape(bh, d)
    with pytest.raises(ValueError, match="grid"):
        check_kernel_shape(1 << 16, 64, 64 * 65535)
    # Q_lo (128, D), P hi + lo (128, 32) and two stages of K hi + lo
    # (32, D) and V^T hi + lo (D, 32), float32, at D = 128: 224 KB and one
    # block per SM
    # (and the stages' six mbarriers and two (kv_valid word, key tile)
    # slots each, and the block's tile plan)
    assert smem_bytes(128) == (2 * 32_768 + 32_768 + 2 * 65_536 + 96 + 32
                               + 16 + 1024)
    assert smem_bytes(128) < 227 << 10 < 2 * smem_bytes(128)


def test_flash_wrapper_checks_kv_group():
    """k and v hold BH / kv_group heads; BH must be a multiple of it."""
    q = torch.zeros((8, 16, 32))
    kv = torch.zeros((2, 16, 32))
    assert flash_attention_bhsd(q, kv, kv, kv_group=4).shape == q.shape
    for group, k in ((4, torch.zeros((8, 16, 32))), (2, kv), (1, kv),
                     (4, torch.zeros((2, 16, 64)))):
        with pytest.raises(ValueError, match="kv_group"):
            flash_attention_bhsd(q, k, k, kv_group=group)
    with pytest.raises(ValueError, match="kv_group"):
        flash_attention_bhsd(q, kv, torch.zeros((4, 16, 32)), kv_group=4)
    for group in (3, 0):
        with pytest.raises(ValueError, match="multiple of kv_group"):
            flash_attention_bhsd(q, kv, kv, kv_group=group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_group", [2, 4, 8, 16, 48])
@pytest.mark.parametrize("sq,sk,d,causal,window", [
    (64, 64, 64, True, None), (100, 300, 32, True, None),
    (150, 130, 128, True, 40), (70, 200, 64, False, 100),
    (48, 37, 64, False, None), (70, 150, 64, False, None)])
def test_flash_kv_group_equals_expanded(sq, sk, d, causal, window,
                                        kv_group, dtype):
    """The plain K5 on unexpanded KV heads (row-block bh reads KV head
    bh // kv_group) equals it on the ``repeat_interleave``-expanded KV,
    bit for bit, through the wrapper and ``ops``."""
    bh = 2 * kv_group
    rng = np.random.default_rng(kv_group)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, s, d)).astype(
        np.float32)).to(dtype) for n, s in ((bh, sq), (2, sk), (2, sk)))
    want = flash_attention_bhsd(q, k.repeat_interleave(kv_group, dim=0),
                                v.repeat_interleave(kv_group, dim=0),
                                causal=causal, window=window)
    for got in (flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                     kv_group=kv_group),
                tref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window, kv_group=kv_group),
                ops.flash_attention(q, k, v, causal=causal, window=window,
                                    kv_group=kv_group)):
        assert got.dtype == dtype and torch.equal(got, want)
    # attention_auto runs the dense oracle on the CPU: its kv_group equals
    # the oracle on the expanded KV
    assert torch.equal(
        ops.attention_auto(q, k, v, causal=causal, window=window,
                           kv_group=kv_group),
        tref.attention_ref(q, k.repeat_interleave(kv_group, dim=0),
                           v.repeat_interleave(kv_group, dim=0),
                           causal=causal, window=window))


# ----------------------------------------------------------- RoPE, SwiGLU

@pytest.mark.parametrize("hd,frac,theta,max_pos", [
    (128, 1.0, 5e6, 2064),    # yi-6b, positions up to the smoke's cache
    (64, 1.0, 1e4, 300),
    (64, 0.5, 1e4, 300),      # partial rotary (chatglm3)
])
def test_rope_matches_reference(ref, hd, frac, theta, max_pos):
    inv, rot = rope_frequencies(hd, frac, theta)
    rinv, rrot = ref.layers.rope_frequencies(hd, frac, theta)
    assert rot == rrot and inv.dtype == torch.float32
    np.testing.assert_array_equal(inv.numpy(), np.asarray(rinv))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 3, hd)).astype(np.float32)
    pos = np.sort(rng.integers(0, max_pos, (2, 40))).astype(np.int32)
    want = ref.layers.apply_rope(ref.jnp.asarray(x), ref.jnp.asarray(pos),
                                 rinv, rrot)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), inv,
                     rot)
    close(got, want, ROPE_TOL)


def test_swiglu_matches_reference(ref):
    rp = ref.layers.init_swiglu(ref.jax.random.PRNGKey(5), 96, 160,
                                ref.jnp.float32)
    mlp = SwiGLU(*(torch.from_numpy(np.array(rp[n]["w"]))
                   for n in ("wi", "wg", "wo")))
    x = np.random.default_rng(5).standard_normal((2, 7, 96)).astype(
        np.float32)
    close(mlp(torch.from_numpy(x)),
          ref.layers.apply_swiglu(rp, ref.jnp.asarray(x)), OUT_TOL)
    own = SwiGLU.init(torch.Generator().manual_seed(0), 96, 160,
                      torch.float32, "cpu")
    assert [tuple(p.shape) for p in own.parameters()] == [
        (96, 160), (96, 160), (160, 96)]


# ------------------------------------------------------------ the mixer

def attention_pair(ref, width, seed=3, **replace):
    """The port's and the reference's attention config and one mixer with
    the reference's weights: ``reduced`` yi-6b (d_model 256, 4 / 1 heads,
    hd 64) or its full attention width (d_model 4096, 32 / 4 heads, hd
    128)."""
    import dataclasses
    cfg = configs.get_config("yi-6b")
    rcfg = ref.configs.get_config("yi-6b")
    if width == "reduced":
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    cfg = dataclasses.replace(cfg, **replace)
    rcfg = dataclasses.replace(rcfg, **replace)
    rp = ref.attention.init_attention(ref.jax.random.PRNGKey(seed), rcfg,
                                      ref.jnp.float32)
    mixer = attn.Attention(*(torch.from_numpy(np.array(rp[n]["w"]))
                             for n in ("wq", "wk", "wv", "wo")), cfg)
    return cfg, rcfg, rp, mixer


def check_cache(cache, rcache):
    close(cache.k, rcache.k, OUT_TOL)
    close(cache.v, rcache.v, OUT_TOL)
    np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                  np.asarray(rcache.slot_pos))
    assert cache.length == int(rcache.length)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_attention_matches_reference(ref, width):
    """``apply_attention``, ``prefill_attention`` (cache contents,
    ``slot_pos``, ``length``) and three ``decode_attention`` steps of one
    mixer, at reduced yi-6b and at its full attention width (batch 1 x
    128; no MLP, so it stays cheap)."""
    cfg, rcfg, rp, mixer = attention_pair(ref, width)
    b, s = (2, 40) if width == "reduced" else (1, 128)
    jnp = ref.jnp
    x = np.random.default_rng(6).standard_normal(
        (b, s + 3, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)

    want = ref.attention.apply_attention(rp, jnp.asarray(x[:, :s]), rcfg)
    with torch.inference_mode():
        got = attn.apply_attention(mixer, xt[:, :s], cfg)
        assert torch.equal(mixer(xt[:, :s]), got)
    close(got, want, OUT_TOL)

    clen = s + 8
    rcache = ref.attention.init_cache(rcfg, b, clen, jnp.float32)
    want, rcache = ref.attention.prefill_attention(
        rp, jnp.asarray(x[:, :s]), rcfg, rcache)
    with torch.inference_mode():
        got, cache = mixer.prefill(xt[:, :s], clen)
    close(got, want, OUT_TOL)
    check_cache(cache, rcache)
    for t in range(s, s + 3):
        want, rcache = ref.attention.decode_attention(
            rp, jnp.asarray(x[:, t:t + 1]), rcfg, rcache)
        with torch.inference_mode():
            got, cache = mixer.decode(xt[:, t:t + 1], cache)
        close(got, want, OUT_TOL)
        check_cache(cache, rcache)


@pytest.mark.parametrize("width", ["reduced", "full"])
def test_cross_attention_matches_reference(ref, width):
    """A cross-attention mixer against the reference's: ``apply_attention``
    with ``kv_x`` (no RoPE, no mask), ``precompute_cross_kv`` and
    ``cross_attention_cached`` over a prompt (the flash kernel's path) and
    over one token (decode's plain path), at reduced llama-3.2-vision-11b
    and at its full attention width (d_model 4096, 32 query heads on 8 KV
    heads of 128; batch 1, 48 tokens over 100 media embeddings)."""
    cfg = configs.get_config("llama-3.2-vision-11b")
    rcfg = ref.configs.get_config("llama-3.2-vision-11b")
    if width == "reduced":
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    rp = ref.attention.init_attention(ref.jax.random.PRNGKey(4), rcfg,
                                      ref.jnp.float32, cross=True)
    mixer = attn.CrossAttention(*(torch.from_numpy(np.array(rp[n]["w"]))
                                  for n in ("wq", "wk", "wv", "wo")), cfg)
    b, s, m = (2, 40, 16) if width == "reduced" else (1, 48, 100)
    rng = np.random.default_rng(9)
    x, media = (rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
                for n in (s, m))
    jx, jm = ref.jnp.asarray(x), ref.jnp.asarray(media)
    tx, tm = torch.from_numpy(x), torch.from_numpy(media)
    with torch.inference_mode():
        got = mixer(tx, tm)
        kv = attn.precompute_cross_kv(mixer, tm, cfg)
        cached = mixer.prefill(tx, kv)
        step = mixer.decode(tx[:, -1:], kv)
    close(got, ref.attention.apply_attention(rp, jx, rcfg, kv_x=jm),
          OUT_TOL)
    rkv = ref.attention.precompute_cross_kv(rp, jm, rcfg)
    for g, w in zip(kv, rkv):
        assert tuple(g.shape) == w.shape == (b, m, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
        close(g, w, OUT_TOL)
    close(cached, ref.attention.cross_attention_cached(rp, jx, rkv, rcfg),
          OUT_TOL)
    close(step, ref.attention.cross_attention_cached(rp, jx[:, -1:], rkv,
                                                     rcfg), OUT_TOL)
    assert isinstance(attn.init_attention(torch.Generator(), cfg,
                                          torch.float32, "cpu", cross=True),
                      attn.CrossAttention)


@pytest.mark.parametrize("s,clen,window", [
    (40, 16, None),   # rolling: the prompt is longer than the cache
    (40, 16, 16),     # a window cache, sized to the window
    (40, 64, 10),     # a window inside a longer cache
])
def test_prefill_rolling_and_window(ref, s, clen, window):
    """The prefill's cache fill through the scratch row (only the last
    ``clen`` keys survive, at ``position % clen``) and windowed attention,
    then decode steps past the window, against the reference."""
    cfg, rcfg, rp, mixer = attention_pair(ref, "reduced", seed=7)
    jnp = ref.jnp
    x = np.random.default_rng(7).standard_normal(
        (2, s + 4, cfg.d_model)).astype(np.float32)
    rcache = ref.attention.init_cache(rcfg, 2, clen, jnp.float32)
    want, rcache = ref.attention.prefill_attention(
        rp, jnp.asarray(x[:, :s]), rcfg, rcache, window=window)
    with torch.inference_mode():
        cache = attn.init_cache(cfg, 2, clen, torch.float32, "cpu")
        got, cache = attn.prefill_attention(
            mixer, torch.from_numpy(x[:, :s]), cfg, cache, window=window)
    close(got, want, OUT_TOL)
    check_cache(cache, rcache)
    for t in range(s, s + 4):
        want, rcache = ref.attention.decode_attention(
            rp, jnp.asarray(x[:, t:t + 1]), rcfg, rcache, window=window)
        with torch.inference_mode():
            got, cache = attn.decode_attention(
                mixer, torch.from_numpy(x[:, t:t + 1]), cfg, cache,
                window=window)
        close(got, want, OUT_TOL)
        check_cache(cache, rcache)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 9),
                                           (False, None), (False, 9)])
def test_kernel_path_matches_grouped_attention(ref, causal, window):
    """``apply_attention`` (the flash kernel on q (B Hq, S, hd) and the
    unexpanded k / v (B KV, S, hd), ``kv_group = Hq / KV``) against the
    reference's ``_grouped_attention`` and the port's twin of it, on the
    same rotated q, k, v (GQA groups of 2; a non-causal call drops the
    window, as the reference does)."""
    cfg, rcfg, rp, mixer = attention_pair(ref, "reduced", n_heads=4,
                                          n_kv_heads=2)
    jnp = ref.jnp
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 33, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 33, 2, 64)).astype(np.float32)
            for _ in range(2))
    want = ref.attention._grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attn._flash_attention(tq, tk, tv, causal=causal,
                                window=window if causal else None)
    close(got, want, OUT_TOL)
    twin = attn._grouped_attention(tq, tk, tv, causal=causal, window=window)
    close(twin, want, OUT_TOL)
    x = rng.standard_normal((2, 33, cfg.d_model)).astype(np.float32)
    close(attn.apply_attention(mixer, torch.from_numpy(x), cfg,
                               causal=causal, window=window),
          ref.attention.apply_attention(rp, jnp.asarray(x), rcfg,
                                        causal=causal, window=window),
          OUT_TOL)


# ------------------------------------------- kv_valid and attn_probs_bf16

def kv_masks(b, sk, seed):
    """A (B, Sk) key mask: row 0 with its last keys and every third key
    dead, row 1 with no live key at all."""
    kv = np.ones((b, sk), bool)
    kv[0, sk - 1 - np.random.default_rng(seed).integers(0, sk // 2):] = False
    kv[0, 2::3] = False
    kv[1] = False
    return kv


def bf16_bounds(q, k, v, do, kv, causal, group, scale):
    """The derived bounds on the gradient's difference in probs_bf16 mode
    (kernels/ref.py flash_attention_bwd_ref, which takes the reference's
    delta, sum(P dP) of the rounded dP): the two sides' float32 dP differ
    by float32 noise, so their bfloat16 roundings land apart only at a
    tie, one bfloat16 ulp (2^-8 of |dP_j|); were every one to land apart,
    delta would move by at most 2^-8 sum_j P_j |dP_j| a row, which moves
    dS_rj by P_rj |delta_r - delta'_r|, so dq_r by at most scale |delta_r
    - delta'_r| sum_j P_rj |k_j| and dk_j by sum_r P_rj |delta_r -
    delta'_r| |q_r scale|; all float32 arrays of (BH, ...)."""
    g = group
    kf = k.repeat_interleave(g, 0).float()
    vf = tref.bf16_round(v.repeat_interleave(g, 0).float())
    s = torch.bmm(q.float() * scale, kf.transpose(1, 2))
    mask = tref.full_mask(q.shape[0], q.shape[1], k.shape[1], causal, None,
                          kv, q.device)
    s = torch.where(mask, s, tref.NEG_INF)
    p = torch.softmax(s, -1) * mask.any(-1, keepdim=True)
    dp = torch.bmm(do.float(), vf.transpose(1, 2)).abs()
    ddelta = 2.0 ** -8 * (p * dp).sum(-1, keepdim=True)
    dq = scale * ddelta * torch.bmm(p, kf.abs())
    dk = torch.bmm((p * ddelta).transpose(1, 2), (q.float() * scale).abs())
    return dq, dk.unflatten(0, (-1, g)).sum(1)


@pytest.mark.parametrize("probs_bf16", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_modes_match_grouped_attention_and_vjp(ref, masked, causal,
                                                     probs_bf16):
    """K5's plain version (forward and backward, the function the kernel
    computes) in the kv_valid / probs_bf16 modes against the reference's
    ``_grouped_attention`` and its ``jax.vjp``, GQA groups of 2, a batch
    row with no live key (its output v's mean over all keys, lse +inf).

    Tolerances: float32 as above (2e-5 on o; each gradient within 1e-4
    of its largest |reference| entry). With probs_bf16 the rounding
    points are the reference's (p and v rounded to bfloat16 in the
    forward; dP and dv in the backward), so o and dv stay at float32 but
    for one bfloat16 ulp where the two float32 p straddle a rounding tie
    (2^-7 of |dv|); dq and dk within :func:`bf16_bounds` (ties of dP)
    plus the float32 tolerance."""
    jnp = ref.jnp
    b, sq, hq, kvh, hd = 2, 37, 4, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sq, kvh, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kv = kv_masks(b, sq, 3) if masked else None

    def fn(q, k, v):
        return ref.attention._grouped_attention(
            q, k, v, causal=causal, window=None,
            kv_valid=None if kv is None else jnp.asarray(kv),
            probs_bf16=probs_bf16)

    want, vjp = ref.jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    wq, wk, wv = (np.asarray(g) for g in vjp(jnp.asarray(do)))

    def heads(a):
        t = torch.from_numpy(a)
        return t.transpose(1, 2).reshape(-1, sq, hd)

    def back(t, n):
        return t.reshape(b, n, sq, hd).transpose(1, 2).numpy()

    tkv = None if kv is None else torch.from_numpy(kv)
    kw = dict(causal=causal, kv_group=hq // kvh, kv_valid=tkv,
              probs_bf16=probs_bf16)
    tq, tk, tv, tdo = (heads(a) for a in (q, k, v, do))
    o, lse = flash_attention_bhsd(tq, tk, tv, return_lse=True, **kw)
    close(back(o, hq), want, dict(rtol=0, atol=TOL[torch.float32]))
    dead = torch.isinf(lse)
    assert bool(dead.any()) == masked
    if masked:
        # batch row 1 has no live key: every one of its rows is dead and
        # averages v over all keys
        assert bool(dead.reshape(b, hq, sq)[1].all())
    dq, dk, dv = flash_attention_bwd(tq, tk, tv, o, tdo, lse=lse, **kw)
    scale = hd ** -0.5
    bq = bk = 0.0
    if probs_bf16:
        bq, bk = (back(t, n) for t, n in zip(
            bf16_bounds(tq, tk, tv, tdo, tkv, causal, hq // kvh, scale),
            (hq, kvh)))
    for name, g, w, bound in (("dq", back(dq, hq), wq, bq),
                              ("dk", back(dk, kvh), wk, bk)):
        slack = 1e-4 * np.abs(w).max()
        assert np.all(np.abs(g - w) <= bound + slack), name
    dvg = back(dv, kvh)
    ulp = 2.0 ** -7 * np.abs(wv) if probs_bf16 else 0.0
    assert np.all(np.abs(dvg - wv) <= ulp + 1e-4 * np.abs(wv).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_flash_bwd_folded_matches_vjp(ref, masked, causal):
    """The backward's plain version in the kernel's order of sums with
    probs_bf16 (``flash_attention_bwd_folded_ref``: dq = scale (A - delta
    B), A = (P bf16(dP)) K, B = P K, the delta made beside A) against
    ``jax.vjp`` of the reference's ``_grouped_attention(probs_bf16=True)``
    at :func:`test_flash_modes_match_grouped_attention_and_vjp`'s sizes
    and bounds (dq and dk within :func:`bf16_bounds` plus 1e-4 of their
    largest |reference| entry, dv within a bfloat16 ulp plus that); and
    the control: each gradient's distance to the reference (Frobenius) at
    most a quarter of the reference's own distance to its float32
    gradient (probs_bf16=False), as chip_smoke.py's FLASH_PB_CONTROL."""
    jnp = ref.jnp
    b, sq, hq, kvh, hd = 2, 37, 4, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sq, kvh, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, hq, hd)).astype(np.float32)
    kv = kv_masks(b, sq, 3) if masked else None

    def vjp(probs_bf16):
        def fn(q, k, v):
            return ref.attention._grouped_attention(
                q, k, v, causal=causal, window=None,
                kv_valid=None if kv is None else jnp.asarray(kv),
                probs_bf16=probs_bf16)

        _, pull = ref.jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        return [np.asarray(g) for g in pull(jnp.asarray(do))]

    want, f32 = vjp(True), vjp(False)

    def heads(a):
        return torch.from_numpy(a).transpose(1, 2).reshape(-1, sq, hd)

    def back(t, n):
        return t.reshape(b, n, sq, hd).transpose(1, 2).numpy()

    tkv = None if kv is None else torch.from_numpy(kv)
    kw = dict(causal=causal, kv_group=hq // kvh, kv_valid=tkv,
              probs_bf16=True)
    tq, tk, tv, tdo = (heads(a) for a in (q, k, v, do))
    o, lse = flash_attention_bhsd(tq, tk, tv, return_lse=True, **kw)
    got = [back(t, n) for t, n in zip(tref.flash_attention_bwd_folded_ref(
        tq, tk, tv, o, tdo, lse=lse, **kw), (hq, kvh, kvh))]
    bq, bk = (back(t, n) for t, n in zip(
        bf16_bounds(tq, tk, tv, tdo, tkv, causal, hq // kvh, hd ** -0.5),
        (hq, kvh)))
    bounds = (bq, bk, 2.0 ** -7 * np.abs(want[2]))
    for name, g, w, f, bound in zip(("dq", "dk", "dv"), got, want, f32,
                                    bounds):
        assert np.all(np.abs(g - w) <= bound + 1e-4 * np.abs(w).max()), name
        control = np.linalg.norm(g - w) / np.linalg.norm(f - w)
        assert control <= 0.25, (name, control)


@pytest.mark.parametrize("masked", [True, False])
def test_flash_bwd_folded_is_the_plain_gradient_reassociated(masked):
    """``flash_attention_bwd_folded_ref`` against ``flash_attention_bwd_ref``
    on the same inputs: with probs_bf16 dk and dv bit for bit and dq the
    same sum reassociated (float32 noise: within 1e-5 of its largest
    entry); without it every gradient bit for bit."""
    g = torch.Generator().manual_seed(5)
    q, o, do = (torch.randn((8, 45, 32), generator=g) for _ in range(3))
    k, v = (torch.randn((4, 45, 32), generator=g) for _ in range(2))
    kv = None
    if masked:
        kv = torch.ones((2, 45), dtype=torch.bool)
        kv[0, :11] = False
        kv[1, 30:] = False
    for pb in (True, False):
        kw = dict(kv_group=2, kv_valid=kv, probs_bf16=pb)
        plain = tref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
        folded = tref.flash_attention_bwd_folded_ref(q, k, v, o, do, **kw)
        assert torch.equal(plain[1], folded[1])
        assert torch.equal(plain[2], folded[2])
        if pb:
            assert not torch.equal(plain[0], folded[0])
            assert (float((plain[0] - folded[0]).abs().max())
                    <= 1e-5 * float(plain[0].abs().max()))
        else:
            assert torch.equal(plain[0], folded[0])


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("rank", [1, 2])
def test_apply_attention_kv_valid_matches_reference(ref, cross, rank):
    """``apply_attention`` with a kv_valid mask, (Sk,) or (B, Sk), self-
    (causal) or cross-attention (over 24 media embeddings), against the
    reference's, the output and ``jax.vjp``'s gradients of x (and of the
    media) at OUT_TOL; a (B, Sk) mask has a row with no live key."""
    cfg, rcfg, rp, mixer = attention_pair(ref, "reduced", seed=11)
    jnp = ref.jnp
    b, s, m = 2, 21, 24
    rng = np.random.default_rng(12)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    media = rng.standard_normal((b, m, cfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    sk = m if cross else s
    kv = kv_masks(b, sk, 12) if rank == 2 else kv_masks(b, sk, 12)[0]

    def fn(x, media):
        return ref.attention.apply_attention(
            rp, x, rcfg, kv_x=media if cross else None,
            kv_valid=jnp.asarray(kv))

    want, vjp = ref.jax.vjp(fn, jnp.asarray(x), jnp.asarray(media))
    gx, gm = vjp(jnp.asarray(dout))
    tx, tm = (torch.from_numpy(a).requires_grad_() for a in (x, media))
    got = attn.apply_attention(mixer, tx, cfg, kv_x=tm if cross else None,
                               kv_valid=torch.from_numpy(kv))
    close(got.detach(), want, OUT_TOL)
    got.backward(torch.from_numpy(dout))
    close(tx.grad, gx, dict(rtol=1e-4, atol=1e-4 * float(np.abs(gx).max())))
    if cross:
        close(tm.grad, gm, dict(rtol=1e-4,
                                atol=1e-4 * float(np.abs(gm).max())))
    twin = attn._grouped_attention(*(t for t in attn._qkv(
        mixer, torch.from_numpy(x), cfg,
        torch.from_numpy(media) if cross else None)), causal=not cross,
        window=None, kv_valid=torch.from_numpy(kv))
    assert twin.shape == (b, s, cfg.n_heads, cfg.resolved_head_dim)


def test_attn_probs_bf16_matches_reference(ref):
    """``attn_probs_bf16``: ``apply_attention`` (and ``jax.vjp``'s gradient
    of x) and ``prefill_attention`` (output and cache) against the
    reference's with the flag; decode and the cached cross path take no
    bfloat16 probabilities in either. Tolerances: the outputs OUT_TOL
    plus one bfloat16 ulp of a probability where the two sides' float32
    p straddle a rounding tie (2^-8 of max |v| through wo: 1e-3 of the
    largest |out|); the gradient of x within 2^-7 of its largest entry,
    dq and dk carrying the delta difference bounded in
    :func:`bf16_bounds` through the projections."""
    import dataclasses
    cfg, rcfg, rp, mixer = attention_pair(ref, "reduced", seed=13,
                                          attn_probs_bf16=True)
    jnp = ref.jnp
    b, s = 2, 33
    rng = np.random.default_rng(14)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    dout = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    want, vjp = ref.jax.vjp(
        lambda x: ref.attention.apply_attention(rp, x, rcfg),
        jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(dout))
    tx = torch.from_numpy(x).requires_grad_()
    got = attn.apply_attention(mixer, tx, cfg)
    out_tol = dict(rtol=1e-4, atol=1e-3 * float(np.abs(want).max()))
    close(got.detach(), want, out_tol)
    got.backward(torch.from_numpy(dout))
    close(tx.grad, gx, dict(rtol=0, atol=2.0 ** -7 * float(
        np.abs(gx).max())))
    # the flag changes the result (the bfloat16 rounding is there)
    plain = ref.attention.apply_attention(
        rp, jnp.asarray(x), dataclasses.replace(rcfg,
                                                attn_probs_bf16=False))
    assert float(np.abs(np.asarray(plain) - np.asarray(want)).max()) > 0
    clen = s + 4
    rcache = ref.attention.init_cache(rcfg, b, clen, jnp.float32)
    want, rcache = ref.attention.prefill_attention(rp, jnp.asarray(x), rcfg,
                                                   rcache)
    with torch.inference_mode():
        got, cache = mixer.prefill(torch.from_numpy(x), clen)
    close(got, want, out_tol)
    check_cache(cache, rcache)
