"""K5's backward kernel on the CPU: what its wrapper plans and refuses
(``kernels/flash_attention.py``), and the forward's lse on the CPU path.

* ``bwd_smem_bytes(d)``, the dynamic shared memory of one block of
  ``csrc/flash_attention_bwd.cu`` (its ``Layout``), fits a block's 227 KB
  for every head dim K5 takes, at the values that layout sums to;
* ``check_bwd_shape`` and the wrapper raise where the kernel cannot go:
  head dims outside (32, 64, 128), grids and tensor maps past their 32-bit
  extents, a row that sees no key, an lse of the wrong shape or type;
* the scratch the wrapper allocates, per its layout;
* ``flash_attention_bhsd(..., return_lse=True)`` on CPU tensors returns
  the plain o and ``flash_lse_ref``, the plain backward on that lse is
  bit-equal to the one that recomputes it, and ``FlashAttentionWithLse``
  carries lse as a non-differentiable output.

The gradients themselves are held against autograd and ``jax.grad`` in
``tests/test_torch_train_attention.py``; the kernel, on the card, in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, MAX_SMEM_BYTES, FlashAttentionWithLse, bwd_padded,
    bwd_smem_bytes, bwd_work_floats, check_bwd_shape, flash_attention_bhsd,
    flash_attention_bwd)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_lse_ref)


@pytest.mark.parametrize("d,want", [(32, 116_800), (64, 198_720),
                                    (128, 230_944)])
def test_bwd_smem_fits_a_block(d, want):
    """Resident lo tiles 2 x 64 x D, stages (2 at D = 128, 4 below) of
    4 x 32 x D and 2 x 32 (lse, delta), the P and dS exchange tiles 4 x 64
    x 32, all float32, two mbarriers a stage and 1 KB of alignment."""
    assert d in HEAD_DIMS
    assert bwd_smem_bytes(d) == want <= MAX_SMEM_BYTES


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_check_bwd_shape_takes_the_main_shapes(d):
    check_bwd_shape(128, d, 2048, 2048, 8)
    check_bwd_shape(96, d, 16, 16, 1)
    check_bwd_shape(48, d, 1, 37, 48)


@pytest.mark.parametrize("bh,d,sq,sk,group,match", [
    (8, 16, 64, 64, 1, "takes D"),
    (8, 256, 64, 64, 1, "takes D"),
    (8, 96, 64, 64, 2, "takes D"),
    (1 << 26, 64, 4096, 64, 1, "grid"),
    (1 << 25, 64, 64, 64, 1, "2\\^31 rows"),
    (2, 64, 64, 1 << 30, 1, "2\\^31 rows"),
])
def test_check_bwd_shape_refuses(bh, d, sq, sk, group, match):
    with pytest.raises(ValueError, match=match):
        check_bwd_shape(bh, d, sq, sk, group)


def lanes(bh, sq, sk, d, group, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((bh, sq, d), (bh // group, sk, d), (bh // group, sk, d),
                      (bh, sq, d))]


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_bwd_wrapper_refuses_a_bad_lse(bad):
    q, k, v, do = lanes(4, 20, 20, 32, 2)
    o = flash_attention_ref(q, k, v, kv_group=2)
    lse = (torch.zeros(4, 21) if bad == "shape"
           else torch.zeros(4, 20, dtype=torch.float64))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, do, kv_group=2, lse=lse)


def test_bwd_wrapper_refuses_rows_that_see_no_key():
    q, k, v, do = lanes(2, 40, 10, 32, 1)
    with pytest.raises(ValueError, match="sees no key"):
        flash_attention_bwd(q, k, v, q, do, window=30)


@pytest.mark.parametrize("bh,sq,sk,d,group", [(128, 2048, 2048, 128, 8),
                                              (96, 16, 16, 32, 1),
                                              (12, 8192, 8192, 128, 6),
                                              (4, 65, 97, 64, 2)])
def test_bwd_scratch_follows_the_layout(bh, sq, sk, d, group):
    """q scale and dO hi and lo on BH heads and K and V hi and lo on BH /
    kv_group heads, rows padded to 64 a head, then delta and lse."""
    qrows, krows = bh * bwd_padded(sq), bh // group * bwd_padded(sk)
    assert bwd_padded(sq) % 64 == 0 and 0 <= bwd_padded(sq) - sq < 64
    assert bwd_work_floats(bh, sq, sk, d, group) == (
        4 * qrows * d + 4 * krows * d + 2 * qrows)


@pytest.mark.parametrize("shape", [(4, 37, 37, 32, True, None, 1),
                                   (6, 64, 64, 64, True, 16, 3),
                                   (4, 50, 70, 128, False, None, 2)])
def test_cpu_lse_is_the_plain_one(shape):
    """return_lse on CPU tensors: the plain o and flash_lse_ref, which is
    torch.logsumexp of the masked scaled scores; the plain backward on it
    is bit-equal to the one that recomputes it."""
    bh, sq, sk, d, causal, window, group = shape
    q, k, v, do = lanes(bh, sq, sk, d, group, seed=sq)
    kw = dict(causal=causal, window=window, kv_group=group)
    o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, flash_attention_ref(q, k, v, **kw))
    assert torch.equal(lse, flash_lse_ref(q, k, **kw))
    s = torch.bmm(q * d ** -0.5, k.repeat_interleave(group, 0).transpose(1, 2))
    rows = torch.arange(sq)[:, None]
    keys = torch.arange(sk)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        mask &= keys <= rows
    if window is not None:
        mask &= keys > rows - window
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    assert float((lse - want).abs().max()) <= 1e-5
    for a, b in zip(flash_attention_bwd(q, k, v, o, do, lse=lse, **kw),
                    flash_attention_bwd_ref(q, k, v, o, do, **kw)):
        assert torch.equal(a, b)


def test_function_returns_lse_without_a_gradient():
    q, k, v, do = lanes(4, 24, 24, 32, 2)
    q.requires_grad_()
    o, lse = FlashAttentionWithLse.apply(q, k, v, True, None, 32 ** -0.5, 2)
    assert o.requires_grad and not lse.requires_grad
    assert torch.equal(lse, flash_lse_ref(q.detach(), k, kv_group=2))
    (g,) = torch.autograd.grad(o, q, do)
    want = flash_attention_bwd_ref(q.detach(), k, v, o.detach(), do,
                                   kv_group=2)[0]
    assert torch.equal(g, want)
