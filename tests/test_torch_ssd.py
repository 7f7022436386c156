"""The port's SSD scan against the reference's, on the CPU.

Inputs come from numpy with a seed and go to both packages. The port's
``ops.ssd`` runs the plain chunked version on CPU tensors (the function
``csrc/ssd_scan.cu`` computes, held against it on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``); the reference runs its
Pallas kernel in interpret mode (``ops.ssd(interpret=True)``), its chunked
jnp version and its sequential scan, as ``tests/test_kernels.py`` runs
them. Shapes are those of ``tests/test_kernels.py`` (one pads: S = 100 at
chunk 32) and one at mamba2-130m's widths (H 24, P 64, N 128, chunk 128)
with S = 200, so it pads too.

Tolerances. y: rtol 1e-4, atol 2e-4. The two sides sum the same float32
products in other orders (XLA's dot and cumsum against PyTorch's), over
up to 2 x 128 terms of size up to ~60 at the full widths: measured max
|d| 1.0e-4 at the full widths (|y| up to 62), 1.2e-5 elsewhere. The
final state: rtol 1e-4, atol 2e-5 (measured 2.4e-6, |h| up to 6). Decode
steps against the sequential scan: the reference's own rtol 1e-4 /
atol 1e-5.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.kernels import ops, tally  # noqa: E402
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (check_kernel_shape,  # noqa: E402
                                          smem_bytes, ssd_scan)

Y_TOL = dict(rtol=1e-4, atol=2e-4)
H_TOL = dict(rtol=1e-4, atol=2e-5)
SHAPES = [
    (2, 256, 3, 32, 16, 64),
    (1, 128, 1, 64, 32, 128),
    (2, 192, 2, 32, 16, 64),      # 3 chunks
    (1, 100, 2, 32, 16, 32),      # pads to 128
    (1, 200, 24, 64, 128, 128),   # mamba2-130m's widths; pads to 256
]


@pytest.fixture(scope="module")
def ref():
    return reference()


def ssd_inputs(b, s, h, p, n, seed=0):
    """x, dt, a, B, C as numpy float32: dt = softplus(N(0,1)) * 0.2 and
    a = -exp(N(0,1)), as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.2).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def pad_seq(arrs, chunk):
    s = arrs[0].shape[1]
    pad = (-s) % chunk
    return [v if v.ndim == 1 else
            np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
            for v in arrs]


def torch_of(arrs):
    return [torch.from_numpy(v) for v in arrs]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_matches_reference(ref, b, s, h, p, n, chunk):
    arrs = ssd_inputs(b, s, h, p, n)
    jarrs = [ref.jnp.asarray(v) for v in arrs]
    y, h_final = ops.ssd(*torch_of(arrs), chunk=chunk, return_state=True)
    assert y.shape == (b, s, h, p) and h_final.shape == (b, h, n, p)
    assert torch.isfinite(y).all() and torch.isfinite(h_final).all()
    y_pallas = ref.ops.ssd(*jarrs, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), **Y_TOL)
    y_chunk, h_chunk = ref.ref.ssd_chunked_ref(
        *[ref.jnp.asarray(v) for v in pad_seq(arrs, chunk)], chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_chunk)[:, :s],
                               **Y_TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(h_chunk),
                               **H_TOL)
    y_seq, h_seq = ref.ref.ssd_ref(*jarrs)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_seq), **Y_TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(h_seq), **H_TOL)
    # y without the state is the same tensor
    assert torch.equal(ops.ssd(*torch_of(arrs), chunk=chunk), y)


@pytest.mark.parametrize("chunk", [32, 64])
def test_ssd_from_initial_state(ref, chunk):
    """A carried-in state h0 (prefill after a cached prefix): the chunked
    and sequential versions of both packages agree."""
    b, s, h, p, n = 2, 128, 3, 32, 16
    arrs = ssd_inputs(b, s, h, p, n, seed=1)
    h0 = np.random.default_rng(2).standard_normal((b, h, n, p)).astype(
        np.float32)
    jarrs = [ref.jnp.asarray(v) for v in arrs]
    y, h_final = ssd_chunked_ref(*torch_of(arrs), chunk=chunk,
                                 h0=torch.from_numpy(h0))
    y_ref, h_ref = ref.ref.ssd_chunked_ref(*jarrs, chunk=chunk,
                                           h0=ref.jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **Y_TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(h_ref), **H_TOL)
    y_seq, h_seq = ssd_ref(*torch_of(arrs), h0=torch.from_numpy(h0))
    y_rseq, h_rseq = ref.ref.ssd_ref(*jarrs, h0=ref.jnp.asarray(h0))
    np.testing.assert_allclose(y_seq.numpy(), np.asarray(y_rseq), **Y_TOL)
    np.testing.assert_allclose(h_seq.numpy(), np.asarray(h_rseq), **H_TOL)
    np.testing.assert_allclose(y.numpy(), y_seq.numpy(), **Y_TOL)


def test_padding_leaves_the_state_unchanged():
    """Padded steps have dt = 0: the state after S = 100 padded to 128
    equals the state of the unpadded sequential scan."""
    arrs = torch_of(ssd_inputs(1, 100, 2, 32, 16, seed=3))
    _, h_pad = ops.ssd(*arrs, chunk=32, return_state=True)
    _, h_seq = ssd_ref(*arrs)
    torch.testing.assert_close(h_pad, h_seq, **H_TOL)


def test_ssd_decode_step_matches_scan(ref):
    """Decode steps one by one equal the sequential scan, in the port and
    against the reference's own decode steps."""
    b, s, h, p, n = 1, 16, 2, 8, 4
    arrs = ssd_inputs(b, s, h, p, n, seed=4)
    x, dt, a, bm, cm = torch_of(arrs)
    y_seq, h_seq = ref.ref.ssd_ref(*[ref.jnp.asarray(v) for v in arrs])
    state = torch.zeros((b, h, n, p))
    rstate = ref.jnp.zeros((b, h, n, p))
    ys = []
    for t in range(s):
        yt, state = ops.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                        bm[:, t], cm[:, t])
        ryt, rstate = ref.ops.ssd_decode_step(
            rstate, *[ref.jnp.asarray(v[:, t]) for v in (arrs[0], arrs[1])],
            ref.jnp.asarray(arrs[2]),
            *[ref.jnp.asarray(v[:, t]) for v in (arrs[3], arrs[4])])
        np.testing.assert_allclose(yt.numpy(), np.asarray(ryt), rtol=1e-4,
                                   atol=1e-5)
        ys.append(yt)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), np.asarray(y_seq),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(h_seq), rtol=1e-4,
                               atol=1e-5)


class Elsewhere(torch.Tensor):
    """A CPU tensor that reports another device, as a tensor of a backend
    with neither a kernel nor its plain version would: the wrappers refuse
    it by name."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ssd_scan_checks_its_arguments():
    x, dt, a, bm, cm = torch_of(ssd_inputs(1, 64, 2, 32, 16))
    with pytest.raises(TypeError):
        ssd_scan(x.double(), dt, a, bm, cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :, :1], a, bm, cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm, chunk=48)        # S not a multiple
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm, chunk=32, h0=torch.zeros(1, 2, 16, 8))
    # meta tensors (the dry run): the kernel's shapes, nothing run, its
    # operations tallied
    meta = [t.to("meta") for t in (x, dt, a, bm, cm)]
    tally.reset()
    y, state = ssd_scan(*meta, chunk=32, return_state=True)
    assert (y.device.type, y.shape, state.shape) == ("meta", x.shape,
                                                     (1, 2, 16, 32))
    assert tally.read()["ssd_scan"] == tally.ssd_flops(1, 64, 2, 32, 16, 32)
    with pytest.raises(ValueError, match="tensors on xpu.*CUDA"):
        ssd_scan(*(t.as_subclass(Elsewhere) for t in (x, dt, a, bm, cm)),
                 chunk=32)


def test_kernel_shape_limits():
    """The shapes the kernel takes (chunk 32/64/128, P 32/64, N <= 128) and
    its shared memory: at mamba2-130m's (chunk, N, P) = (128, 128, 64) the
    largest block (passes 1 and 3: two buffers of a 64-row and a 128-row
    tile of one K slab in hi and lo) needs 99,328 B of the 232,448 a block
    may have."""
    assert smem_bytes(128, 128, 64) == 99_328
    for chunk, n, p in ((128, 128, 64), (32, 32, 32), (32, 16, 32),
                        (64, 16, 32)):
        check_kernel_shape(chunk, n, p)
    for chunk, n, p in ((48, 16, 32), (128, 256, 64), (128, 128, 128),
                        (16, 16, 32)):
        with pytest.raises(ValueError, match="takes"):
            check_kernel_shape(chunk, n, p)
