"""Chunked SSD scan kernel (replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``).

``ssd_scan`` launches ``csrc/ssd_scan.cu`` for CUDA tensors and runs the
plain version, :func:`repro_torch.kernels.ref.ssd_chunked_ref`, for CPU
tensors. Unlike the TPU kernel it takes an initial state ``h0`` and can
write the final state, so the serving prefill runs it too. S must be a
multiple of ``chunk``; :func:`repro_torch.kernels.ops.ssd` pads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (ptr, raise_on_error, stream_of,
                                         unsupported_device)
from repro_torch.kernels.ref import ssd_chunked_ref

# The shapes the kernel takes (csrc/ssd_scan.cu): a warp's 4 rows of a
# 32-row tile, 1-4 column blocks of 32 per lane, rows n = lane + 32 j.
CHUNKS = (32, 64, 128)
HEAD_DIMS = (32, 64)
MAX_STATE = 128
# A block's dynamic shared memory may not pass 227 KB.
MAX_SMEM_BYTES = 232_448


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Dynamic shared memory of one block (csrc/ssd_scan.cu smem_floats):
    C^T (N, L + 4), m^T (L, 36), x (L, P), B (L, N + 1), the state
    (N, P + 1) and four (L,) vectors."""
    return 4 * (n * (chunk + 4) + chunk * 36 + chunk * p + chunk * (n + 1)
                + n * (p + 1) + 4 * chunk)


def check_kernel_shape(chunk: int, n: int, p: int):
    """Raise for a (chunk, N, P) the kernel does not take."""
    if chunk not in CHUNKS or p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk in {CHUNKS}, P "
                         f"in {HEAD_DIMS} and N <= {MAX_STATE}; got chunk "
                         f"{chunk}, N {n}, P {p}")
    need = smem_bytes(chunk, n, p)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: (chunk, N, P) = ({chunk}, {n}, {p}) "
                         f"needs {need} B of shared memory per block, over "
                         f"{MAX_SMEM_BYTES}")


def _check_args(x, dt, a, bm, cm, h0, chunk):
    if x.ndim != 4:
        raise ValueError(f"ssd_scan: x must be (b, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bm.shape[-1]
    want = dict(x=(b, s, h, p), dt=(b, s, h), a=(h,), bm=(b, s, n),
                cm=(b, s, n))
    if h0 is not None:
        want["h0"] = (b, h, n, p)
    got = dict(x=x, dt=dt, a=a, bm=bm, cm=cm, h0=h0)
    for name, shape in want.items():
        t = got[name]
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {x.device}")
    if s % chunk:
        raise ValueError(f"ssd_scan: S={s} is not a multiple of the chunk "
                         f"{chunk} (ops.ssd pads)")


@functools.cache
def _lib():
    fn = _build.load("ssd_scan").ssd_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 128,
             h0: torch.Tensor | None = None, return_state: bool = False):
    """Chunked SSD over x (b, S, H, P), dt (b, S, H), a (H,), bm / cm
    (b, S, N), all float32, S a multiple of ``chunk``; ``h0`` (b, H, N, P)
    or None for zeros. Returns y (b, S, H, P), and the final state
    (b, H, N, P) with ``return_state``.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and count one launch in ``ssd_scan.launches``; CPU
    tensors run the plain version.
    """
    _check_args(x, dt, a, bm, cm, h0, chunk)
    if x.device.type == "cpu":
        y, h_final = ssd_chunked_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
        return (y, h_final) if return_state else y
    if x.device.type != "cuda":
        unsupported_device("ssd_scan", x.device)
    b, s, h, p = x.shape
    n = bm.shape[-1]
    check_kernel_shape(chunk, n, p)
    x, dt, a, bm, cm = (t.contiguous() for t in (x, dt, a, bm, cm))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(x)
    h_final = (torch.empty((b, h, n, p), dtype=torch.float32,
                           device=x.device) if return_state else None)
    with torch.cuda.device(x.device):
        code = _lib()(ptr(x), ptr(dt), ptr(a), ptr(bm), ptr(cm), ptr(h0),
                      ptr(y), ptr(h_final), b, s, h, p, n, chunk,
                      stream_of(x.device))
    raise_on_error("ssd_scan", code)
    ssd_scan.launches += 1
    return (y, h_final) if return_state else y


ssd_scan.launches = 0
