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

# The shapes the kernel takes (csrc/ssd_scan.cu): wgmma tiles of 64 rows
# over K slabs of 32, P and the chunk padded to 64 rows, N to 32, 64 or 128
# state columns.
CHUNKS = (32, 64, 128)
HEAD_DIMS = (32, 64)
MAX_STATE = 128
# A block's dynamic shared memory may not pass 227 KB.
MAX_SMEM_BYTES = 232_448


def state_cols(n: int) -> int:
    """N rounded up to 32, 64 or 128: the state's columns in the kernel's
    tiles and scratch (zeros past N)."""
    return 32 if n <= 32 else 64 if n <= 64 else 128


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Dynamic shared memory of the largest block of the four passes
    (csrc/ssd_scan.cu block_smem): two operand buffers, each a K slab's
    64-row A tile and nb-row B tile, rows of 128 bytes, in hi and lo, plus
    1 KB for alignment; nb is the state's columns (pass 1), the chunk (pass
    3) or P (pass 4, which adds two 16 KB stages of raw sources)."""
    def block(nb):
        return 2 * (2 * 64 * 128 + 2 * nb * 128) + 1024
    return max(block(max(state_cols(n), chunk)), block(p) + 2 * 16384)


def work_floats(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """float32 scratch of one call (csrc/ssd_scan.cu ssd_scan_f32): lc
    (b, H, S), the chunk states (b, S / chunk, H, P, state_cols(N)) and
    C B^T (b, S / chunk, chunk, chunk)."""
    nc = s // chunk
    return b * h * s + b * nc * h * p * state_cols(n) + b * nc * chunk * chunk


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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
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

    CUDA tensors launch the kernel's four passes on the current stream (no
    synchronisation) and count one launch in ``ssd_scan.launches``; with
    grad mode on and an input requiring a gradient they raise
    ``NotImplementedError`` (the kernel has no backward yet, ROADMAP §A
    item 13). CPU tensors run the plain version, which autograd
    differentiates.
    """
    _check_args(x, dt, a, bm, cm, h0, chunk)
    if x.device.type == "cpu":
        y, h_final = ssd_chunked_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
        return (y, h_final) if return_state else y
    if x.device.type != "cuda":
        unsupported_device("ssd_scan", x.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, a, bm, cm, h0)):
        raise NotImplementedError(
            "ssd_scan: the SSD scan kernel (K4) has no backward kernel yet "
            "(ROADMAP §A item 13), so Mamba layers do not train on the card")
    b, s, h, p = x.shape
    n = bm.shape[-1]
    check_kernel_shape(chunk, n, p)
    x, dt, a, bm, cm = (t.contiguous() for t in (x, dt, a, bm, cm))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty_like(x)
    h_final = (torch.empty((b, h, n, p), dtype=torch.float32,
                           device=x.device) if return_state else None)
    work = torch.empty(work_floats(b, s, h, p, n, chunk), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        code = _lib()(ptr(x), ptr(dt), ptr(a), ptr(bm), ptr(cm), ptr(h0),
                      ptr(y), ptr(h_final), ptr(work), b, s, h, p, n, chunk,
                      stream_of(x.device))
    raise_on_error("ssd_scan", code)
    ssd_scan.launches += 1
    return (y, h_final) if return_state else y


ssd_scan.launches = 0
