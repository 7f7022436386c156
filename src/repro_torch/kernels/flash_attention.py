"""Flash attention kernel (replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``).

``flash_attention_bhsd`` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, for CPU tensors.
Inputs are flattened (BH, S, D) and already GQA-expanded
(``models/attention.py`` expands the KV heads). Unlike the TPU kernel it
does not pad: the ragged edges of Sq and Sk are bounds-checked in the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (ptr, raise_on_error, stream_of,
                                         unsupported_device)
from repro_torch.kernels.ref import flash_attention_ref

# The shapes the kernel takes (csrc/flash_attention.cu): a thread owns
# D / 16 output columns as float2 pairs, 64-row query and key tiles.
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BH = 65535  # the grid's y extent
TILE = 64
# A block's dynamic shared memory may not pass 227 KB.
MAX_SMEM_BYTES = 232_448


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu
    smem_floats): the query tile (64, D), the K tile (64, D + 4) or P^T
    (64, 68) over it, the V tile (64, D)."""
    return 4 * (TILE * d + TILE * max(d + 4, TILE + 4) + TILE * d)


def check_kernel_shape(bh: int, d: int):
    """Raise for a (BH, D) the kernel does not take."""
    if d not in HEAD_DIMS or bh > MAX_BH:
        raise ValueError(f"flash_attention_bhsd: the kernel takes D in "
                         f"{HEAD_DIMS} and BH <= {MAX_BH}; got D {d}, BH "
                         f"{bh}")
    need = smem_bytes(d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_bhsd: D = {d} needs {need} B of "
                         f"shared memory per block, over {MAX_SMEM_BYTES}")


def _check_args(q, k, v, window):
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"flash_attention_bhsd: q and k must be (BH, S, D), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bhsd: q must be one of {DTYPES}, "
                        f"got {q.dtype}")
    for name, t, shape in (("k", k, (bh, sk, d)), ("v", v, (bh, sk, d))):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bhsd: {name} is {t.dtype}, q "
                            f"is {q.dtype}")
        if tuple(t.shape) != shape or t.device != q.device:
            raise ValueError(f"flash_attention_bhsd: {name} is "
                             f"{tuple(t.shape)} on {t.device}, want {shape} "
                             f"on {q.device}")
    if min(bh, sq, sk, d) < 1:
        raise ValueError(f"flash_attention_bhsd: empty input, q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bhsd: window {window} < 1")
    if window is not None and sq >= sk + window:
        # row q sees keys (q - window, q]: none below Sk once q >= Sk - 1 +
        # window, and such a row's output would depend on the tile skip
        raise ValueError(f"flash_attention_bhsd: with Sq {sq} >= Sk {sk} + "
                         f"window {window} a query row sees no key")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on a 16-byte boundary (the kernel's
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _lib():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None,
                         skip_tiles: bool = True) -> torch.Tensor:
    """Attention over q (BH, Sq, D), k / v (BH, Sk, D), float32 or
    bfloat16 (all one type), positions from 0 on both sides; ``window``
    keeps keys ``k > q - window``; ``scale`` defaults to D^-0.5. Returns
    (BH, Sq, D) in q's type.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and count one launch in
    ``flash_attention_bhsd.launches``; CPU tensors run the plain version.
    ``skip_tiles=False`` makes the kernel run the key tiles that no row of
    a query tile can see (same result; for tests).
    """
    _check_args(q, k, v, window)
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bhsd", q.device)
    bh, sq, d = q.shape
    check_kernel_shape(bh, d)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _lib()(ptr(q), ptr(k), ptr(v), ptr(o), bh, sq, k.shape[1], d,
                      int(q.dtype == torch.bfloat16), int(causal),
                      0 if window is None else int(window), scale,
                      int(skip_tiles), stream_of(q.device))
    raise_on_error("flash_attention_bhsd", code)
    flash_attention_bhsd.launches += 1
    return o


flash_attention_bhsd.launches = 0
