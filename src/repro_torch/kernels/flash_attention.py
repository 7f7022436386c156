"""Flash attention kernel (replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_bhsd``).

``flash_attention_bhsd`` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs the plain version,
:func:`repro_torch.kernels.ref.flash_attention_ref`, for CPU tensors.
Inputs are flattened (BH, S, D); k and v hold BH / ``kv_group`` heads,
and query row-block ``bh`` reads KV head ``bh // kv_group`` (GQA's shared
KV head, the grouping of ``repeat_interleave``; ``kv_group=1`` is the TPU
kernel's contract). Unlike the TPU kernel it does not pad q or o: the
kernel bounds-checks the ragged edge of Sq, and its prepare pass writes
the split K and V^T into scratch padded with zero keys to a multiple of
the 32-key tile.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (ptr, raise_on_error, stream_of,
                                         unsupported_device)
from repro_torch.kernels.ref import flash_attention_ref

# The shapes the kernel takes (csrc/flash_attention.cu): blocks of 128
# query rows (two wgmma warpgroups of 64), 32-key stages, head dims of
# whole 32-float swizzle atoms.
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCKS = (1 << 31) - 1  # the grid's x extent: BH x ceil(Sq / 128)
BLOCK_ROWS, K_TILE = 128, 32
# A block's dynamic shared memory may not pass 227 KB.
MAX_SMEM_BYTES = 232_448


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu
    ``Layout``): Q_lo (128, D) (Q_hi lives in registers), P hi and lo
    (128, 32), per stage (2 at D = 128, else 4) K hi and lo (32, D) and
    V^T hi and lo (D, 32), all float32; four mbarriers per stage (full
    and empty, of its K half and of its V half) and 1 KB to align the
    base for the 128-byte swizzle."""
    stages = 2 if d == 128 else 4
    return (4 * BLOCK_ROWS * d + 2 * 4 * BLOCK_ROWS * K_TILE
            + stages * 4 * 4 * K_TILE * d + 4 * 8 * stages + 1024)


def padded_keys(sk: int) -> int:
    """Sk rounded up to the 32-key tile (the prepare pass's scratch)."""
    return -(-sk // K_TILE) * K_TILE


def check_kernel_shape(bh: int, d: int, sq: int = 1, sk: int = 1,
                       kv_group: int = 1):
    """Raise for a (BH, D, Sq, Sk, kv_group) the kernel does not take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bhsd: the kernel takes D in "
                         f"{HEAD_DIMS}, got {d}")
    if bh * -(-sq // BLOCK_ROWS) > MAX_BLOCKS:
        raise ValueError(f"flash_attention_bhsd: BH {bh} x Sq {sq} is over "
                         f"the grid's {MAX_BLOCKS} blocks of {BLOCK_ROWS} "
                         f"rows")
    # the tensor maps' row coordinates are 32-bit
    if (bh // kv_group) * max(padded_keys(sk), d) >= 1 << 31:
        raise ValueError(f"flash_attention_bhsd: {bh // kv_group} KV heads "
                         f"of {sk} keys are over the tensor maps' 2^31 rows")
    need = smem_bytes(d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_bhsd: D = {d} needs {need} B of "
                         f"shared memory per block, over {MAX_SMEM_BYTES}")


def _check_args(q, k, v, window, kv_group):
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"flash_attention_bhsd: q and k must be (BH, S, D), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bhsd: q must be one of {DTYPES}, "
                        f"got {q.dtype}")
    if kv_group < 1 or bh % kv_group:
        raise ValueError(f"flash_attention_bhsd: BH {bh} is not a multiple "
                         f"of kv_group {kv_group}")
    kv_shape = (bh // kv_group, sk, d)
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bhsd: {name} is {t.dtype}, q "
                            f"is {q.dtype}")
        if tuple(t.shape) != kv_shape or t.device != q.device:
            raise ValueError(f"flash_attention_bhsd: {name} is "
                             f"{tuple(t.shape)} on {t.device}, want "
                             f"{kv_shape} (BH / kv_group heads) on "
                             f"{q.device}")
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None, kv_group: int = 1,
                         skip_tiles: bool = True) -> torch.Tensor:
    """Attention over q (BH, Sq, D), k / v (BH / kv_group, Sk, D), float32
    or bfloat16 (all one type), positions from 0 on both sides; query
    row-block ``bh`` attends to KV head ``bh // kv_group``; ``window``
    keeps keys ``k > q - window``; ``scale`` defaults to D^-0.5. Returns
    (BH, Sq, D) in q's type.

    CUDA tensors launch the kernel (its prepare pass, then the attention
    kernel) on the current stream (no synchronisation) and count one
    launch in ``flash_attention_bhsd.launches``; CPU tensors run the plain
    version. ``skip_tiles=False`` makes the kernel run the key tiles that
    no row of a query tile can see (same result; for tests).
    """
    _check_args(q, k, v, window, kv_group)
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, kv_group=kv_group)
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bhsd", q.device)
    bh, sq, d = q.shape
    sk = k.shape[1]
    check_kernel_shape(bh, d, sq, sk, kv_group)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    # K_hi, K_lo, V^T_hi, V^T_lo of the unexpanded heads, zero-padded keys
    work = torch.empty(4 * k.shape[0] * padded_keys(sk) * d,
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _lib()(ptr(q), ptr(k), ptr(v), ptr(o), ptr(work), bh,
                      kv_group, sq, sk, d, int(q.dtype == torch.bfloat16),
                      int(causal), 0 if window is None else int(window),
                      scale, int(skip_tiles), stream_of(q.device))
    raise_on_error("flash_attention_bhsd", code)
    flash_attention_bhsd.launches += 1
    return o


flash_attention_bhsd.launches = 0
