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
the 32-key tile. With ``return_lse=True`` it also returns each row's
log-sum-exp (BH, Sq), the statistics of the backward. Which key tiles
its blocks run is :func:`fwd_work_plan`.

``flash_attention_bwd`` is its gradient: ``csrc/flash_attention_bwd.cu``
(3xTF32 ``wgmma`` fed by TMA, three device kernels: a prepare pass, dK /
dV, dQ; a port of its own, the TPU kernel has no backward; which steps
its blocks run is :func:`bwd_work_plan`) for CUDA tensors, :func:`repro_torch.kernels.ref.flash_attention_bwd_ref` for CPU
tensors. It takes the forward's lse; without one it runs K5 once more
for it. :class:`FlashAttention` ties the two together
(:class:`FlashAttentionWithLse`, a ``torch.autograd.Function`` whose
forward has K5 write lse and whose backward is
:class:`FlashAttentionBwd`), with ``vmap`` rules that fold a vmapped axis
into BH, so ``torch.func.grad`` and ``torch.func.vmap(torch.func.grad(
...))`` run both kernels; the bare wrappers return tensors without a
gradient and, on the card, raise when grad mode is on and an input
requires one.

Both take the reference's two optional modes (``csrc/attention_modes.cuh``):
``kv_valid``, a (B, Sk) bool or uint8 mask of live keys with B dividing
BH, row-block ``bh`` reading row ``bh // (BH / B)`` (a row left with no
live key averages v over all Sk keys and has lse = +inf), and
``probs_bf16``, the reference's ``attn_probs_bf16`` (P and V rounded to
bfloat16, their product summed in float32). On ``meta`` tensors they
return empty outputs of the kernel's shapes and add the kernel's
operation count to :mod:`repro_torch.kernels.tally` (the dry run's
route); neither the kernel nor its plain version runs there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, tally
from repro_torch.kernels._launch import (aligned16, no_grad_input, ptr,
                                         raise_on_error, stream_of,
                                         unsupported_device)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_lse_ref)

# The shapes the kernel takes (csrc/flash_attention.cu): blocks of 128
# query rows (two wgmma warpgroups of 64), 32-key stages, head dims of
# whole 32-float swizzle atoms.
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_BLOCKS = (1 << 31) - 1  # the grid's x extent: BH x ceil(Sq / 128)
BLOCK_ROWS, K_TILE = 128, 32
# csrc/flash_attention_bwd.cu: 64 resident keys (dK / dV) or query rows
# (dQ) a block, 32 streamed rows a step; its scratch pads each head's rows
# to a multiple of 64
BWD_TILE, BWD_STEP = 64, 32
# A block's dynamic shared memory may not pass 227 KB.
MAX_SMEM_BYTES = 232_448


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block (csrc/flash_attention.cu
    ``Layout``): Q_lo (128, D) (Q_hi lives in registers), P hi and lo
    (128, 32), per stage (2 at D = 128, else 4) K hi and lo (32, D) and
    V^T hi and lo (D, 32), all float32; six mbarriers per stage (full
    and empty, of its K half, of its V half and of its V half holding a
    K tile in probs_bf16's lse pass), two (kv_valid word, key tile)
    slots per stage (its K half's and its V half's), the block's tile plan
    (16 bytes) and 1 KB to align the base for the 128-byte swizzle."""
    stages = 2 if d == 128 else 4
    return (4 * BLOCK_ROWS * d + 2 * 4 * BLOCK_ROWS * K_TILE
            + stages * 4 * 4 * K_TILE * d + 6 * 8 * stages + 2 * 8 * stages
            + 16 + 1024)


def bwd_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of either backward kernel
    (csrc/flash_attention_bwd.cu ``Layout``): the two warpgroups'
    resident lo tiles (64, D), per stage (2 at D = 128, else 4) the
    streamed tiles X0 and X1 hi and lo (32, D) and its rows' lse and
    delta, the P and dS exchange tiles hi and lo (64, 32), all float32;
    two mbarriers per stage and 1 KB to align the base for the 128-byte
    swizzle."""
    stages = 2 if d == 128 else 4
    return (2 * 4 * BWD_TILE * d + stages * (4 * 4 * BWD_STEP * d
                                            + 2 * 4 * BWD_STEP + 16)
            + 2 * 2 * 4 * BWD_TILE * BWD_STEP + 1024)


def bwd_padded(n: int) -> int:
    """Rows of a head in the backward's scratch: ``n`` rounded up to 64."""
    return -(-n // BWD_TILE) * BWD_TILE


def mode_work_floats(bh: int, sk: int, d: int, kv_group: int,
                     batches: int) -> int:
    """Scratch of the kv_valid mode, either direction: a float32 row of
    D per KV head (the forward's means of v, the backward's dead rows'
    dO sums) and the packed mask, a 32-bit word per 32 keys a batch
    row."""
    return bh // kv_group * d + batches * -(-sk // 32)


def fwd_work_floats(bh: int, sk: int, d: int, kv_group: int,
                    batches: int = 0) -> int:
    """K5's float32 scratch: K and V^T split into hi and lo (BH /
    kv_group heads of Sk padded to the 32-key tile); with a kv_valid mask
    of ``batches`` rows, :func:`mode_work_floats` and each row's first
    and last live key more."""
    return (4 * (bh // kv_group) * padded_keys(sk) * d
            + (mode_work_floats(bh, sk, d, kv_group, batches) + 2 * batches
               if batches else 0))


def bwd_work_floats(bh: int, sq: int, sk: int, d: int, kv_group: int,
                    batches: int = 0) -> int:
    """The backward's float32 scratch: q scale and dO split into hi and lo
    (BH padded query heads), K and V split (BH / kv_group padded key
    heads), delta and lse (the padded rows'); with a kv_valid mask of
    ``batches`` rows, :func:`mode_work_floats` and each row's first and
    last live key more."""
    qrows, krows = bh * bwd_padded(sq), bh // kv_group * bwd_padded(sk)
    return (4 * (qrows + krows) * d + 2 * qrows
            + (mode_work_floats(bh, sk, d, kv_group, batches) + 2 * batches
               if batches else 0))


def kv_bounds(kv_valid: torch.Tensor):
    """Each batch row's first and last live key, (B,) int64 each (Sk and
    -1 for a row with none): what the backward's ``kv_bounds`` pass
    (``csrc/attention_modes.cuh``) derives from the packed words."""
    kv = kv_valid.bool()
    sk = kv.shape[1]
    keys = torch.arange(sk, device=kv.device)
    first = torch.where(kv, keys, sk).amin(dim=1)
    last = torch.where(kv, keys, -1).amax(dim=1)
    return first, last


def fwd_work_plan(bh: int, sq: int, sk: int, kv_group: int, causal: bool,
                  window: int | None = None, kv_valid=None,
                  skip: bool = True):
    """The key tiles K5's blocks run (a twin of ``csrc/flash_attention.cu``'s
    ``block_work``, ``live_tiles`` and ``next_tile``): ``{(head, q0):
    [32-key tiles]}``, the block's 128 rows from q0, keys up to its last
    row (``causal``) from its first row's window; with ``kv_valid`` also
    within the batch row's first and last live key (:func:`kv_bounds`;
    none live, or rows all before the first, and the block runs no tile),
    without the tiles whose packed word is 0. ``skip=False`` runs every
    tile (the kernel's ``skip_tiles=False``). ``kv_group`` orders the
    blocks (KV head by KV head) and changes no block's tiles."""
    del kv_group
    win = window or 0
    kv = None if kv_valid is None else kv_valid.bool().cpu()
    hq = 1 if kv is None else bh // kv.shape[0]
    if kv is not None:
        first, last = (t.tolist() for t in kv_bounds(kv))
    plan = {}
    for h in range(bh):
        for q0 in range(0, sq, BLOCK_ROWS):
            lo, hi = 0, sk
            if skip:
                if causal:
                    hi = min(hi, min(q0 + BLOCK_ROWS, sq))
                if win > 0:
                    lo = max(lo, q0 - win + 1)
                if kv is not None:
                    lo = max(lo, first[h // hq])
                    hi = min(hi, last[h // hq] + 1)
            t0 = lo // K_TILE
            tiles = range(t0, -(-hi // K_TILE) if hi > lo else t0)
            if skip and kv is not None:
                row = kv[h // hq]
                tiles = [t for t in tiles
                         if bool(row[t * K_TILE:(t + 1) * K_TILE].any())]
            plan[h, q0] = list(tiles)
    return plan


def bwd_work_plan(bh: int, sq: int, sk: int, kv_group: int, causal: bool,
                  window: int | None = None, kv_valid=None,
                  skip: bool = True):
    """The steps the backward's blocks run (a twin of
    ``csrc/flash_attention_bwd.cu``'s ``kv_work`` and ``q_work``), as two
    dicts. (b) ``{(kv head, k0): range of 32-row query tiles}``, the
    block's 64 keys from k0 against those tiles of each of its kv_group
    heads: the rows from the block's first key (``causal``) to its last
    key's window; with ``kv_valid`` its live keys stand for its keys, and
    a block with none runs nothing. (c) ``{(head, q0): [32-key tiles]}``,
    the block's 64 rows from q0: keys up to its last row (``causal``) from
    its first row's window; with ``kv_valid`` also within the batch row's
    first and last live key (:func:`kv_bounds`), without the tiles whose
    packed word is 0. ``skip=False`` runs every step (the kernel's
    ``skip_tiles=False``)."""
    g = kv_group
    win = window or 0
    kv = None if kv_valid is None else kv_valid.bool().cpu()
    hq = 1 if kv is None else bh // kv.shape[0]
    if kv is not None:
        first, last = (t.tolist() for t in kv_bounds(kv))
    dkdv, dq = {}, {}
    for kvh in range(bh // g):
        for k0 in range(0, sk, BWD_TILE):
            lo, hi = 0, sq
            if skip:
                lo_key, hi_key = k0, min(k0 + BWD_TILE, sk) - 1
                if kv is not None:
                    live = kv[kvh * g // hq, k0:k0 + BWD_TILE].nonzero()
                    if not len(live):
                        dkdv[kvh, k0] = range(0)
                        continue
                    lo_key, hi_key = k0 + int(live[0]), k0 + int(live[-1])
                if causal:
                    lo = lo_key
                if win > 0:
                    hi = min(hi, hi_key + win)
            t0 = lo // BWD_STEP
            dkdv[kvh, k0] = range(t0, -(-hi // BWD_STEP) if hi > lo else t0)
    for h in range(bh):
        for q0 in range(0, sq, BWD_TILE):
            lo, hi = 0, sk
            if skip:
                if causal:
                    hi = min(hi, min(q0 + BWD_TILE, sq))
                if win > 0:
                    lo = max(lo, q0 - win + 1)
                if kv is not None:
                    lo = max(lo, first[h // hq])
                    hi = min(hi, last[h // hq] + 1)
            t0 = lo // BWD_STEP
            tiles = range(t0, -(-hi // BWD_STEP) if hi > lo else t0)
            if skip and kv is not None:
                row = kv[h // hq]
                tiles = [t for t in tiles
                         if bool(row[t * BWD_STEP:(t + 1) * BWD_STEP].any())]
            dq[h, q0] = list(tiles)
    return dkdv, dq


def check_bwd_shape(bh: int, d: int, sq: int = 1, sk: int = 1,
                    kv_group: int = 1):
    """Raise for a (BH, D, Sq, Sk, kv_group) the backward kernels do not
    take (beyond what K5, whose lse they read, does not take)."""
    check_kernel_shape(bh, d, sq, sk, kv_group)
    blocks = max(bh * -(-sq // BWD_TILE), bh // kv_group * -(-sk // BWD_TILE))
    if blocks > MAX_BLOCKS:
        raise ValueError(f"flash_attention_bwd: BH {bh} x S {max(sq, sk)} "
                         f"is over the grid's {MAX_BLOCKS} blocks of "
                         f"{BWD_TILE}")
    # the tensor maps' row coordinates are 32-bit
    if max(bh * bwd_padded(sq), bh // kv_group * bwd_padded(sk)) >= 1 << 31:
        raise ValueError(f"flash_attention_bwd: BH {bh} x Sq {sq} or "
                         f"{bh // kv_group} x Sk {sk} padded rows are over "
                         f"the tensor maps' 2^31 rows")
    need = bwd_smem_bytes(d)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"flash_attention_bwd: D = {d} needs {need} B of "
                         f"shared memory per block, over {MAX_SMEM_BYTES}")


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


def _check_kv_valid(kv_valid, q, sk):
    """``kv_valid`` as the kernels read it: (B, Sk) uint8 on q's device,
    contiguous, B dividing BH; and BH / B, the heads of a batch row."""
    bh = q.shape[0]
    if (kv_valid.ndim != 2 or kv_valid.shape[1] != sk
            or bh % kv_valid.shape[0] or kv_valid.device != q.device):
        raise ValueError(f"flash_attention_bhsd: kv_valid is "
                         f"{tuple(kv_valid.shape)} on {kv_valid.device}, "
                         f"want (B, {sk}) on {q.device} with B dividing BH "
                         f"{bh}")
    if kv_valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"flash_attention_bhsd: kv_valid must be bool or "
                        f"uint8, got {kv_valid.dtype}")
    return kv_valid.to(torch.uint8).contiguous(), bh // kv_valid.shape[0]


def _meta_outputs(q, sk, return_lse, causal, window):
    """K5 on ``meta``: empty o (and lse), its operations tallied."""
    bh, sq, d = q.shape
    tally.add("flash_attention_bhsd",
              tally.flash_flops(bh, sq, sk, d, causal, window))
    o = torch.empty_like(q)
    if not return_lse:
        return o
    return o, torch.empty((bh, sq), dtype=torch.float32, device=q.device)


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


# the C entries' ``modes`` flag (csrc/attention_modes.cuh kProbsBf16)
PROBS_BF16 = 2


@functools.cache
def _lib():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, causal, window, scale, kv_group, skip_tiles,
                lse=None, kv=None, hq=1, probs_bf16=False) -> torch.Tensor:
    """K5 on checked, aligned CUDA tensors; each row's log-sum-exp into
    ``lse`` (BH, Sq) float32 where given; ``kv`` the checked uint8 mask
    (``hq`` heads a row). Returns o."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    # K_hi, K_lo, V^T_hi, V^T_lo of the unexpanded heads, zero-padded keys;
    # with a mask, the means of v and the packed mask
    work = torch.empty(fwd_work_floats(bh, sk, d, kv_group,
                                       0 if kv is None else kv.shape[0]),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _lib()(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(work),
                      ptr(kv), bh, kv_group, sq, sk, d,
                      int(q.dtype == torch.bfloat16), hq, int(causal),
                      0 if window is None else int(window), scale,
                      int(skip_tiles), PROBS_BF16 if probs_bf16 else 0,
                      stream_of(q.device))
    raise_on_error("flash_attention_bhsd", code)
    return o


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None, kv_group: int = 1,
                         skip_tiles: bool = True, return_lse: bool = False,
                         kv_valid: torch.Tensor | None = None,
                         probs_bf16: bool = False):
    """Attention over q (BH, Sq, D), k / v (BH / kv_group, Sk, D), float32
    or bfloat16 (all one type), positions from 0 on both sides; query
    row-block ``bh`` attends to KV head ``bh // kv_group``; ``window``
    keeps keys ``k > q - window``; ``scale`` defaults to D^-0.5. Returns
    (BH, Sq, D) in q's type; with ``return_lse``, also each row's
    log-sum-exp of its scaled scores (BH, Sq) float32, which
    :func:`flash_attention_bwd` takes (o is the same bits either way).

    CUDA tensors launch the kernel (its prepare pass, then the attention
    kernel) on the current stream (no synchronisation) and count one
    launch in ``flash_attention_bhsd.launches``; CPU tensors run the plain
    version (and :func:`repro_torch.kernels.ref.flash_lse_ref`).
    ``skip_tiles=False`` makes the kernel run the key tiles that no row of
    a query tile can see (same result; for tests). ``kv_valid`` and
    ``probs_bf16`` are the modes of the module docstring.
    """
    _check_args(q, k, v, window, kv_group)
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    if q.device.type == "meta":
        return _meta_outputs(q, k.shape[1], return_lse, causal, window)
    if kv_valid is not None:
        kv_valid, hq = _check_kv_valid(kv_valid, q, k.shape[1])
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, scale=scale,
                  kv_group=kv_group, kv_valid=kv_valid)
        o = flash_attention_ref(q, k, v, probs_bf16=probs_bf16, **kw)
        return (o, flash_lse_ref(q, k, **kw)) if return_lse else o
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bhsd", q.device)
    no_grad_input("flash_attention_bhsd",
                  "ops.flash_attention (FlashAttention)", q, k, v)
    bh, sq, d = q.shape
    check_kernel_shape(bh, d, sq, k.shape[1], kv_group)
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    o = _launch_fwd(q, k, v, causal, window, scale, kv_group, skip_tiles,
                    lse, *((kv_valid, hq) if kv_valid is not None else ()),
                    probs_bf16=probs_bf16)
    flash_attention_bhsd.launches += 1
    _count_modes(flash_attention_bhsd, kv_valid, probs_bf16)
    return (o, lse) if return_lse else o


def _count_modes(wrapper, kv_valid, probs_bf16):
    """A launch in a mode also counts in ``wrapper.mode_launches``."""
    if kv_valid is not None:
        wrapper.mode_launches["kv_valid"] += 1
    if probs_bf16:
        wrapper.mode_launches["probs_bf16"] += 1


MODES = ("kv_valid", "probs_bf16")
flash_attention_bhsd.launches = 0
flash_attention_bhsd.mode_launches = dict.fromkeys(MODES, 0)


@functools.cache
def _bwd_lib():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# the backward's passes, as the C entry's ``only`` numbers them: the
# kv_valid mask's packing and bounds, dead_rows (both kv_valid only), the
# prepare pass, dK / dV (b) and dQ (c), which with probs_bf16 runs first
BWD_PASSES = ("mask", "dead_rows", "prepare", "dkdv", "dq")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None, kv_group: int = 1,
                        skip_tiles: bool = True,
                        lse: torch.Tensor | None = None,
                        kv_valid: torch.Tensor | None = None,
                        probs_bf16: bool = False):
    """The gradients (dq, dk, dv) of :func:`flash_attention_bhsd` at (q, k,
    v), given its output ``o`` and the output's gradient ``do`` (both
    (BH, Sq, D) in q's type); the arguments as the forward's; ``lse``
    (BH, Sq) float32 the forward's row statistics (``return_lse=True``).
    dk and dv hold BH / kv_group heads, each the sum over its query heads.

    CUDA tensors launch ``csrc/flash_attention_bwd.cu`` (a prepare pass,
    then dK and dV, then dQ: three device kernels; with ``probs_bf16`` dQ
    first, which also makes the delta dK and dV read) on the current
    stream and count one launch in ``flash_attention_bwd.launches``;
    without ``lse`` it first runs K5 for it (not counted as a K5 launch). CPU
    tensors run :func:`flash_attention_bwd_ref`. ``skip_tiles=False`` runs
    the steps whose pairs are all masked (same result; for tests).
    ``kv_valid`` and ``probs_bf16`` as the forward's (the module
    docstring), with ``lse`` from the forward in the same mode.
    """
    _check_args(q, k, v, window, kv_group)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want q's {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}")
    if lse is not None and (lse.dtype != torch.float32
                            or lse.shape != q.shape[:2]
                            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse is {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}, want "
                         f"{tuple(q.shape[:2])} float32 on {q.device}")
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.device.type == "meta":
        tally.add("flash_attention_bwd",
                  tally.flash_bwd_flops(bh, sq, sk, d, causal, window))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hq = 1
    if kv_valid is not None:
        kv_valid, hq = _check_kv_valid(kv_valid, q, sk)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window, scale=scale,
                                       kv_group=kv_group, lse=lse,
                                       kv_valid=kv_valid,
                                       probs_bf16=probs_bf16)
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bwd", q.device)
    no_grad_input("flash_attention_bwd",
                  "ops.flash_attention (FlashAttention)", q, k, v, o, do)
    out, launch = _bwd_call(q, k, v, o, do, causal, window, scale, kv_group,
                            skip_tiles, lse, kv_valid, hq, probs_bf16)
    launch(-1)
    flash_attention_bwd.launches += 1
    _count_modes(flash_attention_bwd, kv_valid, probs_bf16)
    return out


flash_attention_bwd.launches = 0
flash_attention_bwd.mode_launches = dict.fromkeys(MODES, 0)


def _bwd_call(q, k, v, o, do, causal, window, scale, kv_group, skip_tiles,
              lse, kv_valid, hq, probs_bf16):
    """(dq, dk, dv), empty, and ``launch(only)``: the backward into them on
    checked CUDA tensors (``only`` -1), or pass ``only`` of
    :data:`BWD_PASSES` alone on the scratch an earlier launch left."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    check_bwd_shape(bh, d, sq, sk, kv_group)
    q, k, v, o, do = (aligned16(t) for t in (q, k, v, o, do))
    if lse is None:
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        _launch_fwd(q, k, v, causal, window, scale, kv_group, skip_tiles, lse,
                    kv_valid, hq, probs_bf16)
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    batches = 0 if kv_valid is None else kv_valid.shape[0]
    work = torch.empty(bwd_work_floats(bh, sq, sk, d, kv_group, batches),
                       dtype=torch.float32, device=q.device)

    def launch(only):
        with torch.cuda.device(q.device):
            code = _bwd_lib()(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do),
                              ptr(lse), ptr(dq), ptr(dk), ptr(dv), ptr(work),
                              ptr(kv_valid), bh, kv_group, sq, sk, d,
                              int(q.dtype == torch.bfloat16), hq, int(causal),
                              0 if window is None else int(window), scale,
                              int(skip_tiles), PROBS_BF16 if probs_bf16 else 0,
                              only, stream_of(q.device))
        raise_on_error("flash_attention_bwd", code)
    return (dq, dk, dv), launch


def flash_attention_bwd_passes(q, k, v, o, do, *, causal: bool = True,
                               window: int | None = None,
                               scale: float | None = None, kv_group: int = 1,
                               lse: torch.Tensor, kv_valid=None,
                               probs_bf16: bool = False):
    """For timing each pass of the backward on its own (not a training
    entry): runs one whole call on CUDA tensors (not counted in
    ``flash_attention_bwd.launches``) and returns ``launch(k)``, which
    launches pass k of :data:`BWD_PASSES` alone on that call's scratch and
    outputs (a pass the call does not run launches nothing)."""
    _check_args(q, k, v, window, kv_group)
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bwd_passes", q.device)
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    hq = 1
    if kv_valid is not None:
        kv_valid, hq = _check_kv_valid(kv_valid, q, k.shape[1])
    _, launch = _bwd_call(q, k, v, o, do, causal, window, scale, kv_group,
                          True, lse, kv_valid, hq, probs_bf16)
    launch(-1)
    return launch


def _fold(info, in_dims, tensors):
    """Each tensor with its vmapped axis (``in_dims``; None: expanded to
    ``info.batch_size``) folded into its leading head axis: (m, n, S, D)
    -> (m n, S, D), batch row-blocks first."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = (t.expand(info.batch_size, *t.shape) if dim is None
             else t.movedim(dim, 0))
        out.append(t.reshape(-1, *t.shape[2:]))
    return out


def _unfold(info, t):
    return t.unflatten(0, (info.batch_size, -1))


def _fold_kv(info, dim, kv_valid):
    """A (B, Sk) mask, vmapped at ``dim`` or shared, as (m B, Sk): row m B
    + b serves row-blocks m BH + b (BH / B) .. of the folded q."""
    if kv_valid is None:
        return None
    return _fold(info, (dim,), (kv_valid,))[0]


class FlashAttentionWithLse(torch.autograd.Function):
    """K5 with its gradient: ``apply(q, k, v, causal, window, scale,
    kv_group, kv_valid, probs_bf16)`` is :func:`flash_attention_bhsd` with
    ``return_lse=True``, (o, lse), lse not differentiable; its backward is
    :class:`FlashAttentionBwd` on the saved lse (the backward kernel on
    the card, :func:`flash_attention_bwd_ref` on the CPU).

    The ``vmap`` rule folds the vmapped axis into BH: q (m, BH, S, D) ->
    (m BH, S, D), k and v (m, BH / g, S, D) -> (m BH / g, S, D), a mask
    (m, B, Sk) -> (m B, Sk), so row-block m BH + bh still reads KV head
    m BH / g + bh // g and mask row m B + bh // (BH / B), and one launch
    serves the whole batch."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, kv_group, kv_valid=None,
                probs_bf16=False):
        with torch.no_grad():
            return flash_attention_bhsd(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        kv_group=kv_group, return_lse=True,
                                        kv_valid=kv_valid,
                                        probs_bf16=probs_bf16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale, kv_group, *modes = inputs
        ctx.opts = (causal, window, scale, kv_group)
        kv_valid, ctx.probs_bf16 = (*modes, None, False)[:2]
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse, kv_valid)

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse, kv_valid = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBwd.apply(q, k, v, o, do, lse, *ctx.opts,
                                             kv_valid, ctx.probs_bf16)
        return dq, dk, dv, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, scale, kv_group,
             kv_valid=None, probs_bf16=False):
        q, k, v = _fold(info, in_dims[:3], (q, k, v))
        kv_valid = _fold_kv(info, in_dims[7] if len(in_dims) > 7 else None,
                            kv_valid)
        o, lse = FlashAttentionWithLse.apply(q, k, v, causal, window, scale,
                                             kv_group, kv_valid, probs_bf16)
        return (_unfold(info, o), _unfold(info, lse)), (0, 0)


class FlashAttention:
    """``FlashAttention.apply(q, k, v, causal, window, scale, kv_group,
    kv_valid=None, probs_bf16=False)``: the output o of
    :class:`FlashAttentionWithLse`, differentiable through K5's backward
    kernel."""

    @staticmethod
    def apply(q, k, v, causal, window, scale, kv_group, kv_valid=None,
              probs_bf16=False):
        return FlashAttentionWithLse.apply(q, k, v, causal, window, scale,
                                           kv_group, kv_valid,
                                           probs_bf16)[0]


class FlashAttentionBwd(torch.autograd.Function):
    """:func:`flash_attention_bwd` (given the forward's lse) as a
    Function, so that the backward of :class:`FlashAttentionWithLse` runs
    batched under ``vmap(grad(...))`` through its own ``vmap`` rule (the
    same fold). It has no gradient of its own."""

    @staticmethod
    def forward(q, k, v, o, do, lse, causal, window, scale, kv_group,
                kv_valid=None, probs_bf16=False):
        with torch.no_grad():
            return flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       window=window, scale=scale,
                                       kv_group=kv_group, lse=lse,
                                       kv_valid=kv_valid,
                                       probs_bf16=probs_bf16)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second derivative "
                                  "in the port")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, do, lse, causal, window, scale,
             kv_group, kv_valid=None, probs_bf16=False):
        q, k, v, o, do, lse = _fold(info, in_dims[:6], (q, k, v, o, do, lse))
        kv_valid = _fold_kv(info, in_dims[10] if len(in_dims) > 10 else None,
                            kv_valid)
        grads = FlashAttentionBwd.apply(q, k, v, o, do, lse, causal, window,
                                        scale, kv_group, kv_valid,
                                        probs_bf16)
        return tuple(_unfold(info, g) for g in grads), (0, 0, 0)
