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
log-sum-exp (BH, Sq), the statistics of the backward.

``flash_attention_bwd`` is its gradient: ``csrc/flash_attention_bwd.cu``
(3xTF32 ``wgmma`` fed by TMA, three device kernels: a prepare pass, dK /
dV, dQ; a port of its own, the TPU kernel has no backward) for CUDA
tensors, :func:`repro_torch.kernels.ref.flash_attention_bwd_ref` for CPU
tensors. It takes the forward's lse; without one it runs K5 once more
for it. :class:`FlashAttention` ties the two together
(:class:`FlashAttentionWithLse`, a ``torch.autograd.Function`` whose
forward has K5 write lse and whose backward is
:class:`FlashAttentionBwd`), with ``vmap`` rules that fold a vmapped axis
into BH, so ``torch.func.grad`` and ``torch.func.vmap(torch.func.grad(
...))`` run both kernels; the bare wrappers return tensors without a
gradient and, on the card, raise when grad mode is on and an input
requires one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (ptr, raise_on_error, stream_of,
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
    V^T hi and lo (D, 32), all float32; four mbarriers per stage (full
    and empty, of its K half and of its V half) and 1 KB to align the
    base for the 128-byte swizzle."""
    stages = 2 if d == 128 else 4
    return (4 * BLOCK_ROWS * d + 2 * 4 * BLOCK_ROWS * K_TILE
            + stages * 4 * 4 * K_TILE * d + 4 * 8 * stages + 1024)


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


def bwd_work_floats(bh: int, sq: int, sk: int, d: int, kv_group: int) -> int:
    """The backward's float32 scratch: q scale and dO split into hi and lo
    (BH padded query heads), K and V split (BH / kv_group padded key
    heads), delta and lse (the padded rows')."""
    qrows, krows = bh * bwd_padded(sq), bh // kv_group * bwd_padded(sk)
    return 4 * (qrows + krows) * d + 2 * qrows


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


def _no_grad_input(kernel: str, *tensors):
    """Raise where grad mode is on and an input requires a gradient: the
    kernel's output would carry none, and the gradient upstream would be
    cut without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: an input requires a gradient, which "
                           "the bare kernel would cut; differentiate "
                           "through ops.flash_attention (FlashAttention)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on a 16-byte boundary (the kernel's
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.cache
def _lib():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(q, k, v, causal, window, scale, kv_group, skip_tiles,
                lse=None) -> torch.Tensor:
    """K5 on checked, aligned CUDA tensors; each row's log-sum-exp into
    ``lse`` (BH, Sq) float32 where given. Returns o."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    # K_hi, K_lo, V^T_hi, V^T_lo of the unexpanded heads, zero-padded keys
    work = torch.empty(4 * k.shape[0] * padded_keys(sk) * d,
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _lib()(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(work),
                      bh, kv_group, sq, sk, d, int(q.dtype == torch.bfloat16),
                      int(causal), 0 if window is None else int(window),
                      scale, int(skip_tiles), stream_of(q.device))
    raise_on_error("flash_attention_bhsd", code)
    return o


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None, kv_group: int = 1,
                         skip_tiles: bool = True, return_lse: bool = False):
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
    a query tile can see (same result; for tests).
    """
    _check_args(q, k, v, window, kv_group)
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, scale=scale,
                  kv_group=kv_group)
        o = flash_attention_ref(q, k, v, **kw)
        return (o, flash_lse_ref(q, k, **kw)) if return_lse else o
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bhsd", q.device)
    _no_grad_input("flash_attention_bhsd", q, k, v)
    bh, sq, d = q.shape
    check_kernel_shape(bh, d, sq, k.shape[1], kv_group)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    o = _launch_fwd(q, k, v, causal, window, scale, kv_group, skip_tiles,
                    lse)
    flash_attention_bhsd.launches += 1
    return (o, lse) if return_lse else o


flash_attention_bhsd.launches = 0


@functools.cache
def _bwd_lib():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None, kv_group: int = 1,
                        skip_tiles: bool = True,
                        lse: torch.Tensor | None = None):
    """The gradients (dq, dk, dv) of :func:`flash_attention_bhsd` at (q, k,
    v), given its output ``o`` and the output's gradient ``do`` (both
    (BH, Sq, D) in q's type); the arguments as the forward's; ``lse``
    (BH, Sq) float32 the forward's row statistics (``return_lse=True``).
    dk and dv hold BH / kv_group heads, each the sum over its query heads.

    CUDA tensors launch ``csrc/flash_attention_bwd.cu`` (a prepare pass,
    then dK and dV, then dQ: three device kernels) on the current stream
    and count one launch in ``flash_attention_bwd.launches``; without
    ``lse`` it first runs K5 for it (not counted as a K5 launch). CPU
    tensors run :func:`flash_attention_bwd_ref`. ``skip_tiles=False`` runs
    the steps whose pairs are all masked (same result; for tests).
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
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window, scale=scale,
                                       kv_group=kv_group, lse=lse)
    if q.device.type != "cuda":
        unsupported_device("flash_attention_bwd", q.device)
    _no_grad_input("flash_attention_bwd", q, k, v, o, do)
    bh, sq, d = q.shape
    sk = k.shape[1]
    check_bwd_shape(bh, d, sq, sk, kv_group)
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    if lse is None:
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        _launch_fwd(q, k, v, causal, window, scale, kv_group, skip_tiles, lse)
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    work = torch.empty(bwd_work_floats(bh, sq, sk, d, kv_group),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _bwd_lib()(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse),
                          ptr(dq), ptr(dk), ptr(dv), ptr(work), bh, kv_group,
                          sq, sk, d, int(q.dtype == torch.bfloat16),
                          int(causal), 0 if window is None else int(window),
                          scale, int(skip_tiles), stream_of(q.device))
    raise_on_error("flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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


class FlashAttentionWithLse(torch.autograd.Function):
    """K5 with its gradient: ``apply(q, k, v, causal, window, scale,
    kv_group)`` is :func:`flash_attention_bhsd` with ``return_lse=True``,
    (o, lse), lse not differentiable; its backward is
    :class:`FlashAttentionBwd` on the saved lse (the backward kernel on
    the card, :func:`flash_attention_bwd_ref` on the CPU).

    The ``vmap`` rule folds the vmapped axis into BH: q (m, BH, S, D) ->
    (m BH, S, D), k and v (m, BH / g, S, D) -> (m BH / g, S, D), so
    row-block m BH + bh still reads KV head m BH / g + bh // g, and one
    launch serves the whole batch."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, kv_group):
        with torch.no_grad():
            return flash_attention_bhsd(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        kv_group=kv_group, return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *ctx.opts = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBwd.apply(q, k, v, o, do, lse, *ctx.opts)
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, *opts):
        q, k, v = _fold(info, in_dims[:3], (q, k, v))
        o, lse = FlashAttentionWithLse.apply(q, k, v, *opts)
        return (_unfold(info, o), _unfold(info, lse)), (0, 0)


class FlashAttention:
    """``FlashAttention.apply(q, k, v, causal, window, scale, kv_group)``:
    the output o of :class:`FlashAttentionWithLse`, differentiable through
    K5's backward kernel."""

    @staticmethod
    def apply(q, k, v, causal, window, scale, kv_group):
        return FlashAttentionWithLse.apply(q, k, v, causal, window, scale,
                                           kv_group)[0]


class FlashAttentionBwd(torch.autograd.Function):
    """:func:`flash_attention_bwd` (given the forward's lse) as a
    Function, so that the backward of :class:`FlashAttentionWithLse` runs
    batched under ``vmap(grad(...))`` through its own ``vmap`` rule (the
    same fold). It has no gradient of its own."""

    @staticmethod
    def forward(q, k, v, o, do, lse, causal, window, scale, kv_group):
        with torch.no_grad():
            return flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       window=window, scale=scale,
                                       kv_group=kv_group, lse=lse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second derivative "
                                  "in the port")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, do, lse, *opts):
        q, k, v, o, do, lse = _fold(info, in_dims[:6], (q, k, v, o, do, lse))
        grads = FlashAttentionBwd.apply(q, k, v, o, do, lse, *opts)
        return tuple(_unfold(info, g) for g in grads), (0, 0, 0)
