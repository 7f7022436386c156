"""Chunked SSD scan kernel (replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``) and its backward.

``ssd_scan`` launches ``csrc/ssd_scan.cu`` for CUDA tensors and runs the
plain version, :func:`repro_torch.kernels.ref.ssd_chunked_ref`, for CPU
tensors. Unlike the TPU kernel it takes an initial state ``h0`` and can
write the final state, so the serving prefill runs it too. S must be a
multiple of ``chunk``; :func:`repro_torch.kernels.ops.ssd` pads.

``ssd_scan_bwd`` is its gradient: ``csrc/ssd_scan_bwd.cu`` for CUDA
tensors (a kernel of the port's own: the TPU kernel has no backward),
:func:`repro_torch.kernels.ref.ssd_scan_bwd_ref` for CPU tensors.
:class:`SsdScan` joins the two as a ``torch.autograd.Function`` with
``vmap`` rules, the route ``ops.ssd`` takes; the bare ``ssd_scan`` on the
card refuses inputs that require a gradient.

``a`` is (H,) or (R, H) with R dividing the batch b: batch element i
reads row i // (b / R) (the ``vmap`` rules fold the samples, each with its
own a, into the batch).

On ``meta`` tensors (the dry run) both return empty outputs of the
kernel's shapes (the forward's saved scratch included) and add the
kernel's operation count to :mod:`repro_torch.kernels.tally`; neither the
kernel nor its plain version runs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, tally
from repro_torch.kernels._launch import (aligned16, no_grad_input, ptr,
                                         raise_on_error, stream_of,
                                         unsupported_device)
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_bwd_ref

# The shapes the kernel takes (csrc/ssd_scan.cu): wgmma tiles of 64 rows
# over K slabs of 32, P and the chunk padded to 64 rows, N to 32, 64 or 128
# state columns.
CHUNKS = (32, 64, 128)
HEAD_DIMS = (32, 64)
MAX_STATE = 128
# A block's dynamic shared memory may not pass 227 KB.
MAX_SMEM_BYTES = 232_448
# The backward's layout (csrc/ssd_scan_bwd.cu): the chunk pass's 8 warps
# as 2 x 4 tiles, K in slabs of 32; the GEMM passes' 64-row tiles of at
# most 128 columns. A chunk-pass block takes a group of heads: the most,
# up to BWD_MAX_GROUP, dividing H that leave BWD_MIN_BLOCKS blocks (three
# waves of the card's 132 SMs, one block an SM).
BWD_WARPS, BWD_SLAB, BWD_ROWS, BWD_COLS = (2, 4), 32, 64, 128
BWD_MAX_GROUP, BWD_MIN_BLOCKS = 8, 3 * 132
# The backward's device kernels, in launch order (``only`` of the C entry)
BWD_PASSES = ("ssd_bwd_gemm<V>", "ssd_bwd_state_pass",
              "ssd_bwd_gemm<UY>", "ssd_bwd_chunk", "ssd_bwd_reduce_cb",
              "ssd_bwd_gemm<BC>", "ssd_bwd_reduce_a")


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


def saved_shapes(b: int, s: int, h: int, p: int, n: int,
                 chunk: int) -> tuple:
    """The forward's scratch, which the backward reads: lc (b, H, S), the
    states entering each chunk (b, S / chunk, H, P, state_cols(N)) and
    C B^T (b, S / chunk, chunk, chunk)."""
    nc = s // chunk
    return ((b, h, s), (b, nc, h, p, state_cols(n)), (b, nc, chunk, chunk))


def bwd_head_group(b: int, s: int, h: int, chunk: int) -> int:
    """Heads a chunk-pass block of the backward takes (``hg`` of
    csrc/ssd_scan_bwd.cu): the largest divisor of H up to BWD_MAX_GROUP
    that leaves b (S / chunk) (H / hg) >= BWD_MIN_BLOCKS blocks, else 1."""
    for hg in range(min(h, BWD_MAX_GROUP), 0, -1):
        if h % hg == 0 and b * (s // chunk) * (h // hg) >= BWD_MIN_BLOCKS:
            return hg
    return 1


def bwd_gemm_smem_bytes(cols: int = BWD_COLS) -> int:
    """Dynamic shared memory of a backward GEMM block of ``cols`` columns
    (passes 0, 2 and 5): its operand buffer (a 32-deep slab of the 64-row A
    tile and the cols-row B tile, rows of 128 bytes, in hi and lo), two raw
    stages (8 KB of A, 32 x cols floats of B) and 1 KB for alignment; 512
    bytes of static shared memory besides."""
    rows = BWD_ROWS
    return (2 * rows * 128 + 2 * cols * 128
            + 2 * (rows * BWD_SLAB * 4 + cols * 128) + 1024)


def bwd_smem_bytes(chunk: int, n: int, p: int) -> int:
    """Dynamic shared memory of the backward's largest block
    (csrc/ssd_scan_bwd.cu): pass 3's C B^T (L rows of L + 8), two head
    buffers of dy and x (L rows of P + 4 each, the mma.sync fragment
    loads' padding), lc and dt, eight arrays of L, 4 + 4 + 2 + 2 rows of L
    of partial sums and 32 floats; the GEMM passes
    :func:`bwd_gemm_smem_bytes` at most."""
    lo = chunk
    wr, wc = BWD_WARPS
    head = 2 * lo * (p + 4) + 2 * lo
    pass3 = lo * (lo + 8) + 2 * head + 8 * lo + 2 * wc * lo + 2 * wr * lo + 32
    return max(4 * pass3, bwd_gemm_smem_bytes())


def bwd_work_floats(b: int, s: int, h: int, p: int, n: int, chunk: int,
                    hg: int | None = None) -> int:
    """float32 scratch of one backward call: dS (b, S / chunk, H, P,
    state_cols(N)); U = B dS^T and Y = C S^T (b, S, H, P) each; the head
    groups' dCB (b, S / chunk, H / hg, chunk, chunk) and their sum (b, S /
    chunk, chunk, chunk); the chunks' shares of da (b, S / chunk, H). hg:
    the head group, :func:`bwd_head_group`'s by default."""
    nc = s // chunk
    groups = h // (hg or bwd_head_group(b, s, h, chunk))
    return (b * nc * h * p * state_cols(n) + 2 * b * s * h * p
            + b * nc * (groups + 1) * chunk * chunk + b * nc * h)


def check_kernel_shape(chunk: int, n: int, p: int):
    """Raise for a (chunk, N, P) the kernels (forward and backward) do not
    take."""
    if chunk not in CHUNKS or p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk in {CHUNKS}, P "
                         f"in {HEAD_DIMS} and N <= {MAX_STATE}; got chunk "
                         f"{chunk}, N {n}, P {p}")
    need = max(smem_bytes(chunk, n, p), bwd_smem_bytes(chunk, n, p))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: (chunk, N, P) = ({chunk}, {n}, {p}) "
                         f"needs {need} B of shared memory per block, over "
                         f"{MAX_SMEM_BYTES}")


def a_group(a: torch.Tensor, b: int) -> int:
    """Batch elements per row of ``a``: b for a (H,), b / R for (R, H)."""
    return b if a.ndim == 1 else b // a.shape[0]


def _check_args(kernel, x, dt, a, bm, cm, h0, chunk, **more):
    if x.ndim != 4:
        raise ValueError(f"{kernel}: x must be (b, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if a.ndim == 2 and a.shape[0] >= 1 and b % a.shape[0] == 0:
        a_shape = (a.shape[0], h)
    else:
        a_shape = (h,)
    want = dict(x=(b, s, h, p), dt=(b, s, h), a=a_shape, bm=(b, s, n),
                cm=(b, s, n), h0=(b, h, n, p), dy=(b, s, h, p),
                dh=(b, h, n, p))
    got = dict(x=x, dt=dt, a=a, bm=bm, cm=cm, h0=h0, **more)
    for name, t in got.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != want[name] or t.device != x.device:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} on "
                             f"{t.device}, want {want[name]} on {x.device} "
                             "(a may be (H,) or (R, H), R dividing b)")
    if s % chunk:
        raise ValueError(f"{kernel}: S={s} is not a multiple of the chunk "
                         f"{chunk} (ops.ssd pads)")


@functools.cache
def _lib():
    fn = _build.load("ssd_scan").ssd_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_fwd(x, dt, a, bm, cm, h0, chunk):
    """K4 on checked CUDA tensors: (y, h_final, lc, states, cb), the last
    three the scratch the backward reads (:func:`saved_shapes`)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    check_kernel_shape(chunk, n, p)
    x, dt, a, bm, cm = (aligned16(t) for t in (x, dt, a, bm, cm))
    h0 = None if h0 is None else aligned16(h0)
    y = torch.empty_like(x)
    h_final = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    lc, states, cb = (torch.empty(sh, dtype=torch.float32, device=x.device)
                      for sh in saved_shapes(b, s, h, p, n, chunk))
    with torch.cuda.device(x.device):
        code = _lib()(ptr(x), ptr(dt), ptr(a), a_group(a, b), ptr(bm),
                      ptr(cm), ptr(h0), ptr(y), ptr(h_final), ptr(lc),
                      ptr(states), ptr(cb), b, s, h, p, n, chunk,
                      stream_of(x.device))
    raise_on_error("ssd_scan", code)
    return y, h_final, lc, states, cb


def _forward(x, dt, a, bm, cm, h0, chunk):
    """(y, h_final, lc, states, cb): K4 for CUDA tensors (one launch
    counted), the plain version for CPU tensors (the saved scratch empty,
    (b, 0) each: the plain backward recomputes it)."""
    if x.device.type == "cpu":
        y, h_final = ssd_chunked_ref(x, dt, a, bm, cm, chunk=chunk, h0=h0)
        empty = x.new_empty((x.shape[0], 0))
        return y, h_final, empty, empty.clone(), empty.clone()
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if x.device.type == "meta":
        tally.add("ssd_scan", tally.ssd_flops(b, s, h, p, n, chunk))
        return (torch.empty_like(x), x.new_empty((b, h, n, p)),
                *(x.new_empty(sh) for sh in saved_shapes(b, s, h, p, n,
                                                         chunk)))
    if x.device.type != "cuda":
        unsupported_device("ssd_scan", x.device)
    out = _launch_fwd(x, dt, a, bm, cm, h0, chunk)
    ssd_scan.launches += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 128,
             h0: torch.Tensor | None = None, return_state: bool = False):
    """Chunked SSD over x (b, S, H, P), dt (b, S, H), a (H,) or (R, H),
    bm / cm (b, S, N), all float32, S a multiple of ``chunk``; ``h0`` (b,
    H, N, P) or None for zeros. Returns y (b, S, H, P), and the final
    state (b, H, N, P) with ``return_state``.

    CUDA tensors launch the kernel's four passes on the current stream (no
    synchronisation) and count one launch in ``ssd_scan.launches``; with
    grad mode on and an input requiring a gradient they raise
    ``RuntimeError`` (the bare kernel would cut the gradient: differentiate
    through ``ops.ssd``, :class:`SsdScan`). CPU tensors run the plain
    version, which autograd differentiates.
    """
    _check_args("ssd_scan", x, dt, a, bm, cm, h0, chunk)
    if x.device.type == "cuda":
        no_grad_input("ssd_scan", "ops.ssd (SsdScan)", x, dt, a, bm, cm, h0)
    y, h_final, *_ = _forward(x, dt, a, bm, cm, h0, chunk)
    return (y, h_final) if return_state else y


ssd_scan.launches = 0


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int = 128, h0: torch.Tensor | None = None,
                 dh: torch.Tensor | None = None, saved=None):
    """The gradients (dx, ddt, da, dbm, dcm, dh0) of :func:`ssd_scan`'s (y,
    final state) at (x, dt, a, bm, cm, h0), given dy (b, S, H, P) and dh
    (b, H, N, P) or None for 0. da has a's shape; dh0 is (b, H, N, P), the
    gradient of a zero initial state where ``h0`` is None. ``saved`` is
    the forward's (lc, states, cb) (:class:`SsdScan` keeps them).

    CUDA tensors launch ``csrc/ssd_scan_bwd.cu`` (seven device kernels) on
    the current stream and count one launch in ``ssd_scan_bwd.launches``;
    without ``saved`` it first runs K4 for them (not counted as a K4
    launch). CPU tensors run :func:`ssd_scan_bwd_ref` (``saved`` unused).
    """
    _check_args("ssd_scan_bwd", x, dt, a, bm, cm, h0, chunk, dy=dy, dh=dh)
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk=chunk, h0=h0,
                                dh=dh)
    if x.device.type == "meta":
        b, s, h, p = x.shape
        tally.add("ssd_scan_bwd",
                  tally.ssd_bwd_flops(b, s, h, p, bm.shape[-1], chunk))
        return (*(torch.empty_like(t) for t in (x, dt, a, bm, cm)),
                x.new_empty((b, h, bm.shape[-1], p)))
    if x.device.type != "cuda":
        unsupported_device("ssd_scan_bwd", x.device)
    no_grad_input("ssd_scan_bwd", "ops.ssd (SsdScan)", x, dt, a, bm, cm, h0,
                  dy, dh)
    check_kernel_shape(chunk, bm.shape[-1], x.shape[-1])
    if saved is None:
        saved = _launch_fwd(x, dt, a, bm, cm, h0, chunk)[2:]
    out, launch = _bwd_call(x, dt, a, bm, cm, dy, dh, saved, chunk)
    launch(-1)
    ssd_scan_bwd.launches += 1
    return out


ssd_scan_bwd.launches = 0


def _bwd_call(x, dt, a, bm, cm, dy, dh, saved, chunk):
    """The backward's outputs (dx, ddt, da, dbm, dcm, dh0), empty, and
    ``launch(only)``: the seven passes into them on checked CUDA tensors
    (``only`` -1), or pass ``only`` alone (:data:`BWD_PASSES`) on the
    scratch an earlier launch left."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    for t, sh in zip(saved, saved_shapes(b, s, h, p, n, chunk)):
        if tuple(t.shape) != sh or t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_bwd: saved scratch {tuple(t.shape)} "
                             f"{t.dtype}, want {sh} float32")
    x, dt, a, bm, cm, dy = (t.contiguous() for t in (x, dt, a, bm, cm, dy))
    dh = None if dh is None else dh.contiguous()
    lc, states, cb = (t.contiguous() for t in saved)
    dx, ddt, da = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    dh0 = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    work = torch.empty(bwd_work_floats(b, s, h, p, n, chunk),
                       dtype=torch.float32, device=x.device)
    hg = bwd_head_group(b, s, h, chunk)

    def launch(only):
        with torch.cuda.device(x.device):
            code = _bwd_lib()(ptr(x), ptr(dt), ptr(a), a_group(a, b), ptr(bm),
                              ptr(cm), ptr(dy), ptr(dh), ptr(lc), ptr(states),
                              ptr(cb), ptr(dx), ptr(ddt), ptr(da), ptr(dbm),
                              ptr(dcm), ptr(dh0), ptr(work), b, s, h, p, n,
                              chunk, hg, only, stream_of(x.device))
        raise_on_error("ssd_scan_bwd", code)
    return (dx, ddt, da, dbm, dcm, dh0), launch


def ssd_scan_bwd_passes(x, dt, a, bm, cm, dy, *, chunk: int = 128,
                        saved):
    """For timing each pass of the backward on its own (not a training
    entry): runs one whole call on CUDA tensors (not counted in
    ``ssd_scan_bwd.launches``) and returns ``launch(k)``, which launches
    pass k of :data:`BWD_PASSES` alone on that call's scratch and outputs
    (their values then meaningless), no initial state."""
    _check_args("ssd_scan_bwd", x, dt, a, bm, cm, None, chunk, dy=dy)
    if x.device.type != "cuda":
        unsupported_device("ssd_scan_bwd_passes", x.device)
    check_kernel_shape(chunk, bm.shape[-1], x.shape[-1])
    _, launch = _bwd_call(x, dt, a, bm, cm, dy, None, saved, chunk)
    launch(-1)
    return launch


def _fold(info, in_dims, tensors):
    """Each tensor (or None) with its vmapped axis (None: expanded to
    ``info.batch_size``) folded into its leading batch axis: (m, b, ...)
    -> (m b, ...), samples first."""
    out = []
    for t, dim in zip(tensors, in_dims):
        if t is not None:
            t = (t.expand(info.batch_size, *t.shape) if dim is None
                 else t.movedim(dim, 0))
            t = t.flatten(0, 1)
        out.append(t)
    return out


def _fold_a(info, dim, a):
    """a of every sample as rows: (m, H) for a per-sample (H,), (m R, H)
    for (R, H); an unbatched a is repeated per sample."""
    a = a.expand(info.batch_size, *a.shape) if dim is None else a.movedim(
        dim, 0)
    return a.reshape(-1, a.shape[-1])


def _unfold(info, t):
    return t.unflatten(0, (info.batch_size, -1))


class SsdScan(torch.autograd.Function):
    """K4 with its gradient: ``apply(x, dt, a, bm, cm, h0, chunk)`` returns
    (y, h_final, lc, states, cb), the last three the forward's scratch (not
    differentiable; empty on the CPU). y and h_final are differentiable in
    x, dt, a, bm, cm and h0 (None for zeros) through :class:`SsdScanBwd`
    (the backward kernel on the card, :func:`ssd_scan_bwd_ref` on the
    CPU).

    The ``vmap`` rule folds the vmapped axis into the batch, (m, b, ...)
    -> (m b, ...), and a into rows (:func:`_fold_a`), so one launch serves
    every sample."""

    @staticmethod
    def forward(x, dt, a, bm, cm, h0, chunk):
        _check_args("ssd_scan", x, dt, a, bm, cm, h0, chunk)
        with torch.no_grad():
            return _forward(x, dt, a, bm, cm, h0, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, a, bm, cm, h0, ctx.chunk = inputs
        _, _, *saved = output
        ctx.mark_non_differentiable(*saved)
        ctx.save_for_backward(x, dt, a, bm, cm, h0, *saved)

    @staticmethod
    def backward(ctx, dy, dh, *_):
        x, dt, a, bm, cm, h0, *saved = ctx.saved_tensors
        dx, ddt, da, dbm, dcm, dh0 = SsdScanBwd.apply(
            x, dt, a, bm, cm, h0, dy, dh, *saved, ctx.chunk)
        return dx, ddt, da, dbm, dcm, None if h0 is None else dh0, None

    @staticmethod
    def vmap(info, in_dims, x, dt, a, bm, cm, h0, chunk):
        x, dt, bm, cm, h0 = _fold(info, in_dims[:2] + in_dims[3:6],
                                  (x, dt, bm, cm, h0))
        out = SsdScan.apply(x, dt, _fold_a(info, in_dims[2], a), bm, cm, h0,
                            chunk)
        return tuple(_unfold(info, t) for t in out), (0,) * 5


class SsdScanBwd(torch.autograd.Function):
    """:func:`ssd_scan_bwd` (given the forward's scratch) as a Function, so
    that the backward of :class:`SsdScan` runs batched under
    ``vmap(grad(...))`` through its own ``vmap`` rule (the same fold; da
    back to each sample's shape of a). It has no gradient of its own."""

    @staticmethod
    def forward(x, dt, a, bm, cm, h0, dy, dh, lc, states, cb, chunk):
        with torch.no_grad():
            return ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=chunk, h0=h0,
                                dh=dh, saved=(lc, states, cb)
                                if x.device.type == "cuda" else None)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the SSD scan has no second derivative "
                                  "in the port")

    @staticmethod
    def vmap(info, in_dims, x, dt, a, bm, cm, h0, dy, dh, lc, states, cb,
             chunk):
        folded = _fold(info, in_dims[:2] + in_dims[3:11],
                       (x, dt, bm, cm, h0, dy, dh, lc, states, cb))
        x, dt, bm, cm, h0, dy, dh, lc, states, cb = folded
        sample_a = a.shape if in_dims[2] is None else (
            a.shape[:in_dims[2]] + a.shape[in_dims[2] + 1:])
        dx, ddt, da, dbm, dcm, dh0 = SsdScanBwd.apply(
            x, dt, _fold_a(info, in_dims[2], a), bm, cm, h0, dy, dh, lc,
            states, cb, chunk)
        da = da.reshape(info.batch_size, *sample_a)
        return ((_unfold(info, dx), _unfold(info, ddt), da,
                 _unfold(info, dbm), _unfold(info, dcm), _unfold(info, dh0)),
                (0,) * 6)
