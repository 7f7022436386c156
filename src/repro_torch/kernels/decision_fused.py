"""Fused decision kernels (replace the Pallas TPU kernels
``repro/kernels/decision_fused.py::decision_fused`` and
``::decision_fused_batched``).

One pass over the client state: Theorem-2 solve on the 14-operand vector,
activity mask (q -> 0 on inactive lanes), Bernoulli selection
``sel = u < q`` from pre-drawn uniforms, Eq. (9) queue update and the
per-lane accounting summands ``tc = ell / max(rate, 1e-9)`` (unmasked) and
``pq = P q`` (masked by ``valid``). The guarantee-one fallback and the
accounting folds stay with the caller (``fl/decision.py``,
``service/step.py``).

``decision_fused`` takes one (N,) client vector and its (14,) operands;
``decision_fused_batched`` takes the service's (B, N) bucket rows with a
(B, 14) operand row each. Both launch ``csrc/decision_fused.cu`` for CUDA
tensors and run their plain versions for CPU tensors. The launch path is
kept lean, since at the engine's and the service's shapes it costs more
than the kernel: the five float outputs are one allocation (a (5, ...)
slab whose rows are returned as views), the grid comes from
:func:`launch_plan`, K2's operands are read by the C side straight from
the host tensor, and a device context is entered only when the lanes are
not on the current device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.scheduler import (SolveCoeffs, solve_round_coeffs,
                                        update_queues_z)
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_lanes, on_device,
                                         raise_on_error, stream_of,
                                         unsupported_device)

# Operand-vector layout: SolveCoeffs' 11 fields in declaration order, then
# AccountCoeffs' ell, bw, n0 (the reference's layout).
N_DECISION_OPS = 14
_N_SOLVE = len(SolveCoeffs._fields)


def pack_decision_operands(solve, acct) -> torch.Tensor:
    """Pack (SolveCoeffs, AccountCoeffs) into the (14,) float32 operand
    vector, a host (CPU) tensor: the kernel takes it by value."""
    leaves = [float(x) for x in list(solve) + list(acct)]
    if len(leaves) != N_DECISION_OPS:
        raise ValueError(f"want {N_DECISION_OPS} operands, got "
                         f"{len(leaves)}")
    return torch.tensor(leaves, dtype=torch.float32)


def _decision_lanes(gains, z, u, o, active, valid):
    """The kernels' per-lane math in plain PyTorch ops, same op order;
    ``o`` holds the 14 operands as tensors on the lanes' device that
    broadcast against them."""
    c = SolveCoeffs(*o[:_N_SOLVE])
    ell, bw, n0 = o[_N_SOLVE:]
    q, p = solve_round_coeffs(gains, z, c)
    if active is not None:
        q = torch.where(active, q, 0.0)
    sel = u < q
    z_new = update_queues_z(z, q, p, c)
    rate = bw * torch.log2(1.0 + gains * p / n0)
    tc = ell / torch.clamp_min(rate, 1e-9)
    pq = p * q
    if valid is not None:
        pq = torch.where(valid, pq, 0.0)
    return sel, q, p, z_new, tc, pq


def decision_fused_plain(gains, z, u, ops, active=None, valid=None):
    """:func:`decision_fused`'s function in plain PyTorch ops: the
    operands as 0-d tensors on the lanes' device."""
    return _decision_lanes(gains, z, u, ops.to(gains.device).unbind(0),
                           active, valid)


def decision_fused_batched_plain(gains, z, u, ops, valid=None):
    """:func:`decision_fused_batched`'s function in plain PyTorch ops: each
    operand a (B, 1) column on the lanes' device, so every division is a
    true IEEE division per row."""
    cols = ops.to(gains.device).unsqueeze(-1).unbind(1)
    return _decision_lanes(gains, z, u, cols, None, valid)


# The launch plan: one lane a thread; a block of ``block`` threads works
# inside one row, ``grid_x`` blocks along it; row blocks loop over rows
# ``by, by + grid_y, ...`` past CUDA's grid-y limit.
MAX_THREADS = 128
MAX_GRID_Y = 65535


class LaunchPlan(NamedTuple):
    block: int    # threads a block, along one row (a warp multiple)
    grid_x: int   # blocks along a row
    grid_y: int   # row blocks


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, n: int) -> LaunchPlan:
    """How the kernel covers ``rows`` rows of ``n`` lanes: blocks of the
    row's length rounded up to a power of two, from one warp to
    ``MAX_THREADS``, so short rows (the service's buckets of 32) make many
    small blocks that spread over every SM."""
    block = min(MAX_THREADS, max(32, 1 << (n - 1).bit_length()))
    return LaunchPlan(block, -(-n // block), min(rows, MAX_GRID_Y))


def decision_outputs(like: torch.Tensor):
    """``(sel, out)`` for lanes like ``like``: ``sel`` bool, ``out`` one
    float32 slab (5, *shape) whose rows are q, P, Z', tc and pq."""
    return (like.new_empty(like.shape, dtype=torch.bool),
            like.new_empty((5, *like.shape)))


@functools.cache
def _lib():
    fn = _build.load("decision_fused").decision_fused_f32
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_uint, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _batched_argtypes(fn):
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_batched():
    return _batched_argtypes(_build.load("decision_fused")
                             .decision_fused_batched_f32)


@functools.cache
def launch_floor():
    """``decision_launch_floor``: an empty kernel with the batched
    kernel's C arguments, launched on the plan it is given."""
    return _batched_argtypes(_build.load("decision_fused")
                             .decision_launch_floor)


def check_args(gains, z, u, ops, active=None, valid=None):
    """:func:`decision_fused`'s argument checks."""
    check_lanes("decision_fused", torch.float32, gains, gains=gains, z=z,
                u=u)
    if active is not None or valid is not None:
        check_lanes("decision_fused", torch.bool, gains,
                    **{k: m for k, m in (("active", active),
                                         ("valid", valid)) if m is not None})
    if (ops.dtype != torch.float32 or ops.device.type != "cpu"
            or ops.shape != (N_DECISION_OPS,)):
        raise ValueError(f"decision_fused: ops must be a ({N_DECISION_OPS},) "
                         f"float32 CPU tensor, got {tuple(ops.shape)} "
                         f"{ops.dtype} on {ops.device}")


def check_batched_args(gains, z, u, ops, valid=None):
    """:func:`decision_fused_batched`'s argument checks."""
    kernel = "decision_fused_batched"
    check_lanes(kernel, torch.float32, gains, 2, gains=gains, z=z, u=u)
    if valid is not None:
        check_lanes(kernel, torch.bool, gains, 2, valid=valid)
    b = gains.shape[0]
    if (ops.dtype != torch.float32 or ops.shape != (b, N_DECISION_OPS)
            or ops.device != gains.device or not ops.is_contiguous()):
        raise ValueError(f"{kernel}: ops must be a contiguous ({b}, "
                         f"{N_DECISION_OPS}) float32 tensor on "
                         f"{gains.device}, got {tuple(ops.shape)} "
                         f"{ops.dtype} on {ops.device}")


def decision_fused(gains: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
                   ops: torch.Tensor, *, active=None, valid=None):
    """One fused pass over a flat (N,) client vector.

    gains, z, u: (N,) float32; ops: the (14,) float32 CPU tensor of
    :func:`pack_decision_operands`; ``active`` / ``valid``: optional (N,)
    bool masks (None = all lanes on). Returns ``(sel_raw, q, p, z_new, tc,
    pq)``, each (N,), ``sel_raw`` bool without the guarantee-one fallback.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and count one launch in ``decision_fused.launches``;
    CPU tensors run the plain version.
    """
    check_args(gains, z, u, ops, active, valid)
    if gains.device.type == "cpu":
        return decision_fused_plain(gains, z, u, ops, active, valid)
    if gains.device.type != "cuda":
        unsupported_device("decision_fused", gains.device)
    sel, out = decision_outputs(gains)
    n = gains.shape[0]
    # the kernel takes the 14 operands by value, read from the host tensor
    host_ops = ops if ops.is_contiguous() else ops.contiguous()
    with on_device(gains.device):
        code = _lib()(gains.data_ptr(), z.data_ptr(), u.data_ptr(),
                      None if active is None else active.data_ptr(),
                      None if valid is None else valid.data_ptr(),
                      sel.data_ptr(), out.data_ptr(), n,
                      host_ops.data_ptr(), *launch_plan(1, n)[:2],
                      stream_of(gains.device))
    raise_on_error("decision_fused", code)
    decision_fused.launches += 1
    return (sel, *out.unbind(0))


decision_fused.launches = 0


def decision_fused_batched(gains: torch.Tensor, z: torch.Tensor,
                           u: torch.Tensor, ops: torch.Tensor, *,
                           valid=None):
    """The fused decision over a service bucket: (B, N) rows, one (14,)
    operand row per bucket slot.

    gains, z, u: (B, N) float32; ops: (B, 14) float32 on the lanes' device
    (gathered there from the bucket's operand table; B rows of 14 floats
    do not fit the kernel-parameter space, and the gather saves a host
    round trip); ``valid``: optional (B, N) bool mask of the power
    summand. The service masks no q (its pad lanes are neutral), so there
    is no ``active``. Returns ``(sel_raw, q, p, z_new, tc, pq)``, each
    (B, N), as :func:`decision_fused` does per row.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and count one launch in
    ``decision_fused_batched.launches``; CPU tensors run the plain version.
    """
    kernel = "decision_fused_batched"
    check_batched_args(gains, z, u, ops, valid)
    if gains.device.type == "cpu":
        return decision_fused_batched_plain(gains, z, u, ops, valid)
    if gains.device.type != "cuda":
        unsupported_device(kernel, gains.device)
    sel, out = decision_outputs(gains)
    b, n = gains.shape
    with on_device(gains.device):
        code = _lib_batched()(
            gains.data_ptr(), z.data_ptr(), u.data_ptr(), ops.data_ptr(),
            None if valid is None else valid.data_ptr(), sel.data_ptr(),
            out.data_ptr(), b, n, *launch_plan(b, n),
            stream_of(gains.device))
    raise_on_error(kernel, code)
    decision_fused_batched.launches += 1
    return (sel, *out.unbind(0))


decision_fused_batched.launches = 0
