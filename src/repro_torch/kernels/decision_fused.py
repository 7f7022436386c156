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
tensors and run their plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.scheduler import (SolveCoeffs, solve_round_coeffs,
                                        update_queues_z)
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_lanes, host_f32, ptr,
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


@functools.cache
def _lib():
    fn = _build.load("decision_fused").decision_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong,
                                            ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib_batched():
    fn = _build.load("decision_fused").decision_fused_batched_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong,
                                            ctypes.c_longlong,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    check_lanes("decision_fused", torch.float32, gains, gains=gains, z=z,
                u=u)
    masks = {k: m for k, m in (("active", active), ("valid", valid))
             if m is not None}
    check_lanes("decision_fused", torch.bool, gains, **masks)
    if (ops.dtype != torch.float32 or ops.device.type != "cpu"
            or ops.shape != (N_DECISION_OPS,)):
        raise ValueError(f"decision_fused: ops must be a ({N_DECISION_OPS},) "
                         f"float32 CPU tensor, got {tuple(ops.shape)} "
                         f"{ops.dtype} on {ops.device}")
    if gains.device.type == "cpu":
        return decision_fused_plain(gains, z, u, ops, active, valid)
    if gains.device.type != "cuda":
        unsupported_device("decision_fused", gains.device)
    sel = torch.empty(gains.shape, dtype=torch.bool, device=gains.device)
    q, p, z_new, tc, pq = (torch.empty_like(gains) for _ in range(5))
    host_ops = host_f32("decision_fused", ops.tolist(), N_DECISION_OPS)
    with torch.cuda.device(gains.device):
        code = _lib()(ptr(gains), ptr(z), ptr(u), ptr(active), ptr(valid),
                      ptr(sel), ptr(q), ptr(p), ptr(z_new), ptr(tc), ptr(pq),
                      gains.shape[0], host_ops, stream_of(gains.device))
    raise_on_error("decision_fused", code)
    decision_fused.launches += 1
    return sel, q, p, z_new, tc, pq


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
    if gains.device.type == "cpu":
        return decision_fused_batched_plain(gains, z, u, ops, valid)
    if gains.device.type != "cuda":
        unsupported_device(kernel, gains.device)
    sel = torch.empty(gains.shape, dtype=torch.bool, device=gains.device)
    q, p, z_new, tc, pq = (torch.empty_like(gains) for _ in range(5))
    with torch.cuda.device(gains.device):
        code = _lib_batched()(ptr(gains), ptr(z), ptr(u), ptr(ops),
                              ptr(valid), ptr(sel), ptr(q), ptr(p),
                              ptr(z_new), ptr(tc), ptr(pq), b,
                              gains.shape[1], stream_of(gains.device))
    raise_on_error(kernel, code)
    decision_fused_batched.launches += 1
    return sel, q, p, z_new, tc, pq


decision_fused_batched.launches = 0
