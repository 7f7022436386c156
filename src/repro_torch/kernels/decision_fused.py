"""Fused decision kernel (replaces the Pallas TPU kernel
``repro/kernels/decision_fused.py::decision_fused``).

One pass over the (N,) client state: Theorem-2 solve on the (14,) operand
vector, activity mask (q -> 0 on inactive lanes), Bernoulli selection
``sel = u < q`` from pre-drawn uniforms, Eq. (9) queue update and the
per-lane accounting summands ``tc = ell / max(rate, 1e-9)`` (unmasked) and
``pq = P q`` (masked by ``valid``). The guarantee-one fallback and the
accounting folds stay with the caller (``fl/decision.py``).

``decision_fused`` launches ``csrc/decision_fused.cu`` for CUDA tensors and
runs :func:`decision_fused_plain` for CPU tensors.
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


def decision_fused_plain(gains, z, u, ops, active=None, valid=None):
    """The kernel's function in plain PyTorch ops, same op order."""
    o = ops.to(gains.device).unbind(0)
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


@functools.cache
def _lib():
    fn = _build.load("decision_fused").decision_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong,
                                            ctypes.c_void_p, ctypes.c_void_p]
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
