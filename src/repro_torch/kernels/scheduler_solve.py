"""Theorem-2 solve kernel (replaces the Pallas TPU kernel
``repro/kernels/scheduler_solve.py::scheduler_solve``).

``scheduler_solve`` launches ``csrc/scheduler_solve.cu`` for CUDA tensors
and runs :func:`scheduler_solve_plain` for CPU tensors. Like the reference
it takes the configs' scalars directly (``solver="cuda"`` in the engine)
and forms the Eq. 16 argument as ``v*lam*ell*gains*LN2 /
(noise*bandwidth*zs)``: the host folds the scalar products in float64 as
Python does for the reference, and rounds each to float32 once.

The launch path is kept lean, as the fused kernels' is: the 13 rounded
scalars and their ctypes array are made once per argument tuple and
cached, q and P are the rows of one (2, N) allocation, and a device
context is entered only when the lanes are not on the current device.
"""

from __future__ import annotations

import ctypes
import functools
import types

import numpy as np
import torch

from repro_torch.core.lambertw import lambertw0
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (check_lanes, host_f32, on_device,
                                         raise_on_error, stream_of,
                                         unsupported_device)

_LN2 = 0.6931471805599453
_EPS = 1e-12
# Order of the host scalar array of the C interface.
SCALARS = ("vle", "ln2", "nb", "n0", "bw", "p_max", "lle_n", "n_over_v",
           "q_floor", "n", "lle", "v", "p_bar")


def solve_scalars(*, n, v, lam, ell, bandwidth, noise, p_max, p_bar,
                  q_floor) -> dict:
    """The kernel's scalars, each a float64 product of Python floats (in the
    reference's association) rounded once to float32."""
    f = lambda x: float(np.float32(x))  # noqa: E731
    return dict(vle=f(v * lam * ell), ln2=f(_LN2), nb=f(noise * bandwidth),
                n0=f(noise), bw=f(bandwidth), p_max=f(p_max),
                lle_n=f(lam * ell * n), n_over_v=f(n / v), q_floor=f(q_floor),
                n=f(n), lle=f(lam * ell), v=f(v), p_bar=f(p_bar))


def scheduler_solve_plain(gains, z, s: dict):
    """The kernel's function in plain PyTorch ops, same op order."""
    c = {k: gains.new_full((), x) for k, x in s.items()}

    def rate(p):
        return torch.clamp_min(c["bw"] * torch.log2(1.0 + gains * p
                                                    / c["n0"]), _EPS)

    def q_eq17(p):
        inv_sq = c["lle_n"] / rate(p) + c["n_over_v"] * z * p
        q = torch.rsqrt(torch.clamp_min(inv_sq, _EPS))
        return torch.clamp_max(torch.maximum(q, c["q_floor"]), 1.0)

    def objective(q, p):
        y0 = torch.reciprocal(c["n"] * q) + c["lle"] * q / rate(p)
        return c["v"] * y0 + z * (p * q - c["p_bar"])

    zs = torch.clamp_min(z, _EPS)
    a = c["vle"] * gains * c["ln2"] / (c["nb"] * zs)
    w = lambertw0(torch.sqrt(a / 4.0))
    p_int = c["n0"] / gains * (a / (4.0 * torch.clamp_min(w * w, _EPS))
                               - 1.0)
    p_int = torch.minimum(torch.clamp_min(p_int, 0.0), c["p_max"])
    p_bnd = c["p_max"].expand(gains.shape)
    q_int, q_bnd = q_eq17(p_int), q_eq17(p_bnd)
    f_int, f_bnd = objective(q_int, p_int), objective(q_bnd, p_bnd)
    use_int = torch.isfinite(f_int) & (f_int <= f_bnd)
    return (torch.where(use_int, q_int, q_bnd),
            torch.where(use_int, p_int, p_bnd))


@functools.lru_cache(maxsize=64)
def launch_scalars(n, v, lam, ell, bandwidth, noise, p_max, p_bar,
                   q_floor):
    """:func:`solve_scalars` of one argument tuple (read-only: every call
    shares it) and the host float32 array the C interface takes, made once
    and cached."""
    s = solve_scalars(n=n, v=v, lam=lam, ell=ell, bandwidth=bandwidth,
                      noise=noise, p_max=p_max, p_bar=p_bar, q_floor=q_floor)
    return types.MappingProxyType(s), host_f32(
        "scheduler_solve", (s[k] for k in SCALARS), len(SCALARS))


def _c_function(name: str):
    fn = getattr(_build.load("scheduler_solve"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                           ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib():
    return _c_function("scheduler_solve_f32")


@functools.cache
def launch_floor():
    """``scheduler_solve_launch_floor``: an empty kernel with the solve
    kernel's C arguments and grid."""
    return _c_function("scheduler_solve_launch_floor")


def scheduler_solve(gains: torch.Tensor, z: torch.Tensor, *, n: int,
                    v: float, lam: float, ell: float, bandwidth: float,
                    noise: float, p_max: float, p_bar: float,
                    q_floor: float = 1e-5):
    """Theorem 2 over a flat client vector: gains, z (N,) float32 ->
    (q, P), each (N,) float32. ``n`` is the configuration's client count
    (Eq. 17 and the objective use it), not the number of lanes: the sweep
    passes every seed's lanes in one call.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and count one launch in ``scheduler_solve.launches``;
    q and P are then the two rows of one (2, N) tensor. CPU tensors run the
    plain version.
    """
    check_lanes("scheduler_solve", torch.float32, gains, gains=gains, z=z)
    s, scalars = launch_scalars(n, v, lam, ell, bandwidth, noise, p_max,
                                p_bar, q_floor)
    if gains.device.type == "cpu":
        return scheduler_solve_plain(gains, z, s)
    if gains.device.type != "cuda":
        unsupported_device("scheduler_solve", gains.device)
    n_lanes = gains.shape[0]
    out = gains.new_empty((2, n_lanes))
    q, p = out.unbind(0)
    with on_device(gains.device):
        code = _lib()(gains.data_ptr(), z.data_ptr(), q.data_ptr(),
                      p.data_ptr(), n_lanes, scalars,
                      stream_of(gains.device))
    raise_on_error("scheduler_solve", code)
    scheduler_solve.launches += 1
    return q, p


scheduler_solve.launches = 0
