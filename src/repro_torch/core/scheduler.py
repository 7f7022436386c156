"""Algorithm 2: Lyapunov drift-plus-penalty client scheduling (twin of
``repro/core/scheduler.py``).

Per round and client, Theorem 2 gives the interior candidate

    A      = V lam ell |h|^2 ln2 / (N0 B Z)            (one power of ln 2:
                                                        the corrected Eq. 16,
                                                        docs/paper_map.md)
    P_int  = N0/|h|^2 * ( (A/4) W0(sqrt(A/4))^-2 - 1 ) clipped to [0, Pmax]
    q      = rsqrt( lam ell N / rate + (N/V) Z P )     clipped to [q_floor, 1]
                                                        (Eq. 17)

and the boundary candidate P = Pmax; the one with the finite, lower
drift-plus-penalty objective is kept. Every expression below keeps the
reference's op order so float32 results agree to a few ulp.

Scalars enter as a :class:`SolveCoeffs` bundle folded on the host in
float64 and rounded once to float32. The functions accept the bundle as
Python floats or as 0-d float32 tensors on the lanes' device (engines
convert it once per run with :func:`as_operands`); inside, every scalar
becomes a 0-d tensor so each division is a true IEEE division on every
device (a CUDA tensor divided by a Python scalar is computed as a product
with the reciprocal, one rounding more).

The key-drawing wrappers of the reference (:func:`sample_selection`,
:func:`schedule_step`, :func:`uniform_selection`) draw through a
``torch.Generator`` on the lanes' device; their math is that of the
raw-taking functions (:func:`selection_from_uniform`,
:func:`uniform_decide`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.channel import (ChannelConfig, channel_rate,
                                      make_channel)
from repro_torch.core.lambertw import lambertw0

_LN2 = 0.6931471805599453
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Hyper-parameters of Algorithm 2."""

    n_clients: int
    model_bits: float                   # ell: bits per model transmission
    lam: float = 10.0                   # lambda: comm-time vs bound trade-off
    V: float = 1000.0                   # Lyapunov penalty weight
    q_floor: float = 1e-5               # numerical floor to keep q in (0,1]
    guarantee_one: bool = True          # force >=1 participant per round


class SchedulerState(NamedTuple):
    """Carried across rounds; Z are the per-client virtual power queues."""

    z: torch.Tensor      # (N,) float32 virtual queues
    t: torch.Tensor      # () int32 round counter


def init_state(cfg: SchedulerConfig, device="cuda") -> SchedulerState:
    return SchedulerState(
        z=torch.zeros((cfg.n_clients,), dtype=torch.float32, device=device),
        t=torch.zeros((), dtype=torch.int32, device=device))


class SolveCoeffs(NamedTuple):
    """Scalar operands of the Theorem-2 solve, in the reference's field
    order (the fused kernel's operand vector depends on it)."""

    a_coef: float    # V lam ell ln2 / (N0 B): Eq. 16 argument scale
    n0: float        # N0
    bw: float        # B
    p_max: float     # Pmax
    lle_n: float     # lam ell N      (Eq. 17 rate term)
    n_over_v: float  # N / V          (Eq. 17 queue term)
    q_floor: float   # numerical floor keeping q in (0, 1]
    n: float         # N
    lle: float       # lam ell        (objective comm term)
    v: float         # V
    p_bar: float     # Pbar


def _f32(x: float) -> float:
    """Round a host float64 to the nearest float32, kept as a Python float."""
    return float(np.float32(x))


def solve_coeffs(cfg: SchedulerConfig, ch: ChannelConfig) -> SolveCoeffs:
    """Fold (cfg, ch) into the solve's scalar operands (host, f64 -> f32)."""
    return SolveCoeffs(
        a_coef=_f32(cfg.V * cfg.lam * cfg.model_bits * _LN2
                    / (ch.noise_power * ch.bandwidth_hz)),
        n0=_f32(ch.noise_power), bw=_f32(ch.bandwidth_hz),
        p_max=_f32(ch.p_max),
        lle_n=_f32(cfg.lam * cfg.model_bits * cfg.n_clients),
        n_over_v=_f32(cfg.n_clients / cfg.V), q_floor=_f32(cfg.q_floor),
        n=_f32(cfg.n_clients), lle=_f32(cfg.lam * cfg.model_bits),
        v=_f32(cfg.V), p_bar=_f32(ch.p_bar))


def as_operands(c, like: torch.Tensor):
    """``c``'s fields as 0-d float32 tensors on ``like``'s device (fields
    already there pass through untouched)."""
    return type(c)(*(x if isinstance(x, torch.Tensor)
                     and x.device == like.device
                     else like.new_full((), float(x)) for x in c))


def coeff_rate(gains, power, c) -> torch.Tensor:
    """Shannon rate bw log2(1 + g P / n0) over a bundle with ``bw``/``n0``."""
    return c.bw * torch.log2(1.0 + gains * power / c.n0)


def _objective_c(q, p, gains, z, c: SolveCoeffs):
    """Per-client drift-plus-penalty objective f(q, P) of Eq. (15)."""
    rate = coeff_rate(gains, p, c)
    y0 = torch.reciprocal(c.n * q) + c.lle * q / torch.clamp_min(rate, _EPS)
    return c.v * y0 + z * (p * q - c.p_bar)


def _q_eq17_c(p, gains, z, c: SolveCoeffs):
    """Eq. (17) for a given power; clipped into [q_floor, 1]."""
    rate = coeff_rate(gains, p, c)
    inv_sq = c.lle_n / torch.clamp_min(rate, _EPS) + c.n_over_v * z * p
    q = torch.rsqrt(torch.clamp_min(inv_sq, _EPS))
    return torch.clamp_max(torch.maximum(q, c.q_floor), 1.0)


def solve_candidates_coeffs(gains: torch.Tensor, z: torch.Tensor, c):
    """Both Theorem-2 candidates and the keep-interior mask:
    ``(q_int, p_int, q_bnd, p_bnd, use_int)``."""
    gains = gains.to(torch.float32)
    z = z.to(torch.float32)
    c = as_operands(c, gains)
    zs = torch.clamp_min(z, _EPS)  # Z = 0 -> huge A -> boundary wins
    a = c.a_coef * gains / zs
    w = lambertw0(torch.sqrt(a / 4.0))
    p_int = c.n0 / gains * (a / (4.0 * torch.clamp_min(w * w, _EPS)) - 1.0)
    p_int = torch.minimum(torch.clamp_min(p_int, 0.0), c.p_max)
    q_int = _q_eq17_c(p_int, gains, z, c)
    p_bnd = c.p_max.expand(gains.shape)
    q_bnd = _q_eq17_c(p_bnd, gains, z, c)
    f_int = _objective_c(q_int, p_int, gains, z, c)
    f_bnd = _objective_c(q_bnd, p_bnd, gains, z, c)
    use_int = torch.isfinite(f_int) & (f_int <= f_bnd)
    return q_int, p_int, q_bnd, p_bnd, use_int


def solve_candidates(gains: torch.Tensor, z: torch.Tensor,
                     cfg: SchedulerConfig, ch: ChannelConfig):
    """Both Theorem-2 candidates and the keep-interior mask from the
    configs: ``(q_int, p_int, q_bnd, p_bnd, use_int)``."""
    return solve_candidates_coeffs(gains, z, solve_coeffs(cfg, ch))


def solve_round_coeffs(gains: torch.Tensor, z: torch.Tensor,
                       c) -> Tuple[torch.Tensor, torch.Tensor]:
    """Theorem-2 solve from a coefficient bundle: -> (q, P), each (N,)."""
    q_int, p_int, q_bnd, p_bnd, use_int = solve_candidates_coeffs(gains, z,
                                                                  c)
    return (torch.where(use_int, q_int, q_bnd),
            torch.where(use_int, p_int, p_bnd))


def solve_round(gains: torch.Tensor, z: torch.Tensor, cfg: SchedulerConfig,
                ch: ChannelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized Theorem-2 solve from the configs (the stitched path)."""
    return solve_round_coeffs(gains, z, solve_coeffs(cfg, ch))


def update_queues_z(z: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                    ch) -> torch.Tensor:
    """Eq. (9): max(Z + P q - Pbar, 0). ``ch`` needs a ``p_bar`` field (a
    ChannelConfig or a coefficient bundle)."""
    return torch.clamp_min(z + p * q - ch.p_bar, 0.0)


def update_queues(state: SchedulerState, q: torch.Tensor, p: torch.Tensor,
                  ch: ChannelConfig) -> SchedulerState:
    """Eq. (9): Z(t+1) = max(Z + P q - Pbar, 0), and the round counter."""
    return SchedulerState(z=update_queues_z(state.z, q, p, ch),
                          t=state.t + 1)


def force_one(sel: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """An empty selection becomes the client of largest q (the first one on
    ties, as ``jnp.argmax``): paper Section VI's fallback. Works row by row
    over the last axis, so a (B, N) bucket batch takes one set of ops."""
    forced = torch.zeros_like(sel).scatter_(
        -1, torch.argmax(q, dim=-1, keepdim=True), True)
    return torch.where(sel.any(-1, keepdim=True), sel, forced)


def selection_from_uniform(u: torch.Tensor, q: torch.Tensor,
                           guarantee_one: bool = True) -> torch.Tensor:
    """I_n = [u_n < q_n], with :func:`force_one` if ``guarantee_one``."""
    sel = u < q
    return force_one(sel, q) if guarantee_one else sel


def sample_selection(generator: torch.Generator, q: torch.Tensor,
                     guarantee_one: bool = True) -> torch.Tensor:
    """I_n ~ Bernoulli(q_n), independently, from uniforms drawn on
    ``generator`` (on q's device); an empty draw selects the client of
    largest q if ``guarantee_one``."""
    u = torch.rand(q.shape, generator=generator, device=q.device)
    return selection_from_uniform(u, q, guarantee_one)


def schedule_step(generator: torch.Generator, gains: torch.Tensor,
                  state: SchedulerState, cfg: SchedulerConfig,
                  ch: ChannelConfig):
    """One Algorithm-2 round: solve, sample, queue update ->
    ``(selected, q, P, new_state)``."""
    q, p = solve_round(gains, state.z, cfg, ch)
    sel = sample_selection(generator, q, cfg.guarantee_one)
    return sel, q, p, update_queues(state, q, p, ch)


def y0(q: torch.Tensor, p: torch.Tensor, gains: torch.Tensor,
       cfg: SchedulerConfig, ch: ChannelConfig) -> torch.Tensor:
    """The scheduling objective y0(t) of Eq. (8), summed over the last
    axis (diagnostics)."""
    rate = channel_rate(gains, p, ch)
    one = q.new_ones(())
    return (one / (cfg.n_clients * torch.clamp_min(q, _EPS))
            + cfg.lam * cfg.model_bits * q / torch.clamp_min(rate, _EPS)
            ).sum(-1)


# --------------------------------------------------------------------------
# The M-matched uniform and greedy top-M baselines (paper Section VI).
#
# Their coefficient bundles hold Python numbers for one tenant, or (B,)
# tensors, one entry per row of a (B, N) bucket batch (the service); the
# decisions then work row by row over the last axis in one set of ops.
# --------------------------------------------------------------------------

class UniformCoeffs(NamedTuple):
    """Scalar operands of the uniform baseline (f32-exact)."""

    m_avg: float   # matched average participation M
    q_val: float   # clip(M / N, 0, 1): the reported q
    pn: float      # Pbar * N: numerator of P = Pbar N / M'
    n: int         # N: M' is clipped into [1, N]


class GreedyCoeffs(NamedTuple):
    """Scalar operands of the greedy top-M channel baseline."""

    m: int         # M
    pn: float      # Pbar * N


def uniform_coeffs(n_clients: int, m_avg: float,
                   ch: ChannelConfig) -> UniformCoeffs:
    """Host-folded operands of :func:`uniform_decide` (f64 folds, f32)."""
    return UniformCoeffs(m_avg=_f32(m_avg),
                         q_val=min(max(_f32(m_avg / n_clients), 0.0), 1.0),
                         pn=_f32(ch.p_bar * n_clients), n=int(n_clients))


def greedy_coeffs(n_clients: int, m_avg: float,
                  ch: ChannelConfig) -> GreedyCoeffs:
    """Host-folded operands of :func:`greedy_decide`."""
    return GreedyCoeffs(m=max(1, int(round(m_avg))),
                        pn=_f32(ch.p_bar * n_clients))


def _on_device(x, like: torch.Tensor) -> torch.Tensor:
    """A tensor passes to ``like``'s device; a number becomes a 0-d int64
    or float32 tensor filled there (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device)
    dtype = (torch.long if isinstance(x, (int, np.integer))
             else torch.float32)
    return like.new_full((), x, dtype=dtype)


def _per_row(c, like: torch.Tensor):
    """``c``'s fields as tensors of ``like``'s leading shape on its device:
    a number becomes a 0-d tensor (int64 or float32) broadcast over it, a
    (B,) column of the service passes through."""
    return type(c)(*(_on_device(x, like).expand(like.shape[:-1])
                     for x in c))


def uniform_draw_m(take_hi: torch.Tensor, m_avg: torch.Tensor,
                   n_clients: torch.Tensor, n_active=None) -> torch.Tensor:
    """The round's subset size M' = floor(M) or ceil(M), clipped into
    [1, N]; an int64 tensor of ``take_hi``'s shape and device. Under an
    activity mask, ``n_active`` (the active count) replaces N: M' clips
    into [1, max(n_active, 1)], so the top-M' threshold never ties into
    inactive lanes."""
    m = torch.clamp_min(take_hi.long() + torch.floor(m_avg), 1)
    hi = (n_clients.long() if n_active is None
          else torch.clamp_min(n_active.long(), 1))
    return torch.minimum(m.long(), hi)


def _top_m(score: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """score >= the m-th largest score of its row (every tie kept)."""
    thresh = torch.sort(score, dim=-1, descending=True).values.gather(
        -1, (m - 1).unsqueeze(-1))
    return score >= thresh


def _fill(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A float32 tensor of ``like``'s shape holding one value per row."""
    return value.to(torch.float32).unsqueeze(-1).expand(
        like.shape).contiguous()


def _p_over_m(pn: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Pbar N / max(M', 1) in float32, an IEEE division per row."""
    return torch.div(pn.to(torch.float32),
                     torch.clamp_min(m, 1).to(torch.float32))


def uniform_decide(raw, c: UniformCoeffs, active=None, n_active=None):
    """The uniform baseline on pre-drawn raws {"take": (...), "scores":
    (..., N)}: the M' highest scores are selected, q = M/N,
    P = Pbar N / M'. Pad lanes must score below every real score.

    Under an activity mask ``active`` (with its count ``n_active``)
    inactive lanes score -1, below every live score, M' clips into the
    active count and their q is 0."""
    scores = raw["scores"]
    c = _per_row(c, scores)
    take_hi = raw["take"] < (c.m_avg - torch.floor(c.m_avg))
    m = uniform_draw_m(take_hi, c.m_avg, c.n, n_active)
    q = _fill(c.q_val, scores)
    if active is not None:
        scores = torch.where(active, scores, -1.0)
        q = torch.where(active, q, 0.0)
    return _top_m(scores, m), q, _fill(_p_over_m(c.pn, m), scores)


def greedy_decide(gains: torch.Tensor, c: GreedyCoeffs, active=None,
                  n_active=None):
    """Top-M instantaneous channels: sel = gains >= the M-th largest gain,
    q the realized indicator, P = Pbar N / M. Pad gains must lie below
    every real (clipped-positive) gain. Under an activity mask inactive
    lanes score -inf and M clips into [1, max(n_active, 1)]; P keeps
    the unclipped M."""
    c = _per_row(c, gains)
    m = c.m.long()
    score, m_eff = gains, m
    if active is not None:
        score = torch.where(active, gains, -torch.inf)
        m_eff = torch.clamp_min(torch.minimum(
            m, torch.clamp_min(n_active.long(), 1)), 1)
    sel = _top_m(score, m_eff)
    return sel, sel.to(torch.float32), _fill(_p_over_m(c.pn, m), gains)


def uniform_selection(generator: torch.Generator, n_clients: int,
                      m_avg: float, ch: ChannelConfig, device="cuda"):
    """FedAvg's uniform policy as in the paper's Section VI: floor(M) or
    ceil(M) clients at random (mean M), P = Pbar N / M'. Draws the
    baseline's raws on ``generator`` (on ``device``), then
    :func:`uniform_decide` -> ``(selected, q, P)``."""
    raw = {"take": torch.rand((), generator=generator, device=device),
           "scores": torch.rand((n_clients,), generator=generator,
                                device=device)}
    return uniform_decide(raw, uniform_coeffs(n_clients, m_avg, ch))


def _raw_at(raws, r: int):
    """Round ``r`` of raws stacked along a leading round axis (a tensor or
    a tuple of them)."""
    if isinstance(raws, tuple):
        return tuple(x[r] for x in raws)
    return raws[r]


def estimate_avg_selected(generator, sigmas: torch.Tensor,
                          cfg: SchedulerConfig, ch: ChannelConfig,
                          rounds: int = 500, channel=None, *,
                          raws=None, init_raw=None) -> torch.Tensor:
    """Monte-Carlo estimate of M = E[sum_n q_n] under Algorithm 2,
    discarding the first 20% as burn-in (queues start at 0).

    ``channel`` is a bound :class:`~repro_torch.core.channel.ChannelModel`
    whose fading law the estimate follows (None: the paper's i.i.d.
    Rayleigh). The randomness comes from ``generator`` (a
    ``torch.Generator`` on ``sigmas``' device: the model's init raw, then
    a raw a round), or from ``raws``, the rounds' raws stacked along a
    leading axis, and ``init_raw`` (tests replay the reference's draws;
    ``generator`` may then be None).
    """
    if channel is None:
        channel = make_channel("rayleigh", sigmas, ch)
    c = as_operands(solve_coeffs(cfg, ch), sigmas)
    z = torch.zeros_like(sigmas, dtype=torch.float32)
    if raws is None:
        init_raw = channel.draw_init(generator)
    state = channel.init(init_raw)
    sums = []
    for r in range(rounds):
        raw = channel.draw(generator) if raws is None else _raw_at(raws, r)
        gains, state = channel.apply(raw, state)
        q, p = solve_round_coeffs(gains, z, c)
        z = update_queues_z(z, q, p, c)
        sums.append(q.sum())
    return torch.stack(sums[rounds // 5:]).mean()
