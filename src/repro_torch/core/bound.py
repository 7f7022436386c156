"""Convergence-bound bookkeeping, Theorem 1 / Corollary 1 (twin of
``repro/core/bound.py``).

Corollary 1:  (1/T) sum_t E||grad f(x_t)||^2
    <=   2 (f(x0) - f*) / (gamma T I)                      [init term]
       + gamma^2 L^2 (I-1)^2 G^2                           [drift term]
       + (gamma L I G^2 / (T N)) sum_t sum_n 1/q_n^t       [sampling term]

The sampling term is the one the scheduler controls; the accumulator sums
sum_n 1/q_n^t each round so the realized bound can be reported beside the
realized gradient norms.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class BoundConstants:
    """Problem constants of Assumptions 1-3 (estimated or configured)."""

    gamma: float          # learning rate
    L: float              # smoothness
    G2: float             # gradient second-moment bound G^2
    I: int                # local steps per round
    n_clients: int


class BoundAccumulator(NamedTuple):
    """Streaming accumulator of the q-dependent term."""

    inv_q_sum: torch.Tensor   # () float32: sum_t sum_n 1/q_n^t
    rounds: torch.Tensor      # () int32: t so far


def init_accumulator(device="cuda") -> BoundAccumulator:
    return BoundAccumulator(
        inv_q_sum=torch.zeros((), dtype=torch.float32, device=device),
        rounds=torch.zeros((), dtype=torch.int32, device=device))


def _inv_sum(q: torch.Tensor) -> torch.Tensor:
    """sum_n 1/q_n, each a true IEEE division."""
    return (q.new_ones(()) / q).sum()


def accumulate(acc: BoundAccumulator, q: torch.Tensor) -> BoundAccumulator:
    return BoundAccumulator(inv_q_sum=acc.inv_q_sum + _inv_sum(q),
                            rounds=acc.rounds + 1)


def corollary1_bound(acc: BoundAccumulator, c: BoundConstants,
                     f0_minus_fstar) -> torch.Tensor:
    """The Corollary-1 right-hand side at the current round count."""
    t = torch.clamp_min(acc.rounds.to(torch.float32), 1.0)
    init_term = 2.0 * torch.as_tensor(f0_minus_fstar, dtype=torch.float32,
                                      device=t.device) / (c.gamma * t * c.I)
    drift_term = (c.gamma ** 2) * (c.L ** 2) * ((c.I - 1) ** 2) * c.G2
    samp_term = (c.gamma * c.L * c.I * c.G2 / (t * c.n_clients)
                 ) * acc.inv_q_sum
    return init_term + drift_term + samp_term


def sampling_term_per_round(q: torch.Tensor,
                            c: BoundConstants) -> torch.Tensor:
    """The round's contribution gamma L I G^2 / N * sum_n 1/q_n: what
    Algorithm 2's objective trades against communication time."""
    return c.gamma * c.L * c.I * c.G2 / c.n_clients * _inv_sum(q)
