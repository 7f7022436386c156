"""Dynamic populations over a fixed arena: churn and stragglers (twin of
``repro/fl/population.py``).

* An **activity mask** over the N lanes: a departed client keeps its lane
  with a ``False`` bit, carried beside the channel state as ``(ch_state,
  active)``. Arrivals and departures are a two-state Markov chain per
  lane (:func:`churn_step`): an active client leaves w.p. ``p_leave``, an
  inactive lane (re)joins w.p. ``p_join``. At least one client stays
  active (the population's mirror of ``guarantee_one``).
* **Straggler failures**: each selected client fails to deliver w.p.
  ``p_fail`` (:func:`failure_split`). A failed client burned its TDMA slot,
  so it stays in ``t_comm`` and ``n_selected`` and is charged in Eq. 9;
  only the training sees ``delivered = sel & ~failed``.
* **Eq. 9**: an inactive lane has q = 0 before selection and before the
  queue update (the policies' ``(active, n_active)`` operands), so its Z
  drains by ``p_bar`` a round while away.

A round is churn -> channel -> masked decision (``valid=active``: under
``solver="cuda_fused"`` the fused kernel applies the mask to q before
selection and to the power summand) -> straggler split -> training on the
delivered participants. The randomness comes from the run's ``Draws``
source (``fl/engine.py``): the round-0 mask's uniforms once per run, the
churn and failure uniforms a round. With the degenerate
:class:`PopulationConfig` (nobody churns or fails, everyone starts
active) every mask op keeps each lane's value, so the run equals the
population-free run bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policies import policy_raw
from repro_torch.core.scheduler import _f32


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Markov churn and straggler scenario over the fixed N-lane arena;
    the default is the degenerate all-active scenario."""

    p_join: float = 0.0       # P[inactive lane joins next round]
    p_leave: float = 0.0      # P[active client departs next round]
    p_fail: float = 0.0       # P[selected client fails to deliver]
    init_active: float = 1.0  # P[lane starts active]

    def validate(self):
        for name in ("p_join", "p_leave", "p_fail", "init_active"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"PopulationConfig.{name}={v} must be a "
                                 f"probability in [0, 1]")
        return self


def population_config(params) -> PopulationConfig:
    """((name, value), ...) | dict | PopulationConfig -> validated config."""
    if isinstance(params, PopulationConfig):
        return params.validate()
    return PopulationConfig(**dict(params)).validate()


def _ensure_one(mask: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """Turn on the lane of the first maximal score when ``mask`` is empty
    (``torch.argmax`` returns the first maximum, as ``jnp.argmax``)."""
    forced = torch.zeros_like(mask).scatter_(
        -1, torch.argmax(score, dim=-1, keepdim=True), True)
    return torch.where(mask.any(-1, keepdim=True), mask, forced)


def init_active_mask(u: torch.Tensor, pcfg: PopulationConfig
                     ) -> torch.Tensor:
    """The round-0 (N,) activity mask from (N,) uniforms in [0, 1):
    ``init_active = 1`` keeps every lane."""
    return _ensure_one(u < _f32(pcfg.init_active), u)


def churn_step(raw: torch.Tensor, active: torch.Tensor,
               pcfg: PopulationConfig) -> torch.Tensor:
    """One Markov arrival/departure step on (N,) uniforms; ``p_join =
    p_leave = 0`` keeps ``active`` exactly."""
    new = torch.where(active, raw >= _f32(pcfg.p_leave),
                      raw < _f32(pcfg.p_join))
    return _ensure_one(new, raw)


def failure_split(raw: torch.Tensor, sel: torch.Tensor,
                  pcfg: PopulationConfig):
    """``(delivered, failed)`` of a selection on (N,) uniforms;
    ``p_fail = 0`` delivers exactly ``sel``."""
    failed = sel & (raw < _f32(pcfg.p_fail))
    return sel & ~failed, failed


def active_count(active: torch.Tensor) -> torch.Tensor:
    """The active-lane count (the policies' ``n_active`` operand), a 0-d
    int32 tensor on the mask's device."""
    return active.sum(-1, dtype=torch.int32)


def make_population_core(parts, pcfg: PopulationConfig):
    """The masked round body over a run's bound parts
    (``fl/engine.py::make_round_parts``): ``pop_round(params, pol_state,
    (ch_state, active), draws, r) -> (params, pol_state, (ch_state,
    active'), t_comm, power, n_sel, sel, q)``, the shape of the engine's
    population-free round except for the ``(ch_state, active)`` carry."""

    def pop_round(params, pol_state, carry, draws, r: int):
        ch_state, active = carry
        active = churn_step(draws.churn_u(r), active, pcfg)
        gains, ch_state = parts.channel.apply(draws.channel_raw(r), ch_state)
        n_act = active_count(active)

        def masked_step(raw, g, st):
            return parts.policy_step(raw, g, st, active, n_act)

        sel, q, p, t_comm, power, n_sel, pol_state = parts.decision(
            masked_step, parts.acct, policy_raw(draws, parts.policy, r),
            gains, pol_state, valid=active)
        delivered, _ = failure_split(draws.fail_u(r), sel, pcfg)
        params = parts.train(params, delivered, q, draws.batch_idx(r))
        return (params, pol_state, (ch_state, active), t_comm, power, n_sel,
                sel, q)

    return pop_round

