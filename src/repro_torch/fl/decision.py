"""The per-round scheduling decision: solve -> select -> Z-update ->
account (twin of ``repro/fl/decision.py``).

* :class:`DecisionCoeffs` — the decision layer's scalar operands: the
  Theorem-2 :class:`~repro_torch.core.scheduler.SolveCoeffs` plus the
  accounting constants, folded on the host once per configuration.
* :func:`decision_step` — the stitched path: any policy step, then the
  TDMA comm-time and expected-power totals through the fixed-association
  block reduce.
* :func:`make_fused_decision` — the same decision for ``proposed`` through
  the fused CUDA kernel; the guarantee-one argmax and the accounting folds
  stay here, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.policies import PolicyState
from repro_torch.core.scheduler import (SchedulerConfig, SolveCoeffs,
                                        _f32, as_operands, coeff_rate,
                                        force_one, solve_coeffs)
from repro_torch.fl.sharding import blocked_total
from repro_torch.kernels.decision_fused import (decision_fused,
                                                pack_decision_operands)


class AccountCoeffs(NamedTuple):
    """Scalar operands of the per-round accounting."""

    ell: float   # model_bits per upload (Eq. 8 numerator)
    bw: float    # bandwidth B (rate factor)
    n0: float    # noise power N0 (rate divisor)


class DecisionCoeffs(NamedTuple):
    """Everything scalar the decision layer consumes."""

    solve: SolveCoeffs
    acct: AccountCoeffs


def account_coeffs(scfg: SchedulerConfig, ch: ChannelConfig) -> AccountCoeffs:
    """Fold the accounting constants on the host (f32, once)."""
    return AccountCoeffs(ell=_f32(scfg.model_bits), bw=_f32(ch.bandwidth_hz),
                         n0=_f32(ch.noise_power))


def decision_coeffs(scfg: SchedulerConfig,
                    ch: ChannelConfig) -> DecisionCoeffs:
    """The full per-configuration bundle (host floats, float32-exact)."""
    return DecisionCoeffs(solve=solve_coeffs(scfg, ch),
                          acct=account_coeffs(scfg, ch))


def _fit_account_axis(contrib: torch.Tensor, acct_len: Optional[int]):
    """Slice or zero-pad a padded client axis to the tenant's accounting
    length ``acct_len`` (= ``padded_len(n_real)``), so the blocked reduce
    associates exactly as an unpadded (n_real,) reduce does. The adjusted
    lanes are exact zeros, which change no block partial."""
    if acct_len is None:
        return contrib
    n = contrib.shape[-1]
    if n >= acct_len:
        return contrib[..., :acct_len]
    return F.pad(contrib, (0, acct_len - n))


def account_totals(contrib: torch.Tensor, pq: torch.Tensor,
                   acct_len: Optional[int] = None):
    """The round's comm time and expected power: both summand lanes cut to
    ``acct_len`` and folded together through the fixed-association
    reduce. Works row by row over the last axis."""
    both = _fit_account_axis(torch.stack([contrib, pq]), acct_len)
    t_comm, power = blocked_total(both).unbind(0)
    return t_comm, power


def account_summands(gains, sel, q, p, acct, valid=None):
    """The per-lane summands of the round's accounting, stacked (2, ...):
    the TDMA comm time ell / rate on selected lanes (Eq. 8) and the
    expected power P q (on ``valid`` lanes)."""
    acct = as_operands(acct, gains)
    rate = coeff_rate(gains, p, acct)
    contrib = torch.where(sel, acct.ell / torch.clamp_min(rate, 1e-9), 0.0)
    pq = p * q if valid is None else torch.where(valid, p * q, 0.0)
    return torch.stack([contrib, pq])


def _account(gains, sel, q, p, acct, valid=None, acct_len=None):
    """TDMA comm time sum_{selected} ell / rate (Eq. 8) and expected power
    sum P q (over ``valid`` lanes)."""
    both = _fit_account_axis(account_summands(gains, sel, q, p, acct, valid),
                             acct_len)
    t_comm, power = blocked_total(both).unbind(0)
    return t_comm, power


def decision_step(policy_step, acct: AccountCoeffs, raw, gains, pol_state,
                  *, valid=None, acct_len: Optional[int] = None):
    """Policy step + accounting: ``(sel, q, p, t_comm, power, n_sel,
    pol_state')``.

    ``policy_step(raw, gains, state)`` is any policy of the registry;
    ``raw`` is its pre-drawn randomness. ``acct`` may hold floats or
    tensors on the lanes' device that broadcast against them (the
    service's (B, 1) per-row columns).

    ``valid`` is a boolean lane mask that gates the expected-power
    summand: the service's real (non-pad) lanes, or the population
    engine's activity mask (``fl/population.py``), passed every round
    (there the policy step masks q itself; the fused decision also sets
    q to 0 on the mask's False lanes before selection). ``acct_len`` is
    the service's tenant accounting length. The population-free engine
    passes neither.
    """
    sel, q, p, pol_state = policy_step(raw, gains, pol_state)
    t_comm, power = _account(gains, sel, q, p, acct, valid, acct_len)
    return sel, q, p, t_comm, power, sel.sum(-1), pol_state


def make_fused_decision(scfg: SchedulerConfig, co: DecisionCoeffs):
    """A :func:`decision_step` drop-in that serves ``proposed`` through the
    fused CUDA kernel (``kernels/decision_fused.py``).

    ``co`` is the host bundle, packed once into the kernel's operand
    vector. The returned callable has ``decision_step``'s signature:
    ``policy_step`` is ignored (the kernel is the policy), ``raw`` is the
    (N,) selection uniforms, and ``acct`` (None: ``co.acct``) feeds the
    accounting. As in the reference, the comm-time and power summands are
    refolded here from the kernel's (sel, q, p), so the totals are the
    stitched path's expressions on the final selection. ``valid`` masks
    the kernel's q to 0 before selection and gates the power summand, as
    the reference's population path uses it.
    """
    ops = pack_decision_operands(co.solve, co.acct)

    def fused_decision(policy_step, acct, u, gains, pol_state, *,
                       valid=None, acct_len: Optional[int] = None):
        del policy_step
        sel, q, p, z_new, _tc, _pq = decision_fused(
            gains, pol_state.z, u, ops, active=valid, valid=valid)
        if scfg.guarantee_one:
            sel = force_one(sel, q)
        t_comm, power = _account(gains, sel, q, p,
                                 co.acct if acct is None else acct, valid,
                                 acct_len)
        st = PolicyState(z_new, pol_state.aux, pol_state.t + 1)
        return sel, q, p, t_comm, power, sel.sum(), st

    return fused_decision
