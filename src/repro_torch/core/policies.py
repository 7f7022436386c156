"""Selection policies of the main path (twin of ``repro/core/policies.py``).

Every policy is a step ``step(raw, gains, state) -> (selected, q, P,
state)`` over the shared :class:`PolicyState`, where ``raw`` is the
policy's pre-drawn randomness (the reference's ``POLICY_DRAWS`` raws):

* ``proposed`` — Algorithm 2: Theorem-2 solve, Bernoulli selection from
  (N,) uniforms, Eq. (9) queue update;
* ``uniform`` — the paper's M-matched uniform baseline, P = Pbar N / M';
* ``greedy_channel`` — the top-M instantaneous channels, P = Pbar N / M
  (biased: q is the realized indicator; it draws no randomness).

The reference's other policies (proportional_gain, update_aware,
aoi_capped) are ROADMAP §A item 2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import (SchedulerConfig, greedy_coeffs,
                                        greedy_decide, selection_from_uniform,
                                        solve_round_coeffs, solve_coeffs,
                                        uniform_coeffs, uniform_decide,
                                        update_queues_z)


class PolicyState(NamedTuple):
    """Cross-policy state, as in the reference."""

    z: torch.Tensor    # (N,) f32: Algorithm-2 virtual power queues (Eq. 9)
    aux: torch.Tensor  # (N,) f32: policy scratch (unused by this slice)
    t: torch.Tensor    # ()   i32: round counter


PolicyStep = Callable[[object, torch.Tensor, PolicyState],
                      Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            PolicyState]]


def _make_proposed(scfg: SchedulerConfig, ch: ChannelConfig, m_avg,
                   solve_fn, coeffs) -> PolicyStep:
    """Algorithm 2. ``solve_fn(gains, z) -> (q, P)`` overrides the solve
    (the CUDA solve kernel); otherwise the coefficient-driven stitched
    solve runs on ``coeffs`` (default: the configs' bundle)."""
    if coeffs is None:
        coeffs = solve_coeffs(scfg, ch)
    if solve_fn is None:
        def solve_fn(gains, z):
            return solve_round_coeffs(gains, z, coeffs)

    def step(u, gains, st: PolicyState):
        q, p = solve_fn(gains, st.z)
        sel = selection_from_uniform(u, q, scfg.guarantee_one)
        z = update_queues_z(st.z, q, p, coeffs)
        return sel, q, p, PolicyState(z, st.aux, st.t + 1)

    return step


def _make_uniform(scfg: SchedulerConfig, ch: ChannelConfig, m_avg,
                  solve_fn, coeffs) -> PolicyStep:
    c = uniform_coeffs(scfg.n_clients, m_avg, ch)

    def step(raw, gains, st: PolicyState):
        sel, q, p = uniform_decide(raw, c)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return step


def _make_greedy(scfg: SchedulerConfig, ch: ChannelConfig, m_avg,
                 solve_fn, coeffs) -> PolicyStep:
    c = greedy_coeffs(scfg.n_clients, m_avg, ch)

    def step(raw, gains, st: PolicyState):
        sel, q, p = greedy_decide(gains, c)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return step


# name -> (builder, needs matched M?)
POLICIES = {
    "proposed": (_make_proposed, False),
    "uniform": (_make_uniform, True),
    "greedy_channel": (_make_greedy, True),
}
# The reference's policies that this port does not have yet.
NOT_PORTED = ("proportional_gain", "update_aware", "aoi_capped")


def draw_selection_uniform(generator: torch.Generator, n: int,
                           device) -> torch.Tensor:
    """The ``proposed`` policy's (N,) selection uniforms in [0, 1)."""
    return torch.rand((n,), generator=generator, device=device)


def _draw_uniform(generator: torch.Generator, n: int, device) -> dict:
    """The uniform baseline's raws: the ceil-branch Bernoulli uniform and
    the (N,) selection scores."""
    return {"take": torch.rand((), generator=generator, device=device),
            "scores": torch.rand((n,), generator=generator, device=device)}


def _draw_greedy(generator: torch.Generator, n: int, device) -> tuple:
    return ()  # deterministic given the gains


POLICY_DRAWS = {"proposed": draw_selection_uniform,
                "uniform": _draw_uniform,
                "greedy_channel": _draw_greedy}

# Pad fills of each policy's raws along a padded client axis (the
# reference's ``fl/client_shard.py::POLICY_RAW_PAD``): proposed pads its
# selection uniforms with 2.0 (never < q <= 1), uniform its scores with
# -1.0 (below every real score in [0, 1)).
POLICY_RAW_PAD = {
    "proposed": 2.0,
    "uniform": {"take": 0.0, "scores": -1.0},
    "greedy_channel": (),
}


def _lookup(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet (ROADMAP §A item 2)")
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r} "
                         f"(registered: {sorted(POLICIES)})")
    return POLICIES[name]


def policy_aux_init(name: str, n_clients: int,
                    device="cuda") -> torch.Tensor:
    """A policy's initial (N,) aux scratch (zeros for every ported
    policy)."""
    _lookup(name)
    return torch.zeros((n_clients,), dtype=torch.float32, device=device)


def init_policy_state(name: str, n_clients: int,
                      device="cuda") -> PolicyState:
    """Fresh state: zero queues, the policy's aux, round 0."""
    return PolicyState(
        z=torch.zeros((n_clients,), dtype=torch.float32, device=device),
        aux=policy_aux_init(name, n_clients, device),
        t=torch.zeros((), dtype=torch.int32, device=device))


def make_policy(name: str, scfg: SchedulerConfig, ch: ChannelConfig, *,
                m_avg: float = 0.0, solve_fn=None,
                coeffs=None) -> PolicyStep:
    """Bind a policy to its configuration. ``m_avg`` is the matched M the
    baselines need (> 0); ``solve_fn``/``coeffs`` only concern
    ``proposed``."""
    builder, needs_m = _lookup(name)
    if needs_m and not m_avg > 0.0:
        raise ValueError(f"policy {name!r} needs m_avg > 0 (matched average "
                         f"participation), got {m_avg!r}")
    return builder(scfg, ch, m_avg, solve_fn, coeffs)
