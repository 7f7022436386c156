"""Selection-policy registry: Algorithm 2 and five baselines (twin of
``repro/core/policies.py``).

Every policy is a step ``step(raw, gains, state, active=None,
n_active=None) -> (selected, q, P, state)`` over the shared
:class:`PolicyState`, where ``raw`` is the policy's pre-drawn randomness:

* ``proposed`` — Algorithm 2: Theorem-2 solve, Bernoulli selection from
  (N,) uniforms, Eq. (9) queue update;
* ``uniform`` — the paper's M-matched uniform baseline, P = Pbar N / M';
* ``greedy_channel`` — the top-M instantaneous channels (biased: q is the
  realized indicator; it draws nothing);
* ``proportional_gain`` — Bernoulli selection with q proportional to the
  gain, scaled to mean M and floored at ``q_floor``;
* ``update_aware`` — q proportional to an accumulated-update-norm proxy in
  ``aux`` (grows by one a skipped round, resets to one on transmission),
  floored at ``q_floor``;
* ``aoi_capped`` — clients whose age (``aux``) reached ``max_age`` are
  forced in, the other slots go to the best channels; q in {0, 1}.

``proportional_gain`` and ``update_aware`` draw the same (N,) uniforms
as ``proposed`` (the reference draws ``uniform(key, (n,))`` on the step
key for all three); ``aoi_capped`` draws nothing. The baselines use
P = Pbar N / M' (M' the round's selection count, or M).

Dynamic populations (``fl/population.py``) pass ``(active, n_active)``:
an (N,) bool mask and its count. Each step then sets q to 0 on inactive
lanes before selection and before the Eq. 9 update, and clips its subset
size into the active count. ``None`` runs exactly the unmasked ops. All
steps work row by row over the last axis, so the sweep runs S seeds as
(S, N) rows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import (SchedulerConfig, _f32, _fill,
                                        _p_over_m, _top_m, greedy_coeffs,
                                        greedy_decide, selection_from_uniform,
                                        solve_coeffs, solve_round_coeffs,
                                        uniform_coeffs, uniform_decide,
                                        update_queues_z)


class PolicyState(NamedTuple):
    """Cross-policy state, as in the reference."""

    z: torch.Tensor    # (N,) f32: Algorithm-2 virtual power queues (Eq. 9)
    aux: torch.Tensor  # (N,) f32: update-norm proxy or age of information
    t: torch.Tensor    # ()   i32: round counter


PolicyStep = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 PolicyState]]


def _aux0_zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


def _aux0_ones(n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def _mask(x: torch.Tensor, active) -> torch.Tensor:
    return x if active is None else torch.where(active, x, 0.0)


def _budget_power(pn: float, sel: torch.Tensor) -> torch.Tensor:
    """P = Pbar N / max(M', 1) on every lane, M' the row's selection
    count: one IEEE division a row of the host-folded Pbar N (filled on
    the device, no host-to-device copy)."""
    return _fill(_p_over_m(sel.new_full((), pn, dtype=torch.float32),
                           sel.sum(-1)), sel)


def greedy_channel(raw, gains: torch.Tensor, m: int, ch: ChannelConfig):
    """Select the top-m channels: ``(selected, q, P)``, q the realized
    indicator (no inverse-propensity weight exists for a client that is
    never selected)."""
    return greedy_decide(gains, greedy_coeffs(gains.shape[-1], float(m),
                                              ch))


def proportional_gain(u, gains: torch.Tensor, m_avg: float,
                      ch: ChannelConfig, q_floor: float = 1e-3,
                      active=None):
    """Bernoulli selection from uniforms ``u`` with q = clip(g / sum(g) M,
    q_floor, 1), g the gains (0 on inactive lanes, whose q is 0):
    ``(selected, q, P)``."""
    g = _mask(gains, active)
    q = g / g.sum(-1, keepdim=True) * _f32(m_avg)
    q = _mask(torch.clamp(q, _f32(q_floor), 1.0), active)
    sel = u < q
    return sel, q, _budget_power(_f32(ch.p_bar * gains.shape[-1]), sel)


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

    def step(u, gains, st: PolicyState, active=None, n_active=None):
        q, p = solve_fn(gains, st.z)
        q = _mask(q, active)
        sel = selection_from_uniform(u, q, scfg.guarantee_one)
        z = update_queues_z(st.z, q, p, coeffs)
        return sel, q, p, PolicyState(z, st.aux, st.t + 1)

    return step


def _make_uniform(scfg: SchedulerConfig, ch: ChannelConfig, m_avg,
                  solve_fn, coeffs) -> PolicyStep:
    c = uniform_coeffs(scfg.n_clients, m_avg, ch)

    def step(raw, gains, st: PolicyState, active=None, n_active=None):
        sel, q, p = uniform_decide(raw, c, active, n_active)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return step


def _make_greedy(scfg: SchedulerConfig, ch: ChannelConfig, m_avg,
                 solve_fn, coeffs) -> PolicyStep:
    c = greedy_coeffs(scfg.n_clients, m_avg, ch)

    def step(raw, gains, st: PolicyState, active=None, n_active=None):
        sel, q, p = greedy_decide(gains, c, active, n_active)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return step


def _make_proportional(scfg, ch, m_avg, solve_fn, coeffs,
                       q_floor: float = 1e-3) -> PolicyStep:
    def step(u, gains, st: PolicyState, active=None, n_active=None):
        sel, q, p = proportional_gain(u, gains, m_avg, ch, q_floor, active)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return step


def _make_update_aware(scfg, ch, m_avg, solve_fn, coeffs,
                       q_floor: float = 1e-3) -> PolicyStep:
    """q proportional to the update-norm proxy ``aux``; an away client's
    proxy stays frozen (no local training while away)."""
    pn = _f32(ch.p_bar * scfg.n_clients)

    def step(u, gains, st: PolicyState, active=None, n_active=None):
        norms = st.aux
        eff = _mask(norms, active)
        q = eff / torch.clamp_min(eff.sum(-1, keepdim=True), 1e-12) * _f32(
            m_avg)
        q = _mask(torch.clamp(q, _f32(q_floor), 1.0), active)
        sel = u < q
        aux = torch.where(sel, 1.0, norms + 1.0)
        if active is not None:
            aux = torch.where(active, aux, norms)
        return sel, q, _budget_power(pn, sel), PolicyState(st.z, aux,
                                                           st.t + 1)

    return step


_FORCE = 1e30  # an aoi-forced lane's score, above every clipped gain


def _make_aoi_capped(scfg, ch, m_avg, solve_fn, coeffs,
                     max_age: Optional[int] = None) -> PolicyStep:
    """Clients of age >= ``max_age`` (default max(2, round(2 N / M))) are
    all selected; the remaining slots of M go to the best channels. An
    away client keeps aging, so it is force-eligible on return."""
    n = scfg.n_clients
    m = max(1, int(round(m_avg)))
    if max_age is None:
        max_age = max(2, int(round(2.0 * n / m)))
    cap = _f32(max_age)
    pn = _f32(ch.p_bar * n)

    def step(raw, gains, st: PolicyState, active=None, n_active=None):
        age = st.aux
        forced = age >= cap
        m_eff = torch.full(gains.shape[:-1], m, dtype=torch.long,
                           device=gains.device)
        if active is not None:
            forced = forced & active
        score = torch.where(forced, _FORCE, gains)
        if active is not None:
            score = torch.where(active, score, -torch.inf)
            m_eff = torch.clamp_min(torch.minimum(
                m_eff, torch.clamp_min(n_active.long(), 1)), 1)
        # the ``| forced`` union keeps every forced lane when there are
        # more of them than slots (they all tie at the top score)
        sel = _top_m(score, m_eff) | forced
        aux = torch.where(sel, 0.0, age + 1.0)
        return (sel, sel.to(torch.float32), _budget_power(pn, sel),
                PolicyState(st.z, aux, st.t + 1))

    return step


# name -> (builder, aux initialiser, needs matched M?), the reference's
# order
POLICIES = {
    "proposed": (_make_proposed, _aux0_zeros, False),
    "uniform": (_make_uniform, _aux0_zeros, True),
    "greedy_channel": (_make_greedy, _aux0_zeros, True),
    "proportional_gain": (_make_proportional, _aux0_zeros, True),
    "update_aware": (_make_update_aware, _aux0_ones, True),
    "aoi_capped": (_make_aoi_capped, _aux0_zeros, True),
}
# name -> the keyword parameters its builder takes
POLICY_PARAMS = {"proposed": (), "uniform": (), "greedy_channel": (),
                 "proportional_gain": ("q_floor",),
                 "update_aware": ("q_floor",), "aoi_capped": ("max_age",)}

# Stable ids in the registry's order (proposed 0, uniform 1), as the
# reference's.
POLICY_IDS = {name: i for i, name in enumerate(POLICIES)}


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


# The reference's three draw plans (the service serves these policies
# and reads this registry's keys).
POLICY_DRAWS = {"proposed": draw_selection_uniform,
                "uniform": _draw_uniform,
                "greedy_channel": _draw_greedy}

# Which stream of a ``Draws`` source (``fl/engine.py``) each policy's step
# consumes: proportional_gain and update_aware draw proposed's selection
# uniforms, greedy_channel and aoi_capped nothing.
POLICY_RAW = {"proposed": "selection_u", "uniform": "uniform_raw",
              "greedy_channel": None, "proportional_gain": "selection_u",
              "update_aware": "selection_u", "aoi_capped": None}


def policy_raw(draws, name: str, r: int):
    """Round ``r``'s raw of policy ``name`` from a ``Draws`` (or
    ``SweepDraws``) source; ``()`` for a policy that draws nothing."""
    stream = POLICY_RAW[name]
    return () if stream is None else getattr(draws, stream)(r)


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
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r} "
                         f"(registered: {sorted(POLICIES)})")
    return POLICIES[name]


def check_policy(name: str, params=()) -> dict:
    """``params`` ((name, value) pairs or a dict) of a registered policy,
    as a dict; unknown policies and parameters raise ``ValueError``."""
    _lookup(name)
    params = dict(params)
    bad = sorted(set(params) - set(POLICY_PARAMS[name]))
    if bad:
        raise ValueError(f"policy {name!r} takes no policy_params {bad} "
                         f"(its params: {list(POLICY_PARAMS[name])})")
    return params


def policy_aux_init(name: str, n_clients: int,
                    device="cuda") -> torch.Tensor:
    """A policy's initial (N,) aux scratch (ones for update_aware, zeros
    for the others)."""
    return _lookup(name)[1](n_clients, device)


def init_policy_state(name: str, n_clients: int,
                      device="cuda") -> PolicyState:
    """Fresh state: zero queues, the policy's aux, round 0."""
    return PolicyState(
        z=torch.zeros((n_clients,), dtype=torch.float32, device=device),
        aux=policy_aux_init(name, n_clients, device),
        t=torch.zeros((), dtype=torch.int32, device=device))


def make_policy(name: str, scfg: SchedulerConfig, ch: ChannelConfig, *,
                m_avg: float = 0.0, solve_fn=None, coeffs=None,
                **params) -> PolicyStep:
    """Bind a policy to its configuration. ``m_avg`` is the matched M the
    baselines need (> 0); ``solve_fn``/``coeffs`` only concern
    ``proposed``; ``params`` are ``q_floor`` (proportional_gain,
    update_aware) or ``max_age`` (aoi_capped)."""
    builder, _, needs_m = _lookup(name)
    if needs_m and not m_avg > 0.0:
        raise ValueError(f"policy {name!r} needs m_avg > 0 (matched average "
                         f"participation), got {m_avg!r}")
    return builder(scfg, ch, m_avg, solve_fn, coeffs,
                   **check_policy(name, params))
