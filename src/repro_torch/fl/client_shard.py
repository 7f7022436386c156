"""Client-axis sharded scheduling over ``torch.distributed`` ranks (twin of
``repro/fl/client_shard.py``).

The scheduler consumes only instantaneous CSI, so the aggregator re-solves
Theorem 2 for every client every round: at millions of users the (N,)
channel -> solve -> select -> account pipeline is the hot path. Here the
client axis is split over the ranks of a ``'client'`` process group
(``fl/sharding.py::make_mesh2d``), one process per device:

* every rank draws the same full-shape (N,) raws from the run's ``Draws``
  source and takes its slice (:class:`ClientLayout`), so the bits do not
  depend on the mesh and no draw is broadcast;
* each rank steps its slice of the fading process and runs its slice of
  the decision: the Theorem-2 solve through K1 (``solver="cuda"``), the
  fused decision through K2 (``"cuda_fused"``, with the activity mask
  under a population) or plain PyTorch (``"stitched"``);
* guarantee-one and the churn's never-empty rule become a count
  (``all_reduce`` SUM) and a global argmax (MAX, then MIN of the index);
* the uniform and greedy baselines' full sort becomes a per-rank
  ``topk`` and a merge of the all-gathered candidates
  (:func:`_top_m_threshold`: the same value as the sequential sort);
* participant packing is a per-rank pack and a merge of the all-gathered
  <= m_cap indices in global order (:func:`_pack_participants_sharded`);
* the accounting is the fixed-association blocked reduce, whose 96 block
  partials are the only float bytes that cross ranks
  (``fl/sharding.py::blocked_total_sharded``).

Layout: with one client shard the rank holds the whole (N,) axis
unpadded. With Dc > 1 the axis is padded to whole accounting blocks
(``padded_len``) and split evenly; pad lanes take the reference's fills
(:data:`CHANNEL_RAW_PAD`, ``POLICY_RAW_PAD``) so they stay finite, never
select and add exactly 0 to the accounting. A run carries only its own
lanes of the policy and channel state between rounds.

Numeric contract (tests/test_torch_client_sharded.py): one client shard
runs the sequential engine's ops on the same tensors, so it equals
``run_simulation_scan`` bit for bit; on wider meshes selections, packs
and thresholds are selections, not arithmetic, so ``n_selected`` stays
exact, and the float accounting adds the same block partials in the same
order (comm time and power within rtol 3e-7 of the sequential run).

Policies with a sharded form: ``proposed``, ``uniform``,
``greedy_channel``. The others need global normalisations with no exact
sharded form and are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.channel import (CHANNEL_RAW, ChannelConfig,
                                      make_channel)
from repro_torch.core.policies import (POLICIES, POLICY_RAW_PAD,
                                       PolicyState, init_policy_state,
                                       make_policy, policy_raw)
from repro_torch.core.scheduler import (SchedulerConfig, _f32, _fill,
                                        _p_over_m, _per_row, as_operands,
                                        greedy_coeffs, uniform_coeffs,
                                        uniform_draw_m)
from repro_torch.fl.decision import (account_summands, decision_coeffs,
                                     decision_step, make_fused_decision)
from repro_torch.fl.population import failure_split, population_config
from repro_torch.fl.round import pack_participants
from repro_torch.fl.sharding import (ACCOUNT_BLOCKS, Mesh2D, all_gather,
                                     blocked_total_sharded, make_mesh2d,
                                     pad_client_axis, padded_len, pmax,
                                     pmin, psum)
from repro_torch.kernels.decision_fused import (decision_fused,
                                                pack_decision_operands)

_I64_MAX = torch.iinfo(torch.int64).max

# Pad fills of each channel model's raws along the client axis: uniforms
# feeding log() pad with 1.0 (log 1 = 0), normals with 0.0, outage_burst's
# transition uniform with 1.0 (a pad lane never enters an outage).
CHANNEL_RAW_PAD = {
    "rayleigh": 1.0,
    "rician": 0.0,
    "lognormal": (1.0, 0.0),
    "gauss_markov": 0.0,
    "mobility": 0.0,
    "outage_burst": (1.0, 1.0),
}

# --------------------------------------------------------------------------
# Which lanes a rank holds.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClientLayout:
    """This rank's share of the (N,) client axis over ``n_shards`` ranks
    (``index`` is its client coordinate, ``group`` the client group)."""

    n: int
    n_shards: int
    index: int
    group: object

    @property
    def n_local(self) -> int:
        """Lanes a rank holds: N on one shard, else padded_len(N) / Dc."""
        if self.n_shards == 1:
            return self.n
        return padded_len(self.n) // self.n_shards

    @property
    def start(self) -> int:
        """The global index of this rank's first lane."""
        return self.index * self.n_local

    @property
    def has_pads(self) -> bool:
        return self.start + self.n_local > self.n

    def local(self, x, fill):
        """This rank's lanes of a full-shape raw (a tensor whose last axis
        is the client axis, or a tuple or dict of them; 0-d leaves pass),
        padded with ``fill`` (a matching tree of fills) past N."""
        if isinstance(x, tuple):
            return tuple(self.local(a, f) for a, f in zip(x, fill))
        if isinstance(x, dict):
            return {k: self.local(v, fill[k]) for k, v in x.items()}
        if x.ndim == 0:
            return x
        lo = min(self.start, self.n)
        hi = min(self.start + self.n_local, self.n)
        return pad_client_axis(x[..., lo:hi], self.n_local, fill)

    def lanes(self, device):
        """``(local_ids, valid)``: the global index of each lane, and the
        real-lane mask (None where this rank holds no pad lane)."""
        ids = torch.arange(self.start, self.start + self.n_local,
                           device=device)
        return ids, (ids < self.n if self.has_pads else None)

    def local_state(self, pol_state: PolicyState, carry):
        """The sequential engine's round-0 state -> this rank's lanes; the
        population's ``(ch_state, active)`` carry pads ``active`` with
        False."""
        pol_state = PolicyState(self.local(pol_state.z, 0.0),
                                self.local(pol_state.aux, 0.0), pol_state.t)
        if isinstance(carry, tuple):
            return pol_state, (self.local(carry[0], 0.0),
                               self.local(carry[1], False))
        return pol_state, self.local(carry, 0.0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full (..., N) tensor from every rank's (..., n_local) lanes
        (one all-gather over the client group; bool travels as uint8)."""
        dtype = x.dtype
        wire = x.to(torch.uint8) if dtype == torch.bool else x
        full = all_gather(wire, self.group).movedim(0, -2)
        full = full.reshape(*x.shape[:-1], -1)[..., :self.n]
        return full.to(dtype)


def check_client_shards(n_shards: int, policy: str, channel: str):
    """Fail fast on an unusable shard count, policy or channel."""
    if n_shards < 1 or ACCOUNT_BLOCKS % n_shards:
        raise ValueError(
            f"client_shards={n_shards} must divide ACCOUNT_BLOCKS="
            f"{ACCOUNT_BLOCKS} (the fixed association width of the exact "
            f"accounting reduce; see repro_torch/fl/sharding.py)")
    if policy not in _STEPS:
        raise ValueError(
            f"policy {policy!r} has no client-sharded implementation "
            f"(sharded: {sorted(_STEPS)}); it needs a global "
            "normalization with no exact sharded form")
    if channel not in CHANNEL_RAW:
        raise ValueError(f"unknown channel model {channel!r} "
                         f"(registered: {sorted(CHANNEL_RAW)})")


def client_layout(n: int, client_shards: int,
                  participant_shards: int = 0) -> Optional[ClientLayout]:
    """This rank's layout of N clients on the ``(client_shards,
    participant_shards)`` mesh; None without client shards."""
    if not client_shards:
        return None
    mesh = make_mesh2d(client_shards, participant_shards)
    return ClientLayout(n, mesh.dc, mesh.c, mesh.client_group)


# --------------------------------------------------------------------------
# Cross-shard selections (the reference's psum / pmax / pmin / all_gather).
# --------------------------------------------------------------------------

def _global_argmax(score: torch.Tensor, start: int, group) -> torch.Tensor:
    """``argmax`` of the sharded vector: the first global index attaining
    the maximum (a selection, exact on any mesh)."""
    lmax = score.max()
    gmax = pmax(lmax, group)
    cand = torch.where(lmax == gmax, score.argmax() + start, _I64_MAX)
    return pmin(cand, group)


def _force_one(sel, q, live, local_ids, start: int, group):
    """Guarantee-one across the shards: an empty selection becomes the
    lane of largest q among ``live`` lanes (all lanes when None), the
    first on ties, as ``core.scheduler.force_one``. Returns ``(sel,
    n_sel)``."""
    count = psum(sel.sum(), group)
    score = q if live is None else torch.where(live, q, -torch.inf)
    forced_at = _global_argmax(score, start, group)
    none = count == 0
    return (torch.where(none, local_ids == forced_at, sel),
            torch.where(none, torch.ones_like(count), count))


def _top_m_threshold(score, m, k_static: int, group):
    """The m-th largest entry of a sharded score vector: a per-rank
    ``topk`` of ``k_static >= min(m, n_local)`` candidates (their union
    holds the global top m), an all-gather, one small sort. The same
    value as the sequential sort, whatever order ties come in; ``m`` is
    a 0-d tensor."""
    cand = torch.topk(score, k_static).values
    merged = all_gather(cand, group).reshape(-1)
    ordered = torch.sort(merged, descending=True).values
    return ordered.gather(0, (m - 1).reshape(1)).reshape(())


def _pack_participants_sharded(delivered, q, m_cap: int,
                               layout: ClientLayout):
    """Each rank packs its own participants (ascending), then the packs
    merge in rank order: ascending global order, the sequential
    ``pack_participants`` indices. Only (Dc, m_cap + 1) indices and counts
    and (Dc, m_cap) q values cross ranks. Returns ``(sel_idx, sel_valid,
    q_sel)``; q is 1 on dead slots (their weight is 0 either way)."""
    lidx, _ = pack_participants(delivered, m_cap)
    ints = torch.cat([lidx + layout.start, delivered.sum().reshape(1)])
    every = all_gather(ints, layout.group)                 # (Dc, m_cap + 1)
    all_q = all_gather(q[lidx], layout.group).reshape(-1)
    counts = every[:, m_cap]
    slots = torch.arange(m_cap, device=q.device)
    take, sel_valid = pack_participants(
        (slots[None, :] < counts[:, None]).reshape(-1), m_cap)
    sel_idx = torch.where(sel_valid, every[:, :m_cap].reshape(-1)[take], 0)
    return sel_idx, sel_valid, torch.where(sel_valid, all_q[take], 1.0)


# --------------------------------------------------------------------------
# Sharded policy steps: step(raw, gains, state, active, n_act) -> (sel, q,
# p, state, n_sel) on this rank's lanes.
# --------------------------------------------------------------------------

class _Shard:
    """What a policy step needs of the layout on one device."""

    def __init__(self, layout: ClientLayout, device):
        self.layout, self.group = layout, layout.group
        self.start = layout.start
        self.ids, self.valid = layout.lanes(device)

    def live(self, active):
        return self.valid if active is None else active

    def mask(self, x, keep):
        return x if keep is None else x & keep


def _proposed(scfg, ch, m_avg, solve_fn, co_host, co, shard: _Shard):
    """Algorithm 2 on the shard: the registry's step without its local
    guarantee-one (the solve through ``solve_fn``, K1 under
    ``solver="cuda"``), then the cross-shard one."""
    step = make_policy("proposed",
                       dataclasses.replace(scfg, guarantee_one=False), ch,
                       solve_fn=solve_fn, coeffs=co.solve)

    def run(u, gains, st, active, n_act):
        sel, q, p, st = step(u, gains, st, active, n_act)
        sel, n_sel = _select(scfg, sel, q, active, shard)
        return sel, q, p, st, n_sel

    return run


def _proposed_fused(scfg, ch, m_avg, solve_fn, co_host, co, shard: _Shard):
    """Algorithm 2 through the fused decision kernel (K2) on the shard's
    lanes: solve, activity mask, Bernoulli selection and the Eq. 9 update
    in one pass, then the cross-shard guarantee-one."""
    ops = pack_decision_operands(co_host.solve, co_host.acct)

    def run(u, gains, st, active, n_act):
        sel, q, p, z, _tc, _pq = decision_fused(gains, st.z, u, ops,
                                                active=active, valid=active)
        sel, n_sel = _select(scfg, sel, q, active, shard)
        return sel, q, p, PolicyState(z, st.aux, st.t + 1), n_sel

    return run


def _select(scfg, sel, q, active, shard: _Shard):
    if scfg.guarantee_one:
        return _force_one(sel, q, shard.live(active), shard.ids, shard.start,
                          shard.group)
    return sel, psum(sel.sum(), shard.group)


def _uniform(scfg, ch, m_avg, solve_fn, co_host, co, shard: _Shard):
    """The M-matched uniform baseline: the top-M' scores over every shard
    (``core.scheduler.uniform_decide``'s ops on the shard's lanes)."""
    m_hi = int(m_avg // 1) + 1          # M' <= floor(M) + 1
    k_static = max(1, min(shard.layout.n_local, m_hi, shard.layout.n))
    c_host = uniform_coeffs(shard.layout.n, m_avg, ch)

    def run(raw, gains, st, active, n_act):
        scores = raw["scores"]
        c = _per_row(c_host, scores)
        take_hi = raw["take"] < (c.m_avg - torch.floor(c.m_avg))
        m = uniform_draw_m(take_hi, c.m_avg, c.n, n_act)
        q = _fill(c.q_val, scores)
        live = shard.live(active)
        if live is not None:
            scores = torch.where(live, scores, -1.0)
        if active is not None:
            q = torch.where(active, q, 0.0)
        thresh = _top_m_threshold(scores, m, k_static, shard.group)
        sel = shard.mask(scores >= thresh, shard.valid)
        return (sel, q, _fill(_p_over_m(c.pn, m), scores),
                PolicyState(st.z, st.aux, st.t + 1),
                psum(sel.sum(), shard.group))

    return run


def _greedy(scfg, ch, m_avg, solve_fn, co_host, co, shard: _Shard):
    """The top-M channels over every shard (``core.scheduler.
    greedy_decide``'s ops on the shard's lanes)."""
    c_host = greedy_coeffs(shard.layout.n, m_avg, ch)
    k_static = max(1, min(shard.layout.n_local, c_host.m, shard.layout.n))

    def run(raw, gains, st, active, n_act):
        c = _per_row(c_host, gains)
        m = c.m.long()
        live = shard.live(active)
        score = gains if live is None else torch.where(live, gains,
                                                       -torch.inf)
        m_eff = m if active is None else torch.clamp_min(torch.minimum(
            m, torch.clamp_min(n_act.long(), 1)), 1)
        thresh = _top_m_threshold(score, m_eff, k_static, shard.group)
        sel = shard.mask(score >= thresh, shard.valid)
        return (sel, sel.to(torch.float32), _fill(_p_over_m(c.pn, m), gains),
                PolicyState(st.z, st.aux, st.t + 1),
                psum(sel.sum(), shard.group))

    return run


_STEPS = {"proposed": _proposed, "uniform": _uniform,
          "greedy_channel": _greedy}


# --------------------------------------------------------------------------
# The sharded schedule of one round.
# --------------------------------------------------------------------------

def make_sharded_schedule(sim_policy: str, sim_channel: str,
                          channel_params: tuple, scfg: SchedulerConfig,
                          ch: ChannelConfig, sigmas: torch.Tensor, *,
                          n_shards: int, m_avg: float = 0.0,
                          solver: str = "cuda_fused", population=None,
                          mesh: Optional[Mesh2D] = None):
    """The client-sharded scheduling step of one round on this rank.

    Returns ``schedule(raw_ch, raw_pol, pol_state, ch_state) -> (sel, q,
    p, delivered, t_comm, power, n_sel, pol_state', ch_state')``. The raws
    are the full-shape (N,) draws of the round (the same on every rank);
    the states, and sel, q, p and delivered, hold this rank's lanes
    (:meth:`ClientLayout.local_state` makes them from the sequential
    engine's); t_comm, power and n_sel are the round's totals, the same on
    every rank.

    ``population`` (a ``PopulationConfig`` or its params) switches on the
    dynamic population: ``schedule(raw_ch, raw_pol, (raw_churn,
    raw_fail), pol_state, (ch_state, active))``, churn first (its
    never-empty rule across the shards), the decision masked by
    ``active`` (K2 with its mask under ``"cuda_fused"``), and stragglers
    dropped from ``delivered`` but charged in t_comm and n_sel.

    ``solver``: ``"cuda_fused"`` runs K2 per shard (``proposed`` only;
    other policies keep their plain step), ``"cuda"`` solves through K1,
    ``"stitched"`` plain PyTorch. ``mesh`` is
    the composed round's mesh (its ``client_group`` of extent
    ``n_shards``); None builds ``(n_shards, 1)``.
    """
    from repro_torch.fl.engine import SOLVERS, make_solve_fn

    check_client_shards(n_shards, sim_policy, sim_channel)
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (want one of "
                         f"{SOLVERS})")
    if POLICIES[sim_policy][2] and not m_avg > 0.0:
        raise ValueError(f"policy {sim_policy!r} needs m_avg > 0 (matched "
                         f"average participation), got {m_avg!r}")
    if mesh is None:
        mesh = make_mesh2d(n_shards, 1)
    elif mesh.dc != n_shards:
        raise ValueError(f"client_shards={n_shards} != the mesh's 'client' "
                         f"extent {mesh.dc}")
    n = int(sigmas.shape[0])
    layout = ClientLayout(n, mesh.dc, mesh.c, mesh.client_group)
    shard = _Shard(layout, sigmas.device)
    chan = make_channel(sim_channel, layout.local(sigmas, 0.0), ch,
                        **dict(channel_params))
    ch_pad = CHANNEL_RAW_PAD[sim_channel]
    pol_pad = POLICY_RAW_PAD[sim_policy]
    co_host = decision_coeffs(scfg, ch)
    co = type(co_host)(*(as_operands(c, sigmas) for c in co_host))
    solve_fn = make_solve_fn(scfg, ch) if solver == "cuda" else None
    fused = solver == "cuda_fused" and sim_policy == "proposed"
    make_step = _proposed_fused if fused else _STEPS[sim_policy]
    policy_step = make_step(scfg, ch, m_avg, solve_fn, co_host, co, shard)
    pcfg = None if population is None else population_config(population)

    def decide(raw_ch, raw_pol, pol_state, ch_state, active, n_act):
        gains, ch_state = chan.apply(layout.local(raw_ch, ch_pad), ch_state)
        sel, q, p, pol_state, n_sel = policy_step(
            layout.local(raw_pol, pol_pad), gains, pol_state, active, n_act)
        both = account_summands(gains, sel, q, p, co.acct,
                                shard.live(active))
        t_comm, power = blocked_total_sharded(both, layout.group,
                                              layout.n_shards).unbind(0)
        return sel, q, p, t_comm, power, n_sel, pol_state, ch_state

    def schedule(raw_ch, raw_pol, pol_state, ch_state):
        sel, q, p, t_comm, power, n_sel, pol_state, ch_state = decide(
            raw_ch, raw_pol, pol_state, ch_state, None, None)
        return sel, q, p, sel, t_comm, power, n_sel, pol_state, ch_state

    def schedule_pop(raw_ch, raw_pol, raw_pop, pol_state, carry):
        ch_state, active = carry
        raw_churn, raw_fail = (layout.local(x, 2.0) for x in raw_pop)
        # churn: population.churn_step per lane, its never-empty rule
        # across the shards; a pad lane never activates
        new = shard.mask(torch.where(active, raw_churn >= _f32(pcfg.p_leave),
                                     raw_churn < _f32(pcfg.p_join)),
                         shard.valid)
        score = (raw_churn if shard.valid is None
                 else torch.where(shard.valid, raw_churn, -torch.inf))
        forced_at = _global_argmax(score, shard.start, shard.group)
        none = psum(new.sum(), shard.group) == 0
        active = torch.where(none, shard.ids == forced_at, new)
        n_act = psum(active.sum(-1, dtype=torch.int32), shard.group)
        sel, q, p, t_comm, power, n_sel, pol_state, ch_state = decide(
            raw_ch, raw_pol, pol_state, ch_state, active, n_act)
        delivered, _ = failure_split(raw_fail, sel, pcfg)
        return (sel, q, p, delivered, t_comm, power, n_sel, pol_state,
                (ch_state, active))

    return schedule if pcfg is None else schedule_pop


# --------------------------------------------------------------------------
# The scheduling-only runner: the massive-N entry point.
# --------------------------------------------------------------------------

def make_schedule_runner(sigmas: torch.Tensor, scfg: SchedulerConfig,
                         ch: ChannelConfig, *, rounds: int,
                         policy: str = "proposed", m_avg: float = 0.0,
                         channel: str = "rayleigh",
                         channel_params: tuple = (),
                         solver: str = "cuda_fused",
                         client_shards: int = 0):
    """The scheduling layer's trajectory alone (no training, no data).

    ``runner(draws) -> (t_comm, power, n_sel)``, each (rounds,) on
    ``sigmas``' device: per-round TDMA comm time, sum P q and
    participation count. ``draws`` is a ``Draws`` source (``fl/engine.py``;
    its channel and policy streams are read) in place of the reference's
    key.

    ``client_shards=0`` is the sequential reference: the engine's decision
    layer (``decision_step``, or K2's ``make_fused_decision`` under
    ``"cuda_fused"``) on the whole (N,) axis with the same blocked
    accounting reduce, so the sequential and sharded trajectories compare
    exactly. ``client_shards=Dc`` runs :func:`make_sharded_schedule` on
    ``Dc`` ranks (the world size). Nothing is read back before the end.
    """
    from repro_torch.fl.engine import SOLVERS, make_solve_fn

    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (want one of "
                         f"{SOLVERS})")
    n = int(sigmas.shape[0])
    chan = make_channel(channel, sigmas, ch, **dict(channel_params))
    if client_shards:
        schedule = make_sharded_schedule(
            policy, channel, channel_params, scfg, ch, sigmas,
            n_shards=client_shards, m_avg=m_avg, solver=solver)
        layout = client_layout(n, client_shards)

        def round_fn(pol_state, ch_state, draws, r):
            *_, t_comm, power, n_sel, pol_state, ch_state = schedule(
                draws.channel_raw(r), policy_raw(draws, policy, r),
                pol_state, ch_state)
            return pol_state, ch_state, t_comm, power, n_sel
    else:
        layout = None
        co_host = decision_coeffs(scfg, ch)
        co = type(co_host)(*(as_operands(c, sigmas) for c in co_host))
        step = make_policy(policy, scfg, ch, m_avg=m_avg,
                           solve_fn=(make_solve_fn(scfg, ch)
                                     if solver == "cuda" else None),
                           coeffs=co.solve)
        decision = (make_fused_decision(scfg, co_host)
                    if solver == "cuda_fused" and policy == "proposed"
                    else decision_step)

        def round_fn(pol_state, ch_state, draws, r):
            gains, ch_state = chan.apply(draws.channel_raw(r), ch_state)
            *_, t_comm, power, n_sel, pol_state = decision(
                step, co.acct, policy_raw(draws, policy, r), gains,
                pol_state)
            return pol_state, ch_state, t_comm, power, n_sel

    def runner(draws):
        pol_state = init_policy_state(policy, n, sigmas.device)
        ch_state = chan.init(draws.channel_init())
        if layout is not None:
            pol_state, ch_state = layout.local_state(pol_state, ch_state)
        outs = []
        for r in range(rounds):
            pol_state, ch_state, t_comm, power, n_sel = round_fn(
                pol_state, ch_state, draws, r)
            outs.append((t_comm, power, n_sel))
        t_comm, power, n_sel = (torch.stack(x) for x in zip(*outs))
        return t_comm, power, n_sel

    return runner


# --------------------------------------------------------------------------
# The full client-sharded simulation round.
# --------------------------------------------------------------------------

def make_client_sharded_round(ds, sim, scfg: SchedulerConfig,
                              ch: ChannelConfig, sigmas: torch.Tensor,
                              parts):
    """The client-sharded round of the engine (``fl/engine.py``), bound to
    a run's parts (``make_round_parts``: the training tail and its mesh).

    ``sim_round(params, pol_state, ch_state, draws, r)`` has the
    sequential round's signature and outputs, with ``pol_state``,
    ``ch_state`` and the returned ``sel`` and ``q`` on this rank's lanes.
    Scheduling runs on the mesh's ``'client'`` group; the <= m_cap merged
    participants then train as the sequential engine trains them (same
    packed indices, batch draws and masked aggregate), or split over the
    ``'part'`` group under ``participant_shards`` (the composed
    ``(Dc, Dp)`` round, whose only traffic between the stages is that
    all-gathered pack).
    """
    schedule = make_sharded_schedule(
        sim.policy, sim.channel, sim.channel_params, scfg, ch, sigmas,
        n_shards=sim.client_shards, m_avg=sim.uniform_m, solver=sim.solver,
        population=sim.population, mesh=parts.mesh)
    layout = client_layout(ds.n_clients, sim.client_shards,
                           sim.participant_shards)

    def sim_round(params, pol_state, ch_state, draws, r: int):
        raws = (draws.channel_raw(r), policy_raw(draws, sim.policy, r))
        if sim.population is not None:
            raws += ((draws.churn_u(r), draws.fail_u(r)),)
        sel, q, _p, delivered, t_comm, power, n_sel, pol_state, ch_state = (
            schedule(*raws, pol_state, ch_state))
        sel_idx, sel_valid, q_sel = _pack_participants_sharded(
            delivered, q, sim.m_cap, layout)
        params = parts.train_packed(params, sel_idx, sel_valid, q_sel,
                                    draws.batch_idx(r))
        return params, pol_state, ch_state, t_comm, power, n_sel, sel, q

    return sim_round
