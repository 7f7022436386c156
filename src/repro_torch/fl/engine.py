"""Wireless-FL simulation engine (twin of ``repro/fl/engine.py``'s
``run_simulation_scan`` and ``run_sweep``).

Each round: a Rayleigh channel observation, the scheduling decision
(Theorem-2 solve, selection, Eq. 9, accounting: ``fl/decision.py``), then
local SGD of the <= ``m_cap`` selected participants and the Algorithm-1
aggregate (``fl/round.py``). The reference compiles the rounds into one
``lax.scan``; here a Python loop enqueues them on the device. The
accounting and the history points stay on the device, and the host reads
them once, after the last round.

The solve behind ``SimConfig.solver``:

    port           reference        what runs
    "stitched"     "jnp"            plain PyTorch ops
    "cuda"         "pallas"         the solve kernel; selection and the
                                    queue update in PyTorch
    "cuda_fused"   "pallas_fused"   the fused decision kernel (default;
                                    other policies than ``proposed`` keep
                                    the stitched path, as in the reference)

Randomness: PyTorch cannot reproduce the reference's threefry draws, so
every draw of a run goes through one :class:`Draws` source. The default,
:class:`GeneratorDraws`, draws on a ``torch.Generator`` on the run's
device; tests pass one that replays arrays drawn by the reference with its
own key chain.

The policy x seed sweep (:func:`run_sweep`, :func:`make_sweep_runner`) is
the scheduling layer alone, without training: per policy, every seed's
channel -> solve -> select -> account chain runs on (S, N) tensors, one
row per seed, round after round, and the host reads the trajectories once
at the end. Its draws come from a :class:`SweepDraws` source
(:class:`GeneratorSweepDraws` by default).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.channel import NOT_PORTED as CHANNELS_NOT_PORTED
from repro_torch.core.channel import (CHANNEL_RAW, ChannelConfig,
                                      make_channel, uplink_time)
from repro_torch.core.policies import (POLICY_DRAWS, PolicyState,
                                       init_policy_state, make_policy)
from repro_torch.core.policies import _lookup as lookup_policy
from repro_torch.core.scheduler import (SchedulerConfig, as_operands,
                                        estimate_avg_selected)
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.decision import (DecisionCoeffs, decision_coeffs,
                                     decision_step, make_fused_decision)
from repro_torch.fl.round import (masked_aggregate, pack_participants,
                                  resolve_wire_dtype, sample_batches,
                                  train_participants)
from repro_torch.kernels.scheduler_solve import scheduler_solve
from repro_torch.models.registry import make_model

SOLVERS = ("stitched", "cuda", "cuda_fused")


@dataclasses.dataclass
class SimConfig:
    """One simulated experiment (paper Section VI defaults); the
    reference's fields and defaults, except ``solver``."""

    rounds: int = 200
    gamma: float = 0.01          # paper: 0.01
    local_steps: int = 10        # I
    batch: int = 32
    m_cap: int = 32              # max simulated participants per round
    eval_every: int = 10
    eval_size: int = 2000
    policy: str = "proposed"     # proposed | uniform
    aggregation: str = "paper"   # paper (Alg.1 l.7) | delta (variance-reduced)
    uniform_m: float = 0.0       # matched M for the uniform baseline
    seed: int = 0                # seeds the default GeneratorDraws
    engine: str = "scan"         # the only engine of the port
    solver: str = "cuda_fused"   # stitched | cuda | cuda_fused
    channel: str = "rayleigh"
    channel_params: tuple = ()
    policy_params: tuple = ()
    model: str = "cnn"
    model_params: tuple = ()     # ((name, value), ...): conv1, conv2, hidden
    participant_shards: int = 0
    client_shards: int = 0
    wire_dtype: str = "float32"  # delta-aggregation wire (float32|bfloat16)
    population: Optional[tuple] = None


def check_channel(channel: str, channel_params: tuple = ()):
    """Reject the reference's fading models that the port lacks (ROADMAP
    §A item 7) and names it does not know."""
    if channel in CHANNELS_NOT_PORTED:
        raise NotImplementedError(
            f"channel {channel!r} is not ported yet (ROADMAP §A item 7)")
    if channel not in CHANNEL_RAW:
        raise ValueError(f"unknown channel model {channel!r}")
    if channel_params:
        raise ValueError("rayleigh takes no channel_params")


def check_sim_config(sim: SimConfig):
    """Reject what this slice of the port does not run, naming the ROADMAP
    item that will bring it."""
    if sim.engine != "scan":
        raise NotImplementedError(
            f"engine={sim.engine!r}: the reference's legacy loop engine is "
            "not ported (ROADMAP §A item 5); use engine='scan'")
    if sim.client_shards or sim.participant_shards:
        raise NotImplementedError(
            "client_shards / participant_shards are not ported yet "
            "(ROADMAP §A item 8)")
    if sim.population is not None:
        raise NotImplementedError(
            "dynamic populations are not ported yet (ROADMAP §A item 7)")
    check_channel(sim.channel)
    if sim.channel_params or sim.policy_params:
        raise ValueError("rayleigh, proposed and uniform take no extra "
                         "channel_params / policy_params")
    if sim.solver not in SOLVERS:
        raise ValueError(f"unknown solver {sim.solver!r} (want one of "
                         f"{SOLVERS})")


class Draws(Protocol):
    """Every random draw of a run, by round index."""

    def channel_raw(self, r: int) -> torch.Tensor:
        """(N,) float32 uniforms in [1e-12, 1) for the Rayleigh gains."""

    def selection_u(self, r: int) -> torch.Tensor:
        """(N,) float32 selection uniforms of ``proposed``."""

    def uniform_raw(self, r: int) -> dict:
        """The uniform baseline's {"take": (), "scores": (N,)} raws."""

    def batch_idx(self, r: int) -> torch.Tensor:
        """(m_cap, I, batch) int64 example indices in [0, per_client)."""


class GeneratorDraws:
    """:class:`Draws` from a ``torch.Generator`` on ``device``.

    Each draw re-seeds the generator from (seed, round, stream), so a
    round's numbers do not depend on which draws a policy asks for or in
    which order: two runs with one seed see the same channel, uniforms and
    minibatches.
    """

    def __init__(self, seed: int, n_clients: int, batch_shape: tuple,
                 per_client: int, device="cuda"):
        self.seed = int(seed)
        self.n = int(n_clients)
        self.batch_shape = tuple(batch_shape)
        self.per_client = int(per_client)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def _seeded(self, r: int, stream: int) -> torch.Generator:
        return self._gen.manual_seed((self.seed * 1_000_003 + r) * 4
                                     + stream)

    def channel_raw(self, r):
        return CHANNEL_RAW["rayleigh"][0](self._seeded(r, 0), self.n,
                                          self.device)

    def selection_u(self, r):
        return POLICY_DRAWS["proposed"](self._seeded(r, 1), self.n,
                                        self.device)

    def uniform_raw(self, r):
        return POLICY_DRAWS["uniform"](self._seeded(r, 2), self.n,
                                       self.device)

    def batch_idx(self, r):
        return torch.randint(0, self.per_client, self.batch_shape,
                             generator=self._seeded(r, 3),
                             device=self.device)


def default_draws(sim: SimConfig, ds: FederatedDataset) -> GeneratorDraws:
    """The run's draws when the caller brings none: seeded by ``sim.seed``."""
    return GeneratorDraws(sim.seed, ds.n_clients,
                          (sim.m_cap, sim.local_steps, sim.batch),
                          ds.client_labels.shape[1], device=ds.device)


def make_solve_fn(scfg: SchedulerConfig, ch: ChannelConfig):
    """``solve(gains, z) -> (q, P)`` through the solve kernel
    (``solver="cuda"``), with the configs' scalars as the reference's
    ``make_solve_fn(solver="pallas")`` passes them."""
    def solve(gains, z):
        return scheduler_solve(
            gains, z, n=scfg.n_clients, v=scfg.V, lam=scfg.lam,
            ell=scfg.model_bits, bandwidth=ch.bandwidth_hz,
            noise=ch.noise_power, p_max=ch.p_max, p_bar=ch.p_bar,
            q_floor=scfg.q_floor)

    return solve


def make_sim_round(ds: FederatedDataset, sim: SimConfig,
                   scfg: SchedulerConfig, ch: ChannelConfig,
                   sigmas: torch.Tensor):
    """One simulated round bound to (ds, sim, configs):
    ``sim_round(params, pol_state, ch_state, draws, r) -> (params,
    pol_state, ch_state, t_comm, power, n_sel, sel, q)``."""
    check_sim_config(sim)
    co_host = decision_coeffs(scfg, ch)
    co = DecisionCoeffs(*(as_operands(c, sigmas) for c in co_host))
    channel = make_channel(sim.channel, sigmas, ch)
    solve = make_solve_fn(scfg, ch) if sim.solver == "cuda" else None
    policy_step = make_policy(sim.policy, scfg, ch, m_avg=sim.uniform_m,
                              solve_fn=solve, coeffs=co.solve)
    decision = decision_step
    if sim.solver == "cuda_fused" and sim.policy == "proposed":
        decision = make_fused_decision(scfg, co_host)
    spec = make_model(sim.model, ds, **dict(sim.model_params))
    wire = resolve_wire_dtype(sim.wire_dtype)
    n = ds.n_clients

    def sim_round(params, pol_state, ch_state, draws: Draws, r: int):
        gains, ch_state = channel.apply(draws.channel_raw(r), ch_state)
        raw = (draws.selection_u(r) if sim.policy == "proposed"
               else draws.uniform_raw(r))
        sel, q, p, t_comm, power, n_sel, pol_state = decision(
            policy_step, co.acct, raw, gains, pol_state)
        sel_idx, sel_valid = pack_participants(sel, sim.m_cap)
        inputs, labels = sample_batches(draws.batch_idx(r), ds.client_images,
                                        ds.client_labels, sel_idx)
        updated = train_participants(spec.loss_fn, params, inputs, labels,
                                     sim.gamma, sim.local_steps)
        params = masked_aggregate(params, updated, sel_valid, q[sel_idx], n,
                                  sim.aggregation, wire)
        return params, pol_state, ch_state, t_comm, power, n_sel, sel, q

    return sim_round


def eval_rounds(rounds: int, eval_every: int) -> list:
    """The rounds at which the history records a point."""
    return [r for r in range(rounds)
            if r % eval_every == 0 or r == rounds - 1]


def make_eval_fn(ds: FederatedDataset, sim: SimConfig):
    """Test-set accuracy of ``sim.model`` on the eval slice."""
    spec = make_model(sim.model, ds, **dict(sim.model_params))
    inputs = ds.test_images[: sim.eval_size]
    labels = ds.test_labels[: sim.eval_size]
    return lambda params: spec.eval_fn(params, inputs, labels)


def history_from_trajectory(rounds: int, eval_every: int, n_clients: int,
                            comm, acc, pcum, nsel) -> Dict[str, np.ndarray]:
    """Per-eval-point host arrays -> the reference's history layout."""
    ev = np.asarray(eval_rounds(rounds, eval_every))
    return {
        "round": ev,
        "comm_time": np.asarray(comm).astype(np.float64),
        "test_acc": np.asarray(acc).astype(np.float64),
        "avg_power": (np.asarray(pcum).astype(np.float64)
                      / (ev + 1) / n_clients),
        "n_selected": np.asarray(nsel).astype(np.int64),
    }


def run_simulation_scan(draws: Optional[Draws], params: dict,
                        ds: FederatedDataset, sim: SimConfig,
                        scfg: SchedulerConfig, ch: ChannelConfig,
                        sigmas: torch.Tensor, *,
                        keep_selection: bool = False
                        ) -> Dict[str, np.ndarray]:
    """Run ``sim.rounds`` rounds on ``ds``'s device; returns the
    reference's history (round, comm_time, test_acc, avg_power,
    n_selected at each eval round).

    ``draws`` None uses :func:`default_draws`. ``keep_selection`` adds
    ``"selected"`` and ``"q"``, the (rounds, N) selection masks and
    probabilities, so two runs can be compared lane by lane.
    """
    sim_round = make_sim_round(ds, sim, scfg, ch, sigmas)
    eval_fn = make_eval_fn(ds, sim)
    draws = default_draws(sim, ds) if draws is None else draws
    device = ds.device
    params = {k: v.detach().clone() for k, v in params.items()}
    pol_state = init_policy_state(sim.policy, ds.n_clients, device)
    ch_state = make_channel(sim.channel, sigmas, ch).init()
    t_cum = torch.zeros((), dtype=torch.float32, device=device)
    p_cum = torch.zeros((), dtype=torch.float32, device=device)
    at_eval = set(eval_rounds(sim.rounds, sim.eval_every))
    points, sels, qs = [], [], []
    for r in range(sim.rounds):
        params, pol_state, ch_state, t_comm, power, n_sel, sel, q = (
            sim_round(params, pol_state, ch_state, draws, r))
        t_cum = t_cum + t_comm
        p_cum = p_cum + power
        if keep_selection:
            sels.append(sel)
            qs.append(q)
        if r in at_eval:
            points.append(torch.stack([t_cum, eval_fn(params), p_cum,
                                       n_sel.to(torch.float32)]))
    traj = torch.stack(points).cpu().numpy()
    hist = history_from_trajectory(sim.rounds, sim.eval_every, ds.n_clients,
                                   *traj.T)
    if keep_selection:
        hist["selected"] = torch.stack(sels).cpu().numpy()
        hist["q"] = torch.stack(qs).cpu().numpy()
    return hist


# --------------------------------------------------------------------------
# Policy x seed sweep: the scheduling layer behind Figs. 2-5's comm-time,
# power and participation axes.
# --------------------------------------------------------------------------

class SweepDraws(Protocol):
    """Every random draw of a sweep: per round, one row per seed."""

    def channel_raw(self, r: int) -> torch.Tensor:
        """(S, N) float32 uniforms in [1e-12, 1) for the Rayleigh gains."""

    def selection_u(self, r: int) -> torch.Tensor:
        """(S, N) float32 selection uniforms of ``proposed``."""

    def uniform_raw(self, r: int) -> dict:
        """The uniform baseline's {"take": (S,), "scores": (S, N)} raws."""

    def match_raws(self, rounds: int) -> torch.Tensor:
        """(rounds, N) channel uniforms of the matched-M estimate."""


class GeneratorSweepDraws:
    """:class:`SweepDraws` from a ``torch.Generator`` on ``device``: seed
    ``s`` draws as a :class:`GeneratorDraws` seeded from (``seed``, s),
    whichever other seeds the sweep holds, so every policy sees the same
    channel and uniforms for a seed (the paired comparison)."""

    def __init__(self, seed: int, seeds: Sequence[int], n_clients: int,
                 device="cuda"):
        self.seed, self.n = int(seed), int(n_clients)
        self.device = torch.device(device)
        self._rows = [GeneratorDraws(self.seed * 1_000_003 + int(s) + 1,
                                     n_clients, (), 1, device)
                      for s in seeds]

    def channel_raw(self, r):
        return torch.stack([d.channel_raw(r) for d in self._rows])

    def selection_u(self, r):
        return torch.stack([d.selection_u(r) for d in self._rows])

    def uniform_raw(self, r):
        raws = [d.uniform_raw(r) for d in self._rows]
        return {k: torch.stack([x[k] for x in raws]) for k in raws[0]}

    def match_raws(self, rounds):
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003)
        draw = CHANNEL_RAW["rayleigh"][0]
        return torch.stack([draw(gen, self.n, self.device)
                            for _ in range(rounds)])


def make_sweep_solve_fn(scfg: SchedulerConfig, ch: ChannelConfig,
                        solver: str):
    """The sweep's solve closure over (S, N) lanes, as the reference's
    ``resolve_solve_fn``: None for ``"stitched"`` (the coefficient-driven
    plain solve), else the solve kernel on the (S N,) lanes flattened, one
    launch for every seed; its ``n`` stays the configuration's N. The
    sweep takes only a solve closure, so ``"cuda_fused"`` launches the
    solve kernel here too."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (want one of "
                         f"{SOLVERS})")
    if solver == "stitched":
        return None
    solve = make_solve_fn(scfg, ch)

    def flat(gains, z):
        q, p = solve(gains.reshape(-1), z.reshape(-1))
        return q.view(gains.shape), p.view(gains.shape)

    return flat


def make_sweep_runner(sigmas: torch.Tensor, scfg: SchedulerConfig,
                      ch: ChannelConfig, *, rounds: int,
                      policy: str = "proposed", m_avg: float = 1.0,
                      channel: str = "rayleigh", channel_params: tuple = (),
                      solver: str = "cuda_fused", guarantee_one: bool = True,
                      policy_params: Optional[dict] = None):
    """The batched scheduling trajectory of ONE policy:
    ``runner(draws, keep_selection=False)`` maps a :class:`SweepDraws` of
    S seeds to per-seed ``(comm_cum, power, avg_power, n_selected)``, each
    an (S, rounds) tensor on ``sigmas``' device, plus the (S, rounds, N)
    selections and q with ``keep_selection``.

    Each round draws the channel, runs the policy on all seeds at once
    ((S, N) tensors: ``proposed`` solves through :func:`make_sweep_solve_fn`,
    so under ``"cuda"`` / ``"cuda_fused"`` one solve-kernel launch serves
    every seed; ``uniform`` launches no kernel) and accounts the TDMA comm
    time and the power sum P q with plain sums, as the reference's sweep
    does (not the blocked reduce). Nothing is read back before the end.
    """
    check_channel(channel, channel_params)
    if policy_params:
        raise ValueError("proposed, uniform and greedy_channel take no "
                         "policy_params")
    n = scfg.n_clients
    scfg_run = dataclasses.replace(scfg, guarantee_one=guarantee_one)
    co = as_operands(decision_coeffs(scfg_run, ch).solve, sigmas)
    step = make_policy(policy, scfg_run, ch, m_avg=m_avg,
                       solve_fn=make_sweep_solve_fn(scfg_run, ch, solver),
                       coeffs=co)
    chan = make_channel(channel, sigmas, ch)

    def runner(draws: SweepDraws, keep_selection: bool = False):
        st0 = init_policy_state(policy, n, sigmas.device)
        cst = chan.init()
        st, outs, kept = None, [], []
        for r in range(rounds):
            gains, cst = chan.apply(draws.channel_raw(r), cst)
            if st is None:
                st = PolicyState(st0.z.expand(gains.shape).clone(),
                                 st0.aux.expand(gains.shape).clone(), st0.t)
            raw = (draws.selection_u(r) if policy == "proposed"
                   else draws.uniform_raw(r) if policy == "uniform"
                   else ())  # greedy_channel draws nothing
            sel, q, p, st = step(raw, gains, st)
            outs.append(torch.stack([
                uplink_time(gains, p, sel, scfg.model_bits, ch),
                (p * q).sum(-1), sel.sum(-1).to(torch.float32)]))
            if keep_selection:
                kept.append((sel, q))
        t_comm, power, nsel = torch.stack(outs, -1).unbind(0)
        denom = torch.arange(1, rounds + 1, dtype=torch.float32,
                             device=power.device)
        out = (torch.cumsum(t_comm, -1), power,
               torch.cumsum(power, -1) / denom / power.new_full((), n),
               nsel.to(torch.int64))
        if keep_selection:
            out += tuple(torch.stack(x, 1) for x in zip(*kept))
        return out

    return runner


def run_sweep(draws: Optional[SweepDraws], sigmas: torch.Tensor,
              scfg: SchedulerConfig, ch: ChannelConfig, *, rounds: int,
              policies: Sequence[str] = ("proposed", "uniform"),
              seeds: Sequence[int] = (0,), seed: int = 0,
              uniform_m: Optional[float] = None,
              solver: str = "cuda_fused", guarantee_one: bool = True,
              match_rounds: int = 300, channel: str = "rayleigh",
              channel_params: tuple = (),
              policy_params: Optional[Dict[str, dict]] = None,
              keep_selection: bool = False) -> Dict[str, np.ndarray]:
    """Channel -> schedule -> select sweep over policies x seeds, on
    ``sigmas``' device (the twin of the reference's ``run_sweep``).

    ``draws`` (None: :class:`GeneratorSweepDraws` from ``seed`` and
    ``seeds``) takes the place of the reference's key. The matched M of
    the baselines is estimated on ``draws.match_raws(match_rounds)`` when
    a policy needs it and ``uniform_m`` is None. Training is excluded
    (that is ``run_simulation``'s job).

    Returns arrays of shape (len(policies), len(seeds), rounds):
    ``comm_time`` (cumulative s), ``power`` (per-round sum P q),
    ``avg_power`` (running mean of sum P q / N, the Fig. 5 trajectory),
    ``n_selected``, plus the float32 ``uniform_m`` used; with
    ``keep_selection`` also ``selected`` and ``q``, (len(policies),
    len(seeds), rounds, N).
    """
    needs_m = any(lookup_policy(p)[1] for p in policies)
    check_channel(channel, channel_params)
    n = scfg.n_clients
    if draws is None:
        draws = GeneratorSweepDraws(seed, seeds, n, sigmas.device)
    if uniform_m is None:
        uniform_m = (float(estimate_avg_selected(
            None, sigmas, scfg, ch, match_rounds,
            raws=draws.match_raws(match_rounds))) if needs_m else 1.0)
    per_policy = []
    for p in policies:
        runner = make_sweep_runner(
            sigmas, scfg, ch, rounds=rounds, policy=p, m_avg=uniform_m,
            channel=channel, channel_params=channel_params, solver=solver,
            guarantee_one=guarantee_one,
            policy_params=(policy_params or {}).get(p))
        per_policy.append(runner(draws, keep_selection))
    names = ["comm_time", "power", "avg_power", "n_selected"]
    if keep_selection:
        names += ["selected", "q"]
    out = {name: torch.stack([r[i] for r in per_policy]).cpu().numpy()
           for i, name in enumerate(names)}
    return dict(policies=list(policies), seeds=np.asarray(seeds),
                uniform_m=np.float32(uniform_m), **out)
