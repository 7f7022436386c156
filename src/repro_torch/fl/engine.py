"""Wireless-FL simulation engine (twin of ``repro/fl/engine.py``'s
``run_simulation_scan`` and ``run_sweep``).

Each round: a channel observation under any registered fading model
(``sim.channel``, ``sim.channel_params``), the scheduling decision of any
registered policy (``sim.policy``, ``sim.policy_params``; Theorem-2
solve, selection, Eq. 9, accounting: ``fl/decision.py``), then local SGD
of the <= ``m_cap`` selected participants and the Algorithm-1 aggregate
(``fl/round.py``). With ``sim.population`` set, the round is the masked
one of ``fl/population.py`` (churn, masked decision, stragglers). The
reference compiles the rounds into one ``lax.scan``; here a Python loop
enqueues them on the device. The accounting and the history points stay
on the device, and the host reads them once, after the last round.

The solve behind ``SimConfig.solver``:

    port           reference        what runs
    "stitched"     "jnp"            plain PyTorch ops
    "cuda"         "pallas"         the solve kernel; selection, masks and
                                    the queue update in PyTorch
    "cuda_fused"   "pallas_fused"   the fused decision kernel (default;
                                    other policies than ``proposed`` keep
                                    the stitched path, as in the reference)

Randomness: PyTorch cannot reproduce the reference's threefry draws, so
every draw of a run goes through one :class:`Draws` source. The default,
:class:`GeneratorDraws`, draws on a ``torch.Generator`` on the run's
device; tests pass one that replays arrays drawn by the reference with its
own key chain.

:func:`make_chunk_runner` and :func:`init_carry` expose the rounds in
chunks: ``run_chunk(carry, n_rounds)`` advances a carry ``(params,
pol_state, ch_state, round, t_comm_cum, power_cum)`` by ``n_rounds``
rounds and evaluates, so a caller can watch a run between chunks. Draws
are taken by round index, so chunks of a and b rounds equal one of a + b
bit for bit.

Telemetry (``repro_torch.obs``, the process-wide switch): with it on,
``run_simulation_scan`` records rounds/s, the per-interval Eq. 8 comm
time and the selection counts from the host history after the run's one
read back, and each chunk records its wall time and the Eq. 9 queue
gauges (that copy waits for the chunk); a first-use counter runs either
way. Nothing recorded feeds back into a round: histories are bitwise the
same with telemetry on or off.

The policy x seed sweep (:func:`run_sweep`, :func:`make_sweep_runner`) is
the scheduling layer alone, without training: per policy, every seed's
channel -> solve -> select -> account chain runs on (S, N) tensors, one
row per seed (a stateful channel carries (2, S, N)), round after round,
and the host reads the trajectories once at the end. Its draws come from
a :class:`SweepDraws` source (:class:`GeneratorSweepDraws` by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.channel import (CHANNEL_INIT_RAW, CHANNEL_RAW,
                                      ChannelConfig, check_channel,
                                      make_channel, uplink_time)
from repro_torch.core.policies import (POLICY_DRAWS, PolicyState,
                                       init_policy_state, make_policy,
                                       policy_raw)
from repro_torch.core.policies import _lookup as lookup_policy
from repro_torch.core.scheduler import (SchedulerConfig, as_operands,
                                        estimate_avg_selected, solve_round)
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.decision import (AccountCoeffs, DecisionCoeffs,
                                     decision_coeffs, decision_step,
                                     make_fused_decision)
from repro_torch.fl.population import (init_active_mask,
                                       make_population_core,
                                       population_config)
from repro_torch.fl.round import (masked_aggregate, pack_participants,
                                  resolve_wire_dtype, sample_batches,
                                  train_participants)
from repro_torch.kernels.scheduler_solve import scheduler_solve
from repro_torch.models.registry import make_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.instrument import EngineInstruments, perf

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
    policy: str = "proposed"     # any core/policies.py POLICIES name
    aggregation: str = "paper"   # paper (Alg.1 l.7) | delta (variance-reduced)
    uniform_m: float = 0.0       # matched M for the baseline policies
    seed: int = 0                # seeds the default GeneratorDraws
    engine: str = "scan"         # the only engine of the port
    solver: str = "cuda_fused"   # stitched | cuda | cuda_fused
    channel: str = "rayleigh"    # any core/channel.py CHANNEL_MODELS name
    channel_params: tuple = ()   # ((name, value), ...) model extras
    policy_params: tuple = ()    # ((name, value), ...) policy extras
    model: str = "cnn"
    model_params: tuple = ()     # ((name, value), ...): conv1, conv2, hidden
    participant_shards: int = 0
    client_shards: int = 0
    wire_dtype: str = "float32"  # delta-aggregation wire (float32|bfloat16)
    population: Optional[tuple] = None
                                 # None: a fixed fleet. ((name, value), ...)
                                 # builds a fl/population.py
                                 # PopulationConfig; () is the degenerate
                                 # all-active scenario, bit for bit the
                                 # population-free run


def check_sim_config(sim: SimConfig):
    """Reject what the port does not run, naming the ROADMAP item that
    will bring it, and names or parameters nobody knows."""
    if sim.engine != "scan":
        raise NotImplementedError(
            f"engine={sim.engine!r}: the reference's legacy loop engine is "
            "not ported (ROADMAP §A item 5); use engine='scan'")
    if sim.client_shards or sim.participant_shards:
        raise NotImplementedError(
            "client_shards / participant_shards are not ported yet "
            "(ROADMAP §A item 8)")
    check_channel(sim.channel, sim.channel_params)
    if sim.population is not None:
        population_config(sim.population)
    if sim.solver not in SOLVERS:
        raise ValueError(f"unknown solver {sim.solver!r} (want one of "
                         f"{SOLVERS})")


class Draws(Protocol):
    """Every random draw of a run: per run, the channel's init raw and the
    round-0 activity uniforms; per round, the channel's raw, the policies'
    raws, the churn and failure uniforms and the minibatch indices."""

    def channel_init(self):
        """The model's init raw (``CHANNEL_INIT_RAW``), None if memoryless."""

    def init_mask_u(self) -> torch.Tensor:
        """(N,) uniforms in [0, 1) of the round-0 activity mask."""

    def channel_raw(self, r: int):
        """The model's raw of round ``r`` (``CHANNEL_RAW``'s draw)."""

    def selection_u(self, r: int) -> torch.Tensor:
        """(N,) selection uniforms of proposed, proportional_gain and
        update_aware."""

    def uniform_raw(self, r: int) -> dict:
        """The uniform baseline's {"take": (), "scores": (N,)} raws."""

    def churn_u(self, r: int) -> torch.Tensor:
        """(N,) uniforms in [0, 1) of the round's churn step."""

    def fail_u(self, r: int) -> torch.Tensor:
        """(N,) uniforms in [0, 1) of the round's straggler split."""

    def batch_idx(self, r: int) -> torch.Tensor:
        """(m_cap, I, batch) int64 example indices in [0, per_client)."""


# GeneratorDraws' streams; the first four keep the numbering of the
# rayleigh-only engine, so its runs keep their draws
_STREAMS = {"channel": 0, "selection": 1, "uniform": 2, "batch": 3,
            "churn": 4, "fail": 5, "channel_init": 6, "init_mask": 7}


class GeneratorDraws:
    """:class:`Draws` from a ``torch.Generator`` on ``device``.

    Each draw re-seeds the generator from (seed, round, stream), so a
    round's numbers do not depend on which draws a policy asks for or in
    which order: two runs with one seed see the same channel, uniforms and
    minibatches. ``channel`` picks the fading model whose raws
    :meth:`channel_raw` and :meth:`channel_init` draw.
    """

    def __init__(self, seed: int, n_clients: int, batch_shape: tuple,
                 per_client: int, device="cuda", channel: str = "rayleigh"):
        self.seed = int(seed)
        self.n = int(n_clients)
        self.batch_shape = tuple(batch_shape)
        self.per_client = int(per_client)
        self.device = torch.device(device)
        check_channel(channel)
        self.channel = channel
        self._gen = torch.Generator(device=self.device)

    def _seeded(self, r: int, stream: str) -> torch.Generator:
        k = _STREAMS[stream]
        return self._gen.manual_seed(
            (self.seed * 1_000_003 + r) * 4 + k % 4 + (k // 4 << 48))

    def channel_init(self):
        draw = CHANNEL_INIT_RAW[self.channel]
        return (None if draw is None else
                draw(self._seeded(0, "channel_init"), self.n, self.device))

    def init_mask_u(self):
        return torch.rand((self.n,), generator=self._seeded(0, "init_mask"),
                          device=self.device)

    def channel_raw(self, r):
        return CHANNEL_RAW[self.channel][0](self._seeded(r, "channel"),
                                            self.n, self.device)

    def selection_u(self, r):
        return POLICY_DRAWS["proposed"](self._seeded(r, "selection"),
                                        self.n, self.device)

    def uniform_raw(self, r):
        return POLICY_DRAWS["uniform"](self._seeded(r, "uniform"), self.n,
                                       self.device)

    def churn_u(self, r):
        return torch.rand((self.n,), generator=self._seeded(r, "churn"),
                          device=self.device)

    def fail_u(self, r):
        return torch.rand((self.n,), generator=self._seeded(r, "fail"),
                          device=self.device)

    def batch_idx(self, r):
        return torch.randint(0, self.per_client, self.batch_shape,
                             generator=self._seeded(r, "batch"),
                             device=self.device)


def default_draws(sim: SimConfig, ds: FederatedDataset) -> GeneratorDraws:
    """The run's draws when the caller brings none: seeded by ``sim.seed``,
    for ``sim.channel``."""
    return GeneratorDraws(sim.seed, ds.n_clients,
                          (sim.m_cap, sim.local_steps, sim.batch),
                          ds.client_labels.shape[1], device=ds.device,
                          channel=sim.channel)


def make_solve_fn(scfg: SchedulerConfig, ch: ChannelConfig,
                  solver: str = "cuda"):
    """``solve(gains, z) -> (q, P)``: through the solve kernel with
    ``solver="cuda"`` (the default; its plain version on CPU tensors), with
    the configs' scalars as the reference's ``make_solve_fn(
    solver="pallas")`` passes them, or the plain ``core.solve_round`` with
    ``solver="stitched"``, the twin of the reference's ``solver="jnp"``.
    Either accepts any 1-D client slice."""
    if solver == "stitched":
        return lambda gains, z: solve_round(gains, z, scfg, ch)
    if solver != "cuda":
        raise ValueError(f"unknown solver {solver!r} (want 'stitched'|"
                         "'cuda')")

    def solve(gains, z):
        return scheduler_solve(
            gains, z, n=scfg.n_clients, v=scfg.V, lam=scfg.lam,
            ell=scfg.model_bits, bandwidth=ch.bandwidth_hz,
            noise=ch.noise_power, p_max=ch.p_max, p_bar=ch.p_bar,
            q_floor=scfg.q_floor)

    return solve


class RoundParts(NamedTuple):
    """A run's round pieces, bound to (ds, sim, configs): what the fixed
    fleet's round and the population's masked round share."""

    channel: object          # core/channel.py ChannelModel
    policy: str              # the policy's name (its Draws stream)
    policy_step: Callable    # (raw, gains, state[, active, n_active])
    decision: Callable       # decision_step or the fused drop-in
    acct: AccountCoeffs      # accounting operands on the device
    train: Callable          # (params, delivered, q, batch_idx) -> params


def make_round_parts(ds: FederatedDataset, sim: SimConfig,
                     scfg: SchedulerConfig, ch: ChannelConfig,
                     sigmas: torch.Tensor) -> RoundParts:
    """Bind the channel, the policy, the decision layer and the training
    tail of ``sim``."""
    check_sim_config(sim)
    co_host = decision_coeffs(scfg, ch)
    co = DecisionCoeffs(*(as_operands(c, sigmas) for c in co_host))
    solve = make_solve_fn(scfg, ch) if sim.solver == "cuda" else None
    policy_step = make_policy(sim.policy, scfg, ch, m_avg=sim.uniform_m,
                              solve_fn=solve, coeffs=co.solve,
                              **dict(sim.policy_params))
    decision = decision_step
    if sim.solver == "cuda_fused" and sim.policy == "proposed":
        decision = make_fused_decision(scfg, co_host)
    spec = make_model(sim.model, ds, **dict(sim.model_params))
    wire = resolve_wire_dtype(sim.wire_dtype)

    def train(params, delivered, q, batch_idx):
        """Local SGD of the first ``m_cap`` delivered participants and
        Algorithm 1's 1/q-weighted aggregate."""
        sel_idx, sel_valid = pack_participants(delivered, sim.m_cap)
        inputs, labels = sample_batches(batch_idx, ds.client_images,
                                        ds.client_labels, sel_idx)
        updated = train_participants(spec.loss_fn, params, inputs, labels,
                                     sim.gamma, sim.local_steps)
        return masked_aggregate(params, updated, sel_valid, q[sel_idx],
                                ds.n_clients, sim.aggregation, wire)

    return RoundParts(
        make_channel(sim.channel, sigmas, ch, **dict(sim.channel_params)),
        sim.policy, policy_step, decision, co.acct, train)


def make_sim_round(ds: FederatedDataset, sim: SimConfig,
                   scfg: SchedulerConfig, ch: ChannelConfig,
                   sigmas: torch.Tensor):
    """One simulated round bound to (ds, sim, configs):
    ``sim_round(params, pol_state, ch_state, draws, r) -> (params,
    pol_state, ch_state, t_comm, power, n_sel, sel, q)``. With
    ``sim.population`` set, ``ch_state`` is the ``(ch_state, active)``
    carry of the masked round (``fl/population.py``)."""
    if sim.population is not None:
        return make_population_core(
            make_round_parts(ds, sim, scfg, ch, sigmas),
            population_config(sim.population))
    parts = make_round_parts(ds, sim, scfg, ch, sigmas)

    def sim_round(params, pol_state, ch_state, draws: Draws, r: int):
        gains, ch_state = parts.channel.apply(draws.channel_raw(r), ch_state)
        sel, q, p, t_comm, power, n_sel, pol_state = parts.decision(
            parts.policy_step, parts.acct, policy_raw(draws, sim.policy, r),
            gains, pol_state)
        params = parts.train(params, sel, q, draws.batch_idx(r))
        return params, pol_state, ch_state, t_comm, power, n_sel, sel, q

    return sim_round


def init_channel_carry(draws: Draws, sim: SimConfig, channel):
    """The round-0 channel carry: the model's state from its init raw,
    paired with the round-0 activity mask when ``sim.population`` is set
    (the ``(ch_state, active)`` carry of the masked round)."""
    ch0 = channel.init(draws.channel_init())
    if sim.population is None:
        return ch0
    return ch0, init_active_mask(draws.init_mask_u(),
                                 population_config(sim.population))


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


def run_config(draws: Draws, params: dict, ds: FederatedDataset,
               sim: SimConfig, scfg: SchedulerConfig, ch: ChannelConfig,
               sigmas: torch.Tensor, *, keep_selection: bool = False):
    """One configuration's ``sim.rounds`` rounds on ``ds``'s device: the
    function behind :func:`run_simulation_scan` and every config of the
    scenario grid (``fl/grid.py``). Returns ``(points, kept)``: an (E, 4)
    tensor of (comm_cum, test_acc, power_cum, n_selected) at each eval
    round, on the device, and with ``keep_selection`` the stacked (rounds,
    N) ``selected`` and ``q`` (and ``active`` under a population)."""
    sim_round = make_sim_round(ds, sim, scfg, ch, sigmas)
    eval_fn = make_eval_fn(ds, sim)
    device = ds.device
    params = {k: v.detach().clone() for k, v in params.items()}
    pol_state = init_policy_state(sim.policy, ds.n_clients, device)
    carry = init_channel_carry(draws, sim, make_channel(
        sim.channel, sigmas, ch, **dict(sim.channel_params)))
    t_cum = torch.zeros((), dtype=torch.float32, device=device)
    p_cum = torch.zeros((), dtype=torch.float32, device=device)
    at_eval = set(eval_rounds(sim.rounds, sim.eval_every))
    points, kept = [], {"selected": [], "q": [], "active": []}
    for r in range(sim.rounds):
        params, pol_state, carry, t_comm, power, n_sel, sel, q = (
            sim_round(params, pol_state, carry, draws, r))
        t_cum = t_cum + t_comm
        p_cum = p_cum + power
        if keep_selection:
            kept["selected"].append(sel)
            kept["q"].append(q)
            if sim.population is not None:
                kept["active"].append(carry[1])
        if r in at_eval:
            points.append(torch.stack([t_cum, eval_fn(params), p_cum,
                                       n_sel.to(torch.float32)]))
    return torch.stack(points), {k: torch.stack(v) for k, v in kept.items()
                                 if v}


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
    probabilities, so two runs can be compared lane by lane, and under a
    population ``"active"``, each round's activity mask.
    """
    ei = EngineInstruments(obs_metrics.default_registry())
    t0 = perf()
    # the reference jits a fresh runner per call: one first use a run
    ei.compiles.miss(("config_runner", sim.rounds), entry="config_runner",
                     policy=sim.policy, rounds=sim.rounds)
    draws = default_draws(sim, ds) if draws is None else draws
    points, kept = run_config(draws, params, ds, sim, scfg, ch, sigmas,
                              keep_selection=keep_selection)
    hist = history_from_trajectory(sim.rounds, sim.eval_every, ds.n_clients,
                                   *points.cpu().numpy().T)
    hist.update({k: v.cpu().numpy() for k, v in kept.items()})
    if ei.enabled:
        ei.record_history(hist, perf() - t0)   # host arrays: already read
    return hist


def make_chunk_runner(ds: FederatedDataset, sim: SimConfig,
                      scfg: SchedulerConfig, ch: ChannelConfig,
                      sigmas: torch.Tensor, draws: Draws):
    """The multi-round chunk function (twin of the reference's).

    ``run_chunk(carry, n_rounds)`` runs ``n_rounds`` rounds from the
    carry's round index on ``draws``, evaluates test accuracy on the
    resulting params and returns ``(carry, acc, last_n_selected)``, both
    device scalars. ``carry = (params, pol_state, ch_state, round,
    t_comm_cum, power_cum)`` (:func:`init_carry`); the accounting stays on
    the device between chunks.

    Telemetry: each chunk length's first call counts an
    ``engine_compile_misses_total`` miss; with telemetry on each chunk
    also records its wall time and the post-chunk Z-queue gauges (Eq. 9),
    whose host copy waits for the chunk — the returned carry is bitwise
    the same either way.
    """
    sim_round = make_sim_round(ds, sim, scfg, ch, sigmas)
    eval_fn = make_eval_fn(ds, sim)
    ei = EngineInstruments(obs_metrics.default_registry())

    def run_chunk(carry, n_rounds: int):
        if n_rounds < 1:
            raise ValueError(f"a chunk runs >= 1 round, got {n_rounds}")
        fresh = ei.compiles.miss(("run_chunk", n_rounds),
                                 entry="run_chunk", n_rounds=n_rounds)
        t0 = perf()
        params, pol_state, ch_state, r0, t_cum, p_cum = carry
        for r in range(r0, r0 + n_rounds):
            params, pol_state, ch_state, t_comm, power, n_sel, *_ = (
                sim_round(params, pol_state, ch_state, draws, r))
            t_cum = t_cum + t_comm
            p_cum = p_cum + power
        carry = (params, pol_state, ch_state, r0 + n_rounds, t_cum, p_cum)
        acc = eval_fn(params)
        if fresh:
            ei.compiles.compile_s.inc(perf() - t0)
        if ei.enabled:
            ei.record_policy_state(pol_state)   # waits: chunk truly done
            ei.chunk_s.record(perf() - t0)
        return carry, acc, n_sel

    return run_chunk


def init_carry(draws: Draws, params: dict, scfg: SchedulerConfig,
               sim: SimConfig, sigmas: torch.Tensor, ch: ChannelConfig):
    """A fresh chunk-runner carry at round 0 on ``sigmas``' device
    (params copied, so the caller's stay untouched). The channel state
    comes from ``draws``' init raw, with the round-0 activity mask under
    ``sim.population``: pass the draws the chunk runner was built with."""
    device = sigmas.device
    channel = make_channel(sim.channel, sigmas, ch,
                           **dict(sim.channel_params))
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return ({k: v.detach().clone() for k, v in params.items()},
            init_policy_state(sim.policy, scfg.n_clients, device),
            init_channel_carry(draws, sim, channel), 0, zero, zero.clone())


# --------------------------------------------------------------------------
# Policy x seed sweep: the scheduling layer behind Figs. 2-5's comm-time,
# power and participation axes.
# --------------------------------------------------------------------------

class SweepDraws(Protocol):
    """Every random draw of a sweep: per round, one row per seed (the seed
    axis just before the client axis of each raw)."""

    def channel_init(self):
        """The model's init raw for every seed, None if memoryless."""

    def channel_raw(self, r: int):
        """The model's raws of round ``r``: (S, N) uniforms for rayleigh,
        (2, S, N) normals for rician, gauss_markov and mobility, a pair of
        (S, N) tensors for lognormal and outage_burst."""

    def selection_u(self, r: int) -> torch.Tensor:
        """(S, N) selection uniforms (proposed, proportional_gain,
        update_aware)."""

    def uniform_raw(self, r: int) -> dict:
        """The uniform baseline's {"take": (S,), "scores": (S, N)} raws."""

    def match_raws(self, rounds: int):
        """The matched-M estimate's channel raws, stacked along a leading
        round axis."""

    def match_init(self):
        """The matched-M estimate's channel init raw (None if
        memoryless)."""


def _stack(trees: list, dim):
    """Stack a list of equally shaped raws (tensors, tuples, dicts or
    None) leaf by leaf, at ``dim(leaf)``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees], dim)
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], dim) for k in first}
    return torch.stack(trees, dim(first))


def stack_seeds(rows: list):
    """Per-seed raws -> one raw with the seed axis just before the client
    axis ((N,) -> (S, N), (2, N) -> (2, S, N), () -> (S,))."""
    return _stack(rows, lambda x: max(x.ndim - 1, 0))


class GeneratorSweepDraws:
    """:class:`SweepDraws` from a ``torch.Generator`` on ``device``: seed
    ``s`` draws as a :class:`GeneratorDraws` seeded from (``seed``, s),
    whichever other seeds the sweep holds, so every policy sees the same
    channel and uniforms for a seed (the paired comparison)."""

    def __init__(self, seed: int, seeds: Sequence[int], n_clients: int,
                 device="cuda", channel: str = "rayleigh"):
        self.seed, self.n = int(seed), int(n_clients)
        self.device = torch.device(device)
        self.channel = channel
        self._rows = [GeneratorDraws(self.seed * 1_000_003 + int(s) + 1,
                                     n_clients, (), 1, device, channel)
                      for s in seeds]

    def channel_init(self):
        return stack_seeds([d.channel_init() for d in self._rows])

    def channel_raw(self, r):
        return stack_seeds([d.channel_raw(r) for d in self._rows])

    def selection_u(self, r):
        return stack_seeds([d.selection_u(r) for d in self._rows])

    def uniform_raw(self, r):
        return stack_seeds([d.uniform_raw(r) for d in self._rows])

    def match_raws(self, rounds):
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003)
        draw = CHANNEL_RAW[self.channel][0]
        return _stack([draw(gen, self.n, self.device)
                       for _ in range(rounds)], lambda x: 0)

    def match_init(self):
        draw = CHANNEL_INIT_RAW[self.channel]
        if draw is None:
            return None
        gen = torch.Generator(device=self.device).manual_seed(
            self.seed * 1_000_003 + (1 << 48))
        return draw(gen, self.n, self.device)


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
    """The batched scheduling trajectory of ONE policy under one channel:
    ``runner(draws, keep_selection=False)`` maps a :class:`SweepDraws` of
    S seeds to per-seed ``(comm_cum, power, avg_power, n_selected)``, each
    an (S, rounds) tensor on ``sigmas``' device, plus the (S, rounds, N)
    selections and q with ``keep_selection``.

    Each round draws the channel, runs the policy on all seeds at once
    ((S, N) tensors: ``proposed`` solves through :func:`make_sweep_solve_fn`,
    so under ``"cuda"`` / ``"cuda_fused"`` one solve-kernel launch serves
    every seed; the baselines launch no kernel) and accounts the TDMA comm
    time and the power sum P q with plain sums, as the reference's sweep
    does (not the blocked reduce). Nothing is read back before the end.
    """
    lookup_policy(policy)
    n = scfg.n_clients
    scfg_run = dataclasses.replace(scfg, guarantee_one=guarantee_one)
    co = as_operands(decision_coeffs(scfg_run, ch).solve, sigmas)
    step = make_policy(policy, scfg_run, ch, m_avg=m_avg,
                       solve_fn=make_sweep_solve_fn(scfg_run, ch, solver),
                       coeffs=co, **(policy_params or {}))
    chan = make_channel(channel, sigmas, ch, **dict(channel_params))

    def runner(draws: SweepDraws, keep_selection: bool = False):
        st0 = init_policy_state(policy, n, sigmas.device)
        cst = chan.init(draws.channel_init())
        st, outs, kept = None, [], []
        for r in range(rounds):
            gains, cst = chan.apply(draws.channel_raw(r), cst)
            if st is None:
                st = PolicyState(st0.z.expand(gains.shape).clone(),
                                 st0.aux.expand(gains.shape).clone(), st0.t)
            sel, q, p, st = step(policy_raw(draws, policy, r), gains, st)
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
    """Channel -> schedule -> select sweep over policies x seeds under any
    registered channel, on ``sigmas``' device (the twin of the reference's
    ``run_sweep``).

    ``draws`` (None: :class:`GeneratorSweepDraws` from ``seed``, ``seeds``
    and ``channel``) takes the place of the reference's key. The matched M
    of the baselines is estimated under the swept channel on
    ``draws.match_raws(match_rounds)`` and ``draws.match_init()`` when a
    policy needs it and ``uniform_m`` is None. Training is excluded (that
    is ``run_simulation``'s job).

    Returns arrays of shape (len(policies), len(seeds), rounds):
    ``comm_time`` (cumulative s), ``power`` (per-round sum P q),
    ``avg_power`` (running mean of sum P q / N, the Fig. 5 trajectory),
    ``n_selected``, plus the float32 ``uniform_m`` used; with
    ``keep_selection`` also ``selected`` and ``q``, (len(policies),
    len(seeds), rounds, N).
    """
    needs_m = any(lookup_policy(p)[2] for p in policies)
    check_channel(channel, channel_params)
    n = scfg.n_clients
    if draws is None:
        draws = GeneratorSweepDraws(seed, seeds, n, sigmas.device, channel)
    if uniform_m is None:
        # M is matched under the swept channel
        chan = make_channel(channel, sigmas, ch, **dict(channel_params))
        uniform_m = (float(estimate_avg_selected(
            None, sigmas, scfg, ch, match_rounds, channel=chan,
            raws=draws.match_raws(match_rounds),
            init_raw=draws.match_init()))
            if needs_m else 1.0)
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
