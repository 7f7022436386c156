"""Wireless-FL simulation engine (twin of ``repro/fl/engine.py``'s
``run_simulation_scan``).

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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol

import numpy as np
import torch

from repro_torch.core.channel import NOT_PORTED as CHANNELS_NOT_PORTED
from repro_torch.core.channel import (CHANNEL_RAW, ChannelConfig,
                                      make_channel)
from repro_torch.core.policies import (POLICY_DRAWS, init_policy_state,
                                       make_policy)
from repro_torch.core.scheduler import SchedulerConfig, as_operands
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
    if sim.channel in CHANNELS_NOT_PORTED:
        raise NotImplementedError(
            f"channel {sim.channel!r} is not ported yet (ROADMAP §A item 7)")
    if sim.channel not in CHANNEL_RAW:
        raise ValueError(f"unknown channel model {sim.channel!r}")
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
    pol_state, ch_state, t_comm, power, n_sel, sel)``."""
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
        return params, pol_state, ch_state, t_comm, power, n_sel, sel

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
    ``"selected"``, the (rounds, N) selection masks, so two runs can be
    compared lane by lane.
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
    points, sels = [], []
    for r in range(sim.rounds):
        params, pol_state, ch_state, t_comm, power, n_sel, sel = sim_round(
            params, pol_state, ch_state, draws, r)
        t_cum = t_cum + t_comm
        p_cum = p_cum + power
        if keep_selection:
            sels.append(sel)
        if r in at_eval:
            points.append(torch.stack([t_cum, eval_fn(params), p_cum,
                                       n_sel.to(torch.float32)]))
    traj = torch.stack(points).cpu().numpy()
    hist = history_from_trajectory(sim.rounds, sim.eval_every, ds.n_clients,
                                   *traj.T)
    if keep_selection:
        hist["selected"] = torch.stack(sels).cpu().numpy()
    return hist
