"""Scenario grid: channel x population x sigma-dist x policy x seed (twin
of ``repro/fl/grid.py``).

* :class:`GridSpec` declares the grid: registered channel models (with
  params), population scenarios (``fl/population.py``), named sigma
  distributions, registered policies (with params), seeds.
* :func:`run_grid` runs every configuration's full trajectory (fading
  draws -> selection policy -> local SGD -> Algorithm-1 aggregate -> TDMA
  accounting) and returns the reference's layout.

The reference compiles the grid into one ``jit(shard_map(...))`` over a
config axis sharded across devices. Here the config axis is split over
the ranks of the initialised ``torch.distributed`` group (one rank when
there is none): each cell's (sigma x seed) configs are padded to a
multiple of the world size by repeating the last one (``grid_cell_inputs``),
each rank runs its contiguous block one config after another, and every
rank all-gathers the cell's results. Each config runs through
``fl/engine.py::run_config``, the function behind
``run_simulation_scan``, so a grid cell equals the per-config run of
:func:`sim_for_config` bit for bit by construction, on any number of
ranks. ``n_devices`` is the world size. The grid owns the config axis: a
``sim`` with ``client_shards`` or ``participant_shards`` is refused.

Like the reference's, the grid takes only a solve closure: under
``solver="cuda"`` ``proposed`` solves through the solve kernel, under
``"cuda_fused"`` it runs the stitched decision (the reference's grid
builds its round cores without the fused decision), so the grid
launches no fused kernel; :func:`sim_for_config` maps the solver
accordingly.

Randomness: config ``(..., seed)`` draws from ``draws(sim_one, seed)``, a
``Draws`` source (default: :func:`fl.engine.default_draws` seeded by
``seed``), shared across cells, so equal seeds give the paired comparison
the paper plots.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.channel import (ChannelConfig, check_channel,
                                      resolve_sigmas)
from repro_torch.core.policies import POLICIES, check_policy
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.engine import (SimConfig, default_draws, eval_rounds,
                                   run_config)
from repro_torch.fl.population import population_config
from repro_torch.fl.sharding import all_gather
from repro_torch.launch.distributed import check_backend


def _normalize(entries) -> Tuple[Tuple[str, tuple], ...]:
    """("name" | ("name", ((param, value), ...))) -> canonical pairs."""
    out = []
    for e in entries:
        if isinstance(e, str):
            out.append((e, ()))
        else:
            name, params = e
            out.append((name, tuple(params)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Declarative scenario grid (the cross product of its axes).

    ``channels`` and ``policies`` entries are registry names, optionally
    paired with params: ``("gauss_markov", (("rho", 0.9),))``.
    ``sigma_dists`` entries are named distributions ("homogeneous" |
    "heterogeneous") or explicit (N,) arrays. ``populations`` (default
    none) adds a population axis after the channels: each entry a
    ``fl/population.py`` param tuple, ``()`` the all-active scenario.
    """

    channels: tuple = (("rayleigh", ()),)
    sigma_dists: tuple = ("heterogeneous",)
    policies: tuple = (("proposed", ()),)
    seeds: tuple = (0,)
    populations: tuple = ()

    def channel_entries(self):
        return _normalize(self.channels)

    def policy_entries(self):
        return _normalize(self.policies)

    def population_entries(self):
        return tuple(tuple(p) for p in self.populations)

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (len(self.channels), len(self.sigma_dists),
                len(self.policies), len(self.seeds))

    @property
    def size(self) -> int:
        c, s, p, k = self.shape
        return c * s * p * k * max(1, len(self.populations))

    def cells(self):
        """(channel_idx, policy_idx) pairs on a population-free grid,
        (channel_idx, population_idx, policy_idx) triples otherwise."""
        if self.populations:
            return list(itertools.product(range(len(self.channels)),
                                          range(len(self.populations)),
                                          range(len(self.policies))))
        return list(itertools.product(range(len(self.channels)),
                                      range(len(self.policies))))

    def validate(self):
        for name, params in self.channel_entries():
            check_channel(name, params)
        for name, params in self.policy_entries():
            check_policy(name, params)
        for p in self.population_entries():
            population_config(p)
        if not self.seeds:
            raise ValueError("GridSpec.seeds must be non-empty")


def sim_for_config(sim: SimConfig, spec: GridSpec, ci: int, si: int,
                   pi: int, *, gi=None) -> Tuple[SimConfig, object]:
    """The per-config SimConfig and sigma dist whose ``run_simulation_scan``
    reproduces grid cell (ci, si, pi), or (ci, gi, si, pi) on a population
    grid. The grid runs no fused decision, so ``"cuda_fused"`` becomes
    ``"stitched"``."""
    cname, cparams = spec.channel_entries()[ci]
    pname, pparams = spec.policy_entries()[pi]
    pop = spec.population_entries()[gi] if gi is not None else None
    solver = "stitched" if sim.solver == "cuda_fused" else sim.solver
    one = dataclasses.replace(sim, channel=cname, channel_params=cparams,
                              policy=pname, policy_params=pparams,
                              population=pop, solver=solver)
    return one, spec.sigma_dists[si]


def make_grid_runner(ds: FederatedDataset, sim: SimConfig,
                     scfg: SchedulerConfig, ch: ChannelConfig,
                     spec: GridSpec):
    """The grid's runner on one card.

    ``runner(params, draws=None)`` runs every config, cell by cell
    (``spec.cells()``) and within a cell in C-order over (sigma_dist,
    seed), and returns a (cells, sigma_dists, seeds, E, 4) tensor of
    (comm_time, test_acc, power_cum, n_selected) at each eval point, on
    the device. ``draws(sim_one, seed)`` builds a config's ``Draws``
    (None: ``default_draws`` seeded by ``seed``).
    """
    if sim.participant_shards or sim.client_shards:
        raise ValueError(
            "the grid shards the CONFIG axis across the ranks; nesting the "
            "participant- or client-sharded round inside it is not "
            "supported — use sim.participant_shards / sim.client_shards "
            "with run_simulation, or the grid with both at 0")
    spec.validate()
    if sim.population is not None:
        raise ValueError(
            "the grid owns the population axis: leave sim.population unset "
            "and declare scenarios via GridSpec.populations")
    n = scfg.n_clients
    sigma_table = [resolve_sigmas(d, n, device=ds.device)
                   for d in spec.sigma_dists]
    pops = bool(spec.populations)
    n_sig, n_seed = len(spec.sigma_dists), len(spec.seeds)
    world, rank = n_devices(), (dist.get_rank() if dist.is_initialized()
                                else 0)
    if world > 1:
        check_backend(ds.device)

    def runner(params, draws: Optional[Callable] = None):
        if draws is None:
            def draws(one, seed):
                return default_draws(dataclasses.replace(one, seed=seed),
                                     ds)
        cells = []
        for cell, sids, seeds in zip(spec.cells(),
                                     *grid_cell_inputs(spec, world)):
            ci, gi, pi = cell if pops else (cell[0], None, cell[1])
            per = len(sids) // world
            rows = []
            for si, seed in zip(sids[rank * per:(rank + 1) * per],
                                seeds[rank * per:(rank + 1) * per]):
                one, _ = sim_for_config(sim, spec, ci, int(si), pi, gi=gi)
                one = dataclasses.replace(one, seed=int(seed))
                points, _ = run_config(draws(one, int(seed)), params, ds,
                                       one, scfg, ch, sigma_table[si])
                rows.append(points)
            rows = torch.stack(rows)
            if world > 1:
                rows = all_gather(rows, dist.group.WORLD).flatten(0, 1)
            cells.append(rows[:n_sig * n_seed])
        out = torch.stack(cells)
        return out.reshape(-1, n_sig, n_seed, *out.shape[2:])

    return runner


def n_devices() -> int:
    """The grid's device count: the world size of the initialised process
    group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1



def pad_to_multiple(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad axis 0 up to a multiple by repeating the last row."""
    c = arr.shape[0]
    pad = (-c) % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


def grid_cell_inputs(spec: GridSpec, n_devices: int = 1):
    """Per-cell (sigma_ids, seeds) config arrays, padded to the device
    count by repeating the last config, as the reference shards them;
    within a cell configs run in C-order over (sigma_dist, seed), and
    rank r runs the r-th contiguous block."""
    n_sig = len(spec.sigma_dists)
    sids = np.repeat(np.arange(n_sig, dtype=np.int32), len(spec.seeds))
    seeds = np.tile(np.asarray(spec.seeds, dtype=np.int64), n_sig)
    sids = pad_to_multiple(sids, n_devices)
    seeds = pad_to_multiple(seeds, n_devices)
    n_cells = len(spec.cells())
    return tuple([sids] * n_cells), tuple([seeds] * n_cells)


def run_grid(draws: Optional[Callable], params, ds: FederatedDataset,
             sim: SimConfig, scfg: SchedulerConfig, ch: ChannelConfig,
             spec: GridSpec) -> Dict[str, np.ndarray]:
    """Run the whole scenario grid on ``ds``'s device.

    ``draws(sim_one, seed)`` (None: ``default_draws`` seeded by ``seed``)
    takes the place of the reference's ``fold_in(key, seed)``: seeds are
    shared across cells. History layout as the reference's: per config,
    ``comm_time`` / ``test_acc`` / ``avg_power`` / ``n_selected`` at each
    eval round, arranged (channels, sigma_dists, policies, seeds,
    eval_points), or with ``spec.populations`` (channels, populations,
    sigma_dists, policies, seeds, eval_points) plus ``"populations"``.

    Baseline policies need ``sim.uniform_m > 0`` (the matched M, see
    ``fl/simulation.py::match_uniform_m``); one M serves every cell.
    """
    spec.validate()
    needs_m = any(POLICIES[name][2] for name, _ in spec.policy_entries())
    if needs_m and not sim.uniform_m > 0.0:
        raise ValueError(
            "grid includes baseline policies: set sim.uniform_m > 0 "
            "(matched average participation; see match_uniform_m)")
    cell_outs = make_grid_runner(ds, sim, scfg, ch, spec)(
        params, draws).cpu().numpy()

    n_ch, n_sig, n_pol, n_seed = spec.shape
    has_pop = bool(spec.populations)
    n_pop = len(spec.populations) if has_pop else 1
    ev = np.asarray(eval_rounds(sim.rounds, sim.eval_every))
    shape = (n_ch, n_pop, n_sig, n_pol, n_seed, len(ev))
    outs = {k: np.zeros(shape, np.float64)
            for k in ("comm_time", "test_acc", "power_cum")}
    outs["n_selected"] = np.zeros(shape, np.int64)
    for cell_key, cell in zip(spec.cells(), cell_outs):
        ci, gi, pi = cell_key if has_pop else (cell_key[0], 0, cell_key[1])
        for i, k in enumerate(("comm_time", "test_acc", "power_cum",
                               "n_selected")):
            outs[k][ci, gi, :, pi] = cell[..., i].astype(outs[k].dtype)
    if not has_pop:
        outs = {k: v[:, 0] for k, v in outs.items()}
    avg_power = outs.pop("power_cum") / (ev + 1) / ds.n_clients
    result = {
        "round": ev,
        "comm_time": outs["comm_time"],
        "test_acc": outs["test_acc"],
        "avg_power": avg_power,
        "n_selected": outs["n_selected"],
        "channels": [name for name, _ in spec.channel_entries()],
        "sigma_dists": [d if isinstance(d, str) else "custom"
                        for d in spec.sigma_dists],
        "policies": [name for name, _ in spec.policy_entries()],
        "seeds": np.asarray(spec.seeds),
        "n_devices": n_devices(),
    }
    if has_pop:
        result["populations"] = [dict(p) for p in
                                 spec.population_entries()]
    return result
