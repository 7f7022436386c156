"""End-to-end wireless-FL simulation entry points (twin of
``repro/fl/simulation.py``).

``run_simulation`` dispatches on ``SimConfig.engine``:

* ``"scan"`` (default): the port's engine, ``fl/engine.py``: every
  registered channel and policy, populations and sharding, the solve
  behind ``sim.solver``, and no host read before the last round;
* ``"loop"``: :func:`run_simulation_loop`, the reference's legacy
  per-round loop, kept as an independent implementation: it builds each
  round from the core functions (the Rayleigh channel, the Theorem-2
  solve, the selection and queue update, the uniform baseline's decision,
  the Eq. 8 TDMA sum), trains the participants one after another and
  reads the round's accounting back on the host.
  tests/test_torch_loop_engine.py holds it against the reference's loop
  and against the scan engine on the same draws.

``match_uniform_m`` sets the uniform baseline's matched participation M;
``time_to_accuracy`` reads a history's comm time at a target accuracy.

Only up to ``m_cap`` participants train in a round (Algorithm 1's
aggregate takes nothing from the others), so N = 3,597 FEMNIST clients
never materialise 3,597 model replicas.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.channel import (ChannelConfig, channel_rate,
                                      make_channel)
from repro_torch.core.scheduler import (SchedulerConfig,
                                        estimate_avg_selected, init_state,
                                        selection_from_uniform, solve_round,
                                        uniform_coeffs, uniform_decide,
                                        update_queues)
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.engine import (Draws, SimConfig, check_engine,
                                   default_draws, make_solve_fn,
                                   run_simulation_scan, run_sweep)
from repro_torch.fl.round import local_sgd, resolve_wire_dtype
from repro_torch.models.registry import make_model

__all__ = ["SimConfig", "run_simulation", "run_simulation_loop",
           "run_simulation_scan", "run_sweep", "make_solve_fn",
           "match_uniform_m", "time_to_accuracy"]


def run_simulation(draws: Optional[Draws], params: dict,
                   ds: FederatedDataset, sim: SimConfig,
                   scfg: SchedulerConfig, ch: ChannelConfig,
                   sigmas: torch.Tensor, *,
                   keep_selection: bool = False) -> Dict[str, np.ndarray]:
    """History dict: round, comm_time (cumulative s), test_acc, avg_power,
    n_selected. ``draws`` (None: seeded by ``sim.seed``) takes the place of
    the reference's PRNG key; the run's device is the dataset's.

    ``sim.engine`` picks the scan engine or the legacy loop; each engine
    runs :func:`~repro_torch.fl.engine.check_engine`, the reference's
    checks (an unknown engine, and a loop config outside the paper's
    setup, raise ``ValueError``). ``keep_selection`` is the scan
    engine's: any other engine keeps no selection and raises."""
    if sim.engine == "scan":
        return run_simulation_scan(draws, params, ds, sim, scfg, ch, sigmas,
                                   keep_selection=keep_selection)
    if keep_selection:
        raise ValueError(f"keep_selection: engine {sim.engine!r} keeps no "
                         "selection; use engine='scan'")
    return run_simulation_loop(draws, params, ds, sim, scfg, ch, sigmas)


def _round_update(loss_fn, params: dict, sel_valid, q_sel, batches,
                  gamma: float, steps: int, n_clients: int,
                  aggregation: str = "paper",
                  wire_dtype=torch.float32) -> dict:
    """Aggregate x <- (1/N) sum_{i in sel} (1/q_i) y_i over the m_cap
    packed rows (paper), or the delta form x + (1/N) sum (1/q)(y - x)
    whose summand is cast to ``wire_dtype`` before the sum.

    The rows train one after another (the reference's ``lax.map``), pad
    rows included, each through :func:`~repro_torch.fl.round.local_sgd`
    on its own, not under ``vmap``."""
    inputs, labels = batches
    rows = [local_sgd(loss_fn, params, (inputs[i], labels[i]), gamma, steps)
            for i in range(inputs.shape[0])]
    w = (sel_valid.to(torch.float32) / torch.clamp_min(q_sel, 1e-9)
         / n_clients)

    def per_row(y):
        return w.reshape((-1,) + (1,) * (y.ndim - 1))

    out = {}
    for k, x in params.items():
        y = torch.stack([row[k] for row in rows]).to(torch.float32)
        if aggregation == "delta":
            delta = y - x.to(torch.float32)[None]
            update = (delta * per_row(y)).to(wire_dtype).sum(0)
            out[k] = x.to(torch.float32) + update.to(torch.float32)
        elif aggregation == "paper":
            out[k] = (y * per_row(y)).sum(0)
        else:
            raise ValueError(f"unknown aggregation {aggregation!r} "
                             "(want 'paper'|'delta')")
    return out


def run_simulation_loop(draws: Optional[Draws], params: dict,
                        ds: FederatedDataset, sim: SimConfig,
                        scfg: SchedulerConfig, ch: ChannelConfig,
                        sigmas: torch.Tensor) -> Dict[str, np.ndarray]:
    """Legacy engine (twin of the reference's ``run_simulation_loop``):
    one round at a time, the host reading each round's comm time, power
    and selection count back. Same history layout as the scan engine.

    ``draws`` None uses ``default_draws(sim, ds)``. Each round: Rayleigh
    gains from ``draws.channel_raw(r)``; for ``proposed`` the Theorem-2
    solve on the queues, the selection from ``draws.selection_u(r)`` and
    the Eq. 9 queue update, for ``uniform`` the baseline's decision on
    ``draws.uniform_raw(r)``; the TDMA comm time (Eq. 8) and sum P q; the
    first ``m_cap`` selected clients (pads at client 0, weight 0) train
    on ``draws.batch_idx(r)``'s minibatches, one after another, and
    aggregate. ``sim.solver`` is ignored, as in the reference: the solve
    is the core's plain math, so no scheduling kernel launches. The
    caller's ``params`` stay as they were."""
    check_engine(sim, loop=True)
    draws = default_draws(sim, ds) if draws is None else draws
    n, m_cap = ds.n_clients, sim.m_cap
    spec = make_model(sim.model, ds, **dict(sim.model_params))
    wire = resolve_wire_dtype(sim.wire_dtype)
    params = {k: v.detach().clone() for k, v in params.items()}
    channel = make_channel("rayleigh", sigmas, ch)
    ch_state = channel.init(draws.channel_init())
    sched_state = init_state(scfg, ds.device)
    uni = (uniform_coeffs(n, sim.uniform_m, ch)
           if sim.policy == "uniform" else None)
    ev_inputs = ds.test_images[: sim.eval_size]
    ev_labels = ds.test_labels[: sim.eval_size]

    def sim_round(params, sched_state, ch_state, r):
        gains, ch_state = channel.apply(draws.channel_raw(r), ch_state)
        if sim.policy == "proposed":
            q, p = solve_round(gains, sched_state.z, scfg, ch)
            sel = selection_from_uniform(draws.selection_u(r), q,
                                         scfg.guarantee_one)
            sched_state = update_queues(sched_state, q, p, ch)
        else:
            sel, q, p = uniform_decide(draws.uniform_raw(r), uni)
        # comm time: the TDMA sum over the selected (Eq. 8 denominator)
        rate = channel_rate(gains, p, ch)
        t_comm = torch.where(sel, gains.new_full((), scfg.model_bits)
                             / torch.clamp_min(rate, 1e-9), 0.0).sum()
        power = (p * q).sum()
        n_sel = int(sel.sum())
        # the first m_cap participants, zero-filled past the selection
        picked = torch.nonzero(sel).flatten()[:m_cap]
        sel_idx = F.pad(picked, (0, m_cap - picked.numel()))
        sel_valid = torch.arange(m_cap, device=sel.device) < n_sel
        idx = draws.batch_idx(r)
        rows = sel_idx[:, None, None]
        batches = (ds.client_images[rows, idx], ds.client_labels[rows, idx])
        params = _round_update(spec.loss_fn, params, sel_valid, q[sel_idx],
                               batches, sim.gamma, sim.local_steps, n,
                               sim.aggregation, wire)
        return params, sched_state, ch_state, t_comm, power, n_sel

    hist: Dict[str, List] = {"round": [], "comm_time": [], "test_acc": [],
                             "avg_power": [], "n_selected": []}
    t_cum = power_cum = 0.0
    for r in range(sim.rounds):
        params, sched_state, ch_state, t_comm, power, n_sel = sim_round(
            params, sched_state, ch_state, r)
        t_cum += float(t_comm)
        power_cum += float(power)
        if r % sim.eval_every == 0 or r == sim.rounds - 1:
            hist["round"].append(r)
            hist["comm_time"].append(t_cum)
            hist["test_acc"].append(float(spec.eval_fn(params, ev_inputs,
                                                       ev_labels)))
            hist["avg_power"].append(power_cum / (r + 1) / n)
            hist["n_selected"].append(n_sel)
    dtypes = {"round": np.int64, "n_selected": np.int64}
    return {k: np.asarray(v, dtype=dtypes.get(k, np.float64))
            for k, v in hist.items()}


def match_uniform_m(generator, sigmas: torch.Tensor, scfg: SchedulerConfig,
                    ch: ChannelConfig, rounds: int = 300,
                    channel: str = "rayleigh", channel_params: tuple = (), *,
                    raws=None, init_raw=None) -> float:
    """Algorithm 2's average participation M (Monte Carlo over ``rounds``
    rounds), for the M-matched baselines (paper Section VI), under the
    fading model ``channel`` with its ``channel_params``: match M under
    the channel you will sweep. ``rayleigh`` takes no params; passing
    some is an error rather than a silently mis-matched M. ``raws`` and
    ``init_raw`` replay the channel's raws (rounds stacked along a
    leading axis) and its init raw."""
    chan = make_channel(channel, sigmas, ch, **dict(channel_params))
    return float(estimate_avg_selected(generator, sigmas, scfg, ch, rounds,
                                       channel=chan, raws=raws,
                                       init_raw=init_raw))


def time_to_accuracy(hist: Dict[str, np.ndarray], target: float
                     ) -> Optional[float]:
    """First cumulative comm time at which test_acc >= target; None when
    the target is never reached or the history is empty. Plain-list
    histories work as well as the engine's arrays."""
    acc = np.asarray(hist["test_acc"], dtype=np.float64)
    idx = np.nonzero(acc >= target)[0]
    if idx.size == 0:
        return None
    return float(np.asarray(hist["comm_time"], dtype=np.float64)[idx[0]])
