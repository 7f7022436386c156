"""End-to-end wireless-FL simulation entry points (twin of
``repro/fl/simulation.py``).

``run_simulation`` runs the port's engine (``fl/engine.py``);
``match_uniform_m`` sets the uniform baseline's matched participation M;
``time_to_accuracy`` reads a history's comm time at a target accuracy.
The reference's legacy per-round loop engine is not ported: the port's
parity reference is the JAX package itself (tests/test_torch_engine.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.channel import ChannelConfig, make_channel
from repro_torch.core.scheduler import SchedulerConfig, estimate_avg_selected
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.engine import (Draws, SimConfig, make_solve_fn,
                                   run_simulation_scan, run_sweep)

__all__ = ["SimConfig", "run_simulation", "run_simulation_scan",
           "run_sweep", "make_solve_fn", "match_uniform_m",
           "time_to_accuracy"]


def run_simulation(draws: Optional[Draws], params: dict,
                   ds: FederatedDataset, sim: SimConfig,
                   scfg: SchedulerConfig, ch: ChannelConfig,
                   sigmas: torch.Tensor, *,
                   keep_selection: bool = False) -> Dict[str, np.ndarray]:
    """History dict: round, comm_time (cumulative s), test_acc, avg_power,
    n_selected. ``draws`` (None: seeded by ``sim.seed``) takes the place of
    the reference's PRNG key; the run's device is the dataset's."""
    return run_simulation_scan(draws, params, ds, sim, scfg, ch, sigmas,
                               keep_selection=keep_selection)


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
