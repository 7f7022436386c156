"""Federated learning over the wireless scheduler: the decision layer, the
Algorithm-1 round, the simulation engine and the policy x seed sweep."""

from repro_torch.fl.engine import (Draws, GeneratorDraws,
                                   GeneratorSweepDraws, SimConfig,
                                   SweepDraws, make_sweep_runner,
                                   run_simulation_scan, run_sweep)
from repro_torch.fl.simulation import (match_uniform_m, run_simulation,
                                       time_to_accuracy)

__all__ = ["Draws", "GeneratorDraws", "GeneratorSweepDraws", "SimConfig",
           "SweepDraws", "make_sweep_runner", "run_simulation_scan",
           "run_sweep", "match_uniform_m", "run_simulation",
           "time_to_accuracy"]
