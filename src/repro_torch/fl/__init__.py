"""Federated learning over the wireless scheduler: the decision layer, the
Algorithm-1 round and the simulation engine."""

from repro_torch.fl.engine import (Draws, GeneratorDraws, SimConfig,
                                   run_simulation_scan)
from repro_torch.fl.simulation import match_uniform_m, run_simulation

__all__ = ["Draws", "GeneratorDraws", "SimConfig", "run_simulation_scan",
           "match_uniform_m", "run_simulation"]
