"""Federated learning over the wireless scheduler: the decision layer, the
Algorithm-1 round, the simulation engine, dynamic populations, the policy
x seed sweep, the scenario grid and the policy tournament."""

# Engine internals (make_sim_round, make_chunk_runner, init_carry,
# eval_rounds) stay importable from repro_torch.fl.engine but are not part
# of the package surface, as in the reference: the carry/chunk layout is
# free to change without breaking the public API.

from repro_torch.fl.engine import (Draws, GeneratorDraws,
                                   GeneratorSweepDraws, SimConfig,
                                   SweepDraws, make_solve_fn,
                                   make_sweep_runner, run_simulation_scan,
                                   run_sweep)
from repro_torch.fl.grid import GridSpec, run_grid
from repro_torch.fl.population import PopulationConfig
from repro_torch.fl.round import (delta_aggregate, fl_round, local_sgd,
                                  make_fl_train_step, make_train_step,
                                  weighted_aggregate)
from repro_torch.fl.simulation import (match_uniform_m, run_simulation,
                                       time_to_accuracy)
from repro_torch.fl.tournament import run_tournament

__all__ = ["fl_round", "local_sgd", "make_fl_train_step", "make_train_step",
           "weighted_aggregate", "delta_aggregate", "make_solve_fn",
           "Draws", "GeneratorDraws", "GeneratorSweepDraws", "SimConfig",
           "SweepDraws", "make_sweep_runner", "run_simulation_scan",
           "run_sweep", "GridSpec", "run_grid", "PopulationConfig",
           "match_uniform_m", "run_simulation", "time_to_accuracy",
           "run_tournament"]
