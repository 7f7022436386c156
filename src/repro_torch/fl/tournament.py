"""Policy tournament over adversarial wireless scenarios (twin of
``repro/fl/tournament.py``).

Composes :class:`fl.grid.GridSpec` with its population axis: churn x
outage x straggler-rate x policy x seed run through one ``run_grid``
call, then every policy is scored per scenario on the host:

* **regret-vs-oracle** (accuracy): a scenario's oracle is the policy that
  ends that (channel, population, sigma, seed) trajectory with the
  highest test accuracy; a policy's regret is the gap to it. Every policy
  sees the same fading, churn and failure draws (the grid shares a seed's
  draws across cells), so the regret is paired.
* **time-to-accuracy**: the first cumulative comm time at which a
  trajectory reaches ``acc_target_frac`` of the scenario oracle's final
  accuracy (``inf`` when never), and the paired regret against the
  fastest policy of the scenario.

The scoring (:func:`tournament_metrics`, :func:`leaderboard`) is the
reference's host numpy, copied. With process-wide telemetry on
(``repro_torch.obs.configure(True)``) ``run_tournament`` records the
sweep's scale (configs, configs/s, wall) and each policy's scored
accuracy regret, host numpy over the finished leaderboard: trajectories
are bitwise the same either way.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl.engine import SimConfig
from repro_torch.fl.grid import GridSpec, run_grid
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.instrument import TournamentInstruments, perf

__all__ = ["run_tournament", "tournament_metrics", "leaderboard"]

# metric array layout (populations axis always present in a tournament)
AXES = ("channels", "populations", "sigma_dists", "policies", "seeds")
_POL_AXIS = AXES.index("policies")


def tournament_metrics(grid: Dict[str, np.ndarray],
                       acc_target_frac: float = 0.9) -> Dict[str, object]:
    """Score a population-grid result (host numpy).

    Takes ``run_grid`` output WITH a population axis — every history array
    is (C, G, S, P, K, E) — and returns per-config metrics shaped
    (C, G, S, P, K):

    * ``final_acc`` — test accuracy at the last eval point.
    * ``regret_acc`` — oracle final accuracy minus own (>= 0; the oracle is
      the per-scenario best policy, so its own regret is exactly 0).
    * ``time_to_acc`` — first cumulative comm time reaching
      ``acc_target_frac * oracle final accuracy``; ``inf`` if never.
    * ``regret_tta`` — time_to_acc minus the scenario's fastest policy's
      (``inf`` - ``inf`` is scored 0: nobody reached the target, nobody is
      behind the leader).
    * ``acc_target`` — the (C, G, S, 1, K) per-scenario target itself.
    """
    acc = np.asarray(grid["test_acc"], np.float64)
    comm = np.asarray(grid["comm_time"], np.float64)
    if acc.ndim != 6:
        raise ValueError(
            "tournament_metrics needs a population-grid result "
            "(test_acc with axes (C, G, S, P, K, E)); got "
            f"{acc.ndim} axes — set GridSpec.populations (an empty-dict "
            "scenario `()` gives the degenerate all-active lane)")
    final_acc = acc[..., -1]
    oracle = final_acc.max(axis=_POL_AXIS, keepdims=True)
    regret_acc = oracle - final_acc
    target = acc_target_frac * oracle[..., None]
    reached = acc >= target
    ever = reached.any(axis=-1)
    first = reached.argmax(axis=-1)
    tta = np.take_along_axis(comm, first[..., None], axis=-1)[..., 0]
    tta = np.where(ever, tta, np.inf)
    best_tta = tta.min(axis=_POL_AXIS, keepdims=True)
    with np.errstate(invalid="ignore"):
        regret_tta = tta - best_tta
    regret_tta = np.where(np.isnan(regret_tta), 0.0, regret_tta)  # inf-inf
    return {
        "final_acc": final_acc,
        "regret_acc": regret_acc,
        "time_to_acc": tta,
        "regret_tta": regret_tta,
        "acc_target": target[..., 0],
        "acc_target_frac": float(acc_target_frac),
        "metric_axes": list(AXES),
    }


def leaderboard(metrics: Dict[str, object], policies) -> list:
    """Per-policy summary rows, best mean accuracy-regret first.

    ``mean_regret_tta`` averages over the scenarios where the policy
    reached the target; ``unreached`` counts the ones it never did.
    """
    rows = []
    for pi, name in enumerate(policies):
        r_acc = np.moveaxis(metrics["regret_acc"], _POL_AXIS, 0)[pi]
        r_tta = np.moveaxis(metrics["regret_tta"], _POL_AXIS, 0)[pi]
        tta = np.moveaxis(metrics["time_to_acc"], _POL_AXIS, 0)[pi]
        acc = np.moveaxis(metrics["final_acc"], _POL_AXIS, 0)[pi]
        fin = np.isfinite(r_tta)
        rows.append({
            "policy": name,
            "mean_final_acc": float(acc.mean()),
            "mean_regret_acc": float(r_acc.mean()),
            "mean_regret_tta": float(r_tta[fin].mean()) if fin.any()
            else float("inf"),
            "oracle_wins": int((r_acc == 0.0).sum()),
            "unreached": int(np.sum(~np.isfinite(tta))),
        })
    return sorted(rows, key=lambda r: r["mean_regret_acc"])


def run_tournament(draws: Optional[Callable], params,
                   ds: FederatedDataset, sim: SimConfig,
                   scfg: SchedulerConfig, ch: ChannelConfig, *,
                   channels=(("rayleigh", ()),), populations=((),),
                   policies=(("proposed", ()),), seeds=(0,),
                   sigma_dists=("heterogeneous",),
                   acc_target_frac: float = 0.9) -> Dict[str, object]:
    """Run churn x outage x straggler x policy x seed through one
    ``run_grid`` call and score it.

    ``channels`` / ``policies`` are registry entries (optionally with
    params), ``populations`` ``fl/population.py`` param tuples (``()`` the
    all-active scenario); ``draws(sim_one, seed)`` builds a config's
    ``Draws`` (None: seeded by ``seed``). Returns the grid history merged
    with the metric arrays and a ``"leaderboard"``. Baseline policies need
    ``sim.uniform_m > 0`` (the matched M), as in ``run_grid``.
    """
    ti = TournamentInstruments(obs_metrics.default_registry())
    t0 = perf()
    spec = GridSpec(channels=tuple(channels), sigma_dists=tuple(sigma_dists),
                    policies=tuple(policies), seeds=tuple(seeds),
                    populations=tuple(tuple(p) for p in populations))
    grid = run_grid(draws, params, ds, sim, scfg, ch, spec)
    out = dict(grid)
    out.update(tournament_metrics(grid, acc_target_frac))
    out["leaderboard"] = leaderboard(out, grid["policies"])
    if ti.enabled:
        ti.record(spec.size, perf() - t0, out["leaderboard"])
    return out
