"""The scenario grid (``fl/grid.py``) and the policy tournament
(``fl/tournament.py``) against the reference.

* ``run_grid`` on a 2 channel x 2 population x 3 policy x 1 seed grid (12
  configs, N = 48, CNN 8/16/32 on 16x16 images, 3 rounds) on the
  reference's data and its grid's own draws (config key ``fold_in(key,
  seed)``): the reference's layout and labels, n_selected exact,
  comm_time and avg_power at rtol 1e-5, accuracy within 2 of the 64 eval
  images;
* every grid cell bit for bit against the port's own
  ``run_simulation_scan`` of that config (``sim_for_config``);
* ``GridSpec`` and the grid's argument checks; ``pad_to_multiple`` and
  ``grid_cell_inputs``;
* ``tournament_metrics`` and ``leaderboard`` equal to the reference's on
  its fixtures and on the grid's arrays, exactly; the all-unreached and
  population-free cases; ``run_tournament`` on the grid's spec.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
from test_torch_reference import (ReplayDraws, grid_draws,  # noqa: E402
                                  record_draws, reference)

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      resolve_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.synthetic import from_numpy  # noqa: E402
from repro_torch.fl import grid as pgrid  # noqa: E402
from repro_torch.fl import tournament as ptour  # noqa: E402
from repro_torch.fl.engine import SimConfig, run_simulation_scan  # noqa: E402

N, PER_CLIENT, N_TEST = 48, 16, 64
CNN = dict(conv1=8, conv2=16, hidden=32)
SIM = dict(rounds=3, eval_every=2, m_cap=4, batch=4, local_steps=2,
           eval_size=N_TEST, model_params=tuple(CNN.items()), uniform_m=6.0)
BITS = 32 * 50000.0
SPEC = dict(channels=("rayleigh",
                      ("outage_burst", (("outage_p", 0.2),
                                        ("burst_len", 3.0)))),
            populations=((), (("p_leave", 0.2), ("p_join", 0.3),
                              ("p_fail", 0.25))),
            policies=("proposed", "uniform",
                      ("aoi_capped", (("max_age", 3),))),
            seeds=(1,))
HIST = ("comm_time", "test_acc", "avg_power", "n_selected")


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def world(ref):
    jax = ref.jax
    ds = ref.synthetic.make_cifar10_like(jax.random.PRNGKey(0), n_clients=N,
                                         per_client=PER_CLIENT, n_test=N_TEST,
                                         h=16, w=16)
    pds = from_numpy(ds.client_images, ds.client_labels, ds.test_images,
                     ds.test_labels, ds.n_classes, device="cpu")
    params = ref.registry.make_model("cnn", ds, **CNN).init_fn(
        jax.random.PRNGKey(1))
    pparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return ds, pds, params, pparams


@pytest.fixture(scope="module")
def grids(ref, world):
    """The reference's grid on one device and the port's on its replayed
    draws, both with the solve kernel (``pallas`` interpret / ``cuda``,
    whose plain version runs on the CPU)."""
    ds, pds, params, pparams = world
    jax = ref.jax
    key = jax.random.PRNGKey(9)
    want = ref.grid.run_grid(
        key, params, ds, ref.engine.SimConfig(solver="pallas", **SIM),
        ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS),
        ref.channel.ChannelConfig(n_clients=N), ref.grid.GridSpec(**SPEC),
        devices=jax.devices()[:1])
    sim = SimConfig(solver="cuda", **SIM)
    got = pgrid.run_grid(grid_draws(ref, key, N, PER_CLIENT), pparams, pds,
                         sim, SchedulerConfig(n_clients=N, model_bits=BITS),
                         ChannelConfig(n_clients=N),
                         pgrid.GridSpec(**SPEC))
    return want, got, sim, key


def test_grid_matches_reference(grids):
    """Layout, labels and every config's history."""
    want, got, _, _ = grids
    assert got["comm_time"].shape == want["comm_time"].shape == (
        2, 2, 1, 3, 1, 2)
    for k in ("channels", "sigma_dists", "policies", "populations"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["round"], want["round"])
    np.testing.assert_array_equal(got["seeds"], want["seeds"])
    assert got["n_devices"] == 1
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    for k in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=2 / N_TEST)


def test_grid_cells_equal_per_config_runs_bitwise(ref, world, grids):
    """Every cell of the grid is its config's run_simulation_scan, bit
    for bit (the grid runs exactly that function)."""
    _, pds, _, pparams = world
    _, got, sim, key = grids
    spec = pgrid.GridSpec(**SPEC)
    for ci, gi, pi in spec.cells():
        one, sdist = pgrid.sim_for_config(sim, spec, ci, 0, pi, gi=gi)
        seed = spec.seeds[0]
        hist = run_simulation_scan(
            ReplayDraws(record_draws(
                ref, ref.jax.random.fold_in(key, seed), one.rounds, N,
                (one.m_cap, one.local_steps, one.batch), PER_CLIENT,
                one.channel)),
            pparams, pds, dataclasses.replace(one, seed=seed),
            SchedulerConfig(n_clients=N, model_bits=BITS),
            ChannelConfig(n_clients=N), resolve_sigmas(sdist, N,
                                                       device="cpu"))
        for k in HIST:
            np.testing.assert_array_equal(got[k][ci, gi, 0, pi, 0], hist[k],
                                          err_msg=f"{k} cell {ci, gi, pi}")


def test_grid_spec_and_checks(world):
    """GridSpec's shape, size and cells (with and without populations);
    unknown names and params, missing matched M, a population on the sim
    and an empty seed list are errors; sim_for_config maps cuda_fused to
    the stitched decision the grid runs."""
    _, pds, _, pparams = world
    spec = pgrid.GridSpec(**SPEC)
    assert spec.shape == (2, 1, 3, 1) and spec.size == 12
    assert len(spec.cells()) == 12 and spec.cells()[1] == (0, 0, 1)
    flat = pgrid.GridSpec(channels=("rayleigh",), policies=("proposed",
                                                             "uniform"))
    assert flat.cells() == [(0, 0), (0, 1)] and flat.size == 2
    sim = SimConfig(solver="cuda_fused", **SIM)
    one, sdist = pgrid.sim_for_config(sim, spec, 1, 0, 2, gi=1)
    assert (one.channel, one.policy, one.solver, sdist) == (
        "outage_burst", "aoi_capped", "stitched", "heterogeneous")
    assert one.policy_params == (("max_age", 3),)
    assert dict(one.population)["p_fail"] == 0.25
    args = (pparams, pds, sim, SchedulerConfig(n_clients=N, model_bits=BITS),
            ChannelConfig(n_clients=N))
    for bad, match in ((dict(channels=("awgn",)), "unknown channel"),
                       (dict(policies=("best",)), "unknown policy"),
                       (dict(policies=(("uniform", (("q_floor", .1),)),)),
                        "policy_params"),
                       (dict(seeds=()), "seeds"),
                       (dict(populations=((("p_fail", 2.0),),)), "p_fail")):
        with pytest.raises(ValueError, match=match):
            pgrid.run_grid(None, *args, pgrid.GridSpec(**bad))
    with pytest.raises(ValueError, match="uniform_m"):
        pgrid.run_grid(None, pparams, pds,
                       dataclasses.replace(sim, uniform_m=0.0), *args[3:],
                       pgrid.GridSpec(policies=("uniform",)))
    with pytest.raises(ValueError, match="population"):
        pgrid.run_grid(None, pparams, pds,
                       dataclasses.replace(sim, population=()), *args[3:],
                       flat)


def test_pad_and_cell_inputs(ref):
    """pad_to_multiple repeats the last row; the cell inputs run C-order
    over (sigma_dist, seed), as the reference's."""
    a = np.arange(5)
    np.testing.assert_array_equal(pgrid.pad_to_multiple(a, 4),
                                  [0, 1, 2, 3, 4, 4, 4, 4])
    np.testing.assert_array_equal(pgrid.pad_to_multiple(a, 5), a)
    spec = pgrid.GridSpec(sigma_dists=("homogeneous", "heterogeneous"),
                          seeds=(3, 7, 8), policies=("proposed",
                                                     "uniform"))
    sids, seeds = pgrid.grid_cell_inputs(spec, 1)
    assert len(sids) == len(seeds) == 2
    np.testing.assert_array_equal(sids[0], [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(seeds[0], [3, 7, 8, 3, 7, 8])
    rsids, _ = ref.grid.grid_cell_inputs(
        ref.jax.random.PRNGKey(0), ref.grid.GridSpec(
            sigma_dists=spec.sigma_dists, seeds=spec.seeds,
            policies=spec.policies), 1)
    np.testing.assert_array_equal(sids[0], rsids[0])


def tournament_fixture():
    """The reference's hand-built two-policy history."""
    acc = np.zeros((1, 1, 1, 2, 1, 3))
    comm = np.zeros((1, 1, 1, 2, 1, 3))
    acc[0, 0, 0, 0, 0] = [0.2, 0.5, 0.8]
    acc[0, 0, 0, 1, 0] = [0.1, 0.2, 0.3]
    comm[0, 0, 0, 0, 0] = [1.0, 2.0, 3.0]
    comm[0, 0, 0, 1, 0] = [0.5, 1.0, 1.5]
    return {"test_acc": acc, "comm_time": comm}


def unreached_fixture():
    acc = np.full((1, 1, 1, 2, 1, 2), 0.1)
    acc[0, 0, 0, 0, 0, -1] = 0.5
    acc[..., -1] = np.minimum(acc[..., -1], 0.4)
    return {"test_acc": acc, "comm_time": np.ones_like(acc)}


def assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("case", ["fixture", "unreached", "grid"])
def test_tournament_metrics_and_leaderboard(ref, grids, case):
    """The scoring equals the reference's exactly on its fixtures and on
    the grid's arrays; the hand-computed numbers of the reference's test;
    inf - inf scores 0."""
    if case == "fixture":
        hist, frac, names = tournament_fixture(), 0.9, ["proposed",
                                                         "uniform"]
    elif case == "unreached":
        hist, frac, names = unreached_fixture(), 1.1, ["a", "b"]
    else:
        hist, frac, names = grids[1], 0.9, grids[1]["policies"]
    got = ptour.tournament_metrics(hist, frac)
    want = ref.tournament.tournament_metrics(hist, frac)
    assert_metrics_equal(got, want)
    assert ptour.leaderboard(got, names) == ref.tournament.leaderboard(
        want, names)
    assert ptour.AXES == ref.tournament.AXES
    if case == "fixture":
        np.testing.assert_allclose(got["regret_acc"][0, 0, 0, :, 0],
                                   [0.0, 0.5])
        assert got["time_to_acc"][0, 0, 0, 0, 0] == 3.0
        assert np.isinf(got["time_to_acc"][0, 0, 0, 1, 0])
        assert np.isinf(got["regret_tta"][0, 0, 0, 1, 0])
        rows = ptour.leaderboard(got, names)
        assert rows[0]["policy"] == "proposed"
        assert rows[0]["oracle_wins"] == 1 and rows[1]["unreached"] == 1
    if case == "unreached":
        assert np.isinf(got["time_to_acc"]).all()
        np.testing.assert_array_equal(got["regret_tta"], 0.0)


def test_tournament_metrics_rejects_population_free_grid():
    """A 5-axis (population-free) history is a usage error."""
    with pytest.raises(ValueError, match="population"):
        ptour.tournament_metrics({"test_acc": np.zeros((1, 1, 2, 1, 3)),
                                  "comm_time": np.zeros((1, 1, 2, 1, 3))})


def test_run_tournament_on_the_grid(ref, world, grids):
    """run_tournament is run_grid on its spec plus the scoring: the same
    arrays as the grid, regret >= 0 and exactly 0 for each scenario's
    oracle, an ordered leaderboard of every policy."""
    _, pds, _, pparams = world
    _, grid, sim, key = grids
    t = ptour.run_tournament(
        grid_draws(ref, key, N, PER_CLIENT), pparams, pds, sim,
        SchedulerConfig(n_clients=N, model_bits=BITS),
        ChannelConfig(n_clients=N), **SPEC)
    for k in HIST:
        np.testing.assert_array_equal(t[k], grid[k])
    assert t["regret_acc"].shape == (2, 2, 1, 3, 1)
    assert (t["regret_acc"] >= 0).all()
    assert (t["regret_acc"].min(axis=ptour.AXES.index("policies"))
            == 0).all()
    names = [r["policy"] for r in t["leaderboard"]]
    assert sorted(names) == sorted(t["policies"])
    regs = [r["mean_regret_acc"] for r in t["leaderboard"]]
    assert regs == sorted(regs)
