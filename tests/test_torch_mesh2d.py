"""The composed (client x part) mesh over gloo ranks (the twin of
tests/test_mesh2d.py).

``SimConfig(client_shards=Dc, participant_shards=Dp)`` runs both sharded
stages of a round on one ``(Dc, Dp)`` mesh of ranks
(``fl/sharding.py::make_mesh2d``, rank ``c * Dp + p``): the (N,) client
schedule over each column's ``'client'`` group, the packed participants'
local SGD over each row's ``'part'`` group, and the all-gathered <= m_cap
index pack the only traffic between the stages. The matrix:

* mesh (1, 1) on one rank — bit for bit the sequential run (every history
  key, the selections, q and, under a population, the activity masks);
* (2, 1) and (1, 2) on two ranks, (2, 2) on four — n_selected and the
  selections exact, comm_time and avg_power within rtol 3e-7, test_acc
  within atol 2e-2 of the sequential run; every rank returns the same
  history;
* against the reference — every mesh against the reference's
  ``run_simulation_scan`` on its recorded draws (n_selected exact,
  comm_time and avg_power at rtol 1e-5);

over three policies x three channel models, the population round (churn
and stragglers from a partly active start) and the fused decision kernel
(K2, its plain version here). The (2, 2) mesh also runs the telemetry
suite's 2D leg: telemetry on against off, bit for bit. Then the mesh's
coordinates and groups, and its guards.
"""

import dataclasses

import numpy as np
import pytest
import torch.distributed as dist
from test_torch_ranks import numpy_images, reference_dataset, start
from test_torch_reference import ReplayDraws, record_draws, reference

from repro_torch import obs
from repro_torch.convert import params_from_jax
from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import from_numpy
from repro_torch.fl.engine import SimConfig, run_simulation_scan
from repro_torch.fl.sharding import make_mesh2d

N = 48
PER_CLIENT = 32
BITS = 32 * 50_000.0
SIM = dict(rounds=4, eval_every=2, m_cap=5, batch=4, local_steps=2,
           eval_size=128, model="mlp", solver="stitched")
HIST_KEYS = ("round", "comm_time", "test_acc", "avg_power", "n_selected")
POP = (("p_join", 0.3), ("p_leave", 0.2), ("p_fail", 0.25),
       ("init_active", 0.8))
MESHES = {1: ((1, 1),), 2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# leg -> (SimConfig fields, the reference run it is held against)
LEGS = {
    "proposed": (dict(policy="proposed"), "proposed"),
    "uniform": (dict(policy="uniform", uniform_m=4.0, channel="lognormal",
                     channel_params=(("shadow_db", 3.0),)), "uniform"),
    "greedy": (dict(policy="greedy_channel", uniform_m=3.0,
                    channel="gauss_markov", channel_params=(("rho", 0.8),)),
               "greedy"),
    "population": (dict(policy="proposed", population=POP), "population"),
    "fused": (dict(policy="proposed", solver="cuda_fused"), "proposed"),
}


def _channel(leg):
    return LEGS[leg][0].get("channel", "rayleigh")


def _configs():
    return (SchedulerConfig(n_clients=N, model_bits=BITS),
            ChannelConfig(n_clients=N), heterogeneous_sigmas(N, device="cpu"))


def mesh_ranks(payload):
    """Rank body: every leg on each mesh of this world (and sequentially at
    world 1); at world 4 the telemetry leg; the mesh's coordinates."""
    world = dist.get_world_size()
    pds = from_numpy(*payload["ds"], device="cpu")
    params = params_from_jax(payload["params"], "cpu")
    out = {}
    for leg, (fields, _) in LEGS.items():
        draws = ReplayDraws(payload["draws"][_channel(leg)])
        sim = SimConfig(**dict(SIM, **fields))
        runs = {mesh: dataclasses.replace(sim, client_shards=mesh[0],
                                          participant_shards=mesh[1])
                for mesh in MESHES[world]}
        if world == 1:
            runs["sequential"] = sim
        out[leg] = {k: run_simulation_scan(draws, params, pds, s,
                                           *_configs(), keep_selection=True)
                    for k, s in runs.items()}
    if world == 4:
        draws = ReplayDraws(payload["draws"]["rayleigh"])
        sim = SimConfig(**SIM, client_shards=2, participant_shards=2)
        off = run_simulation_scan(draws, params, pds, sim, *_configs())
        reg = obs.configure(True)
        on = run_simulation_scan(draws, params, pds, sim, *_configs())
        out["telemetry"] = (off, on, reg.value("engine_runs_total"),
                            reg.value("engine_rounds_total"))
        obs.configure(False)
    mesh = {}
    for dc, dp in MESHES[world]:
        m = make_mesh2d(dc, dp)
        mesh[(dc, dp)] = (m.dc, m.dp, m.c, m.p,
                          dist.get_process_group_ranks(m.client_group),
                          dist.get_process_group_ranks(m.part_group))
    try:
        make_mesh2d(world, 2)
    except ValueError as e:
        mesh["error"] = str(e)
    out["mesh"] = mesh
    return out


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Worlds 1, 2 and 4 started first; meanwhile the reference."""
    jax = ref.jax
    arrays = numpy_images(N, seed=7, per_client=PER_CLIENT)
    ds = reference_dataset(ref, arrays)
    params = ref.registry.make_model("mlp", ds).init_fn(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    draws = {c: record_draws(ref, key, SIM["rounds"], N,
                             (SIM["m_cap"], SIM["local_steps"],
                              SIM["batch"]), PER_CLIENT, c)
             for c in {_channel(leg) for leg in LEGS}}
    payload = dict(ds=arrays, draws=draws,
                   params={k: np.asarray(v) for k, v in params.items()})
    tmp = tmp_path_factory.mktemp("mesh2d")
    started = {w: start(tmp, w, __name__, "mesh_ranks", payload)
               for w in MESHES}
    want = {}
    for leg, (fields, held_by) in LEGS.items():
        if held_by != leg:
            continue
        sim = ref.engine.SimConfig(**dict(SIM, solver="jnp", **fields))
        want[leg] = ref.engine.run_simulation_scan(
            key, params, ds, sim,
            ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS),
            ref.channel.ChannelConfig(n_clients=N),
            ref.channel.heterogeneous_sigmas(N))
    return {w: r.results() for w, r in started.items()}, want


def _cells():
    return [(leg, w, mesh) for w, meshes in MESHES.items()
            for mesh in meshes for leg in LEGS]


@pytest.mark.parametrize("leg,world,mesh", _cells())
def test_mesh_matrix(runs, leg, world, mesh):
    out, want = runs
    seq = out[1][0][leg]["sequential"]
    got = out[world][0][leg][mesh]
    keys = ("selected", "q") + (("active",) if leg == "population" else ())
    if mesh == (1, 1):
        for k in HIST_KEYS + keys:
            np.testing.assert_array_equal(seq[k], got[k], err_msg=k)
    else:
        np.testing.assert_array_equal(seq["round"], got["round"])
        np.testing.assert_array_equal(seq["n_selected"], got["n_selected"])
        for k in keys:
            if k != "q":
                np.testing.assert_array_equal(seq[k], got[k], err_msg=k)
        for k in ("comm_time", "avg_power", "q"):
            np.testing.assert_allclose(got[k], seq[k], rtol=3e-7, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(got["test_acc"], seq["test_acc"],
                                   atol=2e-2)
    for other in out[world][1:]:
        for k in HIST_KEYS:
            np.testing.assert_array_equal(other[leg][mesh][k], got[k])
    ref_hist = want[LEGS[leg][1]]
    np.testing.assert_array_equal(got["n_selected"], ref_hist["n_selected"])
    for k in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[k], ref_hist[k], rtol=1e-5,
                                   err_msg=k)


def test_population_masks_on_the_mesh(runs):
    """No inactive lane is selected or has q != 0 on the (2, 2) mesh."""
    got = runs[0][4][0]["population"][(2, 2)]
    active = got["active"]
    assert active.any(1).all() and not active.all()
    assert not got["selected"][~active].any()
    assert not got["q"][~active].any()


def test_telemetry_2d_leg_bitwise(runs):
    """Telemetry on against off on the (2, 2) mesh, bit for bit, with the
    engine's counters recorded."""
    for off, on, n_runs, n_rounds in (r["telemetry"] for r in runs[0][4]):
        for k in off:
            np.testing.assert_array_equal(off[k], on[k], err_msg=k)
        assert n_runs == 1.0 and n_rounds == SIM["rounds"]


@pytest.mark.parametrize("world", list(MESHES))
def test_mesh_coordinates_and_guards(runs, world):
    for rank, out in enumerate(runs[0][world]):
        mesh = out["mesh"]
        for (dc, dp) in MESHES[world]:
            got_dc, got_dp, c, p, column, row = mesh[(dc, dp)]
            assert (got_dc, got_dp) == (dc, dp)
            assert (c, p) == divmod(rank, dp)
            assert column == [cc * dp + p for cc in range(dc)]
            assert row == [c * dp + pp for pp in range(dp)]
        assert f"mesh ({world}, 2) = {2 * world} ranks" in mesh["error"]
        assert f"world size {world}" in mesh["error"]


def test_make_mesh2d_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError,
                       match="repro_torch.launch.distributed.initialize"):
        make_mesh2d(1, 1)
