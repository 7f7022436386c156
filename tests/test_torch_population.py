"""Dynamic populations (``fl/population.py``) against the reference: the
primitives on shared uniforms, the masked engine round at a small CIFAR-10
shape on the reference's own data and draws, and the contracts of the
reference's tests/test_population.py.

* ``PopulationConfig`` validation; ``init_active_mask``, ``churn_step``,
  ``failure_split`` and ``active_count`` exact against the reference's on
  the same uniforms, and their degenerate cases;
* ``run_simulation`` with churn, stragglers and a partly active start at
  N = 48 (CNN 8/16/32 on 16x16 images, 3 rounds), per solver pair
  (``stitched``/``jnp``, ``cuda``/``pallas`` interpret, ``cuda_fused``/
  ``pallas_fused``) and for other policies under other channels:
  n_selected exact, comm_time and avg_power at rtol 1e-5, accuracy
  within 2 of the 64 eval images;
* the all-active contract inside the port: ``population=()`` equals the
  population-free run bit for bit, per policy and per solver;
* the kept activity masks: an inactive lane is never selected, its q is
  0; Z stays finite and non-negative across the scenario cube.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import (ReplayDraws, record_draws,  # noqa: E402
                                  reference)

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import policies as pp  # noqa: E402
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      resolve_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.synthetic import from_numpy  # noqa: E402
from repro_torch.fl import population as ppop  # noqa: E402
from repro_torch.fl.simulation import SimConfig, run_simulation  # noqa: E402

N, PER_CLIENT, N_TEST = 48, 16, 64
CNN = dict(conv1=8, conv2=16, hidden=32)
SIM = dict(rounds=3, eval_every=2, m_cap=4, batch=4, local_steps=2,
           eval_size=N_TEST, model_params=tuple(CNN.items()))
BITS = 32 * 50000.0
HIST = ("round", "comm_time", "test_acc", "avg_power", "n_selected")
# churn + stragglers from a partly active start: the adversarial scenario
POP = (("p_join", 0.3), ("p_leave", 0.2), ("p_fail", 0.25),
       ("init_active", 0.8))


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def world(ref):
    """The reference's small CIFAR-10-shaped data, its port, CNN
    parameters in both packages, and sigmas in the paper's three levels."""
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
    sig = np.repeat(np.float32([0.2, 0.75, 1.2]), [8, 16, 24])
    return ds, pds, params, pparams, sig


def port_run(world, draws=None, **kw):
    _, pds, _, pparams, sig = world
    return run_simulation(draws, pparams, pds, SimConfig(**dict(SIM, **kw)),
                          SchedulerConfig(n_clients=N, model_bits=BITS),
                          ChannelConfig(n_clients=N),
                          resolve_sigmas(sig, N, device="cpu"),
                          keep_selection=True)


# --------------------------------------------------------------------------
# Primitives.
# --------------------------------------------------------------------------

def test_population_config_validation(ref):
    """The reference's accepted and rejected scenarios."""
    assert ppop.population_config(()) == ppop.PopulationConfig()
    assert ppop.population_config(ppop.PopulationConfig(p_fail=0.5)).p_fail \
        == 0.5
    assert ppop.population_config({"p_join": 0.3}).p_join == 0.3
    with pytest.raises(ValueError, match="p_fail"):
        ppop.population_config((("p_fail", 1.5),))
    with pytest.raises(ValueError, match="p_leave"):
        ppop.population_config((("p_leave", -0.1),))
    with pytest.raises(TypeError):
        ppop.population_config((("no_such_knob", 0.5),))
    assert [f.name for f in ppop.PopulationConfig.__dataclass_fields__
            .values()] == list(ref.population.PopulationConfig
                               .__dataclass_fields__)


@pytest.mark.parametrize("scenario", [(), POP, (("p_leave", 1.0),),
                                      (("init_active", 0.0),),
                                      (("p_fail", 1.0), ("p_join", 1.0)),
                                      (("p_leave", 0.5), ("p_join", 0.5),
                                       ("p_fail", 0.5), ("init_active",
                                                         0.3))])
def test_primitives_match_reference(ref, scenario):
    """init_active_mask, 6 churn steps, failure_split and active_count on
    the reference's own uniforms: exact; the fleet never empties, and an
    emptied one keeps the first argmax of the uniforms."""
    jax = ref.jax
    pcfg = ppop.population_config(scenario)
    rcfg = ref.population.population_config(scenario)
    key = jax.random.PRNGKey(len(scenario))
    n = 20
    want = ref.population.init_active_mask(key, n, rcfg)
    u0 = np.array(jax.random.uniform(
        jax.random.fold_in(key, ref.population.POP_INIT_TAG), (n,)))
    got = ppop.init_active_mask(torch.from_numpy(u0), pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    active, w_active = got, want
    for k in jax.random.split(key, 6):
        raw = np.array(ref.population.draw_churn_raw(k, n))
        w_active = ref.population.churn_step(raw, w_active, rcfg)
        active = ppop.churn_step(torch.from_numpy(raw), active, pcfg)
        np.testing.assert_array_equal(active.numpy(), np.asarray(w_active))
        assert active.any()
        if not (raw >= pcfg.p_leave).any() and not (raw < pcfg.p_join).any():
            assert int(active.sum()) == 1
        assert int(ppop.active_count(active)) == int(
            ref.population.active_count(w_active))
        assert ppop.active_count(active).dtype == torch.int32
        fraw = np.array(ref.population.draw_fail_raw(k, n))
        sel = raw < 0.5
        wd, wf = ref.population.failure_split(fraw, sel, rcfg)
        d, f = ppop.failure_split(torch.from_numpy(fraw),
                                  torch.from_numpy(sel), pcfg)
        np.testing.assert_array_equal(d.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(f.numpy(), np.asarray(wf))
        np.testing.assert_array_equal((d | f).numpy(), sel)
        assert not (d & f).any()


def test_degenerate_primitives():
    """init_active 1 keeps every lane, 0 exactly one; p_leave 1 empties
    the fleet but for the first argmax of the uniforms; p_fail 0 delivers
    the selection, 1 nothing."""
    u = torch.rand(9, generator=torch.Generator().manual_seed(3))
    assert ppop.init_active_mask(u, ppop.PopulationConfig()).all()
    one = ppop.init_active_mask(u, ppop.PopulationConfig(init_active=0.0))
    assert int(one.sum()) == 1 and int(one.long().argmax()) == int(
        u.argmax())
    new = ppop.churn_step(u, torch.ones(9, dtype=torch.bool),
                          ppop.PopulationConfig(p_leave=1.0))
    assert int(new.sum()) == 1 and bool(new[u.argmax()])
    sel = torch.tensor([True, False, True, True, False])
    d, f = ppop.failure_split(u[:5], sel, ppop.PopulationConfig())
    assert torch.equal(d, sel) and not f.any()
    d, f = ppop.failure_split(u[:5], sel, ppop.PopulationConfig(p_fail=1.0))
    assert not d.any() and torch.equal(f, sel)


# --------------------------------------------------------------------------
# The masked engine round against the reference.
# --------------------------------------------------------------------------

ENGINE_CASES = [
    ("stitched", "jnp", "proposed", "rayleigh", ()),
    ("cuda", "pallas", "proposed", "rayleigh", ()),
    ("cuda_fused", "pallas_fused", "proposed", "gauss_markov",
     (("rho", 0.8),)),
    ("stitched", "jnp", "uniform", "outage_burst",
     (("outage_p", 0.2), ("burst_len", 3.0))),
    ("stitched", "jnp", "aoi_capped", "lognormal", (("shadow_db", 6.0),)),
    ("stitched", "jnp", "update_aware", "mobility", ()),
]


@pytest.mark.parametrize("solver,ref_solver,policy,channel,cparams",
                         ENGINE_CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in ENGINE_CASES])
def test_population_run_matches_reference(ref, world, solver, ref_solver,
                                          policy, channel, cparams):
    """run_simulation under POP on the reference's data and draws:
    n_selected exact, comm_time and avg_power at rtol 1e-5, test accuracy
    within 2 of the 64 eval images; inactive lanes never selected, q = 0
    on them."""
    ds, _, params, _, sig = world
    jax = ref.jax
    kw = dict(policy=policy, channel=channel, channel_params=cparams,
              population=POP,
              uniform_m=6.0 if pp.POLICIES[policy][2] else 0.0)
    key = jax.random.PRNGKey(6)
    want = ref.simulation.run_simulation(
        key, params, ds, ref.simulation.SimConfig(solver=ref_solver,
                                                  **SIM, **kw),
        ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS),
        ref.channel.ChannelConfig(n_clients=N),
        ref.channel.resolve_sigmas(sig, N))
    draws = ReplayDraws(record_draws(ref, key, SIM["rounds"], N,
                                     (SIM["m_cap"], SIM["local_steps"],
                                      SIM["batch"]), PER_CLIENT, channel))
    got = port_run(world, draws, solver=solver, **kw)
    for k in ("round", "n_selected"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=2 / N_TEST)
    active = got["active"]
    assert active.shape == (SIM["rounds"], N) and not active.all()
    assert not got["selected"][~active].any()
    np.testing.assert_array_equal(got["q"][~active], 0.0)


@pytest.mark.parametrize("policy,solver", [
    ("proposed", "stitched"), ("proposed", "cuda"),
    ("proposed", "cuda_fused"), ("uniform", "stitched"),
    ("greedy_channel", "stitched"), ("proportional_gain", "stitched"),
    ("update_aware", "stitched"), ("aoi_capped", "cuda_fused")])
def test_all_active_equals_population_free_bitwise(world, policy, solver):
    """population=() (nobody churns or fails, all active) reproduces the
    population-free run bit for bit: the histories, every round's
    selection and q."""
    kw = dict(policy=policy, solver=solver, channel="gauss_markov",
              uniform_m=6.0 if pp.POLICIES[policy][2] else 0.0)
    free = port_run(world, **kw)
    degenerate = port_run(world, population=(), **kw)
    for k in HIST + ("selected", "q"):
        np.testing.assert_array_equal(free[k], degenerate[k], err_msg=k)
    assert degenerate["active"].all()


def test_adversarial_population_changes_the_run(world):
    """The scenario bites: churn and stragglers change the trajectory."""
    free = port_run(world, solver="stitched")
    adv = port_run(world, solver="stitched", population=POP)
    assert not np.array_equal(free["comm_time"], adv["comm_time"])
    assert not adv["active"].all()


def z_trajectory(p_join, p_leave, p_fail, init_active, seed, rounds=40,
                 n=16):
    """The scheduling layer alone under churn: rayleigh gains -> churn ->
    masked proposed step on the port's generator; the (rounds, n) Z."""
    from repro_torch.core.channel import homogeneous_sigmas, make_channel
    ch = ChannelConfig(n_clients=n)
    scfg = SchedulerConfig(n_clients=n, model_bits=BITS)
    step = pp.make_policy("proposed", scfg, ch)
    pcfg = ppop.population_config(
        (("p_join", p_join), ("p_leave", p_leave), ("p_fail", p_fail),
         ("init_active", init_active)))
    gen = torch.Generator().manual_seed(seed)
    chan = make_channel("rayleigh", homogeneous_sigmas(n, device="cpu"), ch)
    active = ppop.init_active_mask(torch.rand(n, generator=gen), pcfg)
    st = pp.init_policy_state("proposed", n, "cpu")
    zs = []
    for _ in range(rounds):
        active = ppop.churn_step(torch.rand(n, generator=gen), active, pcfg)
        gains, _ = chan.step(gen, None)
        sel, _, _, st = step(torch.rand(n, generator=gen), gains, st,
                             active, ppop.active_count(active))
        ppop.failure_split(torch.rand(n, generator=gen), sel, pcfg)
        zs.append(st.z)
    return torch.stack(zs).numpy()


def test_z_finite_nonnegative_fixed_seed_sweep():
    """The corners of the scenario cube and six random points keep every
    Z finite and >= 0 (Eq. 9 is a max(., 0) of finite charges)."""
    rng = np.random.default_rng(42)
    corners = [(0.0, 0.0, 0.0, 1.0), (1.0, 1.0, 1.0, 0.0),
               (0.0, 1.0, 0.5, 1.0), (1.0, 0.0, 0.0, 0.0)]
    for i, pt in enumerate(corners + [tuple(rng.uniform(size=4))
                                      for _ in range(6)]):
        zs = z_trajectory(*pt, seed=i)
        assert np.isfinite(zs).all() and (zs >= 0).all(), pt
