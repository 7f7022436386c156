"""The legacy loop engine, ``repro_torch.fl.simulation.run_simulation_loop``,
held three ways.

* Against the reference's ``run_simulation_loop`` on the reference's own
  key, its draws recorded and replayed (``record_draws`` /
  ``ReplayDraws``), for ``proposed`` and ``uniform``: ``round`` and
  ``n_selected`` exact, ``comm_time`` and ``avg_power`` at rtol 1e-5 (the
  scheduling trajectory does not depend on the model, and both loops sum
  their accounting in float64 on the host), ``test_acc`` within 2 of the
  64 eval images (float32 convolutions associate differently in the two
  frameworks; a logit near a tie can flip an argmax), as in
  tests/test_torch_engine.py.
* Against the port's scan engine on the same draws, the twins of
  tests/test_engine.py's parity tests (both policies; cnn / mlp /
  transformer_lm under both aggregations and both wires; the five awkward
  ``(rounds, eval_every)`` pairs), with the scan engine under each of its
  solvers (``cuda`` and ``cuda_fused`` run their plain versions on CPU
  tensors): ``round`` and ``n_selected`` exact, the floats at the
  reference's rtol 5e-4 / atol 1e-5 (float32 accumulation on the device
  against the loop's float64 on the host; the participants train under
  ``vmap`` in one and one after another in the other).
* The guards: ``run_simulation`` raises ``ValueError`` for an unknown
  engine and for a loop config outside the paper's setup (another
  channel or policy, client or participant sharding, a population, a
  kept selection), as the reference's dispatcher does; the loop leaves
  the caller's parameters as they were.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like, make_lm_federated
from repro_torch.fl.engine import (SimConfig, default_draws, eval_rounds,
                                   run_simulation_scan)
from repro_torch.fl.simulation import run_simulation, run_simulation_loop
from repro_torch.models.registry import make_model

N = 40
HIST_KEYS = ("round", "comm_time", "test_acc", "avg_power", "n_selected")
SOLVERS = ("stitched", "cuda", "cuda_fused")
CNN = (("conv1", 8), ("conv2", 16), ("hidden", 32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the loop's many small ops stall when several
    test processes' thread pools share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small_setup():
    ds = make_cifar10_like(torch.Generator().manual_seed(0), n_clients=N,
                           per_client=64, n_test=400, h=16, w=16,
                           device="cpu")
    params = make_model("cnn", ds, **dict(CNN)).init_fn(
        torch.Generator().manual_seed(1))
    ch = ChannelConfig(n_clients=N)
    scfg = SchedulerConfig(n_clients=N, model_bits=32 * 50000.0, lam=10.0,
                           V=1000.0)
    return ds, params, ch, scfg


def _sim(policy="proposed", **kw):
    base = dict(rounds=13, eval_every=5, m_cap=6, batch=8, local_steps=3,
                eval_size=400, policy=policy, model_params=CNN, seed=2)
    base.update(kw)
    return SimConfig(**base)


def _sig():
    return heterogeneous_sigmas(N, device="cpu")


def assert_engines_agree(h_loop, h_scan):
    assert set(h_loop) == set(h_scan) == set(HIST_KEYS)
    for k in HIST_KEYS:
        assert h_loop[k].dtype == h_scan[k].dtype, k
    np.testing.assert_array_equal(h_loop["round"], h_scan["round"])
    np.testing.assert_array_equal(h_loop["n_selected"], h_scan["n_selected"])
    for k in ("comm_time", "test_acc", "avg_power"):
        np.testing.assert_allclose(h_loop[k], h_scan[k], rtol=5e-4,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------ against the scan engine

@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("policy,uniform_m", [("proposed", 0.0),
                                              ("uniform", 5.0)])
def test_scan_matches_loop_history(small_setup, policy, uniform_m, solver):
    """Same draws -> same trajectory from two independent engines."""
    ds, params, ch, scfg = small_setup
    sim = _sim(policy, uniform_m=uniform_m, solver=solver)
    h_loop = run_simulation_loop(None, params, ds, sim, scfg, ch, _sig())
    h_scan = run_simulation_scan(None, params, ds, sim, scfg, ch, _sig())
    assert_engines_agree(h_loop, h_scan)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("model,aggregation,wire", [
    ("cnn", "delta", "float32"),
    ("cnn", "delta", "bfloat16"),
    ("mlp", "paper", "float32"),
    ("mlp", "delta", "bfloat16"),
    ("transformer_lm", "paper", "float32"),
    ("transformer_lm", "delta", "float32"),
])
def test_scan_matches_loop_all_models_and_delta(small_setup, model,
                                                aggregation, wire, solver):
    """Every registered model, both aggregations and the delta form's
    bfloat16 wire."""
    ds_img, _, ch, scfg = small_setup
    if model == "transformer_lm":
        ds = make_lm_federated(torch.Generator().manual_seed(0),
                               n_clients=N, per_client=32, seq=12, vocab=16,
                               n_test=256, device="cpu")
    else:
        ds = ds_img
    mp = CNN if model == "cnn" else ()
    sim = _sim(rounds=6, eval_every=3, local_steps=2, model=model,
               model_params=mp, aggregation=aggregation, wire_dtype=wire,
               solver=solver)
    params = make_model(model, ds, **dict(mp)).init_fn(
        torch.Generator().manual_seed(1))
    h_loop = run_simulation_loop(None, params, ds, sim, scfg, ch, _sig())
    h_scan = run_simulation_scan(None, params, ds, sim, scfg, ch, _sig())
    assert_engines_agree(h_loop, h_scan)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("rounds,eval_every", [
    (4, 10),    # eval_every > rounds: round 0 + final round only
    (13, 5),    # eval stride does not divide rounds
    (1, 3),     # single round: the round-0 eval IS the final eval
    (7, 7),     # stride == rounds
    (10, 5),    # final round lands exactly on the stride
])
def test_eval_bookkeeping_awkward_shapes(small_setup, rounds, eval_every,
                                         solver):
    """The loop's modulo rule and the scan engine's ``eval_rounds`` record
    the same rounds, each float key one entry per eval point."""
    ds, params, ch, scfg = small_setup
    sim = _sim(rounds=rounds, eval_every=eval_every, local_steps=1, m_cap=3,
               solver=solver, seed=11)
    ev = eval_rounds(rounds, eval_every)
    h_loop = run_simulation_loop(None, params, ds, sim, scfg, ch, _sig())
    h_scan = run_simulation_scan(None, params, ds, sim, scfg, ch, _sig())
    assert h_loop["round"].tolist() == ev == h_scan["round"].tolist()
    assert_engines_agree(h_loop, h_scan)
    for k in ("comm_time", "test_acc", "avg_power"):
        assert h_loop[k].shape == (len(ev),)


def test_run_simulation_dispatches_on_engine(small_setup):
    """``engine="loop"`` runs the loop; its default draws are
    ``default_draws(sim, ds)``."""
    ds, params, ch, scfg = small_setup
    sim = _sim(rounds=4, eval_every=3, local_steps=1, engine="loop")
    h = run_simulation(None, params, ds, sim, scfg, ch, _sig())
    want = run_simulation_loop(default_draws(sim, ds), params, ds, sim,
                               scfg, ch, _sig())
    for k in HIST_KEYS:
        np.testing.assert_array_equal(h[k], want[k], err_msg=k)


# ------------------------------------------------------------- the guards

@pytest.mark.parametrize("fields,match", [
    (dict(engine="bogus"), "unknown engine 'bogus'"),
    (dict(engine="loop", channel="rician"), "paper's setup"),
    (dict(engine="loop", policy="greedy_channel", uniform_m=4.0),
     "paper's setup"),
    (dict(engine="loop", client_shards=1), "sharding needs engine='scan'"),
    (dict(engine="loop", participant_shards=1),
     "sharding needs engine='scan'"),
    (dict(engine="loop", population=()), "population"),
])
def test_loop_guards_raise_value_error(small_setup, fields, match):
    """The reference's checks and error type, before any round runs."""
    ds, params, ch, scfg = small_setup
    sim = _sim(rounds=2, **fields)
    with pytest.raises(ValueError, match=match):
        run_simulation(None, params, ds, sim, scfg, ch, _sig())


def test_loop_keeps_no_selection(small_setup):
    ds, params, ch, scfg = small_setup
    with pytest.raises(ValueError, match="keeps no selection"):
        run_simulation(None, params, ds, _sim(rounds=2, engine="loop"),
                       scfg, ch, _sig(), keep_selection=True)


def test_loop_guards_hold_on_the_direct_call(small_setup):
    """Called directly, the loop refuses what it cannot run too (the
    reference's loop would silently draw Rayleigh gains)."""
    ds, params, ch, scfg = small_setup
    with pytest.raises(ValueError, match="paper's setup"):
        run_simulation_loop(None, params, ds,
                            _sim(rounds=2, channel="lognormal"), scfg, ch,
                            _sig())


def test_loop_leaves_the_callers_params(small_setup):
    ds, params, ch, scfg = small_setup
    before = {k: v.clone() for k, v in params.items()}
    run_simulation_loop(None, params, ds, _sim(rounds=2, eval_every=1),
                        scfg, ch, _sig())
    assert all(torch.equal(params[k], before[k]) for k in before)


# ------------------------------------------------- against the reference

REF_N = 20
REF_MODEL = dict(conv1=4, conv2=8, hidden=16)
REF_SIM = dict(rounds=4, eval_every=2, m_cap=4, batch=4, local_steps=2,
               eval_size=64, model_params=tuple(REF_MODEL.items()))
BITS = 32 * 50_000.0


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from test_torch_reference import reference
    return reference()


@pytest.fixture(scope="module")
def world(ref):
    """A small federated problem on the reference side and its port."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data.synthetic import from_numpy
    jax = ref.jax
    ds = ref.synthetic.make_cifar10_like(jax.random.PRNGKey(0),
                                         n_clients=REF_N, per_client=16,
                                         n_test=64, h=8, w=8)
    params = ref.registry.make_model("cnn", ds, **REF_MODEL).init_fn(
        jax.random.PRNGKey(1))
    pds = from_numpy(ds.client_images, ds.client_labels, ds.test_images,
                     ds.test_labels, ds.n_classes, device="cpu")
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return ds, params, pds, params_from_jax(np_params, device="cpu")


@pytest.mark.parametrize("aggregation", ["paper", "delta"])
@pytest.mark.parametrize("policy", ["proposed", "uniform"])
def test_loop_matches_reference_loop(ref, world, policy, aggregation):
    """The port's loop on the reference's draws against the reference's
    loop on its key: n_selected and round exact, comm_time and avg_power
    at rtol 1e-5, test accuracy within 2 of the 64 eval images."""
    from test_torch_reference import ReplayDraws, record_draws
    ds, params, pds, pparams = world
    jax = ref.jax
    extra = {"uniform_m": 5.5} if policy == "uniform" else {}
    key = jax.random.PRNGKey(2)
    sim = ref.simulation.SimConfig(policy=policy, aggregation=aggregation,
                                   engine="loop", **REF_SIM, **extra)
    want = ref.simulation.run_simulation_loop(
        key, params, ds, sim, ref.scheduler.SchedulerConfig(
            n_clients=REF_N, model_bits=BITS),
        ref.channel.ChannelConfig(n_clients=REF_N),
        ref.channel.heterogeneous_sigmas(REF_N))
    draws = ReplayDraws(record_draws(ref, key, REF_SIM["rounds"], REF_N,
                                     (REF_SIM["m_cap"],
                                      REF_SIM["local_steps"],
                                      REF_SIM["batch"]), 16))
    psim = SimConfig(policy=policy, aggregation=aggregation, engine="loop",
                     **REF_SIM, **extra)
    got = run_simulation(draws, pparams, pds, psim,
                         SchedulerConfig(n_clients=REF_N, model_bits=BITS),
                         ChannelConfig(n_clients=REF_N),
                         heterogeneous_sigmas(REF_N, device="cpu"))
    assert set(got) == set(want)
    for k in HIST_KEYS:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    np.testing.assert_array_equal(got["round"], want["round"])
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    np.testing.assert_allclose(got["comm_time"], want["comm_time"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["avg_power"], want["avg_power"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=2 / 64)


def test_guards_match_the_reference(ref, world):
    """Each guard raises ``ValueError`` on both sides, with the
    reference's message."""
    ds, params, pds, pparams = world
    jax = ref.jax
    cases = [dict(engine="bogus"), dict(engine="loop", channel="rician"),
             dict(engine="loop", policy="greedy_channel", uniform_m=4.0),
             dict(engine="loop", client_shards=1),
             dict(engine="loop", participant_shards=1),
             dict(engine="loop", population=())]
    rcfg = ref.scheduler.SchedulerConfig(n_clients=REF_N, model_bits=BITS)
    rch = ref.channel.ChannelConfig(n_clients=REF_N)
    for fields in cases:
        rsim = dataclasses.replace(ref.simulation.SimConfig(**REF_SIM),
                                   **fields)
        with pytest.raises(ValueError) as want:
            ref.simulation.run_simulation(
                jax.random.PRNGKey(0), params, ds, rsim, rcfg, rch,
                ref.channel.heterogeneous_sigmas(REF_N))
        psim = dataclasses.replace(SimConfig(**REF_SIM), **fields)
        with pytest.raises(ValueError) as got:
            run_simulation(None, pparams, pds, psim,
                           SchedulerConfig(n_clients=REF_N, model_bits=BITS),
                           ChannelConfig(n_clients=REF_N),
                           heterogeneous_sigmas(REF_N, device="cpu"))
        assert str(got.value) == str(want.value), fields
