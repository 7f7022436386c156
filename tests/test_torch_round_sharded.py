"""The participant-sharded round over gloo ranks (the twin of
tests/test_round_sharded.py).

``SimConfig(participant_shards=Dp)`` splits the <= m_cap packed
participants' local SGD over Dp ranks, the Algorithm-1 aggregate an
all-reduce (``fl/round.py::make_sharded_round_update``):

* world 1 — bit for bit the sequential engine (an all-reduce of one rank
  is the identity), for every registry model in the cases, both
  aggregations and the bfloat16 wire;
* worlds 2 and 4 — the accounting is upstream of training, so comm_time,
  avg_power and n_selected equal the sequential run's exactly; test_acc
  within atol 2e-2 (the participant sum re-associates per shard);
  m_cap = 5 and 3 do not divide by 2 or 4, so zero-weight pad rows train
  (at m_cap = 3 on 4 ranks one rank holds only pad rows);
* against the reference — every run against the reference's
  ``run_simulation_scan`` on its recorded draws (n_selected exact,
  comm_time and avg_power at rtol 1e-5), and the update itself at world 1
  against the reference's ``make_sharded_round_update`` on its one CPU
  device;
* the update against the masked aggregate computed by hand on every world
  (rtol 1e-6, atol 1e-7), and the guards.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_ranks import numpy_images, reference_dataset, start
from test_torch_reference import ReplayDraws, record_draws, reference

from repro_torch.convert import params_from_jax
from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import from_numpy
from repro_torch.fl.engine import SimConfig, run_simulation_scan
from repro_torch.fl.round import (make_sharded_round_update,
                                  train_participants)
from repro_torch.models.registry import make_model

N = 24
PER_CLIENT = 32
BITS = 32 * 50_000.0
SIM = dict(rounds=4, eval_every=2, m_cap=5, batch=4, local_steps=2,
           eval_size=128)
HIST_KEYS = ("round", "comm_time", "test_acc", "avg_power", "n_selected")
ACCOUNT_KEYS = ("round", "comm_time", "avg_power", "n_selected")
CNN = (("conv1", 4), ("conv2", 8), ("hidden", 16))
WORLDS = (1, 2, 4)
LEGS = {
    "cnn_paper": dict(model="cnn", model_params=CNN),
    "cnn_delta_bf16": dict(model="cnn", model_params=CNN,
                           aggregation="delta", wire_dtype="bfloat16"),
    "mlp_delta": dict(model="mlp", aggregation="delta"),
    "mlp_uneven": dict(model="mlp", m_cap=3),
}
# the direct update: (m_cap, steps, batch) rows of the MLP
DIRECT = (4, 2, 4)
DIRECT_VALID = np.array([True, True, True, False])
DIRECT_Q = np.array([0.5, 0.9, 0.2, 1.0], np.float32)


def _configs():
    return (SchedulerConfig(n_clients=N, model_bits=BITS),
            ChannelConfig(n_clients=N), heterogeneous_sigmas(N, device="cpu"))


def round_ranks(payload):
    """Rank body: every leg at ``participant_shards`` = the world size (and
    sequentially at world 1), the direct update, the guards."""
    world = dist.get_world_size()
    pds = from_numpy(*payload["ds"], device="cpu")
    draws = {m: ReplayDraws(d) for m, d in payload["draws"].items()}
    out = {}
    for name, fields in LEGS.items():
        sim = SimConfig(**dict(SIM, **fields))
        leg_draws = draws[sim.m_cap]
        params = params_from_jax(payload["params"][fields["model"]], "cpu")
        runs = {"sharded": dataclasses.replace(sim,
                                               participant_shards=world)}
        if world == 1:
            runs["sequential"] = sim
        out[name] = {k: run_simulation_scan(leg_draws, params, pds, s,
                                            *_configs())
                     for k, s in runs.items()}
    spec = make_model("mlp", pds)
    params = params_from_jax(payload["params"]["mlp"], "cpu")
    inputs, labels = (torch.from_numpy(x) for x in payload["direct"])
    labels = labels.long()
    valid, q = torch.from_numpy(DIRECT_VALID), torch.from_numpy(DIRECT_Q)
    got = make_sharded_round_update(spec.loss_fn, 0.01, DIRECT[1], N, world)(
        params, inputs, labels, valid, q)
    y = train_participants(spec.loss_fn, params, inputs, labels, 0.01,
                           DIRECT[1])
    w = valid.to(torch.float32) / q / N
    want = {k: (leaf * w.reshape((-1,) + (1,) * (leaf.ndim - 1))).sum(0)
            for k, leaf in y.items()}
    out["direct"] = ({k: v.numpy() for k, v in got.items()},
                     {k: v.numpy() for k, v in want.items()})
    errors = {}
    for label, call in (
            ("n_shards", lambda: make_sharded_round_update(
                spec.loss_fn, 0.01, 1, N, world + 1)),
            ("wire", lambda: run_simulation_scan(
                None, params, pds, SimConfig(**SIM, model="mlp",
                                              participant_shards=world,
                                              wire_dtype="float8"),
                *_configs()))):
        try:
            call()
        except ValueError as e:
            errors[label] = str(e)
    out["guards"] = errors
    return out


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """The ranks at worlds 1, 2 and 4, started first; meanwhile the
    reference on the same draws."""
    jax = ref.jax
    arrays = numpy_images(N, seed=5, per_client=PER_CLIENT)
    ds = reference_dataset(ref, arrays)
    models = {m: ref.registry.make_model(m, ds, **dict(mp)).init_fn(
        jax.random.PRNGKey(1)) for m, mp in (("cnn", CNN), ("mlp", ()))}
    key = jax.random.PRNGKey(2)
    recorded = {m: record_draws(ref, key, SIM["rounds"], N,
                                (m, SIM["local_steps"], SIM["batch"]),
                                PER_CLIENT)
                for m in {f.get("m_cap", SIM["m_cap"]) for f in LEGS.values()}}
    rng = np.random.default_rng(4)
    idx = rng.integers(0, PER_CLIENT, DIRECT)
    rows = np.arange(DIRECT[0])[:, None, None]
    direct = (arrays[0][rows, idx], arrays[1][rows, idx])
    payload = dict(ds=arrays, draws=recorded, direct=direct, params={
        m: {k: np.asarray(v) for k, v in p.items()}
        for m, p in models.items()})
    tmp = tmp_path_factory.mktemp("round_sharded")
    started = {w: start(tmp, w, __name__, "round_ranks", payload)
               for w in WORLDS}
    want = {}
    for name, fields in LEGS.items():
        sim = ref.engine.SimConfig(**dict(SIM, **fields))
        want[name] = ref.engine.run_simulation_scan(
            key, models[fields["model"]], ds, sim,
            ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS),
            ref.channel.ChannelConfig(n_clients=N),
            ref.channel.heterogeneous_sigmas(N))
    spec = ref.registry.make_model("mlp", ds)
    want["direct"] = {k: np.asarray(v) for k, v in
                      ref.round.make_sharded_round_update(
                          spec.loss_fn, 0.01, DIRECT[1], N, 1,
                          devices=jax.devices()[:1])(
                          models["mlp"], *direct, DIRECT_VALID,
                          DIRECT_Q).items()}
    return {w: r.results() for w, r in started.items()}, want


@pytest.mark.parametrize("leg", list(LEGS))
def test_world1_bitwise(runs, leg):
    out = runs[0][1][0][leg]
    for k in HIST_KEYS:
        np.testing.assert_array_equal(out["sequential"][k],
                                      out["sharded"][k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("leg", list(LEGS))
def test_worldN_accounting_exact(runs, leg, world):
    seq = runs[0][1][0][leg]["sequential"]
    for rank, out in enumerate(runs[0][world]):
        got = out[leg]["sharded"]
        for k in ACCOUNT_KEYS:
            np.testing.assert_array_equal(seq[k], got[k],
                                          err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["test_acc"], seq["test_acc"],
                                   atol=2e-2)
        np.testing.assert_array_equal(
            got["test_acc"], runs[0][world][0][leg]["sharded"]["test_acc"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("leg", list(LEGS))
def test_sharded_matches_reference(runs, leg, world):
    out, want = runs
    got = out[world][0][leg]["sharded"]
    np.testing.assert_array_equal(got["round"], want[leg]["round"])
    np.testing.assert_array_equal(got["n_selected"], want[leg]["n_selected"])
    for k in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[k], want[leg][k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_direct_update_matches_masked_aggregate(runs, world):
    for rank, out in enumerate(runs[0][world]):
        got, want = out["direct"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{rank} {k}")


def test_world1_update_matches_reference(runs):
    """The update at one rank against the reference's on its one CPU
    device: float32 SGD in two frameworks (test_torch_engine.py's local
    SGD tolerance)."""
    out, want = runs
    got, _ = out[1][0]["direct"]
    ref_params = params_from_jax(want["direct"], "cpu")
    for k, v in ref_params.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_guards(runs, world):
    errors = runs[0][world][0]["guards"]
    assert f"n_shards={world + 1} needs a process group of {world + 1}" in (
        errors["n_shards"])
    assert "unknown wire_dtype 'float8'" in errors["wire"]


def test_guards_without_a_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError,
                       match="repro_torch.launch.distributed.initialize"):
        make_sharded_round_update(lambda p, b: 0.0, 0.01, 1, N, 1)
