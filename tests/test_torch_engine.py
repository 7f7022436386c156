"""What federates, and the whole slice, against the reference.

* the CNN: the reference's parameters carried across by
  ``params_from_jax`` give the reference's logits (this pins the flatten
  order before ``f1w``), local SGD and both aggregate forms agree;
* the whole main path: ``run_simulation`` of the port on the reference's
  own draws against ``repro.fl.simulation.run_simulation``, for each
  solver pair (stitched/jnp, cuda/pallas, cuda_fused/pallas_fused) and
  both policies. The scheduling trajectory does not depend on the model,
  so it is held tightly: n_selected exact, comm_time and avg_power at
  rtol 1e-5. Model outputs are held loosely (stated per test): float32
  convolutions associate differently in the two frameworks.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import (ReplayDraws, record_draws,  # noqa: E402
                                  reference)

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      heterogeneous_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.synthetic import from_numpy  # noqa: E402
from repro_torch.fl import round as prd  # noqa: E402
from repro_torch.fl.engine import (SimConfig, init_policy_state,  # noqa: E402
                                   make_sim_round)
from repro_torch.fl.simulation import run_simulation  # noqa: E402
from repro_torch.models.cnn import CNN  # noqa: E402
from repro_torch.models.registry import make_model  # noqa: E402

N = 20
MODEL = dict(conv1=4, conv2=8, hidden=16)
SIM = dict(rounds=4, eval_every=2, m_cap=4, batch=4, local_steps=2,
           eval_size=64, model_params=tuple(MODEL.items()))
BITS = 32 * 50_000.0


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def world(ref):
    """A small federated problem on the reference side and its port."""
    jax = ref.jax
    ds = ref.synthetic.make_cifar10_like(jax.random.PRNGKey(0), n_clients=N,
                                         per_client=16, n_test=64, h=8, w=8)
    params = ref.registry.make_model("cnn", ds, **MODEL).init_fn(
        jax.random.PRNGKey(1))
    pds = from_numpy(ds.client_images, ds.client_labels, ds.test_images,
                     ds.test_labels, ds.n_classes, device="cpu")
    np_params = {k: np.asarray(v) for k, v in params.items()}
    return ds, params, pds, params_from_jax(np_params, device="cpu")


def test_cnn_forward_matches_apply_cnn(ref, world):
    """Logits at rtol 1e-5 / atol 1e-5: conv sums associate differently.
    A (c, h, w) flatten before f1w would be off by O(1)."""
    ds, params, pds, pparams = world
    want = np.asarray(ref.cnn.apply_cnn(params, ds.test_images))
    got = CNN(pparams)(pds.test_images).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    spec = make_model("cnn", pds, **MODEL)
    acc = spec.eval_fn(pparams, pds.test_images, pds.test_labels)
    want_acc = ref.registry.make_model("cnn", ds, **MODEL).eval_fn(
        params, ds.test_images, ds.test_labels)
    assert float(acc) == pytest.approx(float(want_acc), abs=1.5 / 64)


def test_local_sgd_matches(ref, world):
    """Two SGD steps from the same weights on the same minibatches:
    rtol 1e-4 / atol 1e-5 (gradients of float32 convs)."""
    ds, params, pds, pparams = world
    steps, b = 2, 8
    x = np.asarray(ds.client_images[0, : steps * b]).reshape(
        steps, b, *ds.client_images.shape[2:])
    y = np.asarray(ds.client_labels[0, : steps * b]).reshape(steps, b)
    want = ref.round.local_sgd(ref.cnn.cnn_loss, params, (x, y), 0.05, steps)
    spec = make_model("cnn", pds, **MODEL)
    got = prd.local_sgd(spec.loss_fn, pparams,
                        (torch.from_numpy(x), torch.from_numpy(y).long()),
                        0.05, steps)
    want = params_from_jax({k: np.asarray(v) for k, v in want.items()},
                           device="cpu")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("agg,wire,atol", [("paper", "float32", 1e-6),
                                           ("delta", "float32", 1e-6),
                                           ("delta", "bfloat16", 2e-3)])
def test_masked_aggregate_matches(ref, agg, wire, atol):
    """Algorithm 1 line 7 over 5 materialized participants (2 invalid):
    float32 forms at rtol 1e-6 / atol 1e-6; the bf16 wire at atol 2e-3,
    about one bf16 ulp of the largest weighted delta (the two frameworks
    may round the bf16 partial sums at different places)."""
    rng = np.random.default_rng(0)
    x = {"a": rng.standard_normal((6, 3)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    y = {k: (v[None] + 0.1 * rng.standard_normal((5,) + v.shape))
         .astype(np.float32) for k, v in x.items()}
    valid = np.array([True, True, True, False, False])
    q = np.array([0.3, 0.9, 0.05, 1.0, 0.2], np.float32)
    jw = {"float32": ref.jnp.float32, "bfloat16": ref.jnp.bfloat16}[wire]
    want = ref.round.masked_aggregate(x, y, valid, q, 20, agg, jw)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ty = {k: torch.from_numpy(v) for k, v in y.items()}
    got = prd.masked_aggregate(t, ty, torch.from_numpy(valid),
                               torch.from_numpy(q), 20, agg,
                               prd.resolve_wire_dtype(wire))
    for k in x:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=atol)


@pytest.mark.parametrize("n,m_cap,k", [(20, 4, 0), (20, 4, 3), (20, 4, 9),
                                       (3, 6, 2)])
def test_pack_participants(ref, n, m_cap, k):
    """Packed indices and validity exact, also with more selected clients
    than m_cap and with m_cap > N."""
    sel = np.zeros(n, bool)
    sel[np.random.default_rng(k).choice(n, k, replace=False)] = True
    want = ref.round.pack_participants(ref.jnp.asarray(sel), m_cap)
    got = prd.pack_participants(torch.from_numpy(sel), m_cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SOLVER_PAIRS = [("stitched", "jnp"), ("cuda", "pallas"),
                ("cuda_fused", "pallas_fused")]


@pytest.mark.parametrize("policy", ["proposed", "uniform"])
@pytest.mark.parametrize("solver,ref_solver", SOLVER_PAIRS)
def test_whole_slice_matches_reference(ref, world, solver, ref_solver,
                                       policy):
    """The port's run_simulation on the reference's draws: n_selected
    exact, comm_time and avg_power at rtol 1e-5; test accuracy within 2 of
    the 64 eval images (a logit near a tie can flip an argmax)."""
    ds, params, pds, pparams = world
    jax = ref.jax
    extra = {"uniform_m": 5.5} if policy == "uniform" else {}
    key = jax.random.PRNGKey(2)
    sim = ref.simulation.SimConfig(policy=policy, solver=ref_solver,
                                   **SIM, **extra)
    cfg = ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=N)
    want = ref.simulation.run_simulation(
        key, params, ds, sim, cfg, ch, ref.channel.heterogeneous_sigmas(N))
    draws = ReplayDraws(record_draws(ref, key, SIM["rounds"], N,
                                     (SIM["m_cap"], SIM["local_steps"],
                                      SIM["batch"]), 16))
    got = run_simulation(draws, pparams, pds,
                         SimConfig(policy=policy, solver=solver, **SIM,
                                   **extra),
                         SchedulerConfig(n_clients=N, model_bits=BITS),
                         ChannelConfig(n_clients=N),
                         heterogeneous_sigmas(N, device="cpu"))
    np.testing.assert_array_equal(got["round"], want["round"])
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    np.testing.assert_allclose(got["comm_time"], want["comm_time"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["avg_power"], want["avg_power"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=2 / 64)


def test_final_params_match_reference(ref, world):
    """Three full rounds (proposed, fused decision): the final global
    model at rtol 1e-3 / atol 1e-4 — float32 SGD in two frameworks."""
    ds, params, pds, pparams = world
    jax = ref.jax
    rounds = 3
    sim = ref.simulation.SimConfig(solver="pallas_fused", **SIM)
    cfg = ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=N)
    sig = ref.channel.heterogeneous_sigmas(N)
    key = jax.random.PRNGKey(3)
    draws = ReplayDraws(record_draws(ref, key, rounds, N,
                                     (SIM["m_cap"], SIM["local_steps"],
                                      SIM["batch"]), 16))
    run_chunk = ref.engine.make_chunk_runner(ds, sim, cfg, ch, sig)
    carry, _, _ = run_chunk(  # donates the carry, key included
        ref.engine.init_carry(key, params, cfg, sim, sig, ch), rounds)
    want = params_from_jax({k: np.asarray(v) for k, v in carry[0].items()},
                           device="cpu")
    pcfg = SchedulerConfig(n_clients=N, model_bits=BITS)
    sim_round = make_sim_round(pds, SimConfig(solver="cuda_fused", **SIM),
                               pcfg, ChannelConfig(n_clients=N),
                               heterogeneous_sigmas(N, device="cpu"))
    got, st, ch_state = pparams, init_policy_state("proposed", N, "cpu"), None
    for r in range(rounds):
        got, st, ch_state, *_ = sim_round(got, st, ch_state, draws, r)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(st.z, torch.as_tensor(np.array(carry[1].z)),
                               rtol=1e-5, atol=1e-3)
