"""The paper's FEMNIST experiment (section VI-B) and the FL round's
unmasked entry points, against the reference.

* the configuration, ``make_femnist_like``'s statistics and
  ``gather_batches``;
* the models: ``cnn_accuracy`` and ``param_count``, the MLP
  (``apply_mlp``, ``mlp_loss``, the registry's ``mlp`` entry);
* Algorithm 1 over an explicit client axis: ``weighted_aggregate``,
  ``delta_aggregate``, ``fl_round`` and the train steps;
* the whole slice at a FEMNIST shape (N = 48 writers, 28x28x1, 62
  classes, CNN 8/16/32, 3 rounds) on the reference's own data and draws,
  per solver pair and for the MLP: n_selected exact, comm_time and
  avg_power at rtol 1e-5, accuracy within 2 of the 64 eval images;
* ``time_to_accuracy``'s edge cases.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import (ReplayDraws, record_draws,  # noqa: E402
                                  reference)

from repro_torch.configs import femnist_cnn  # noqa: E402
from repro_torch.convert import (mlp_params_from_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      resolve_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.synthetic import (from_numpy,  # noqa: E402
                                        gather_batches, make_femnist_like)
from repro_torch.fl import round as prd  # noqa: E402
from repro_torch.fl.simulation import (SimConfig,  # noqa: E402
                                       run_simulation, time_to_accuracy)
from repro_torch.models import cnn as pcnn  # noqa: E402
from repro_torch.models import mlp as pmlp  # noqa: E402
from repro_torch.models.registry import make_model  # noqa: E402

N, PER_CLIENT, N_TEST = 48, 16, 64
CNN = dict(conv1=8, conv2=16, hidden=32)
SIM = dict(rounds=3, eval_every=2, m_cap=4, batch=4, local_steps=2,
           eval_size=N_TEST)
BITS = 32.0 * femnist_cnn.CONFIG.d_paper


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def world(ref):
    """The reference's FEMNIST-shaped data and its port, and sigmas in the
    paper's three levels."""
    ds = ref.synthetic.make_femnist_like(ref.jax.random.PRNGKey(0),
                                         n_clients=N, per_client=PER_CLIENT,
                                         n_test=N_TEST)
    pds = from_numpy(ds.client_images, ds.client_labels, ds.test_images,
                     ds.test_labels, ds.n_classes, device="cpu")
    sig = np.repeat(np.float32([0.2, 0.75, 1.2]), [8, 16, 24])
    return ds, pds, sig


def test_config_matches_reference(ref):
    """CONFIG and scaled() field for field; the derived channel and
    scheduler configs; the paper's 500/1,500/1,597 sigma split."""
    assert (dataclasses.asdict(femnist_cnn.CONFIG)
            == dataclasses.asdict(ref.femnist.CONFIG))
    for frac in (0.001, 0.1, 1.0):
        assert (dataclasses.asdict(femnist_cnn.scaled(frac))
                == dataclasses.asdict(ref.femnist.scaled(frac)))
    for lam in (10.0, 100.0):
        assert (dataclasses.asdict(femnist_cnn.CONFIG.scheduler(lam))
                == dataclasses.asdict(ref.femnist.CONFIG.scheduler(lam)))
    assert (dataclasses.asdict(femnist_cnn.CONFIG.channel())
            == dataclasses.asdict(ref.femnist.CONFIG.channel()))
    sig = resolve_sigmas(femnist_cnn.paper_sigmas(), 3597, device="cpu")
    assert [int((sig == np.float32(s)).sum()) for s in (0.2, 0.75, 1.2)] == [
        500, 1500, 1597]


def test_make_femnist_like_statistics():
    """Shapes, label range, and strongly non-i.i.d. writers: the mean top
    class share of a client above 0.12 (Dirichlet 0.3 over 62 classes
    gives ~0.2; uniform labels ~1/62), as the reference's test holds its
    maker (tests/test_fl_simulation.py)."""
    gen = torch.Generator().manual_seed(0)
    ds = make_femnist_like(gen, n_clients=30, per_client=16, n_test=100,
                           device="cpu")
    assert ds.client_images.shape == (30, 16, 28, 28, 1)
    assert ds.client_labels.shape == (30, 16)
    assert ds.test_images.shape == (100, 28, 28, 1)
    assert ds.n_classes == 62
    assert int(ds.client_labels.min()) >= 0
    assert int(ds.client_labels.max()) < 62
    assert torch.isfinite(ds.client_images).all()
    counts = torch.nn.functional.one_hot(ds.client_labels, 62).sum(1)
    assert float((counts.max(1).values / 16.0).mean()) > 0.12


def test_gamma_draws_match_the_law():
    """Gamma(0.3) from the generator's normals and uniforms: mean and
    variance 0.3, within 3% at 400,000 draws (sd of the mean ~0.1%)."""
    from repro_torch.data.synthetic import _gamma

    x = _gamma(torch.Generator().manual_seed(1), 0.3, (400_000,),
               "cpu").exp().double()
    assert abs(float(x.mean()) - 0.3) < 0.3 * 0.03
    assert abs(float(x.var()) - 0.3) < 0.3 * 0.03


def test_gather_batches():
    """gather_batches: (N, steps, batch, H, W, C) images of each client's
    own examples, at the indices the generator draws."""
    gen = torch.Generator().manual_seed(2)
    ds = make_femnist_like(gen, n_clients=6, per_client=10, n_test=8,
                           device="cpu")
    twin = torch.Generator().set_state(gen.get_state())
    imgs, labs = gather_batches(ds, gen, 3, 4)
    idx = torch.randint(0, 10, (6, 3, 4), generator=twin)
    assert imgs.shape == (6, 3, 4, 28, 28, 1) and labs.shape == (6, 3, 4)
    for n in range(6):
        assert torch.equal(imgs[n], ds.client_images[n][idx[n]])
        assert torch.equal(labs[n], ds.client_labels[n][idx[n]])


def test_cnn_accuracy_and_param_count(ref, world):
    """cnn_accuracy in slices of 1,024 and of 10 equals the reference's
    within 2 of 64 images (a logit near a tie); the full-width FEMNIST CNN
    counts the reference's parameters exactly."""
    ds, pds, _ = world
    cfg = ref.cnn.CNNConfig(28, 28, 1, 62, **CNN)
    params = ref.cnn.init_cnn(ref.jax.random.PRNGKey(3), cfg)
    pparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    want = float(ref.cnn.cnn_accuracy(params, ds.test_images,
                                      ds.test_labels))
    for batch in (1024, 10):
        got = float(pcnn.cnn_accuracy(pparams, pds.test_images,
                                      pds.test_labels, batch=batch))
        assert got == pytest.approx(want, abs=2 / N_TEST)
    full = ref.cnn.init_cnn(ref.jax.random.PRNGKey(0),
                            ref.femnist.CONFIG.cnn)
    port_full = pcnn.init_cnn(torch.Generator().manual_seed(0),
                              femnist_cnn.CONFIG.cnn, device="cpu")
    assert pcnn.param_count(port_full) == ref.cnn.param_count(full)
    assert pcnn.param_count(pparams) == ref.cnn.param_count(params)


def test_mlp_matches_reference(ref, world):
    """The MLP's logits at rtol 1e-5 / atol 1e-5 and its loss and gradient
    at rtol 1e-5 / atol 1e-6 on the reference's parameters; the registry's
    entry builds it, and its init draws the reference's law (zero biases,
    |w| <= 2 sqrt(2 / fan_in))."""
    ds, pds, _ = world
    cfg = ref.mlp.MLPConfig(28, 28, 1, 62, hidden=16)
    params = ref.mlp.init_mlp(ref.jax.random.PRNGKey(4), cfg)
    pparams = mlp_params_from_jax(params, device="cpu")
    x, y = ds.client_images[0], ds.client_labels[0]
    tx, ty = pds.client_images[0], pds.client_labels[0]
    np.testing.assert_allclose(pmlp.apply_mlp(pparams, tx).detach().numpy(),
                               np.asarray(ref.mlp.apply_mlp(params, x)),
                               rtol=1e-5, atol=1e-5)
    want = float(ref.mlp.mlp_loss(params, (x, y)))
    assert float(pmlp.mlp_loss(pparams, (tx, ty))) == pytest.approx(
        want, rel=1e-5)
    want_g = ref.jax.grad(ref.mlp.mlp_loss)(params, (x, y))
    got_g = torch.func.grad(pmlp.mlp_loss)(pparams, (tx, ty))
    for k in pparams:
        np.testing.assert_allclose(got_g[k].numpy(), np.asarray(want_g[k]),
                                   rtol=1e-5, atol=1e-6)
    spec = make_model("mlp", pds, hidden=16)
    init = spec.init_fn(torch.Generator().manual_seed(4))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert not init["b1"].any() and not init["b2"].any()
    assert float(init["w1"].abs().max()) <= 2 * (2 / 784) ** 0.5 + 1e-6
    acc = spec.eval_fn(pparams, pds.test_images, pds.test_labels)
    want_acc = ref.registry.make_model("mlp", ds, hidden=16).eval_fn(
        params, ds.test_images, ds.test_labels)
    assert float(acc) == pytest.approx(float(want_acc), abs=2 / N_TEST)


# A small non-convex problem in both frameworks (the reference's
# tests/test_convergence.py): a tanh layer's regression, per-client data.
CLIENTS, DIM, HID = 8, 6, 8


def problem(seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((CLIENTS, 2, 16, DIM)).astype(np.float32)
    ys = (np.tanh(xs @ rng.standard_normal((DIM, 1)))
          + 0.5 * rng.standard_normal((CLIENTS, 1, 1, 1))).astype(np.float32)
    params = {"w1": (rng.standard_normal((DIM, HID)) * 0.4).astype(
        np.float32), "w2": rng.standard_normal((HID, 1)).astype(np.float32)}
    return params, xs, ys


def loss_jax(jnp):
    def loss(p, batch):
        x, y = batch
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)
    return loss


def loss_torch(p, batch):
    x, y = batch
    return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()


def tensors(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("form", ["weighted", "delta_f32", "delta_bf16"])
def test_unmasked_aggregates(ref, form):
    """Algorithm 1 line 7 over an explicit 8-client axis, half selected:
    float32 forms at rtol 1e-6 / atol 1e-6; the bf16 wire at atol 2e-3
    (about a bf16 ulp of the largest weighted delta)."""
    rng = np.random.default_rng(12)
    x = {"a": rng.standard_normal((6, 3)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    y = {k: (v[None] + 0.1 * rng.standard_normal((CLIENTS,) + v.shape))
         .astype(np.float32) for k, v in x.items()}
    sel = np.arange(CLIENTS) % 2 == 0
    q = rng.uniform(0.1, 1.0, CLIENTS).astype(np.float32)
    args = (tensors(x), tensors(y), torch.from_numpy(sel),
            torch.from_numpy(q))
    if form == "weighted":
        want = ref.round.weighted_aggregate(x, y, sel, q)
        got, atol = prd.weighted_aggregate(*args), 1e-6
    else:
        wire = "float32" if form == "delta_f32" else "bfloat16"
        want = ref.round.delta_aggregate(x, y, sel, q,
                                         getattr(ref.jnp, wire))
        got = prd.delta_aggregate(*args, prd.resolve_wire_dtype(wire))
        atol = 1e-6 if wire == "float32" else 2e-3
    for k in x:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=atol)


def test_fl_round_and_train_steps(ref):
    """fl_round (every client's local SGD, then the weighted aggregate),
    make_fl_train_step and make_train_step on the same problem: rtol 1e-5
    / atol 1e-6 (float32 gradients in two frameworks)."""
    params, xs, ys = problem(13)
    sel = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)
    q = np.linspace(0.2, 0.9, CLIENTS).astype(np.float32)
    lj = loss_jax(ref.jnp)
    want = ref.round.fl_round(lj, params, (xs, ys), sel, q, 0.05, 2)
    got = prd.fl_round(loss_torch, tensors(params),
                       (torch.from_numpy(xs), torch.from_numpy(ys)),
                       torch.from_numpy(sel), torch.from_numpy(q), 0.05, 2)
    step = prd.make_fl_train_step(loss_torch, 0.05, 2, CLIENTS)
    again = step(tensors(params), (torch.from_numpy(xs),
                                   torch.from_numpy(ys)),
                 torch.from_numpy(sel), torch.from_numpy(q))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        assert torch.equal(again[k], got[k])
    batch = (xs[0, 0], ys[0, 0])
    want_p, want_loss = ref.round.make_train_step(lj, 0.1)(params, batch)
    got_p, got_loss = prd.make_train_step(loss_torch, 0.1)(
        tensors(params), tuple(torch.from_numpy(b) for b in batch))
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    for k in params:
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=1e-5, atol=1e-6)


def test_q1_round_is_fedavg():
    """q = 1 for every client reproduces full-participation FedAvg
    (atol 1e-6), the reference's tests/test_convergence.py check."""
    params, xs, ys = problem(14)
    tp = tensors(params)
    ones = torch.ones(CLIENTS)
    out = prd.fl_round(loss_torch, tp, (torch.from_numpy(xs),
                                        torch.from_numpy(ys)), ones, ones,
                       0.1, 2)
    local = [prd.local_sgd(loss_torch, tp, (torch.from_numpy(xs[i]),
                                            torch.from_numpy(ys[i])), 0.1, 2)
             for i in range(CLIENTS)]
    for k in tp:
        manual = torch.stack([p[k] for p in local]).mean(0)
        torch.testing.assert_close(out[k], manual, rtol=0, atol=1e-6)


SOLVER_PAIRS = [("stitched", "jnp", "cnn"), ("cuda", "pallas", "cnn"),
                ("cuda_fused", "pallas_fused", "cnn"),
                ("cuda_fused", "pallas_fused", "mlp")]


@pytest.mark.parametrize("solver,ref_solver,model", SOLVER_PAIRS)
def test_femnist_slice_matches_reference(ref, world, solver, ref_solver,
                                         model):
    """The port's run_simulation on the reference's FEMNIST-shaped data
    and draws: n_selected exact, comm_time and avg_power at rtol 1e-5,
    test accuracy within 2 of the 64 eval images."""
    ds, pds, sig = world
    jax = ref.jax
    model_params = CNN if model == "cnn" else {"hidden": 16}
    spec = ref.registry.make_model(model, ds, **model_params)
    params = spec.init_fn(jax.random.PRNGKey(5))
    np_params = {k: np.asarray(v) for k, v in params.items()}
    pparams = (params_from_jax(np_params, device="cpu") if model == "cnn"
               else mlp_params_from_jax(np_params, device="cpu"))
    key = jax.random.PRNGKey(6)
    sim = dict(SIM, model=model, model_params=tuple(model_params.items()))
    want = ref.simulation.run_simulation(
        key, params, ds, ref.simulation.SimConfig(solver=ref_solver, **sim),
        ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS),
        ref.channel.ChannelConfig(n_clients=N),
        ref.channel.resolve_sigmas(sig, N))
    draws = ReplayDraws(record_draws(ref, key, SIM["rounds"], N,
                                     (SIM["m_cap"], SIM["local_steps"],
                                      SIM["batch"]), PER_CLIENT))
    got = run_simulation(draws, pparams, pds,
                         SimConfig(solver=solver, **sim),
                         SchedulerConfig(n_clients=N, model_bits=BITS),
                         ChannelConfig(n_clients=N),
                         resolve_sigmas(sig, N, device="cpu"))
    np.testing.assert_array_equal(got["round"], want["round"])
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    np.testing.assert_allclose(got["comm_time"], want["comm_time"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["avg_power"], want["avg_power"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=2 / N_TEST)


def test_time_to_accuracy_edge_cases(ref):
    """Empty histories and never-reached targets give None; the first
    crossing, inclusive; plain lists work like arrays; each as the
    reference's (tests/test_fl_simulation.py)."""
    hist = {"test_acc": [0.1, 0.4, 0.6], "comm_time": [1.0, 2.0, 3.0]}
    cases = [({"test_acc": [], "comm_time": []}, 0.5),
             ({"test_acc": np.asarray([]), "comm_time": np.asarray([])}, 0.5),
             (hist, 0.9), (hist, 0.5), (hist, 0.4),
             ({k: np.asarray(v) for k, v in hist.items()}, 0.5)]
    for h, target in cases:
        assert (time_to_accuracy(h, target)
                == ref.simulation.time_to_accuracy(h, target))
    assert time_to_accuracy(hist, 0.5) == 3.0
    assert time_to_accuracy(hist, 0.4) == 2.0
    assert time_to_accuracy(hist, 0.9) is None
