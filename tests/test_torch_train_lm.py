"""The registry's ``transformer_lm`` and LM training on the CPU, against
the reference:

* ``models/transformer_lm.py``: the reference's ``init_lm`` tree carried
  across (``convert.transformer_lm_params_from_jax``) gives its logits,
  loss, accuracy and gradients (``torch.func.grad`` against
  ``jax.grad``) on seeded numpy tokens; ``init_lm``'s layout;
* the registry: ``make_model("transformer_lm", ...)`` on token data, and
  the reference's errors for image data and float tokens, both ways;
* data: the reference's ``make_lm_federated`` arrays through
  ``from_numpy`` stay int64; the port's own ``make_lm_federated`` shapes
  and roll convention;
* the FL engine: ``run_simulation`` with ``model="transformer_lm"`` on
  the reference's replayed draws against the reference's (the fused
  decision), and three rounds' final global model against the
  reference's chunk runner;
* ``launch/train.py`` (``run_lm`` on a reduced id, ``run_fl``) and
  ``examples/model_zoo_fl.py`` at ``--device cpu``.

Tolerances: logits atol 2e-6 (measured 2.4e-7), the loss rtol 1e-5,
gradients 1e-5 of each leaf's largest |reference| (measured 4.8e-7):
float32 sums in other orders. The scheduling trajectory does not depend
on the model: n_selected exact, comm_time and avg_power rtol 1e-5 (as
``tests/test_torch_engine.py``); accuracy within 2 of the 64 x 12 test
tokens (an argmax near a tie can flip); the final model rtol 1e-3 / atol
1e-5 after three rounds of float32 SGD in two frameworks.
"""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import (ReplayDraws, record_draws,  # noqa: E402
                                  reference)

from repro_torch.convert import transformer_lm_params_from_jax  # noqa: E402
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      heterogeneous_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.synthetic import (from_numpy,  # noqa: E402
                                        make_cifar10_like, make_lm_federated)
from repro_torch.fl.engine import (SimConfig, init_policy_state,  # noqa: E402
                                   make_sim_round)
from repro_torch.fl.simulation import run_simulation  # noqa: E402
from repro_torch.models import transformer_lm as tl  # noqa: E402
from repro_torch.models.registry import make_model  # noqa: E402

N = 12
SEQ, PER_CLIENT, N_TEST, VOCAB = 12, 16, 64, 32
SIM = dict(rounds=4, eval_every=2, m_cap=4, batch=4, local_steps=2,
           eval_size=N_TEST, model="transformer_lm")
BITS = 32 * 50_000.0


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def lm_mod(ref):
    import importlib
    return importlib.import_module("repro.models.transformer_lm")


@pytest.fixture(scope="module")
def world(ref):
    """A small federated token problem on the reference side and its
    port."""
    jax = ref.jax
    ds = ref.synthetic.make_lm_federated(
        jax.random.PRNGKey(0), n_clients=N, per_client=PER_CLIENT, seq=SEQ,
        vocab=VOCAB, n_test=N_TEST)
    params = ref.registry.make_model("transformer_lm", ds).init_fn(
        jax.random.PRNGKey(1))
    pds = from_numpy(ds.client_images, ds.client_labels, ds.test_images,
                     ds.test_labels, ds.n_classes, device="cpu")
    return ds, params, pds, transformer_lm_params_from_jax(
        jax.tree.map(np.asarray, params), device="cpu")


def tokens(b, s, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, VOCAB, (b, s))
    return tok, np.roll(tok, -1, axis=1)


@pytest.mark.parametrize("d_model,n_heads,n_layers", [(32, 2, 2),
                                                      (64, 2, 3),
                                                      (64, 4, 1)])
def test_lm_matches_reference(ref, lm_mod, d_model, n_heads, n_layers):
    jax, jnp = ref.jax, ref.jnp
    rcfg = lm_mod.LMConfig(vocab=VOCAB, d_model=d_model, n_heads=n_heads,
                           n_layers=n_layers)
    cfg = tl.LMConfig(vocab=VOCAB, d_model=d_model, n_heads=n_heads,
                      n_layers=n_layers)
    rp = lm_mod.init_lm(jax.random.PRNGKey(n_layers), rcfg)
    pp = transformer_lm_params_from_jax(jax.tree.map(np.asarray, rp),
                                        device="cpu")
    tok, tgt = tokens(4, 16, d_model)
    rb = (jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32))
    pb = (torch.from_numpy(tok), torch.from_numpy(tgt))
    np.testing.assert_allclose(
        tl.apply_lm(pp, pb[0], cfg).numpy(),
        np.asarray(lm_mod.apply_lm(rp, rb[0], rcfg)), atol=2e-6, rtol=0)
    rloss, rgrads = jax.jit(jax.value_and_grad(lm_mod.lm_loss),
                            static_argnums=2)(rp, rb, rcfg)
    grads, loss = torch.func.grad_and_value(tl.lm_loss)(pp, pb, cfg)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = transformer_lm_params_from_jax(jax.tree.map(np.asarray, rgrads),
                                          device="cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        assert scale > 0, name
        assert float((g - want[name]).abs().max()) <= 1e-5 * scale, name
    assert float(tl.lm_accuracy(pp, *pb, cfg)) == pytest.approx(
        float(lm_mod.lm_accuracy(rp, *rb, rcfg)))


def test_init_lm_layout(lm_mod, ref):
    """init_lm's names and shapes are the reference tree's, drawn on the
    generator (norms are ones)."""
    cfg = tl.LMConfig(vocab=VOCAB)
    got = tl.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = transformer_lm_params_from_jax(ref.jax.tree.map(
        np.asarray, lm_mod.init_lm(ref.jax.random.PRNGKey(0),
                                   lm_mod.LMConfig(vocab=VOCAB))),
        device="cpu")
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.shape == want[k].shape and v.dtype == torch.float32
        assert not v.requires_grad and not v.is_inference()
    assert torch.equal(got["lnf.g"], torch.ones(32))
    assert float(got["emb.emb"].std()) == pytest.approx(0.02 * 0.88,
                                                        rel=0.1)
    again = tl.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(v, again[k]) for k, v in got.items())


def test_registry_builds_and_refuses(ref, world):
    ds, _, pds, _ = world
    spec = make_model("transformer_lm", pds, d_model=64, n_layers=1)
    params = spec.init_fn(torch.Generator().manual_seed(0))
    assert params["layers.0.attn.wq.w"].shape == (64, 64)
    assert "layers.1.ln1.g" not in params
    batch = (pds.client_images[0, :4], pds.client_labels[0, :4])
    assert np.isfinite(float(spec.loss_fn(params, batch)))
    acc = float(spec.eval_fn(params, pds.test_images, pds.test_labels))
    assert 0.0 <= acc <= 1.0
    img = make_cifar10_like(torch.Generator().manual_seed(0), n_clients=2,
                            per_client=2, n_test=2, h=4, w=4, device="cpu")
    rimg = ref.synthetic.make_cifar10_like(ref.jax.random.PRNGKey(0),
                                           n_clients=2, per_client=2,
                                           n_test=2, h=4, w=4)
    msg = "model 'transformer_lm' needs token client data"
    for build, data in ((make_model, img),
                        (ref.registry.make_model, rimg)):
        with pytest.raises(ValueError, match=msg):
            build("transformer_lm", data)
    floats = from_numpy(np.asarray(ds.client_images, np.float32),
                        ds.client_labels, ds.test_images, ds.test_labels,
                        ds.n_classes, device="cpu")
    with pytest.raises(ValueError, match=msg):
        make_model("transformer_lm", floats)
    for name in ("cnn", "mlp"):
        with pytest.raises(ValueError, match="token datasets federate via "
                                             "model='transformer_lm'"):
            make_model(name, pds)
        with pytest.raises(ValueError, match="token datasets federate via "
                                             "model='transformer_lm'"):
            ref.registry.make_model(name, ds)


def test_lm_federated_through_from_numpy(world):
    ds, _, pds, _ = world
    for got, want in ((pds.client_images, ds.client_images),
                      (pds.client_labels, ds.client_labels),
                      (pds.test_images, ds.test_images),
                      (pds.test_labels, ds.test_labels)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pds.n_classes == VOCAB and pds.n_clients == N


def test_make_lm_federated():
    ds = make_lm_federated(torch.Generator().manual_seed(3), n_clients=6,
                           per_client=5, seq=9, vocab=20, n_test=7,
                           device="cpu")
    assert ds.client_images.shape == (6, 5, 9)
    assert ds.test_images.shape == (7, 9)
    assert ds.client_images.dtype == torch.int64
    assert int(ds.client_images.min()) >= 0
    assert int(ds.client_images.max()) < 20
    assert torch.equal(ds.client_labels[..., :-1], ds.client_images[..., 1:])
    assert torch.equal(ds.client_labels[..., -1], ds.client_images[..., 0])
    assert torch.equal(ds.test_labels, torch.roll(ds.test_images, -1, -1))
    # non-i.i.d.: the clients' unigram counts differ
    counts = torch.stack([torch.bincount(c.reshape(-1), minlength=20)
                          for c in ds.client_images])
    assert not bool((counts == counts[0]).all())


def test_fl_run_matches_reference(ref, world):
    """The default solver pair (the fused decision; the other pairs are
    tests/test_torch_engine.py's, with the CNN)."""
    solver, ref_solver = "cuda_fused", "pallas_fused"
    ds, params, pds, pparams = world
    jax = ref.jax
    key = jax.random.PRNGKey(2)
    want = ref.simulation.run_simulation(
        key, params, ds, ref.simulation.SimConfig(solver=ref_solver, **SIM),
        ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS),
        ref.channel.ChannelConfig(n_clients=N),
        ref.channel.heterogeneous_sigmas(N))
    draws = ReplayDraws(record_draws(ref, key, SIM["rounds"], N,
                                     (SIM["m_cap"], SIM["local_steps"],
                                      SIM["batch"]), PER_CLIENT))
    got = run_simulation(draws, pparams, pds,
                         SimConfig(solver=solver, **SIM),
                         SchedulerConfig(n_clients=N, model_bits=BITS),
                         ChannelConfig(n_clients=N),
                         heterogeneous_sigmas(N, device="cpu"))
    np.testing.assert_array_equal(got["round"], want["round"])
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    for key_ in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[key_], want[key_], rtol=1e-5)
    np.testing.assert_allclose(got["test_acc"], want["test_acc"],
                               atol=2 / (N_TEST * SEQ))


def test_fl_final_params_match_reference(ref, world):
    """Three rounds (proposed, fused decision): the global LM against
    the reference's chunk runner."""
    ds, params, pds, pparams = world
    jax = ref.jax
    rounds, key = 3, jax.random.PRNGKey(3)
    sim = ref.simulation.SimConfig(solver="pallas_fused", gamma=0.5, **SIM)
    cfg = ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=N)
    sig = ref.channel.heterogeneous_sigmas(N)
    draws = ReplayDraws(record_draws(ref, key, rounds, N,
                                     (SIM["m_cap"], SIM["local_steps"],
                                      SIM["batch"]), PER_CLIENT))
    run_chunk = ref.engine.make_chunk_runner(ds, sim, cfg, ch, sig)
    carry, _, _ = run_chunk(
        ref.engine.init_carry(key, params, cfg, sim, sig, ch), rounds)
    want = transformer_lm_params_from_jax(
        jax.tree.map(np.asarray, carry[0]), device="cpu")
    sim_round = make_sim_round(
        pds, SimConfig(solver="cuda_fused", gamma=0.5, **SIM),
        SchedulerConfig(n_clients=N, model_bits=BITS),
        ChannelConfig(n_clients=N), heterogeneous_sigmas(N, device="cpu"))
    got, st, ch_state = pparams, init_policy_state("proposed", N, "cpu"), None
    for r in range(rounds):
        got, st, ch_state, *_ = sim_round(got, st, ch_state, draws, r)
    moved = max(float((got[k] - pparams[k]).abs().max()) for k in got)
    assert moved > 1e-3     # the rounds trained the model
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-5)


def test_train_lm_on_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--arch", "yi-6b", "--steps", "3",
                      "--seq", "16", "--batch", "2", "--layers", "2",
                      "--d-model", "64", "--gamma", "0.5"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "yi-6b-reduced" and line["device"] == "cpu"
    assert line["steps"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))


def test_train_fl_on_cpu(capsys):
    from repro_torch.launch import train
    out = train.main(["--device", "cpu", "--rounds", "2", "--per-client",
                      "4", "--eval-size", "20", "--eval-every", "1",
                      "--m-cap", "2", "--batch", "2"])
    assert out["dataset"] == "cifar10" and out["n_clients"] == 100
    assert out["history"]["round"] == [0, 1]
    assert out["total_comm_time_s"] > 0 and 0 <= out["final_acc"] <= 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "rounds"] == 2


def test_model_zoo_fl_example_on_cpu(capsys):
    from repro_torch.examples import model_zoo_fl
    hist = model_zoo_fl.main(["--device", "cpu", "--rounds", "2"])
    assert list(hist) == ["cnn", "mlp", "transformer_lm", "mlp_sharded"]
    for h in hist.values():
        assert h["round"].tolist() == [0, 1]
        assert (h["n_selected"] >= 1).all()
    text = capsys.readouterr().out
    assert text.count("devices/round") == 3
    assert "mlp sharded x1 (delta/bf16 wire)" in text
    # the sharded leg's schedule is the MLP leg's: same draws, one rank
    for k in ("comm_time", "n_selected"):
        np.testing.assert_array_equal(hist["mlp_sharded"][k],
                                      hist["mlp"][k])
