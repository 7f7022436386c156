"""``ModelConfig.remat_layers`` in the port: each decoder layer recomputed
in the backward through ``models/model.py::RematLayer``, the reference's
``jax.checkpoint`` of ``_apply_layer``.

One id of each mixer family, reduced (Mamba, dense attention, the hybrid
Mamba + attention + MoE stack), from the reference's ``init_params``
carried across by ``convert.lm_params_from_jax``, on seeded numpy tokens:

- every entry that builds a model takes the flag (``init_params``,
  ``lm_params_from_jax``), with the same leaves as without it;
- the loss and every gradient leaf under ``torch.func.grad`` against
  ``jax.grad`` of the reference's ``loss_fn`` with ``remat_layers=True``
  (tolerances of ``tests/test_torch_train_dense.py``: the loss rtol 1e-5,
  each leaf within 1e-4 of its largest |reference| entry, the two sides
  summing float32 products in other orders);
- ``vmap(grad)`` over two parameter sets (the FL round's shape) against
  the reference's ``vmap(grad)``, the same tolerances;
- remat on against remat off in the port: the same loss and gradients
  bit for bit (the recompute runs the same operations on the same
  inputs);
- what autograd keeps: under ``saved_tensors_hooks`` a remat forward
  saves, beside the tensors outside the layers (the embedding, the final
  norm, the head, the loss), only each layer's input and parameters.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402
from test_torch_train_dense import step_inputs  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# one id of each mixer family: Mamba, dense attention, the hybrid MoE
IDS = ["mamba2-130m", "yi-6b", "jamba-v0.1-52b"]
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    return reference()


def remat(cfg, on=True):
    return dataclasses.replace(cfg, remat_layers=on)


def models(ref, arch):
    """The reference's params and configs (remat on) and the port's LM
    carried across."""
    jax = ref.jax
    cfg = remat(configs.get_config(arch).reduced())
    rcfg = remat(ref.configs.get_config(arch).reduced())
    rparams = ref.model.init_params(jax.random.PRNGKey(0), rcfg)
    model = lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return cfg, rcfg, rparams, model


def by_name(ref, tree, cfg):
    return dict(lm_params_from_jax(ref.jax.tree.map(np.asarray, tree), cfg,
                                   device="cpu").named_parameters())


def close_leaves(got: dict, want: dict, tag):
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = float(w.abs().max())
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert float((g - w).abs().max()) <= GRAD_TOL * max(scale, 1e-30), (
            tag, name, float((g - w).abs().max()), scale)


def loss_of(model, cfg):
    def loss(p, b):
        return torch.func.functional_call(model, p, (b, cfg))
    return loss


@pytest.mark.parametrize("entry", ["init_params", "lm_params_from_jax"])
@pytest.mark.parametrize("arch", IDS)
def test_remat_layers_is_honoured(ref, arch, entry):
    """Every entry builds with the flag, the same leaves as without it."""
    cfg = remat(configs.get_config(arch).reduced())
    plain = configs.get_config(arch).reduced()
    if entry == "init_params":
        own = M.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        base = M.init_params(torch.Generator().manual_seed(0), plain,
                             device="cpu")
    else:
        tree = ref.jax.tree.map(np.asarray, ref.model.init_params(
            ref.jax.random.PRNGKey(0), ref.configs.get_config(arch)
            .reduced()))
        own = lm_params_from_jax(tree, cfg, device="cpu")
        base = lm_params_from_jax(tree, plain, device="cpu")
    got = dict(own.named_parameters())
    want = dict(base.named_parameters())
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("arch", IDS)
def test_remat_step_matches_reference_grad(ref, arch):
    jax = ref.jax
    cfg, rcfg, rparams, model = models(ref, arch)
    rbatch, batch = step_inputs(ref, cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.model.loss_fn(p, b, rcfg)))(rparams, rbatch)
    params = {k: v.detach() for k, v in model.named_parameters()}
    grads, loss = torch.func.grad_and_value(loss_of(model, cfg))(params,
                                                                  batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    close_leaves(grads, by_name(ref, rgrads, cfg), arch)


@pytest.mark.parametrize("arch", IDS)
def test_remat_vmap_grad_matches_reference(ref, arch):
    """Two parameter sets (the second scaled by 1.01) and two batches
    under ``vmap(grad)``, against the reference's ``vmap(grad)``."""
    jax, jnp = ref.jax, ref.jnp
    cfg, rcfg, rparams, model = models(ref, arch)
    rb0, b0 = step_inputs(ref, cfg, seed=1)
    rb1, b1 = step_inputs(ref, cfg, seed=2)
    rstack = jax.tree.map(lambda w: jnp.stack([w, w * 1.01]), rparams)
    rbatch = jax.tree.map(lambda a, b: jnp.stack([a, b]), rb0, rb1)
    rgrads = jax.vmap(jax.grad(
        lambda p, b: ref.model.loss_fn(p, b, rcfg)))(rstack, rbatch)
    params = {k: torch.stack([v.detach(), v.detach() * 1.01])
              for k, v in model.named_parameters()}
    batch = M.Batch(*(None if a is None else torch.stack([a, b])
                      for a, b in zip(b0, b1)))
    dims = M.Batch(*(None if a is None else 0 for a in batch))
    grads = torch.func.vmap(torch.func.grad(loss_of(model, cfg)),
                            in_dims=(0, dims))(params, batch)
    for i in range(2):
        close_leaves({k: g[i] for k, g in grads.items()},
                     by_name(ref, jax.tree.map(lambda g: g[i], rgrads), cfg),
                     (arch, i))


@pytest.mark.parametrize("arch", IDS)
def test_remat_on_equals_remat_off(ref, arch):
    """The port with and without the flag: the same loss and gradients, bit
    for bit, under ``grad``."""
    cfg, _, _, model = models(ref, arch)
    _, batch = step_inputs(ref, cfg)
    params = {k: v.detach() for k, v in model.named_parameters()}
    on = torch.func.grad_and_value(loss_of(model, cfg))(params, batch)
    off = torch.func.grad_and_value(loss_of(model, remat(cfg, False)))(
        params, batch)
    assert torch.equal(on[1], off[1])
    assert all(torch.equal(on[0][k], off[0][k]) for k in params)


@pytest.mark.parametrize("arch", IDS)
def test_remat_keeps_only_layer_inputs(ref, arch):
    """Autograd's saved tensors in a remat forward: each layer saves its
    input (B, S, d) and its parameters, nothing of its inside; without
    remat the layers keep activations of other shapes (the projections,
    the MLP's d_ff, attention's heads, the SSM's scan), which the remat
    forward does not."""
    cfg, _, _, model = models(ref, arch)
    _, batch = step_inputs(ref, cfg)
    b, s = batch.tokens.shape
    params = {k: v.detach().requires_grad_() for k, v in
              model.named_parameters()}
    param_ids = {id(v) for v in params.values()}

    def saved(on):
        kept = []

        def pack(t):
            kept.append(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = torch.func.functional_call(model, params,
                                              (batch, remat(cfg, on)))
        loss.backward()
        return kept

    inside = saved(True)
    layer_input = (b, s, cfg.d_model)
    outside = [t for t in inside if id(t) not in param_ids
               and tuple(t.shape) != layer_input]
    # outside the layers: the tokens' embedding lookup, the final norm,
    # the head and the loss, none of them (B, S, d_ff)- or heads-shaped
    layer_kept = [t for t in inside if tuple(t.shape) == layer_input]
    assert len(layer_kept) >= cfg.n_layers
    shapes_out = {tuple(t.shape) for t in outside}
    full = saved(False)
    shapes_full = {tuple(t.shape) for t in full
                   if id(t) not in param_ids}
    inner = shapes_full - shapes_out - {layer_input}
    assert inner, "the layers without remat keep no activation of their own"
    assert not (inner & shapes_out)
    assert sum(t.numel() for t in outside) < sum(
        t.numel() for t in full if id(t) not in param_ids)
