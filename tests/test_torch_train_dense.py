"""One train step of each dense, VLM and encoder-decoder id of the zoo
(``yi-6b``, ``chatglm3-6b``, ``minicpm-2b``, ``granite-20b``,
``llama-3.2-vision-11b``, ``seamless-m4t-large-v2``), ``reduced()``,
against ``jax.grad`` of the reference's ``loss_fn``: the mirror of
``tests/test_arch_smoke.py::test_reduced_forward_and_train_step`` with
the reference's own numbers as the yardstick. ``tests/
test_torch_train_moe.py`` does the Mamba and MoE ids.

The reference's ``init_params`` tree is carried across by
``convert.lm_params_from_jax``; the port's loss is ``torch.func.
functional_call`` of the ``LM`` module over its parameter dict (the
``launch/train.py::run_lm`` step), ``fl/round.py::make_train_step`` takes
the SGD step. Seeded numpy tokens (2, 16), next-token labels, media and
frames go to both packages. The reference's gradient is computed once per
id (``jax.jit(jax.value_and_grad(...))``); its gradient tree is carried
across with the same converter, so every leaf is compared by the port's
name.

Tolerances: the loss rtol 1e-5; each gradient leaf within 1e-4 of its
largest |reference| entry (measured up to 6.4e-6, jamba's ``a_log``: the
two sides sum float32 products in other orders over d_model = 256 and the
vocabulary of 512); the stepped parameters rtol 1e-5 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.fl.round import make_train_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

GAMMA = 0.01
GRAD_TOL = 1e-4
IDS = ["yi-6b", "chatglm3-6b", "minicpm-2b", "granite-20b",
       "llama-3.2-vision-11b", "seamless-m4t-large-v2"]


@pytest.fixture(scope="module")
def ref():
    return reference()


def step_inputs(ref, cfg, b=2, s=16, seed=1):
    """Seeded tokens, labels (the tokens rolled by one), and the media
    or frames the id reads, as the reference's and the port's batches."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    media = (rng.standard_normal((b, cfg.n_media_tokens, cfg.d_model))
             .astype(np.float32) if cfg.cross_attn_every else None)
    frames = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32) if cfg.is_encoder_decoder else None)

    def j(a):
        return None if a is None else ref.jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    return (ref.model.Batch(tokens=j(tok), labels=j(lab), media=j(media),
                            frames=j(frames)),
            M.Batch(tokens=t(tok).long(), labels=t(lab).long(),
                    media=t(media), frames=t(frames)))


def check_train_step(ref, arch):
    """The port's loss, gradients and SGD step against the reference's on
    ``arch`` reduced; returns the port's gradients by name."""
    jax = ref.jax
    cfg = configs.get_config(arch).reduced()
    rcfg = ref.configs.get_config(arch).reduced()
    rparams = ref.model.init_params(jax.random.PRNGKey(0), rcfg)
    model = lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    rbatch, batch = step_inputs(ref, cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.model.loss_fn(p, b, rcfg)))(rparams, rbatch)
    rstepped = jax.tree.map(lambda w, g: w - GAMMA * g, rparams, rgrads)

    params = {k: v.detach() for k, v in model.named_parameters()}

    def loss_fn(p, b):
        return torch.func.functional_call(model, p, (b, cfg))

    grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
    stepped, step_loss = make_train_step(loss_fn, GAMMA)(params, batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert float(step_loss) == float(loss)

    def by_name(tree):
        return dict(lm_params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                       device="cpu").named_parameters())

    want, want_stepped = by_name(rgrads), by_name(rstepped)
    assert set(grads) == set(want) == set(stepped)
    for name, g in grads.items():
        w = want[name]
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        scale = float(w.abs().max())
        assert scale > 0, f"{arch}: no gradient reaches {name}"
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
        torch.testing.assert_close(stepped[name], want_stepped[name],
                                   rtol=1e-5, atol=1e-7)
    return grads


@pytest.mark.parametrize("arch", IDS)
def test_train_step_matches_reference(ref, arch):
    check_train_step(ref, arch)
