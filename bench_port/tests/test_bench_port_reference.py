"""Each plain reference against the port at a tiny size on the CPU."""

import pytest
import torch

import data
import harness
from conftest import tiny_context
from reference import lm_ref


def test_lm_reference_matches_the_port():
    ctx = tiny_context("yi6b.train_2k")
    drv = harness.load_module("drivers", "lm_train")
    cfg, tr = ctx.cfg, ctx.traffic
    w = data.lm_weights(data.seeded("cpu", 5, 1), cfg, 2, "cpu")
    tokens, labels = data.token_batches(data.seeded("cpu", 5, 2), 1, 2, 16,
                                        cfg["vocab_size"], "cpu")
    model, mcfg, _ = drv.build(ctx, w)
    params = {k: p.detach() for k, p in model.named_parameters()}
    from repro_torch.models.model import Batch

    def loss_fn(p):
        return torch.func.functional_call(
            model, p, (Batch(tokens=tokens[0], labels=labels[0]), mcfg))

    grads, loss = torch.func.grad_and_value(loss_fn)(params)
    ref_loss, ref_grads = lm_ref.loss_and_grads(w, tokens[0], labels[0], cfg,
                                                2)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-6)
    for name, g in ref_grads.items():
        got = grads[drv.program_name(name)]
        assert float((got - g).norm()) <= 1e-5 * float(g.norm()), name
