"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program at a tiny size on the
CPU (the harness's look for a chip skipped); the same run unbroken comes
out correct. The cells run on one chip, so none has an exchange between
chips to leave out; training produces no token to alter."""

import pytest

import harness
from conftest import tiny_context


def lm_run(fault=None):
    ctx = tiny_context("yi6b.train_2k")
    return harness.load_module("drivers", "lm_train").run(ctx, fault=fault)


def _lm_unchanged(step):
    return lambda params, batch: (params, step(params, batch)[1])


def _lm_half_batch(step):
    def half(params, batch):
        rows = batch.tokens.shape[0] // 2
        return step(params, batch._replace(tokens=batch.tokens[:rows],
                                           labels=batch.labels[:rows]))
    return half


def test_lm_sound_run_is_correct():
    out = lm_run()
    assert all(c.ok for c in out.checks), out.checks


@pytest.mark.parametrize("fault", [_lm_unchanged, _lm_half_batch],
                         ids=["unchanged", "half_batch"])
def test_lm_fault_is_not_correct(fault):
    out = lm_run(fault)
    assert not all(c.ok for c in out.checks), out.checks
