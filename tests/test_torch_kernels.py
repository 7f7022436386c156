"""The plain versions of the port's two kernels against the reference's
Pallas kernels, run in interpret mode on the CPU as the reference's own
tests run them, at the block-edge sizes of the reference's 1024-lane
block; plus the wrappers' argument checks.

On CPU tensors the wrappers run the plain versions, which are what the
CUDA kernels are held against on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances, as the reference's kernel tests set them:
q rtol 1e-5 / atol 1e-6, P and every power-like output rtol 1e-5 /
atol 1e-3, tc rtol 1e-5; ``sel`` exact on every lane where
|u - q_ref| > 1e-6; the selection count exact.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_core import boundary_states, random_states  # noqa: E402
from test_torch_reference import reference  # noqa: E402

from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.fl.decision import decision_coeffs  # noqa: E402
from repro_torch.kernels.decision_fused import (  # noqa: E402
    N_DECISION_OPS, decision_fused, pack_decision_operands)
from repro_torch.kernels.scheduler_solve import scheduler_solve  # noqa: E402

EDGE_SIZES = [1, 1023, 1024, 1025, 3 * 1024 + 17]
KW = dict(n=100, v=1000.0, lam=10.0, ell=32 * 555178.0, bandwidth=22e6,
          noise=1.0, p_max=100.0, p_bar=1.0, q_floor=1e-5)


@pytest.fixture(scope="module")
def ref():
    return reference()


def mixed_states(n):
    """Random lanes with every third lane a branch-boundary state (Z = 0,
    gains at the clip bounds, huge queues)."""
    gains, z = random_states(n, n)
    bg, bz = boundary_states(n)
    gains[::3], z[::3] = bg[::3], bz[::3]
    return gains, z


def assert_close(name, got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_scheduler_solve_plain_matches_pallas(ref, n):
    gains, z = mixed_states(n)
    want = ref.scheduler_solve.scheduler_solve(gains, z, interpret=True,
                                               **KW)
    q, p = scheduler_solve(torch.from_numpy(gains), torch.from_numpy(z),
                           **KW)
    assert q.shape == p.shape == (n,)
    assert np.isfinite(q.numpy()).all() and np.isfinite(p.numpy()).all()
    assert_close("q", q.numpy(), want[0], 1e-5, 1e-6)
    assert_close("p", p.numpy(), want[1], 1e-5, 1e-3)


def _ref_ops(ref):
    ch = ref.channel.ChannelConfig(n_clients=100)
    cfg = ref.scheduler.SchedulerConfig(n_clients=100,
                                        model_bits=32 * 555178.0, lam=10.0,
                                        V=1000.0)
    co = ref.decision.decision_coeffs(cfg, ch)
    return ref.decision_fused.pack_decision_operands(co.solve, co.acct)


def _port_ops():
    co = decision_coeffs(SchedulerConfig(n_clients=100,
                                         model_bits=32 * 555178.0, lam=10.0,
                                         V=1000.0),
                         ChannelConfig(n_clients=100))
    return pack_decision_operands(co.solve, co.acct)


def test_operand_vectors_bit_equal(ref):
    np.testing.assert_array_equal(_port_ops().numpy(),
                                  np.asarray(_ref_ops(ref)))
    assert _port_ops().shape == (N_DECISION_OPS,)


@pytest.mark.parametrize("masks", ["none", "active_valid", "valid"])
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_decision_fused_plain_matches_pallas(ref, n, masks):
    gains, z = mixed_states(n)
    rng = np.random.default_rng(n + 1)
    u = rng.uniform(0, 1, n).astype(np.float32)
    mask = rng.uniform(0, 1, n) < 0.8
    mask[::1024] = False  # block-boundary lanes inactive
    active = mask if masks == "active_valid" else None
    valid = mask if masks != "none" else None
    want = ref.decision_fused.decision_fused(
        gains, z, u, _ref_ops(ref), active=active, valid=valid,
        interpret=True)
    t = torch.from_numpy
    got = decision_fused(t(gains), t(z), t(u), _port_ops(),
                         active=None if active is None else t(active),
                         valid=None if valid is None else t(valid))
    sel, q, p, z_new, tc, pq = (x.numpy() for x in got)
    for x in (q, p, z_new, tc, pq):
        assert x.shape == (n,) and np.isfinite(x).all()
    q_ref = np.asarray(want[1])
    assert_close("q", q, q_ref, 1e-5, 1e-6)
    assert_close("p", p, want[2], 1e-5, 1e-3)
    assert_close("z_new", z_new, want[3], 1e-5, 1e-3)
    assert_close("tc", tc, want[4], 1e-5)
    assert_close("pq", pq, want[5], 1e-5, 1e-3)
    far = np.abs(u - q_ref) > 1e-6
    np.testing.assert_array_equal(sel[far], np.asarray(want[0])[far])
    if far.all():
        assert sel.sum() == int(np.asarray(want[0]).sum())
    if active is not None:
        assert (q[~active] == 0).all() and not sel[~active].any()
    if valid is not None:
        assert (pq[~valid] == 0).all()


def test_wrappers_reject_bad_arguments():
    g = torch.ones(8)
    ops = _port_ops()
    with pytest.raises(TypeError):
        scheduler_solve(g.double(), g.double(), **KW)
    with pytest.raises(ValueError):
        scheduler_solve(g, torch.ones(9), **KW)
    with pytest.raises(ValueError):
        scheduler_solve(torch.ones(16)[::2], g, **KW)
    with pytest.raises(ValueError):
        scheduler_solve(torch.ones(0), torch.ones(0), **KW)
    with pytest.raises(ValueError):
        scheduler_solve(g.to("meta"), g.to("meta"), **KW)
    with pytest.raises(TypeError):
        decision_fused(g, g, g, ops, valid=torch.ones(8))
    with pytest.raises(ValueError):
        decision_fused(g, g, g, ops[:13])
    with pytest.raises(ValueError):
        decision_fused(g, g, g, ops.double())
