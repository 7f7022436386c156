"""The plain versions of the port's three kernels against the reference's
Pallas kernels, run in interpret mode on the CPU as the reference's own
tests run them, at the block-edge sizes of the reference's 1024-lane
block; the bucket-batched fused kernel's plain version against the
single-row one, row by row; plus the wrappers' argument checks.

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
    N_DECISION_OPS, decision_fused, decision_fused_batched,
    pack_decision_operands)
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


def batched_case(b, n, seed):
    """(B, N) mixed lanes, uniforms, a ragged valid mask (row r real up to
    a random length) and B heterogeneous operand rows, for both packages."""
    rng = np.random.default_rng(seed)
    gains, z = mixed_states(b * n)
    gains, z = gains.reshape(b, n), z.reshape(b, n)
    u = rng.uniform(0, 1, (b, n)).astype(np.float32)
    n_real = rng.integers(1, n + 1, b)
    valid = np.arange(n)[None, :] < n_real[:, None]
    port_ops, ref_ops = [], []
    for _ in range(b):
        kw = dict(n_clients=int(rng.integers(1, 200)),
                  model_bits=float(rng.uniform(1e5, 1e7)),
                  lam=float(rng.uniform(0.5, 30.0)),
                  V=float(rng.uniform(10.0, 1e4)))
        p_max = float(rng.uniform(20.0, 150.0))
        co = decision_coeffs(SchedulerConfig(**kw),
                             ChannelConfig(n_clients=kw["n_clients"],
                                           p_max=p_max))
        port_ops.append(pack_decision_operands(co.solve, co.acct))
        ref_ops.append(np.asarray(port_ops[-1]))
    return gains, z, u, valid, torch.stack(port_ops), np.stack(ref_ops)


BATCHED_SHAPES = [(1, 8), (3, 32), (5, 100), (4, 1029)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n", BATCHED_SHAPES)
def test_decision_fused_batched_plain_matches_pallas(ref, b, n, masked):
    """The bucket-batched kernel's plain version against the reference's
    ``decision_fused_batched`` (interpret mode) at the tolerances above,
    heterogeneous operand rows, ``valid`` None or ragged."""
    gains, z, u, valid, ops, ref_ops = batched_case(b, n, b * n)
    v = valid if masked else None
    want = ref.decision_fused.decision_fused_batched(
        gains, z, u, ref.jnp.asarray(ref_ops), valid=v, interpret=True)
    t = torch.from_numpy
    got = decision_fused_batched(t(gains), t(z), t(u), ops,
                                 valid=None if v is None else t(v))
    sel, q, p, z_new, tc, pq = (x.numpy() for x in got)
    for x in (q, p, z_new, tc, pq):
        assert x.shape == (b, n) and np.isfinite(x).all()
    q_ref = np.asarray(want[1])
    assert_close("q", q, q_ref, 1e-5, 1e-6)
    assert_close("p", p, want[2], 1e-5, 1e-3)
    assert_close("z_new", z_new, want[3], 1e-5, 1e-3)
    assert_close("tc", tc, want[4], 1e-5)
    assert_close("pq", pq, want[5], 1e-5, 1e-3)
    far = np.abs(u - q_ref) > 1e-6
    np.testing.assert_array_equal(sel[far], np.asarray(want[0])[far])
    if v is not None:
        assert (pq[~v] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n", BATCHED_SHAPES)
def test_decision_fused_batched_plain_equals_single_row(b, n, masked):
    """Row r of the batched plain version equals the single-row plain
    version on row r with its own operands, exactly (torch.equal): the
    same elementwise ops on the same values, the operands a (B, 1)
    column in one and 0-d in the other."""
    gains, z, u, valid, ops, _ = batched_case(b, n, b + n)
    t = torch.from_numpy
    v = t(valid) if masked else None
    got = decision_fused_batched(t(gains), t(z), t(u), ops, valid=v)
    for r in range(b):
        row = decision_fused(t(gains[r]), t(z[r]), t(u[r]), ops[r].clone(),
                             valid=None if v is None else v[r].clone())
        for name, x, y in zip(("sel", "q", "p", "z", "tc", "pq"), got, row):
            assert torch.equal(x[r], y), f"{name} row {r}"


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
    g2, ops2 = torch.ones(2, 8), torch.stack([ops, ops])
    with pytest.raises(ValueError):
        decision_fused_batched(g, g, g, ops)            # 1-D lanes
    with pytest.raises(ValueError):
        decision_fused_batched(g2, g2, g2, ops2[:1])    # one operand row
    with pytest.raises(ValueError):
        decision_fused_batched(g2, g2, g2, ops2.to("meta"))
    with pytest.raises(TypeError):
        decision_fused_batched(g2, g2, g2, ops2, valid=g2)
    with pytest.raises(ValueError):
        decision_fused_batched(g2, g2.t().contiguous().t(), g2, ops2)
