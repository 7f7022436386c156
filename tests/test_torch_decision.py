"""The decision layer against the reference on the reference's own draws:
the stitched ``decision_step`` (proposed and uniform) and the fused
``make_fused_decision`` against their JAX twins (the fused one against the
interpret-mode Pallas kernel), also with the service's ``valid`` /
``acct_len`` bucket hooks, and stitched against fused inside the port.

Tolerances: t_comm, power, q and Z' at rtol 1e-5 (atol 1e-6 on q, 1e-3 on
power-like values, the reference's kernel-test tolerances); n_sel exact;
``sel`` exact on lanes where |u - q_ref| > 1e-6.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_core import random_states  # noqa: E402
from test_torch_reference import reference  # noqa: E402

from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.policies import (PolicyState,  # noqa: E402
                                       init_policy_state, make_policy)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.fl.decision import (decision_coeffs,  # noqa: E402
                                     decision_step, make_fused_decision)

SIZES = [1, 100, 1025]


@pytest.fixture(scope="module")
def ref():
    return reference()


def setup(ref, n):
    cfg = ref.scheduler.SchedulerConfig(n_clients=n, model_bits=32 * 555178.0,
                                        lam=10.0, V=1000.0)
    ch = ref.channel.ChannelConfig(n_clients=n)
    pcfg = SchedulerConfig(n_clients=n, model_bits=32 * 555178.0, lam=10.0,
                           V=1000.0)
    return cfg, ch, pcfg, ChannelConfig(n_clients=n)


def states(ref, n, seed):
    gains, z = random_states(n, seed)
    st = ref.policies.init_policy_state("proposed", n)._replace(z=z)
    pst = init_policy_state("proposed", n, device="cpu")._replace(
        z=torch.from_numpy(z))
    return gains, st, pst


def assert_decision_close(got, want, u):
    sel, q, p, t_comm, power, n_sel, st = got
    q_ref = np.asarray(want[1])
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-3)
    far = np.abs(u - q_ref) > 1e-6
    assert far.all(), "a uniform fell inside the tolerance band"
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want[0]))
    assert int(n_sel) == int(want[5])
    np.testing.assert_allclose(float(t_comm), float(want[3]), rtol=1e-5)
    np.testing.assert_allclose(float(power), float(want[4]), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(st.z.numpy(), np.asarray(want[6].z),
                               rtol=1e-5, atol=1e-3)
    assert int(st.t) == int(want[6].t)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fused", [False, True])
def test_proposed_decision_matches_reference(ref, n, fused):
    cfg, ch, pcfg, pch = setup(ref, n)
    gains, st, pst = states(ref, n, n)
    key = ref.jax.random.PRNGKey(n)
    co = ref.decision.decision_coeffs(cfg, ch)
    if fused:
        want = ref.decision.make_fused_decision(cfg, co, interpret=True)(
            None, None, key, gains, st)
    else:
        step = ref.policies.make_policy("proposed", cfg, ch,
                                        coeffs=co.solve)
        want = ref.decision.decision_step(step, co.acct, key, gains, st)
    u = np.array(ref.policies.draw_selection_uniform(key, n))
    pco = decision_coeffs(pcfg, pch)
    if fused:
        got = make_fused_decision(pcfg, pco)(None, None, torch.from_numpy(u),
                                             torch.from_numpy(gains), pst)
    else:
        step = make_policy("proposed", pcfg, pch, coeffs=pco.solve)
        got = decision_step(step, pco.acct, torch.from_numpy(u),
                            torch.from_numpy(gains), pst)
    assert_decision_close(got, want, u)


def test_uniform_decision_matches_reference(ref):
    """The uniform baseline's decision: selection, q, P exact; t_comm and
    power at rtol 1e-5."""
    n = 100
    cfg, ch, pcfg, pch = setup(ref, n)
    gains, st, pst = states(ref, n, 9)
    key = ref.jax.random.PRNGKey(9)
    co = ref.decision.decision_coeffs(cfg, ch)
    step = ref.policies.make_policy("uniform", cfg, ch, m_avg=6.4)
    want = ref.decision.decision_step(step, co.acct, key, gains, st)
    raw = {k: torch.as_tensor(np.array(v))
           for k, v in ref.policies._draw_uniform(key, n).items()}
    pco = decision_coeffs(pcfg, pch)
    got = decision_step(make_policy("uniform", pcfg, pch, m_avg=6.4),
                        pco.acct, raw, torch.from_numpy(gains), pst)
    for i in (0, 1, 2, 5):
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(want[i]))
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)


@pytest.mark.parametrize("case", ["draw", "none_drawn"])
@pytest.mark.parametrize("n", SIZES)
def test_fused_equals_stitched_in_port(n, case):
    """Inside the port, on the CPU, the fused decision (the kernel's plain
    version) is bitwise the stitched one: same ops, same operands —
    including the guarantee-one fallback when nothing is drawn."""
    pcfg = SchedulerConfig(n_clients=n, model_bits=32 * 555178.0)
    pch = ChannelConfig(n_clients=n)
    gains, z = (torch.from_numpy(x) for x in random_states(n, n + 7))
    u = torch.rand(n, generator=torch.Generator().manual_seed(n))
    if case == "none_drawn":
        u = torch.ones(n)
    pst = PolicyState(z, torch.zeros(n), torch.zeros((), dtype=torch.int32))
    pco = decision_coeffs(pcfg, pch)
    step = make_policy("proposed", pcfg, pch, coeffs=pco.solve)
    a = decision_step(step, pco.acct, u, gains, pst)
    b = make_fused_decision(pcfg, pco)(None, None, u, gains, pst)
    for x, y in zip(list(a[:6]) + list(a[6]), list(b[:6]) + list(b[6])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    if case == "none_drawn":
        assert int(a[5]) == 1 and bool(a[0][torch.argmax(a[1])])


@pytest.mark.parametrize("n,width", [(100, 128), (400, 512)])
@pytest.mark.parametrize("fused", [False, True])
def test_bucket_hooks_match_reference(ref, n, width, fused):
    """The ``valid`` / ``acct_len`` hooks on a padded client axis: real
    lanes first, pad lanes with u = 2.0; the accounting cut or zero-padded
    to padded_len(n) (192 > 128 pads, 480 < 512 cuts). The fused form also
    masks q to 0 on invalid lanes, as the reference's does."""
    cfg, ch, pcfg, pch = setup(ref, n)
    gains, st, pst = states(ref, width, n + width)
    valid = np.arange(width) < n
    acct_len = ref.sharding.padded_len(n)
    co = ref.decision.decision_coeffs(cfg, ch)
    pco = decision_coeffs(pcfg, pch)
    t = torch.from_numpy
    if fused:
        # the reference draws u from the key; its q is 0 on invalid lanes
        key = ref.jax.random.PRNGKey(n)
        u = np.array(ref.policies.draw_selection_uniform(key, width))
        want = ref.decision.make_fused_decision(cfg, co, interpret=True)(
            None, None, key, gains, st, valid=valid, acct_len=acct_len)
        got = make_fused_decision(pcfg, pco)(None, None, t(u), t(gains), pst,
                                             valid=t(valid),
                                             acct_len=acct_len)
    else:
        # the service's proposed core: the uniforms arrive as raws
        u = np.random.default_rng(n).uniform(0, 1, width).astype(np.float32)
        u[n:] = 2.0
        core = ref.policies.fence_step(
            lambda k, g, s: _ref_proposed(ref, u, g, s, co.solve, cfg))
        want = ref.decision.decision_step(core, co.acct, None, gains, st,
                                          valid=valid, acct_len=acct_len)
        got = decision_step(make_policy("proposed", pcfg, pch,
                                        coeffs=pco.solve),
                            pco.acct, t(u), t(gains), pst, valid=t(valid),
                            acct_len=acct_len)
    far = np.abs(u - np.asarray(want[1])) > 1e-6
    assert far.all()
    assert_decision_close(got, want, u)
    assert not got[0][n:].any()


def _ref_proposed(ref, u, gains, st, c, cfg):
    """The reference's proposed core on given uniforms (its service's
    ``_proposed_core``)."""
    sch = ref.scheduler
    q, p = sch.solve_round_coeffs(gains, st.z, c)
    sel = sch.selection_from_uniform(ref.jnp.asarray(u), q,
                                     cfg.guarantee_one)
    z = sch.update_queues_z(st.z, q, p, c)
    return sel, q, p, st._replace(z=z, t=st.t + 1)
