"""The port's core math against the JAX reference on the same inputs:
Lambert-W, the Theorem-2 solve (coefficient and config forms), the host
coefficient folds, sigmas and the Rayleigh apply, the queue update and
guarantee-one selection, the uniform baseline, the matched-M estimate, and
the fixed-association accounting reduce."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.core import channel as pc  # noqa: E402
from repro_torch.core import lambertw as pl  # noqa: E402
from repro_torch.core import scheduler as ps  # noqa: E402
from repro_torch.fl import sharding as psh  # noqa: E402
from repro_torch.fl.decision import decision_coeffs  # noqa: E402

N = 257


@pytest.fixture(scope="module")
def ref():
    return reference()


def configs(lib, n=100, lam=10.0):
    ch = lib.channel.ChannelConfig(n_clients=n)
    cfg = lib.scheduler.SchedulerConfig(n_clients=n, model_bits=32 * 555178.0,
                                        lam=lam, V=1000.0)
    return cfg, ch


def port_configs(n=100, lam=10.0):
    return (ps.SchedulerConfig(n_clients=n, model_bits=32 * 555178.0, lam=lam,
                               V=1000.0),
            pc.ChannelConfig(n_clients=n))


def random_states(n, seed):
    rng = np.random.default_rng(seed)
    gains = np.exp(rng.standard_normal(n) * 2.0).astype(np.float32)
    z = (np.abs(rng.standard_normal(n)) * 50.0).astype(np.float32)
    return gains, z


def boundary_states(n):
    """Branch-boundary lanes: gains at the clip bounds, Z = 0 exactly (the
    Z floor), huge queues (the P = Pmax boundary)."""
    lo, hi = pc.ChannelConfig(n_clients=100).gain_bounds()
    reps = -(-n // 6)
    gains = np.tile(np.array([lo, hi, 1.0, 1e-3, 1e3, 37.0], np.float32),
                    reps)[:n]
    z = np.tile(np.array([0.0, 0.0, 1e4, 5.0, 0.0, 1e-6], np.float32),
                reps)[:n]
    return gains, z


def test_lambertw0_grid(ref):
    """W0 on [0, 1e12]: the port's four Halley steps against the
    reference's; rtol 2e-6 (a few float32 ulp: exp/log differ by an ulp
    between XLA and PyTorch), atol 1e-12 near 0."""
    z = np.concatenate([[0.0, 1e-30, 0.5, 1.0, 2.718282, np.e, 10.0],
                        np.logspace(-8, 12, 400)]).astype(np.float32)
    want = np.asarray(ref.lambertw.lambertw0(ref.jnp.asarray(z)))
    got = pl.lambertw0(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-12)
    # and it is W0: w e^w = z to float32 round-off
    w = got.astype(np.float64)
    np.testing.assert_allclose(w * np.exp(w), z, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("states", ["random", "boundary"])
@pytest.mark.parametrize("form", ["coeffs", "configs"])
def test_solve_matches_reference(ref, states, form):
    """q at rtol 1e-5 / atol 1e-6 and P at rtol 1e-5 / atol 1e-3 — the
    reference's own kernel-vs-oracle tolerances
    (tests/test_scheduler_solve_pallas.py)."""
    gains, z = (random_states(N, 0) if states == "random"
                else boundary_states(N))
    cfg, ch = configs(ref)
    pcfg, pch = port_configs()
    g_j, z_j = ref.jnp.asarray(gains), ref.jnp.asarray(z)
    g_t, z_t = torch.from_numpy(gains), torch.from_numpy(z)
    if form == "coeffs":
        want = ref.scheduler.solve_round_coeffs(
            g_j, z_j, ref.scheduler.solve_coeffs(cfg, ch))
        got = ps.solve_round_coeffs(g_t, z_t, ps.solve_coeffs(pcfg, pch))
    else:
        want = ref.scheduler.solve_round(g_j, z_j, cfg, ch)
        got = ps.solve_round(g_t, z_t, pcfg, pch)
    q, p = (x.numpy() for x in got)
    assert np.isfinite(q).all() and np.isfinite(p).all()
    np.testing.assert_allclose(q, np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p, np.asarray(want[1]), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n,lam", [(100, 10.0), (100, 100.0), (3597, 10.0)])
def test_host_folds_bit_equal(ref, n, lam):
    """SolveCoeffs, AccountCoeffs and UniformCoeffs: every leaf bit-equal
    to the reference's float64 -> float32 fold."""
    cfg, ch = configs(ref, n, lam)
    pcfg, pch = port_configs(n, lam)
    want = ref.decision.decision_coeffs(cfg, ch)
    got = decision_coeffs(pcfg, pch)
    for w, g in zip(list(want.solve) + list(want.acct),
                    list(got.solve) + list(got.acct)):
        assert np.float32(g) == np.float32(w) and float(np.float32(g)) == g
    m = 7.31
    uw = ref.scheduler.uniform_coeffs(n, m, ch)
    ug = ps.uniform_coeffs(n, m, pch)
    assert [np.float32(x) for x in ug[:3]] == [np.float32(x) for x in uw[:3]]
    assert ug.n == int(uw.n)


@pytest.mark.parametrize("n", [7, 100, 3597])
def test_sigmas_and_rayleigh_apply(ref, n):
    """Sigma tables exact; gains = clip(-2 sigma^2 log u) at rtol 1e-6
    (one float32 log, an ulp apart between XLA and PyTorch)."""
    for name in ("homogeneous_sigmas", "heterogeneous_sigmas"):
        want = np.asarray(getattr(ref.channel, name)(n))
        got = getattr(pc, name)(n, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    sig = ref.channel.heterogeneous_sigmas(n)
    raw = ref.channel._rayleigh_draw(ref.jax.random.PRNGKey(n), n)
    cfg = ref.channel.ChannelConfig(n_clients=n)
    want, _ = ref.channel._rayleigh_apply(raw, None, sig, cfg)
    got, _ = pc.make_channel("rayleigh", torch.tensor(np.array(sig)),
                             pc.ChannelConfig(n_clients=n)).apply(
        torch.tensor(np.array(raw)), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    lo, hi = cfg.gain_bounds()
    assert (got.numpy() >= np.float32(lo)).all()
    assert (got.numpy() <= np.float32(hi)).all()


def test_channel_rate_and_queue_update(ref):
    """Eq. 8 rate at rtol 1e-6 (one log2) and the Eq. 9 update at rtol
    1e-6 / atol 1e-6."""
    gains, z = random_states(N, 1)
    p = np.random.default_rng(2).uniform(0, 100, N).astype(np.float32)
    q = np.random.default_rng(3).uniform(0, 1, N).astype(np.float32)
    cfg, ch = configs(ref)
    _, pch = port_configs()
    want = ref.channel.channel_rate(gains, p, ch)
    got = pc.channel_rate(torch.from_numpy(gains), torch.from_numpy(p), pch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    want = ref.scheduler.update_queues_z(z, q, p, ch)
    got = ps.update_queues_z(*(torch.from_numpy(x) for x in (z, q, p)), pch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["draw", "none_drawn", "tie"])
def test_selection_from_uniform(ref, case):
    """Bernoulli selection exact; an empty draw forces the argmax of q, the
    FIRST maximal lane on ties in both frameworks."""
    rng = np.random.default_rng(4)
    q = rng.uniform(0.01, 0.5, 50).astype(np.float32)
    u = rng.uniform(0, 1, 50).astype(np.float32)
    if case != "draw":
        u[:] = 0.99
    if case == "tie":
        q[[7, 21, 40]] = 0.75
    want = np.asarray(ref.scheduler.selection_from_uniform(u, q))
    got = ps.selection_from_uniform(torch.from_numpy(u),
                                    torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "tie":
        assert np.flatnonzero(got).tolist() == [7]


@pytest.mark.parametrize("m_avg", [0.3, 3.0, 7.6, 19.9, 25.0])
def test_uniform_decide(ref, m_avg):
    """The uniform baseline's exact ops (floor/ceil, sort threshold, one
    division) agree bit for bit, M' clipped into [1, N]."""
    n = 20
    _, ch = configs(ref, n)
    _, pch = port_configs(n)
    key = ref.jax.random.PRNGKey(int(m_avg * 10))
    for k in ref.jax.random.split(key, 4):
        raw = ref.policies._draw_uniform(k, n)
        want = ref.scheduler.uniform_decide(
            raw, ref.scheduler.uniform_coeffs(n, m_avg, ch))
        got = ps.uniform_decide(
            {k: torch.as_tensor(np.array(v)) for k, v in raw.items()},
            ps.uniform_coeffs(n, m_avg, pch))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m_avg", [1.0, 3.4, 7.6, 20.0])
def test_greedy_decide(ref, m_avg):
    """The greedy top-M baseline's exact ops (sort threshold, indicator q,
    one division) agree bit for bit, ties at the threshold kept."""
    n = 20
    _, ch = configs(ref, n)
    _, pch = port_configs(n)
    rng = np.random.default_rng(int(m_avg * 10))
    for _ in range(4):
        gains = rng.exponential(1.0, n).astype(np.float32) + 1e-3
        gains[[3, 11]] = gains[5]  # a tie that may sit at the threshold
        want = ref.scheduler.greedy_decide(
            gains, ref.scheduler.greedy_coeffs(n, m_avg, ch))
        got = ps.greedy_decide(torch.from_numpy(gains),
                               ps.greedy_coeffs(n, m_avg, pch))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gc, gr = ps.greedy_coeffs(n, m_avg, pch), ref.scheduler.greedy_coeffs(
        n, m_avg, ch)
    assert gc.m == int(gr.m) and np.float32(gc.pn) == gr.pn


def test_row_batched_baselines_equal_per_row():
    """force_one, uniform_decide and greedy_decide on a (B, N) batch with
    per-row (B,) coefficients equal the same calls row by row, exactly
    (the service's stitched rows rest on it)."""
    n, rows = 30, 6
    rng = np.random.default_rng(9)
    m_avgs = [0.4, 2.0, 3.7, 9.5, 29.9, 30.0]
    uni = [ps.uniform_coeffs(n, m, pc.ChannelConfig(n_clients=n,
                                                    p_bar=1.0 + i))
           for i, m in enumerate(m_avgs)]
    gre = [ps.greedy_coeffs(n, m, pc.ChannelConfig(n_clients=n,
                                                   p_bar=0.5 + i))
           for i, m in enumerate(m_avgs)]
    scores = torch.from_numpy(rng.uniform(0, 1, (rows, n)).astype(np.float32))
    take = torch.from_numpy(rng.uniform(0, 1, rows).astype(np.float32))
    gains = torch.from_numpy(rng.exponential(1.0, (rows, n))
                             .astype(np.float32))
    q = torch.from_numpy(rng.uniform(0, 1, (rows, n)).astype(np.float32))
    sel = q > 0.97
    sel[1] = False  # an empty row: the fallback
    stack = lambda cs: type(cs[0])(*(torch.tensor(  # noqa: E731
        [float(x) for x in col], dtype=torch.float32) for col in zip(*cs)))
    got_u = ps.uniform_decide({"take": take, "scores": scores}, stack(uni))
    got_g = ps.greedy_decide(gains, stack(gre))
    got_f = ps.force_one(sel, q)
    for r in range(rows):
        want_u = ps.uniform_decide({"take": take[r], "scores": scores[r]},
                                   uni[r])
        want_g = ps.greedy_decide(gains[r], gre[r])
        for g, w in zip(got_u + got_g, want_u + want_g):
            assert torch.equal(g[r], w), r
        assert torch.equal(got_f[r], ps.force_one(sel[r], q[r]))
    assert got_f[1].sum() == 1


def test_match_uniform_m(ref):
    """The matched-M Monte Carlo on the reference's own channel draws:
    rtol 1e-5 (a mean of float32 sums of q)."""
    n, rounds = 40, 60
    cfg, ch = configs(ref, n)
    pcfg, pch = port_configs(n)
    sig = ref.channel.heterogeneous_sigmas(n)
    key = ref.jax.random.PRNGKey(5)
    want = ref.simulation.match_uniform_m(key, sig, cfg, ch, rounds=rounds)
    # estimate_avg_selected draws draw_gains(k) for k in split(key, rounds)
    raws = np.stack([np.asarray(ref.channel._rayleigh_draw(k, n))
                     for k in ref.jax.random.split(key, rounds)])
    from repro_torch.fl.simulation import match_uniform_m
    got = match_uniform_m(None, torch.tensor(np.array(sig)), pcfg, pch,
                          rounds=rounds, raws=torch.from_numpy(raws))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 95, 96, 97, 3597])
def test_blocked_total(ref, n):
    """The 96-block partials + left fold: rtol 1e-6 against the reference
    (the in-block sums may associate differently); stacked contributions
    fold independently; the padded length matches."""
    rng = np.random.default_rng(n)
    contrib = rng.exponential(1.0, (2, n)).astype(np.float32)
    want = [float(ref.sharding.blocked_total(ref.jnp.asarray(c)))
            for c in contrib]
    got = psh.blocked_total(torch.from_numpy(contrib)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert psh.padded_len(n) == ref.sharding.padded_len(n)
    # the fold is a left fold over the block partials, in block order
    parts = psh.block_partials(
        torch.nn.functional.pad(torch.from_numpy(contrib[0]),
                                (0, (-n) % 96)), 96).numpy()
    acc = np.float32(0.0) + parts[0]
    for x in parts[1:]:
        acc = np.float32(acc + x)
    assert got[0] == acc


# --------------------------------------------------------------------------
# The scheduler's key-drawing wrappers, the uplink times, the sigma
# distributions, K1's oracle and the Corollary-1 bound.
# --------------------------------------------------------------------------

def draws_of(gen: torch.Generator, fn):
    """``fn(gen)`` on a copy of ``gen``'s state: the numbers a wrapper will
    draw next, for the reference to see the same ones."""
    twin = torch.Generator().set_state(gen.get_state())
    return fn(twin)


def test_solve_candidates_and_y0(ref):
    """Both candidates and the keep mask of the config form: q at rtol
    1e-5 / atol 1e-6, P at rtol 1e-5 / atol 1e-3, the mask exact where
    the two objectives differ by more than 1e-5 relative; y0 at rtol
    1e-5 (float32 sums)."""
    gains, z = random_states(N, 5)
    cfg, ch = configs(ref)
    pcfg, pch = port_configs()
    want = ref.scheduler.solve_candidates(gains, z, cfg, ch)
    got = ps.solve_candidates(torch.from_numpy(gains), torch.from_numpy(z),
                              pcfg, pch)
    for g, w, atol in zip(got[:4], want[:4], (1e-6, 1e-3, 1e-6, 1e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)
    f_int = np.asarray(ref.scheduler._objective(want[0], want[1], gains, z,
                                                cfg, ch))
    f_bnd = np.asarray(ref.scheduler._objective(want[2], want[3], gains, z,
                                                cfg, ch))
    far = np.abs(f_int - f_bnd) > 1e-5 * np.abs(f_bnd)
    np.testing.assert_array_equal(got[4].numpy()[far],
                                  np.asarray(want[4])[far])
    q, p = ref.scheduler.solve_round(gains, z, cfg, ch)
    want_y0 = ref.scheduler.y0(q, p, gains, cfg, ch)
    got_y0 = ps.y0(torch.tensor(np.array(q)), torch.tensor(np.array(p)),
                   torch.from_numpy(gains), pcfg, pch)
    np.testing.assert_allclose(float(got_y0), float(want_y0), rtol=1e-5)


def test_schedule_step_and_queues_on_shared_draws(ref):
    """init_state, schedule_step (solve, sample_selection, update_queues)
    and sample_selection alone, the reference fed the uniforms the port's
    generator draws: selections exact where |u - q| > 1e-6, q at rtol
    1e-5 / atol 1e-6, P and Z at rtol 1e-5 / atol 1e-3, the counter
    exact."""
    gains, z = random_states(N, 6)
    cfg, ch = configs(ref)
    pcfg, pch = port_configs()
    st = ps.init_state(pcfg, device="cpu")
    want_st = ref.scheduler.init_state(cfg)
    np.testing.assert_array_equal(st.z.numpy(), np.asarray(want_st.z))
    assert int(st.t) == int(want_st.t) == 0
    st = ps.SchedulerState(torch.from_numpy(z), st.t)
    gen = torch.Generator().manual_seed(6)
    u = draws_of(gen, lambda g: torch.rand(N, generator=g)).numpy()
    sel, q, p, st2 = ps.schedule_step(gen, torch.from_numpy(gains), st,
                                      pcfg, pch)
    wq, wp = ref.scheduler.solve_round(gains, z, cfg, ch)
    wsel = ref.scheduler.selection_from_uniform(u, wq, cfg.guarantee_one)
    want_st2 = ref.scheduler.update_queues(
        ref.scheduler.SchedulerState(z=ref.jnp.asarray(z), t=want_st.t),
        wq, wp, ch)
    far = np.abs(u - np.asarray(wq)) > 1e-6
    np.testing.assert_array_equal(sel.numpy()[far], np.asarray(wsel)[far])
    np.testing.assert_allclose(q.numpy(), np.asarray(wq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(wp), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(st2.z.numpy(), np.asarray(want_st2.z),
                               rtol=1e-5, atol=1e-3)
    assert int(st2.t) == int(want_st2.t) == 1
    # sample_selection on q's that draw nobody: the argmax is forced
    q_low = torch.full((N,), 1e-9)
    q_low[17] = 2e-9
    u = draws_of(gen, lambda g: torch.rand(N, generator=g)).numpy()
    got = ps.sample_selection(gen, q_low)
    want = ref.scheduler.selection_from_uniform(u, q_low.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() == 1 and got[17]


@pytest.mark.parametrize("m_avg", [0.4, 7.5, 40.0])
def test_uniform_selection_on_shared_draws(ref, m_avg):
    """uniform_selection: the selection, q and P exact against the
    reference's baseline on the same take and scores."""
    n = 40
    _, ch = configs(ref, n)
    _, pch = port_configs(n)
    gen = torch.Generator().manual_seed(int(m_avg * 10))

    def raw(g):
        return {"take": torch.rand((), generator=g).numpy(),
                "scores": torch.rand((n,), generator=g).numpy()}

    want = ref.scheduler.uniform_decide(
        draws_of(gen, raw), ref.scheduler.uniform_coeffs(n, m_avg, ch))
    got = ps.uniform_selection(gen, n, m_avg, pch, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uplink_times(ref):
    """TDMA time over a selection and its expectation under q: rtol 1e-6
    (one log2, one division a lane, float32 sums)."""
    gains, _ = random_states(N, 7)
    rng = np.random.default_rng(7)
    p = rng.uniform(0, 100, N).astype(np.float32)
    q = rng.uniform(0, 1, N).astype(np.float32)
    sel = rng.uniform(0, 1, N) < 0.3
    bits = 32 * 555178.0
    _, ch = configs(ref)
    _, pch = port_configs()
    t = (torch.from_numpy(x) for x in (gains, p))
    want = ref.channel.uplink_time(gains, p, sel, bits, ch)
    got = pc.uplink_time(*t, torch.from_numpy(sel), bits, pch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = ref.channel.expected_uplink_time(gains, p, q, bits, ch)
    got = pc.expected_uplink_time(torch.from_numpy(gains),
                                  torch.from_numpy(p), torch.from_numpy(q),
                                  bits, pch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dist", ["homogeneous", "heterogeneous", "array"])
@pytest.mark.parametrize("n", [10, 100, 3597])
def test_resolve_sigmas(ref, dist, n):
    """Named distributions and an explicit array, exact; the reference's
    rounding of the heterogeneous fractions (360/1,439/1,798 at FEMNIST's
    3,597, not the paper's 500/1,500/1,597)."""
    arg = (np.linspace(0.1, 2.0, n).astype(np.float32) if dist == "array"
           else dist)
    want = np.asarray(ref.channel.resolve_sigmas(arg, n))
    got = pc.resolve_sigmas(arg, n, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    if dist == "heterogeneous" and n == 3597:
        counts = [int((got == np.float32(s)).sum()) for s in (0.2, 0.75, 1.2)]
        assert counts == [360, 1439, 1798]
    assert set(pc.SIGMA_DISTS) == set(ref.channel.SIGMA_DISTS)


def test_resolve_sigmas_rejects(ref):
    with pytest.raises(ValueError, match="unknown sigma"):
        pc.resolve_sigmas("lognormal", 10, device="cpu")
    with pytest.raises(ValueError, match="want \\(10,\\)"):
        pc.resolve_sigmas(np.ones(9, np.float32), 10, device="cpu")


def test_draw_gains(ref):
    """draw_gains is the rayleigh apply of the generator's next uniforms
    (the reference's body on the same uniforms: rtol 1e-6), clipped."""
    n = 500
    cfg = ref.channel.ChannelConfig(n_clients=n)
    sig = pc.heterogeneous_sigmas(n, device="cpu")
    gen = torch.Generator().manual_seed(8)
    u = draws_of(gen, lambda g: pc._rayleigh_draw(g, n, "cpu")).numpy()
    got = pc.draw_gains(gen, sig, pc.ChannelConfig(n_clients=n)).numpy()
    want, _ = ref.channel._rayleigh_apply(u, None, sig.numpy(), cfg)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    lo, hi = cfg.gain_bounds()
    assert (got >= np.float32(lo)).all() and (got <= np.float32(hi)).all()


@pytest.mark.parametrize("states", ["random", "boundary"])
def test_scheduler_solve_ref(ref, states):
    """K1's oracle against the reference's: q at rtol 1e-5 / atol 1e-6,
    P at rtol 1e-5 / atol 1e-3 (tests/test_scheduler_solve_pallas.py)."""
    from repro_torch.kernels.ref import scheduler_solve_ref

    gains, z = (random_states(N, 9) if states == "random"
                else boundary_states(N))
    kw = dict(n=N, v=1000.0, lam=10.0, ell=32 * 444062.0, bandwidth=22e6,
              noise=1.0, p_max=100.0, p_bar=1.0)
    want = ref.ref.scheduler_solve_ref(gains, z, **kw)
    got = scheduler_solve_ref(torch.from_numpy(gains), torch.from_numpy(z),
                              **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-3)


def test_corollary1_bound(ref):
    """The accumulator over five rounds of q, the bound and the per-round
    sampling term: rtol 1e-6 (float32 sums of reciprocals)."""
    from repro_torch.core import bound as pb

    rng = np.random.default_rng(10)
    c = dict(gamma=0.01, L=2.0, G2=3.0, I=10, n_clients=N)
    acc = pb.init_accumulator(device="cpu")
    want_acc = ref.bound.init_accumulator()
    for _ in range(5):
        q = rng.uniform(0.05, 1.0, N).astype(np.float32)
        acc = pb.accumulate(acc, torch.from_numpy(q))
        want_acc = ref.bound.accumulate(want_acc, q)
        np.testing.assert_allclose(
            float(pb.sampling_term_per_round(torch.from_numpy(q),
                                             pb.BoundConstants(**c))),
            float(ref.bound.sampling_term_per_round(
                q, ref.bound.BoundConstants(**c))), rtol=1e-6)
    assert int(acc.rounds) == int(want_acc.rounds) == 5
    np.testing.assert_allclose(float(acc.inv_q_sum),
                               float(want_acc.inv_q_sum), rtol=1e-6)
    for f0 in (0.0, 2.5):
        np.testing.assert_allclose(
            float(pb.corollary1_bound(acc, pb.BoundConstants(**c), f0)),
            float(ref.bound.corollary1_bound(
                want_acc, ref.bound.BoundConstants(**c), f0)), rtol=1e-6)
    # a fresh accumulator divides by max(t, 1)
    np.testing.assert_allclose(
        float(pb.corollary1_bound(pb.init_accumulator(device="cpu"),
                                  pb.BoundConstants(**c), 1.0)),
        float(ref.bound.corollary1_bound(
            ref.bound.init_accumulator(), ref.bound.BoundConstants(**c),
            1.0)), rtol=1e-6)


def test_all_configs_and_ssd_auto(ref):
    """all_configs maps every ported id to the reference's config; ssd_auto
    on CPU tensors is the sequential oracle, as the reference's off a TPU
    (rtol 1e-5 / atol 1e-5: float32 einsums in two frameworks)."""
    import dataclasses

    from repro_torch import configs as pcfgs
    from repro_torch.kernels import ops as pops

    got = pcfgs.all_configs()
    want = ref.configs.all_configs()
    assert list(got) == [k for k in want if k in got]
    assert list(got) == list(want)
    assert set(got) == set(pcfgs.PORTED_IDS) == set(pcfgs.ARCH_IDS)
    for name, cfg in got.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want[name])
    rng = np.random.default_rng(11)
    b, s, h, p, n = 1, 40, 2, 8, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    want = ref.ops.ssd_auto(x, dt, a, bm, cm, chunk=16)
    got = pops.ssd_auto(*(torch.from_numpy(v) for v in (x, dt, a, bm, cm)),
                        chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
