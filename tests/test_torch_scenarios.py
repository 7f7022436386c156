"""The fading-model registry and the policy registry against the
reference, with and without activity masks (the mirror of the
reference's tests/test_channel_models.py, tests/test_policies.py and the
policy-level cases of tests/test_population.py).

* every channel's ``init`` and ``apply`` on the reference's own draws,
  10 rounds at N = 48: gains and state at rtol 1e-6 (float32 ops in two
  frameworks), the outage indicator and the outage floor exact;
* the registries' names, ids and parameter checks; the channels'
  statistics on the port's own generator (K -> 0 Rician is Rayleigh, the
  Gauss-Markov autocorrelation, mobility is Gauss-Markov bit for bit,
  the outage floor and marginal), the matched M under a channel against
  the reference's at rtol 1e-5;
* all six policies (and two with params) against the reference's steps
  over 5 rounds at N = 40, unmasked and under masks leaving 1, 7 and 40
  lanes active: selections exact where |u - q| > 1e-6, q and P at rtol
  1e-6 for the baselines (the solve's rtol 1e-5 / atol 1e-6 and 1e-5 /
  1e-3 for ``proposed``), aux exact, Z at rtol 1e-5; the all-True mask
  equal to no mask bit for bit;
* the masked policies' contracts: inactive lanes never selected with
  q = 0, Z drains by p_bar while away, M' clipped into the active count.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.core import channel as pc  # noqa: E402
from repro_torch.core import policies as pp  # noqa: E402
from repro_torch.core import scheduler as ps  # noqa: E402
from repro_torch.fl.decision import decision_coeffs  # noqa: E402
from repro_torch.fl.simulation import match_uniform_m  # noqa: E402

N = 48
BITS = 32 * 50000.0
CHANNELS = [("rayleigh", {}), ("rician", {}), ("rician", {"k_factor": 2.0}),
            ("lognormal", {}), ("lognormal", {"shadow_db": 6.0}),
            ("gauss_markov", {}), ("gauss_markov", {"rho": 0.5}),
            ("mobility", {}), ("mobility", {"speed_mps": 3.0,
                                            "carrier_hz": 5.9e9}),
            ("outage_burst", {}),
            ("outage_burst", {"outage_p": 0.2, "burst_len": 4.0})]


@pytest.fixture(scope="module")
def ref():
    return reference()


def sigmas_np(n=N):
    return np.repeat(np.float32([0.2, 0.75, 1.2]),
                     [n // 6, n // 3, n - n // 6 - n // 3])


def to_torch(raw):
    if isinstance(raw, tuple):
        return tuple(to_torch(x) for x in raw)
    return torch.from_numpy(np.array(raw))


# --------------------------------------------------------------------------
# Channels.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,params", CHANNELS,
                         ids=[f"{n}-{'-'.join(p) or 'default'}"
                              for n, p in CHANNELS])
def test_channel_init_and_apply_match_reference(ref, name, params):
    """init on the reference's init raw, then 10 rounds of apply on its
    round raws: gains and state at rtol 1e-6; outage lanes exactly at the
    floor in both, the indicator exact."""
    jax = ref.jax
    sig = sigmas_np()
    ch = ref.channel.ChannelConfig(n_clients=N)
    pch = pc.ChannelConfig(n_clients=N)
    key = jax.random.PRNGKey(11)
    init_fn, _ = ref.channel.CHANNEL_MODELS[name]
    draw, apply = ref.channel.CHANNEL_RAW[name]
    k0 = jax.random.fold_in(key, 0x6368)
    want_st = init_fn(k0, ref.jnp.asarray(sig), ch, **params)
    model = pc.make_channel(name, torch.from_numpy(sig), pch, **params)
    init_raw = {"gauss_markov": lambda: jax.random.normal(k0, (2, N)),
                "mobility": lambda: jax.random.normal(k0, (2, N)),
                "outage_burst": lambda: jax.random.uniform(k0, (N,))}.get(
                    name, lambda: None)()
    st = model.init(None if init_raw is None else to_torch(init_raw))
    assert st.shape == (2, N) and st.dtype == torch.float32
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), rtol=1e-6)
    floor = np.float32(ref.channel._outage_gain_floor(ch))
    for k in jax.random.split(key, 10):
        raw = draw(k, N)
        want_g, want_st = apply(raw, want_st, ref.jnp.asarray(sig), ch,
                                **params)
        gains, st = model.apply(to_torch(raw), st)
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(gains.numpy(), want_g, rtol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   rtol=1e-6, atol=1e-7)
        if name == "outage_burst":
            np.testing.assert_array_equal(st.numpy(), np.asarray(want_st))
            np.testing.assert_array_equal(gains.numpy() == floor,
                                          want_g == floor)


def test_registry_names_ids_and_params(ref):
    """The reference's names in its order and its ids; unknown names and
    parameters raise; the outage floor and mobility_rho are the
    reference's, exactly."""
    assert list(pc.CHANNEL_MODELS) == list(ref.channel.CHANNEL_MODELS)
    assert list(pc.CHANNEL_RAW) == list(ref.channel.CHANNEL_RAW)
    assert pc.CHANNEL_IDS == ref.channel.CHANNEL_IDS
    sig = pc.homogeneous_sigmas(N, device="cpu")
    ch = pc.ChannelConfig(n_clients=N)
    with pytest.raises(ValueError, match="unknown channel"):
        pc.make_channel("awgn", sig, ch)
    with pytest.raises(ValueError, match="channel_params"):
        pc.make_channel("rayleigh", sig, ch, rho=0.9)
    with pytest.raises(ValueError, match="channel_params"):
        pc.make_channel("gauss_markov", sig, ch, k_factor=2.0)
    assert pc._outage_gain_floor(ch) == ref.channel._outage_gain_floor(
        ref.channel.ChannelConfig(n_clients=N))
    for kw in ({}, {"speed_mps": 30.0}, {"carrier_hz": 28e9},
               {"speed_mps": 0.0}, {"round_s": 0.05}):
        assert pc.mobility_rho(**kw) == ref.channel.mobility_rho(**kw)
    assert pp.POLICY_IDS == ref.policies.POLICY_IDS
    assert list(pp.POLICIES) == list(ref.policies.POLICIES)
    assert {k: v[2] for k, v in pp.POLICIES.items()} == {
        k: v[2] for k, v in ref.policies.POLICIES.items()}
    assert list(pp.POLICY_DRAWS) == list(ref.policies.POLICY_DRAWS)


def rollout(name, rounds, seed, n=64, **params):
    """(rounds, n) gains of a model on the port's generator, sigma = 1."""
    sig = pc.homogeneous_sigmas(n, device="cpu")
    model = pc.make_channel(name, sig, pc.ChannelConfig(n_clients=n),
                            **params)
    gen = torch.Generator().manual_seed(seed)
    st = model.init(model.draw_init(gen))
    out = []
    for _ in range(rounds):
        gains, st = model.step(gen, st)
        out.append(gains)
    return torch.stack(out).numpy()


def test_state_contract_and_rayleigh_is_draw_gains():
    """Every model: a (2, N) float32 state, gains within the clip range;
    rayleigh's step is draw_gains on the same generator, state untouched."""
    n = 64
    sig = pc.homogeneous_sigmas(n, device="cpu")
    ch = pc.ChannelConfig(n_clients=n)
    lo, hi = ch.gain_bounds()
    for name in pc.CHANNEL_MODELS:
        model = pc.make_channel(name, sig, ch)
        gen = torch.Generator().manual_seed(0)
        st = model.init(model.draw_init(gen))
        assert st.shape == (2, n) and st.dtype == torch.float32, name
        gains, st2 = model.step(gen, st)
        assert gains.shape == (n,) and st2.shape == (2, n), name
        assert float(gains.min()) >= np.float32(lo), name
        assert float(gains.max()) <= np.float32(hi), name
    model = pc.make_channel("rayleigh", sig, ch)
    gains, st = model.step(torch.Generator().manual_seed(3),
                           pc.channel_state_zero(n, "cpu"))
    assert torch.equal(gains, pc.draw_gains(torch.Generator().manual_seed(3),
                                            sig, ch))
    assert not st.any()


def test_rician_and_lognormal_statistics():
    """K -> 0 Rician has Rayleigh's mean 2 and std 2; a strong LOS keeps
    the mean and collapses the spread; log-normal shadowing keeps the mean
    and widens the spread (the reference's bounds)."""
    ray = rollout("rayleigh", 400, 4)
    ric = rollout("rician", 400, 4, k_factor=1e-6)
    assert abs(ric.mean() - ray.mean()) < 0.1
    assert abs(ric.std() - ray.std()) < 0.15
    assert abs(ric.mean() - 2.0) < 0.1
    strong = rollout("rician", 200, 5, k_factor=50.0)
    assert abs(strong.mean() - 2.0) < 0.1
    assert strong.std() < 0.3 * ray.std()
    logn = rollout("lognormal", 400, 6, shadow_db=6.0)
    assert abs(logn.mean() - ray.mean()) < 0.2
    assert logn.std() > 1.2 * ray.std()


@pytest.mark.parametrize("rho", [0.0, 0.9])
def test_gauss_markov_autocorrelation(rho):
    """corr(|g_t|^2, |g_t+1|^2) = rho^2 within 0.05, mean 2 within 0.1;
    the stationary init starts at full power."""
    g = rollout("gauss_markov", 3000, 7, rho=rho)
    corr = np.corrcoef(g[:-1].ravel(), g[1:].ravel())[0, 1]
    assert abs(corr - rho ** 2) < 0.05, (corr, rho)
    assert abs(g.mean() - 2.0) < 0.1
    early = rollout("gauss_markov", 40, 8, rho=0.95)
    assert 1.0 < early[0].mean() < 3.5
    assert 1.2 < early[:5].mean() < 3.0


def test_mobility_is_gauss_markov_bitwise():
    """mobility is gauss_markov at mobility_rho, bit for bit, and its
    power autocorrelation is rho^2 at a vehicular speed."""
    kw = dict(speed_mps=3.0, carrier_hz=5.9e9, round_s=0.02)
    np.testing.assert_array_equal(
        rollout("mobility", 50, 9, **kw),
        rollout("gauss_markov", 50, 9, rho=pc.mobility_rho(**kw)))
    kw = dict(speed_mps=10.0, carrier_hz=2.4e9, round_s=0.01)
    g = rollout("mobility", 3200, 13, **kw)
    corr = np.corrcoef(g[:-1].ravel(), g[1:].ravel())[0, 1]
    assert abs(corr - pc.mobility_rho(**kw) ** 2) < 0.05
    assert 0.0 < pc.mobility_rho(120.0 / 3.6) < pc.mobility_rho(1.5) < 1.0
    assert pc.mobility_rho(0.0) == 1.0


def test_outage_burst_validation_floor_and_marginal():
    """Unreachable rates raise at init; outage gains sit at the floor,
    which is >= the float64 clip bound; the stationary outage fraction is
    outage_p within 4.5 sigma of the sticky chain's inflated variance."""
    sig = pc.homogeneous_sigmas(N, device="cpu")
    ch = pc.ChannelConfig(n_clients=N)
    for bad in (dict(outage_p=-0.1), dict(outage_p=1.0),
                dict(burst_len=0.5), dict(outage_p=0.9, burst_len=2.0)):
        with pytest.raises(ValueError):
            pc.make_channel("outage_burst", sig, ch, **bad).init(
                torch.rand(N))
    lo, _ = ch.gain_bounds()
    floor = pc._outage_gain_floor(ch)
    g = rollout("outage_burst", 200, 11, outage_p=0.5, burst_len=3.0)
    assert floor >= lo and float(g.min()) >= float(np.float32(lo))
    assert (g == np.float32(floor)).mean() > 0.2
    outage_p, burst_len, rounds, n = 0.2, 4.0, 1600, 64
    g = rollout("outage_burst", rounds, 12, n=n, outage_p=outage_p,
                burst_len=burst_len)
    frac = float((g == np.float32(floor)).mean())
    p_rec = 1.0 / burst_len
    p_ent = outage_p * p_rec / (1.0 - outage_p)
    r = 1.0 - p_ent - p_rec
    sigma = np.sqrt(outage_p * (1 - outage_p) * (1 + r) / (1 - r)
                    / (rounds * n))
    assert abs(frac - outage_p) < 4.5 * sigma, (frac, 4.5 * sigma)


@pytest.mark.parametrize("channel,params", [
    ("gauss_markov", (("rho", 0.8),)), ("outage_burst", ()),
    ("lognormal", ())])
def test_match_uniform_m_under_a_channel(ref, channel, params):
    """match_uniform_m under a channel on the reference's raws (its init
    on fold_in(key, 1), a draw per split key): rtol 1e-5; rayleigh with
    params is an error."""
    jax = ref.jax
    n, rounds = 40, 60
    cfg = ref.scheduler.SchedulerConfig(n_clients=n, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=n)
    sig = ref.channel.heterogeneous_sigmas(n)
    key = jax.random.PRNGKey(5)
    want = ref.simulation.match_uniform_m(key, sig, cfg, ch, rounds=rounds,
                                          channel=channel,
                                          channel_params=params)
    draw = ref.channel.CHANNEL_RAW[channel][0]
    raws = [draw(k, n) for k in jax.random.split(key, rounds)]
    raws = (tuple(torch.as_tensor(np.stack([np.asarray(r[i]) for r in raws]))
                  for i in range(2)) if isinstance(raws[0], tuple)
            else torch.as_tensor(np.stack([np.asarray(r) for r in raws])))
    k1 = jax.random.fold_in(key, 1)
    init = {"gauss_markov": lambda: jax.random.normal(k1, (2, n)),
            "outage_burst": lambda: jax.random.uniform(k1, (n,))}.get(
                channel, lambda: None)()
    got = match_uniform_m(
        None, torch.tensor(np.array(sig)),
        ps.SchedulerConfig(n_clients=n, model_bits=BITS),
        pc.ChannelConfig(n_clients=n), rounds=rounds, channel=channel,
        channel_params=params, raws=raws,
        init_raw=None if init is None else to_torch(init))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="channel_params"):
        match_uniform_m(None, torch.tensor(np.array(sig)),
                        ps.SchedulerConfig(n_clients=n, model_bits=BITS),
                        pc.ChannelConfig(n_clients=n), rounds=2,
                        channel_params=(("rho", 0.9),))


# --------------------------------------------------------------------------
# Policies.
# --------------------------------------------------------------------------

NP = 40
POLICY_CASES = [("proposed", {}), ("uniform", {}), ("greedy_channel", {}),
                ("proportional_gain", {}), ("update_aware", {}),
                ("aoi_capped", {}), ("proportional_gain", {"q_floor": 0.05}),
                ("aoi_capped", {"max_age": 2})]


def mask_of(n_active):
    """An N = 40 activity mask with ``n_active`` lanes on, spread over the
    arena (None: no mask)."""
    if n_active is None:
        return None
    on = np.random.default_rng(n_active).permutation(NP)[:n_active]
    mask = np.zeros(NP, bool)
    mask[on] = True
    return mask


def policy_configs(ref, guarantee_one=True):
    cfg = ref.scheduler.SchedulerConfig(n_clients=NP, model_bits=BITS,
                                        guarantee_one=guarantee_one)
    ch = ref.channel.ChannelConfig(n_clients=NP)
    pcfg = ps.SchedulerConfig(n_clients=NP, model_bits=BITS,
                              guarantee_one=guarantee_one)
    pch = pc.ChannelConfig(n_clients=NP)
    return cfg, ch, pcfg, pch


def port_raw(ref, name, k):
    """The port step's raw: what the reference step draws from ``k``."""
    stream = pp.POLICY_RAW[name]
    if stream == "selection_u":
        return torch.as_tensor(np.asarray(
            ref.policies.draw_selection_uniform(k, NP)))
    if stream == "uniform_raw":
        return {k_: torch.as_tensor(np.asarray(v))
                for k_, v in ref.policies._draw_uniform(k, NP).items()}
    return ()


@pytest.mark.parametrize("n_active", [None, 1, 7, 40],
                         ids=["unmasked", "1", "7", "40"])
@pytest.mark.parametrize("name,params", POLICY_CASES,
                         ids=[n + ("-" + "-".join(p) if p else "")
                              for n, p in POLICY_CASES])
def test_policy_steps_match_reference(ref, name, params, n_active):
    """5 rounds of the reference's step and the port's on the same gains
    and draws, the state carried: sel exact where |u - q| > 1e-6, q and P
    at rtol 1e-6 (proposed: the solve's tolerances), aux exact, Z at rtol
    1e-5 / atol 1e-3; masked: inactive lanes unselected with q = 0. The
    all-True mask equals the unmasked step bit for bit in the port."""
    jax = ref.jax
    cfg, ch, pcfg, pch = policy_configs(ref)
    co = ref.decision.decision_coeffs(cfg, ch)
    pco = decision_coeffs(pcfg, pch)
    m_avg = 6.0 if pp.POLICIES[name][2] else 0.0
    want_step = ref.policies.make_policy(name, cfg, ch, m_avg=m_avg,
                                         coeffs=co.solve, **params)
    step = pp.make_policy(name, pcfg, pch, m_avg=m_avg, coeffs=pco.solve,
                          **params)
    mask = mask_of(n_active)
    extra = () if mask is None else (ref.jnp.asarray(mask),
                                     ref.jnp.int32(mask.sum()))
    pextra = () if mask is None else (torch.from_numpy(mask),
                                      torch.tensor(int(mask.sum()),
                                                   dtype=torch.int32))
    want_st = ref.policies.init_policy_state(name, NP)
    st = pp.init_policy_state(name, NP, "cpu")
    np.testing.assert_array_equal(st.aux.numpy(), np.asarray(want_st.aux))
    key = jax.random.PRNGKey(21)
    rng = np.random.default_rng(21)
    tol = ((1e-5, 1e-6), (1e-5, 1e-3)) if name == "proposed" else (
        (1e-6, 0.0), (1e-6, 0.0))
    for r, k in enumerate(jax.random.split(key, 5)):
        gains = np.exp(rng.standard_normal(NP) * 1.5).astype(np.float32)
        if r == 0 and name == "proposed":
            # non-zero queues so the interior candidate is exercised
            z = (np.abs(rng.standard_normal(NP)) * 5).astype(np.float32)
            want_st = want_st._replace(z=ref.jnp.asarray(z))
            st = st._replace(z=torch.from_numpy(z))
        w_sel, w_q, w_p, want_st = want_step(k, ref.jnp.asarray(gains),
                                             want_st, *extra)
        raw = port_raw(ref, name, k)
        sel, q, p, st = step(raw, torch.from_numpy(gains), st, *pextra)
        w_sel, w_q, w_p = (np.asarray(x) for x in (w_sel, w_q, w_p))
        if isinstance(raw, torch.Tensor):
            far = np.abs(raw.numpy() - w_q) > 1e-6
        else:
            far = np.ones(NP, bool)
        np.testing.assert_array_equal(sel.numpy()[far], w_sel[far])
        np.testing.assert_allclose(q.numpy(), w_q, rtol=tol[0][0],
                                   atol=tol[0][1])
        np.testing.assert_allclose(p.numpy(), w_p, rtol=tol[1][0],
                                   atol=tol[1][1])
        np.testing.assert_array_equal(st.aux.numpy(), np.asarray(want_st.aux))
        np.testing.assert_allclose(st.z.numpy(), np.asarray(want_st.z),
                                   rtol=1e-5, atol=1e-3)
        assert int(st.t) == int(want_st.t) == r + 1
        assert sel.any()
        if mask is not None:
            assert not sel.numpy()[~mask].any()
            np.testing.assert_array_equal(q.numpy()[~mask], 0.0)
        if n_active == NP:
            st0 = st._replace(t=st.t - 1)
            base = step(raw, torch.from_numpy(gains), st0)
            prev = step(raw, torch.from_numpy(gains), st0, *pextra)
            for a, b in zip(base[:3] + (base[3].z, base[3].aux),
                            prev[:3] + (prev[3].z, prev[3].aux)):
                assert torch.equal(a, b)


def test_policy_registry_contract():
    """make_policy: unknown names and unknown params raise, a baseline
    needs m_avg > 0; every policy's step keeps the shared shapes and
    dtypes, advances t and selects someone; the baselines meet the power
    budget instantaneously (the reference's tests/test_policies.py)."""
    n = 50
    scfg = ps.SchedulerConfig(n_clients=n, model_bits=BITS)
    ch = pc.ChannelConfig(n_clients=n)
    with pytest.raises(ValueError, match="unknown policy"):
        pp.make_policy("fedavg", scfg, ch)
    with pytest.raises(ValueError, match="m_avg"):
        pp.make_policy("uniform", scfg, ch)
    with pytest.raises(ValueError, match="policy_params"):
        pp.make_policy("proposed", scfg, ch, q_floor=0.1)
    with pytest.raises(ValueError, match="unknown policy"):
        pp.init_policy_state("fedavg", n, "cpu")
    gen = torch.Generator().manual_seed(2)
    gains = pc.draw_gains(gen, pc.homogeneous_sigmas(n, device="cpu"), ch)
    u = torch.rand(n, generator=gen)
    uni = {"take": torch.rand((), generator=gen),
           "scores": torch.rand(n, generator=gen)}
    for name in pp.POLICIES:
        step = pp.make_policy(name, scfg, ch, m_avg=5.0)
        st = pp.init_policy_state(name, n, "cpu")
        raw = {"selection_u": u, "uniform_raw": uni, None: ()}[
            pp.POLICY_RAW[name]]
        sel, q, p, st2 = step(raw, gains, st)
        assert sel.shape == q.shape == p.shape == (n,), name
        assert sel.dtype == torch.bool and q.dtype == torch.float32, name
        assert st2.z.shape == (n,) and st2.aux.shape == (n,), name
        assert int(st2.t) == int(st.t) + 1 and sel.any(), name
        assert bool(((q >= 0) & (q <= 1)).all()), name
        if name != "proposed":
            assert float((p * sel).sum()) <= ch.p_bar * n * 1.01, name
    assert float(pp.init_policy_state("update_aware", n, "cpu").aux.min()) \
        == 1.0


def test_greedy_and_proportional_gain_functions(ref):
    """greedy_channel picks the top m channels; proportional_gain's q is
    positive, monotone in the gain and sums to ~M; both equal the
    reference's functions on the same inputs (q at rtol 1e-6)."""
    n = 50
    ch = pc.ChannelConfig(n_clients=n)
    rch = ref.channel.ChannelConfig(n_clients=n)
    gains = torch.arange(1.0, 51.0)
    sel, q, p = pp.greedy_channel((), gains, 5, ch)
    assert int(sel.sum()) == 5 and sel[-5:].all() and not sel[:45].any()
    w = ref.policies.greedy_channel(None, gains.numpy(), 5, rch)
    for a, b in zip((sel, q, p), w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    key = ref.jax.random.PRNGKey(1)
    g = np.asarray(ref.channel.draw_gains(
        key, ref.channel.homogeneous_sigmas(n), rch))
    sel, q, p = pp.proportional_gain(
        torch.as_tensor(np.asarray(ref.jax.random.uniform(key, (n,)))),
        torch.from_numpy(g), 6.0, ch)
    w_sel, w_q, w_p = ref.policies.proportional_gain(key, g, 6.0, rch)
    np.testing.assert_allclose(q.numpy(), np.asarray(w_q), rtol=1e-6)
    np.testing.assert_array_equal(p.numpy(), np.asarray(w_p))
    assert bool((q > 0).all() and (q <= 1).all())
    assert abs(float(q.sum()) - 6.0) < 1.5
    order = torch.argsort(torch.from_numpy(g))
    assert bool((torch.diff(q[order]) >= -1e-7).all())


def run_policy(name, rounds, seed, n=50, **params):
    """``rounds`` steps of a policy on Rayleigh gains (sigma 1) from the
    port's generator: the stacked (sel, q)."""
    scfg = ps.SchedulerConfig(n_clients=n, model_bits=BITS)
    ch = pc.ChannelConfig(n_clients=n)
    step = pp.make_policy(name, scfg, ch, m_avg=5.0, **params)
    st = pp.init_policy_state(name, n, "cpu")
    gen = torch.Generator().manual_seed(seed)
    sig = pc.homogeneous_sigmas(n, device="cpu")
    sels, qs = [], []
    for _ in range(rounds):
        gains = pc.draw_gains(gen, sig, ch)
        sel, q, _, st = step(torch.rand(n, generator=gen), gains, st)
        sels.append(sel)
        qs.append(q)
    return torch.stack(sels).numpy(), torch.stack(qs).numpy()


def test_update_aware_favors_stale_clients():
    """The update-norm proxy grows while a client is skipped, so stale
    clients get 1.5x the q of fresh ones, and everyone is scheduled."""
    sel, q = run_policy("update_aware", 200, 4)
    stale = np.zeros(50)
    qs_stale, qs_fresh = [], []
    for t in range(200):
        hi = stale > 5
        if hi.any() and (~hi).any():
            qs_stale.append(q[t][hi].mean())
            qs_fresh.append(q[t][~hi].mean())
        stale = np.where(sel[t], 0, stale + 1)
    assert np.mean(qs_stale) > 1.5 * np.mean(qs_fresh)
    assert sel.any(axis=0).all()


def test_aoi_capped_enforces_age_cap():
    """No client's age exceeds the cap; ~m selected a round."""
    cap = 8
    sel, _ = run_policy("aoi_capped", 120, 5, max_age=cap)
    age = np.zeros(50)
    for t in range(120):
        assert (age <= cap).all(), (t, age.max())
        age = np.where(sel[t], 0, age + 1)
    assert 3.0 <= sel.sum(axis=1).mean() <= 9.0


def test_proposed_policy_is_schedule_step():
    """The registry's Algorithm 2 is schedule_step on the same uniforms,
    bit for bit."""
    n = 50
    scfg = ps.SchedulerConfig(n_clients=n, model_bits=BITS)
    ch = pc.ChannelConfig(n_clients=n)
    gains = pc.draw_gains(torch.Generator().manual_seed(6),
                          pc.homogeneous_sigmas(n, device="cpu"), ch)
    u = torch.rand(n, generator=torch.Generator().manual_seed(7))
    got = pp.make_policy("proposed", scfg, ch)(
        u, gains, pp.init_policy_state("proposed", n, "cpu"))
    want = ps.schedule_step(torch.Generator().manual_seed(7), gains,
                            ps.init_state(scfg, "cpu"), scfg, ch)
    for a, b in zip(got[:3] + (got[3].z,), want[:3] + (want[3].z,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(pp.POLICIES))
def test_inactive_lanes_never_selected_q_zero(ref, name):
    """Masked steps on random half-active masks: inactive lanes are never
    selected, their q is exactly 0, everything stays finite; the same as
    the reference's selections where |u - q| > 1e-6."""
    n = 16
    cfg = ref.scheduler.SchedulerConfig(n_clients=n, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=n)
    pcfg = ps.SchedulerConfig(n_clients=n, model_bits=BITS)
    pch = pc.ChannelConfig(n_clients=n)
    m_avg = 6.0 if pp.POLICIES[name][2] else 0.0
    step = pp.make_policy(name, pcfg, pch, m_avg=m_avg,
                          coeffs=decision_coeffs(pcfg, pch).solve)
    want_step = ref.policies.make_policy(
        name, cfg, ch, m_avg=m_avg,
        coeffs=ref.decision.decision_coeffs(cfg, ch).solve)
    jax = ref.jax
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        gains = np.asarray(jax.numpy.exp(jax.random.normal(
            jax.random.fold_in(key, 1), (n,))))
        active = np.array(jax.random.uniform(jax.random.fold_in(key, 2),
                                             (n,)) < 0.5)
        active[0] = True
        w = want_step(key, gains, ref.policies.init_policy_state(name, n),
                      active, ref.jnp.int32(active.sum()))
        raw = {"selection_u": lambda: torch.as_tensor(np.asarray(
                   ref.policies.draw_selection_uniform(key, n))),
               "uniform_raw": lambda: {
                   k: torch.as_tensor(np.asarray(v)) for k, v in
                   ref.policies._draw_uniform(key, n).items()},
               None: lambda: ()}[pp.POLICY_RAW[name]]()
        sel, q, p, st1 = step(raw, torch.from_numpy(gains),
                              pp.init_policy_state(name, n, "cpu"),
                              torch.from_numpy(active),
                              torch.tensor(int(active.sum())))
        assert not sel.numpy()[~active].any(), name
        np.testing.assert_array_equal(q.numpy()[~active], 0.0)
        assert torch.isfinite(q).all() and torch.isfinite(p).all()
        assert torch.isfinite(st1.z).all()
        far = (np.abs(raw.numpy() - np.asarray(w[1])) > 1e-6
               if isinstance(raw, torch.Tensor) else np.ones(n, bool))
        np.testing.assert_array_equal(sel.numpy()[far],
                                      np.asarray(w[0])[far])


def test_inactive_z_drains_by_p_bar():
    """Eq. 9 with q masked to 0: an inactive lane's queue becomes
    max(z - p_bar, 0); active lanes are charged P q >= 0 on top."""
    n = 8
    scfg = ps.SchedulerConfig(n_clients=n, model_bits=BITS,
                              guarantee_one=False)
    ch = pc.ChannelConfig(n_clients=n)
    step = pp.make_policy("proposed", scfg, ch)
    st0 = pp.init_policy_state("proposed", n, "cpu")._replace(
        z=torch.full((n,), 5.0))
    gains = torch.exp(torch.randn(n, generator=torch.Generator()
                                  .manual_seed(0)))
    active = torch.arange(n) < 4
    _, _, _, st1 = step(torch.rand(n, generator=torch.Generator()
                                   .manual_seed(1)), gains, st0, active,
                        active.sum())
    expect = max(5.0 - ch.p_bar, 0.0)
    np.testing.assert_allclose(st1.z[4:].numpy(), expect, rtol=1e-6)
    assert (st1.z[:4] >= expect - 1e-6).all()


def test_uniform_draw_m_clips_to_active_count(ref):
    """M' clips into [1, max(n_active, 1)] under a mask, into [1, N]
    without; each as the reference's uniform_draw_m."""
    cases = [(True, 10.0, 1), (True, 10.0, 3), (True, 10.0, 7),
             (False, 4.5, 10), (False, 5.0, 0), (False, 3.5, None),
             (True, 3.5, None), (False, 0.2, None), (True, 20.0, None)]
    for take_hi, m_avg, n_active in cases:
        kw = {} if n_active is None else {"n_active": n_active}
        want = int(ref.scheduler.uniform_draw_m(
            ref.jnp.asarray(take_hi), ref.jnp.float32(m_avg), 12,
            **{k: ref.jnp.int32(v) for k, v in kw.items()}))
        got = int(ps.uniform_draw_m(
            torch.tensor(take_hi), torch.tensor(m_avg), torch.tensor(12),
            None if n_active is None else torch.tensor(n_active)))
        assert got == want, (take_hi, m_avg, n_active)
    assert int(ps.uniform_draw_m(torch.tensor(True), torch.tensor(10.0),
                                 torch.tensor(12), torch.tensor(3))) == 3
    assert int(ps.uniform_draw_m(torch.tensor(False), torch.tensor(5.0),
                                 torch.tensor(12), torch.tensor(0))) == 1


# --------------------------------------------------------------------------
# The sweep under a channel.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channel,params,policies", [
    ("gauss_markov", (("rho", 0.8),), ("update_aware", "proposed")),
    ("outage_burst", (("outage_p", 0.2), ("burst_len", 4.0)),
     ("aoi_capped", "proportional_gain")),
    ("mobility", (), ("greedy_channel", "uniform"))])
def test_sweep_under_a_channel_matches_reference(ref, channel, params,
                                                 policies):
    """run_sweep under a stateful channel on the reference's own draws
    (the seeds' (2, S, N) states, the matched M under the channel):
    n_selected exact, comm_time, power and avg_power at rtol 1e-5, the
    matched M at rtol 1e-5."""
    from test_torch_reference import ReplaySweepDraws, record_sweep_draws

    from repro_torch.fl.engine import run_sweep
    n, seeds, rounds, match = 40, (0, 3), 12, 60
    key = ref.jax.random.PRNGKey(8)
    cfg = ref.scheduler.SchedulerConfig(n_clients=n, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=n)
    want = ref.engine.run_sweep(key, ref.channel.heterogeneous_sigmas(n),
                                cfg, ch, rounds=rounds, seeds=seeds,
                                policies=policies, channel=channel,
                                channel_params=params, match_rounds=match)
    draws = ReplaySweepDraws(record_sweep_draws(ref, key, rounds, n, seeds,
                                                match, channel))
    got = run_sweep(draws, pc.heterogeneous_sigmas(n, device="cpu"),
                    ps.SchedulerConfig(n_clients=n, model_bits=BITS),
                    pc.ChannelConfig(n_clients=n), rounds=rounds,
                    seeds=seeds, policies=policies, channel=channel,
                    channel_params=params, match_rounds=match,
                    solver="cuda")
    np.testing.assert_allclose(got["uniform_m"], want["uniform_m"],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    for k in ("comm_time", "power", "avg_power"):
        assert got[k].shape == (2, len(seeds), rounds)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
