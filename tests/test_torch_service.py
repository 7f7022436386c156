"""The port's multi-tenant scheduler service (``repro_torch.service``)
against the reference service (``repro.service``) on the same tenants and
the same request stream, the reference's service contracts
(tests/test_service.py) held inside the port, and logs and snapshots
crossing between the two packages.

Across frameworks the port is held to the kernel tests' tolerances:
q rtol 1e-5 / atol 1e-6; P, power and Z rtol 1e-5 / atol 1e-3; t_comm
rtol 1e-5;
``sel`` exact on every lane where |u - q_ref| > 1e-6 (the baselines'
selections exactly); ``n_sel`` exact wherever ``sel`` is; round counters
exact. Inside the port (replay, restore, evict/reload, warmup, pad rows)
the contracts are bitwise, as in the reference. Everything runs on the CPU
(``device="cpu"``), where the kernels' wrappers run their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.core.channel import ChannelConfig  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.kernels.decision_fused import (  # noqa: E402
    decision_fused_batched)
from repro_torch.kernels.scheduler_solve import scheduler_solve  # noqa: E402
from repro_torch.service import RequestLog, SchedulerService  # noqa: E402

# (clients, tenants, policy, m_avg): proposed in two buckets (b32, b128),
# one uniform N = 40 tenant (b64), greedy N = 21 (b32, a bucket of its own)
MIX = ((24, 3, "proposed", 0.0), (100, 2, "proposed", 0.0),
       (40, 1, "uniform", 4.0), (21, 2, "greedy_channel", 3.0))
DOUBLE = "p24-0"          # submitted twice in flush 1
FLUSHES = 4
COMPACT_AFTER = 1         # the reference compacts its log after flush 1
SOLVERS = ("stitched", "cuda_fused")
N = 40


def tenant_table(seed=0):
    """[(name, n, policy, m_avg, scfg kwargs, ch kwargs)], each tenant its
    own V, lam, ell and Pmax."""
    rng = np.random.default_rng(seed)
    out = []
    for n, count, policy, m_avg in MIX:
        for i in range(count):
            out.append((f"{policy[0]}{n}-{i}", n, policy, m_avg,
                        dict(n_clients=n,
                             model_bits=float(rng.uniform(1e5, 1e7)),
                             lam=float(rng.uniform(0.5, 30.0)),
                             V=float(rng.uniform(10.0, 1e4))),
                        dict(n_clients=n,
                             p_max=float(rng.uniform(20.0, 150.0)))))
    return out


def add_tenants(svc, scfg_cls, ch_cls, table):
    for name, _, policy, m_avg, sk, ck in table:
        svc.add_tenant(name, scfg_cls(**sk), ch_cls(**ck), policy=policy,
                       m_avg=m_avg)


def request(rng, n, policy):
    gains = np.clip(-2.0 * np.log(rng.random(n, dtype=np.float32) + 1e-12),
                    1e-3, 1e3).astype(np.float32)
    if policy == "proposed":
        raw = rng.random(n, dtype=np.float32)
    elif policy == "uniform":
        raw = {"take": np.float32(rng.random()),
               "scores": rng.random(n, dtype=np.float32)}
    else:
        raw = ()
    return gains, raw


def stream(table, seed=1):
    """Per flush, the [(name, gains, raw)] requests in submission order."""
    rng = np.random.default_rng(seed)
    flushes = []
    for f in range(FLUSHES):
        reqs = [(name, *request(rng, n, policy))
                for name, n, policy, *_ in table]
        if f == 1:
            reqs += [(DOUBLE, *request(rng, 24, "proposed"))]
        flushes.append(reqs)
    return flushes


def serve(svc, flushes, compact_after=None):
    """Serve the stream; per flush the responses and every tenant's
    (z, t) after it."""
    out = []
    for f, reqs in enumerate(flushes):
        for name, gains, raw in reqs:
            svc.submit(name, gains, raw=raw)
        resp = svc.flush()
        states = {nm: svc.tenant_state(nm) for nm in resp}
        out.append((resp, states))
        if f == compact_after:
            svc.compact_log()
    return out


def port_service(solver="cuda_fused", table=None, **kw):
    svc = SchedulerService(solver=solver, device="cpu", **kw)
    add_tenants(svc, SchedulerConfig, ChannelConfig,
                tenant_table() if table is None else table)
    return svc


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference service (solver="jnp") on the shared stream; its
    compacted log and final state saved to npz."""
    ref = reference()
    from repro.core import ChannelConfig as RC
    from repro.core import SchedulerConfig as RS
    from repro.service import SchedulerService as RefService
    table, flushes = tenant_table(), stream(tenant_table())
    svc = RefService(solver="jnp")
    add_tenants(svc, RS, RC, table)
    served = serve(svc, flushes, compact_after=COMPACT_AFTER)
    tmp = tmp_path_factory.mktemp("ref_service")
    svc.log.save(str(tmp / "log.npz"))
    svc.save(str(tmp / "state.npz"))
    final = {name: svc.tenant_state(name) for name, *_ in table}
    return dict(ref=ref, RC=RC, RS=RS, RefService=RefService, table=table,
                flushes=flushes, served=served, tmp=tmp, final=final)


def raws_of(reqs):
    """name -> the raws of its LAST request in a flush."""
    return {name: raw for name, _, raw in reqs}


def assert_decision_close(got, want, raw, msg=""):
    np.testing.assert_allclose(got.q, want.q, rtol=1e-5, atol=1e-6,
                               err_msg=f"q {msg}")
    np.testing.assert_allclose(got.p, want.p, rtol=1e-5, atol=1e-3,
                               err_msg=f"p {msg}")
    np.testing.assert_allclose(got.t_comm, want.t_comm, rtol=1e-5,
                               err_msg=f"t_comm {msg}")
    np.testing.assert_allclose(got.power, want.power, rtol=1e-5, atol=1e-3,
                               err_msg=f"power {msg}")
    far = (np.abs(raw - np.asarray(want.q)) > 1e-6
           if isinstance(raw, np.ndarray) else np.ones(want.sel.shape, bool))
    np.testing.assert_array_equal(got.sel[far], np.asarray(want.sel)[far],
                                  err_msg=f"sel {msg}")
    if far.all():
        assert int(got.n_sel) == int(want.n_sel), f"n_sel {msg}"


def assert_state_close(got, want, msg=""):
    np.testing.assert_allclose(got.z, np.asarray(want.z), rtol=1e-5,
                               atol=1e-3, err_msg=f"z {msg}")
    assert int(got.t) == int(want.t), f"t {msg}"


# --------------------------------------------------------------------------
# The port service against the reference service.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_service_matches_reference(ref_run, solver):
    """Every Decision field of every flush (one with a tenant submitted
    twice) and every served tenant's Z and t after it, the port under
    ``solver`` against the reference under ``jnp``."""
    svc = port_service(solver)
    got = serve(svc, ref_run["flushes"], compact_after=COMPACT_AFTER)
    for f, ((resp, states), (want, want_states), reqs) in enumerate(
            zip(got, ref_run["served"], ref_run["flushes"])):
        assert set(resp) == set(want)
        raws = raws_of(reqs)
        for name in want:
            msg = f"{solver} flush {f} {name}"
            assert_decision_close(resp[name], want[name], raws[name], msg)
            assert_state_close(states[name], want_states[name], msg)
    assert int(svc.tenant_state(DOUBLE).t) == FLUSHES + 1


def test_fused_launches_once_per_proposed_group(ref_run, monkeypatch):
    """Under ``cuda_fused`` each proposed group runs the bucket-batched
    fused path once; uniform and greedy groups run stitched rows."""
    import repro_torch.service.step as step_mod
    calls = []

    def spy(gains, *args, **kw):
        calls.append(tuple(gains.shape))
        return decision_fused_batched(gains, *args, **kw)

    monkeypatch.setattr(step_mod, "decision_fused_batched", spy)
    svc = port_service("cuda_fused")
    serve(svc, ref_run["flushes"][:1])
    assert sorted(calls) == [(2, 128), (4, 32)]  # B padded to powers of 2


# --------------------------------------------------------------------------
# Logs and snapshots across the two packages.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_port_replays_reference_log(ref_run, solver):
    """The reference's compacted log (snapshot inside) loads in the port
    and replays there to the reference's live responses and final state;
    the reference's saved state loads into the port bit for bit."""
    svc = port_service(solver)
    names = [t[0] for t in ref_run["table"]]
    log = RequestLog.load(str(ref_run["tmp"] / "log.npz"),
                          {n: svc.raw_structure(n) for n in names})
    assert log.snapshot is not None and log.n_compacted == 9
    replayed = log.replay(svc)
    live = ref_run["served"][COMPACT_AFTER + 1:]
    seq = {}
    for resp in replayed:
        for name, d in resp.items():
            seq.setdefault(name, []).append(d)
    for k, ((want, _), reqs) in enumerate(
            zip(live, ref_run["flushes"][COMPACT_AFTER + 1:])):
        raws = raws_of(reqs)
        for name in want:
            assert_decision_close(seq[name][k], want[name], raws[name],
                                  f"replay {k} {name}")
    for name in names:
        assert_state_close(svc.tenant_state(name), ref_run["final"][name],
                           name)
    exact = port_service(solver)
    exact.load(str(ref_run["tmp"] / "state.npz"))
    for name in names:
        got, want = exact.tenant_state(name), ref_run["final"][name]
        np.testing.assert_array_equal(got.z, np.asarray(want.z))
        np.testing.assert_array_equal(got.aux, np.asarray(want.aux))
        assert int(got.t) == int(want.t)


def test_reference_loads_port_snapshot_and_log(ref_run, tmp_path):
    """A port snapshot loads through the reference's TenantStore.load bit
    for bit, and a port log loads in the reference and replays there to
    the port's live responses."""
    svc = port_service("cuda_fused")
    table, flushes = ref_run["table"], ref_run["flushes"]
    serve(svc, flushes[:1])
    svc.save(str(tmp_path / "state.npz"))
    start = svc.snapshot()
    mark = len(svc.log)
    (live, _), = serve(svc, flushes[2:3])
    svc.log.save(str(tmp_path / "log.npz"))

    rsvc = ref_run["RefService"](solver="jnp")
    add_tenants(rsvc, ref_run["RS"], ref_run["RC"], table)
    rsvc.load(str(tmp_path / "state.npz"))
    for name, *_ in table:
        spec = svc.store.spec(name)
        want = start[spec.bucket.as_string()]
        row = svc.store.bucket_of(name).row_of[name]
        got = rsvc.tenant_state(name)
        np.testing.assert_array_equal(np.asarray(got.z),
                                      want.z[row, :spec.n])
        assert int(got.t) == int(want.t[row])

    from repro.service import RequestLog as RefLog
    log = RefLog.load(str(tmp_path / "log.npz"),
                      {n: rsvc.raw_structure(n) for n, *_ in table})
    assert len(log) == len(svc.log)
    tail = RefLog()
    tail.entries = log.entries[mark:]
    raws = raws_of(flushes[2])
    seen = set()
    for resp in tail.replay(rsvc, restore=False):
        for name, d in resp.items():
            assert_decision_close(live[name], d, raws[name], name)
            seen.add(name)
    assert seen == set(live)


# --------------------------------------------------------------------------
# The reference's service contracts, inside the port.
# --------------------------------------------------------------------------

def configs(n=N, **kw):
    scfg = SchedulerConfig(n_clients=n, model_bits=32 * 50000.0,
                           **{k: v for k, v in kw.items()
                              if k in ("lam", "V", "q_floor")})
    ch = ChannelConfig(n_clients=n,
                       **{k: v for k, v in kw.items()
                          if k in ("p_max", "p_bar", "noise_power")})
    return scfg, ch


def gains_of(rng, n):
    return (np.abs(rng.standard_normal(n)) + 0.01).astype(np.float32)


def raw_of(rng, n, policy):
    return request(rng, n, policy)[1]


UNI = (SchedulerConfig(n_clients=70, model_bits=1e6, lam=2.0, V=300.0),
       ChannelConfig(n_clients=70, p_max=60.0))


def two_tenant_service(solver):
    svc = SchedulerService(solver=solver, device="cpu")
    svc.add_tenant("a", *configs())
    svc.add_tenant("b", *UNI, policy="uniform", m_avg=6.0)
    return svc


def random_flushes(svc, n_flushes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_flushes):
        for nm, n, pol in (("a", N, "proposed"), ("b", 70, "uniform")):
            svc.submit(nm, gains_of(rng, n), raw=raw_of(rng, n, pol))
        out.append(svc.flush())
    return out


def per_tenant(dicts):
    out = {}
    for d in dicts:
        for nm, dec in d.items():
            out.setdefault(nm, []).append(dec)
    return out


def assert_same_decision(x, y, msg=""):
    for field in x._fields:
        np.testing.assert_array_equal(getattr(x, field), getattr(y, field),
                                      err_msg=f"{field} {msg}")


def assert_tenant_sequences_equal(live, replayed):
    a, b = per_tenant(live), per_tenant(replayed)
    assert set(a) == set(b)
    for nm in a:
        assert len(a[nm]) == len(b[nm]), nm
        for r, (x, y) in enumerate(zip(a[nm], b[nm])):
            assert_same_decision(x, y, f"{nm} serve {r}")


def assert_states_equal(s1, s2, msg=""):
    np.testing.assert_array_equal(s1.z, s2.z, err_msg=msg)
    np.testing.assert_array_equal(s1.aux, s2.aux, err_msg=msg)
    assert int(s1.t) == int(s2.t), msg


@pytest.mark.parametrize("solver", SOLVERS)
def test_pad_rows_and_lanes_stay_finite_and_dead(solver):
    """Odd N (11 pad lanes in a 32-wide bucket): responses finite, pad
    lanes never selected; a batch of 3 in a 4-tenant bucket pads with one
    sentinel row, which reads the last tenant's row and must leave it
    untouched."""
    svc = SchedulerService(solver=solver, device="cpu")
    for i in range(4):
        svc.add_tenant(f"odd{i}", *configs(n=21, V=100.0 * (i + 1)))
    rng = np.random.default_rng(3)
    for r in range(4):
        for i in range(3):
            svc.submit(f"odd{i}", gains_of(rng, 21),
                       raw=raw_of(rng, 21, "proposed"))
        out = svc.flush()
        for i in range(3):
            d = out[f"odd{i}"]
            assert d.sel.shape == (21,) and d.q.shape == (21,)
            assert np.isfinite(d.q).all() and np.isfinite(d.p).all()
            assert np.isfinite(d.t_comm) and np.isfinite(d.power)
            assert 1 <= int(d.n_sel) <= 21
    st = svc.tenant_state("odd0")
    assert st.z.shape == (21,) and np.isfinite(st.z).all()
    assert int(st.t) == 4
    last = svc.tenant_state("odd3")
    assert int(last.t) == 0 and not last.z.any()


@pytest.mark.parametrize("solver", SOLVERS)
def test_snapshot_restore_replay_bitexact(solver, tmp_path):
    """A restored service reproduces the logged session bit for bit,
    through the npz round trips of state and log."""
    svc = two_tenant_service(solver)
    random_flushes(svc, 2, seed=5)
    svc.save(str(tmp_path / "state.npz"))
    mark = len(svc.log)
    live = random_flushes(svc, 3, seed=6)
    svc.log.save(str(tmp_path / "log.npz"))
    log = RequestLog.load(str(tmp_path / "log.npz"),
                          {n: svc.raw_structure(n) for n in ("a", "b")})
    assert len(log) == len(svc.log) and log.n_requests == svc.log.n_requests
    svc2 = two_tenant_service(solver)
    svc2.load(str(tmp_path / "state.npz"))
    tail = RequestLog()
    tail.entries = log.entries[mark:]
    assert_tenant_sequences_equal(live, tail.replay(svc2))
    for nm in ("a", "b"):
        assert_states_equal(svc.tenant_state(nm), svc2.tenant_state(nm), nm)


@pytest.mark.parametrize("solver", SOLVERS)
def test_same_tenant_twice_in_one_flush_serves_in_order(solver):
    """k submissions in one flush = k waves in order: state advances as
    k single-request flushes do."""
    rng = np.random.default_rng(4)
    reqs = [(gains_of(rng, N), raw_of(rng, N, "proposed")) for _ in range(4)]
    one = SchedulerService(solver=solver, device="cpu")
    one.add_tenant("t", *configs())
    for g, u in reqs:
        one.submit("t", g, raw=u)
    last = one.flush()["t"]
    seq = SchedulerService(solver=solver, device="cpu")
    seq.add_tenant("t", *configs())
    for g, u in reqs:
        seq.submit("t", g, raw=u)
        d = seq.flush()["t"]
    assert_same_decision(last, d)
    assert_states_equal(one.tenant_state("t"), seq.tenant_state("t"))
    assert int(one.tenant_state("t").t) == 4


def test_validation_errors():
    svc = SchedulerService(device="cpu")
    scfg, ch = configs()
    svc.add_tenant("t", scfg, ch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="already registered"):
        svc.add_tenant("t", scfg, ch)
    with pytest.raises(ValueError, match="not servable"):
        svc.add_tenant("ua", scfg, ch, policy="update_aware", m_avg=3.0)
    with pytest.raises(ValueError, match="m_avg > 0"):
        svc.add_tenant("u", scfg, ch, policy="uniform")
    with pytest.raises(KeyError):
        svc.submit("ghost", np.ones(N, np.float32), generator=gen)
    with pytest.raises(ValueError, match="shape"):
        svc.submit("t", np.ones(N + 1, np.float32), generator=gen)
    with pytest.raises(ValueError, match="exactly one"):
        svc.submit("t", np.ones(N, np.float32))
    with pytest.raises(ValueError, match="layout"):
        svc.submit("t", np.ones(N, np.float32), raw=np.float32(0.5))
    with pytest.raises(ValueError, match="unknown solver"):
        SchedulerService(solver="magma", device="cpu")
    bad = np.ones(N, np.float32)
    bad[3] = 0.0
    with pytest.raises(ValueError, match="positive"):
        svc.submit("t", bad, generator=gen)
    with pytest.raises(ValueError, match="m_avg"):
        svc.add_tenant("g", *configs(), policy="greedy_channel",
                       m_avg=N + 1.0)
    assert svc.n_queued == 0
    svc.submit("t", np.ones(N, np.float32), generator=gen)  # draws raws
    assert svc.flush()["t"].sel.shape == (N,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SchedulerService()          # the default device is the GPU


@pytest.mark.parametrize("solver", SOLVERS)
def test_flush_failure_midway_replay_stays_bitexact(solver):
    """A flush that raises on wave 2 of 3 has advanced state for wave 1;
    the log holds exactly that wave, so replay from the last snapshot
    reproduces the live state bit for bit."""
    scfg, ch = configs()
    svc = SchedulerService(solver=solver, device="cpu")
    svc.add_tenant("t", scfg, ch)
    rng = np.random.default_rng(21)
    svc.submit("t", gains_of(rng, N), raw=raw_of(rng, N, "proposed"))
    svc.flush()
    snap = svc.snapshot()
    mark = len(svc.log)
    for _ in range(3):
        svc.submit("t", gains_of(rng, N), raw=raw_of(rng, N, "proposed"))
    orig = svc._dispatch_group
    calls = {"n": 0}

    def boom(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected wave-2 failure")
        return orig(*args, **kw)

    svc._dispatch_group = boom
    with pytest.raises(RuntimeError, match="injected"):
        svc.flush()
    svc._dispatch_group = orig
    assert calls["n"] == 2
    assert len(svc.log) == mark + 1
    assert int(svc.tenant_state("t").t) == 2
    svc2 = SchedulerService(solver=solver, device="cpu")
    svc2.add_tenant("t", scfg, ch)
    svc2.restore(snap)
    tail = RequestLog()
    tail.entries = svc.log.entries[mark:]
    tail.replay(svc2, restore=False)
    assert_states_equal(svc.tenant_state("t"), svc2.tenant_state("t"))


def test_submit_rejects_nonfinite_gains():
    svc = SchedulerService(device="cpu")
    svc.add_tenant("t", *configs())
    for poison in (np.inf, -np.inf, np.nan):
        bad = np.ones(N, np.float32)
        bad[7] = poison
        with pytest.raises(ValueError, match="finite"):
            svc.submit("t", bad, raw=np.zeros(N, np.float32))
    assert svc.n_queued == 0 and len(svc.log) == 0


@pytest.mark.parametrize("solver", SOLVERS)
def test_add_tenant_preserves_sibling_queues_bitwise(solver):
    """Admitting B into A's bucket neither resets A's queues nor changes
    A's next decision."""
    scfg, ch = configs()
    rng = np.random.default_rng(7)
    reqs = [(gains_of(rng, N), raw_of(rng, N, "proposed")) for _ in range(6)]
    ctrl = SchedulerService(solver=solver, device="cpu")
    test = SchedulerService(solver=solver, device="cpu")
    for svc in (ctrl, test):
        svc.add_tenant("a", scfg, ch)
        for g, u in reqs[:5]:
            svc.submit("a", g, raw=u)
            svc.flush()
    test.add_tenant("b", dataclasses.replace(scfg, V=321.0), ch)
    assert_states_equal(test.tenant_state("a"), ctrl.tenant_state("a"))
    for svc in (ctrl, test):
        svc.submit("a", *reqs[5][:1], raw=reqs[5][1])
    assert_same_decision(test.flush()["a"], ctrl.flush()["a"])


@pytest.mark.parametrize("solver", SOLVERS)
def test_evict_spill_reload_bitwise_vs_never_evicted(solver, tmp_path):
    """evict -> spill to disk -> reload -> serve equals never evicting,
    for the evicted tenant and for the sibling whose row shifts."""
    scfg, ch = configs()
    sib = dataclasses.replace(scfg, V=44.0, lam=3.0)

    def build(spill_dir=None):
        svc = SchedulerService(solver=solver, spill_dir=spill_dir,
                               device="cpu")
        svc.add_tenant("a", scfg, ch)
        svc.add_tenant("c", sib, ch)
        svc.add_tenant("b", *UNI, policy="uniform", m_avg=6.0)
        return svc

    base, lc = build(), build(str(tmp_path))
    sizes = {"a": (N, "proposed"), "c": (N, "proposed"), "b": (70, "uniform")}

    def serve_both(names, r):
        out = []
        for svc in (base, lc):
            rng = np.random.default_rng(100 + r)
            for nm in names:
                n, pol = sizes[nm]
                svc.submit(nm, gains_of(rng, n), raw=raw_of(rng, n, pol))
            out.append(svc.flush())
        return out

    for r in range(3):
        serve_both(("a", "c", "b"), r)
    lc.evict("a")
    assert lc.spilled == ("a",)
    assert list(tmp_path.glob("spill-*.npz"))
    for r in range(3, 5):
        db, dl = serve_both(("c", "b"), r)
        for nm in ("c", "b"):
            assert_same_decision(db[nm], dl[nm], nm)
    lc.reload("a")
    assert lc.spilled == () and not list(tmp_path.glob("spill-*.npz"))
    for r in range(5, 7):
        db, dl = serve_both(("a", "c", "b"), r)
        for nm in ("a", "c", "b"):
            assert_same_decision(db[nm], dl[nm], f"{nm} round {r}")
    for nm in ("a", "c", "b"):
        assert_states_equal(base.tenant_state(nm), lc.tenant_state(nm), nm)


def test_evict_lru_and_auto_reload_on_submit():
    svc = two_tenant_service("cuda_fused")
    random_flushes(svc, 1, seed=3)
    svc.submit("a", np.ones(N, np.float32), raw=np.zeros(N, np.float32))
    svc.flush()
    assert svc.evict_lru() == "b"
    assert "b" not in svc.store and svc.spilled == ("b",)
    with pytest.raises(ValueError, match="reload"):
        svc.add_tenant("b", *UNI)
    rng = np.random.default_rng(6)
    svc.submit("b", np.ones(70, np.float32), raw=raw_of(rng, 70, "uniform"))
    assert "b" in svc.store
    assert svc.flush()["b"].sel.shape == (70,)
    svc.submit("a", np.ones(N, np.float32), raw=np.zeros(N, np.float32))
    with pytest.raises(ValueError, match="queued"):
        svc.evict("a")
    svc.flush()


@pytest.mark.parametrize("solver", SOLVERS)
def test_compacted_log_replay_equals_full_log_replay(solver, tmp_path):
    """Replaying the compacted log (snapshot inside, through npz) equals
    replaying the full log from the start state, and the live service."""
    svc = two_tenant_service(solver)
    start = svc.snapshot()
    random_flushes(svc, 2, seed=5)
    full_entries = [list(e) for e in svc.log.entries]
    svc.compact_log()
    assert len(svc.log) == 0 and svc.log.n_compacted == len(full_entries)
    live = random_flushes(svc, 3, seed=6)
    full_entries += [list(e) for e in svc.log.entries]
    svc.log.save(str(tmp_path / "log.npz"))
    loaded = RequestLog.load(str(tmp_path / "log.npz"),
                             {n: svc.raw_structure(n) for n in ("a", "b")})
    assert loaded.snapshot is not None
    assert loaded.n_compacted == svc.log.n_compacted
    svc2 = two_tenant_service(solver)
    assert_tenant_sequences_equal(live, loaded.replay(svc2))
    full = RequestLog()
    full.entries = full_entries
    svc3 = two_tenant_service(solver)
    svc3.restore(start)
    full.replay(svc3, restore=False)
    for nm in ("a", "b"):
        assert_states_equal(svc.tenant_state(nm), svc2.tenant_state(nm), nm)
        assert_states_equal(svc2.tenant_state(nm), svc3.tenant_state(nm), nm)
    svc.submit("a", np.ones(N, np.float32), raw=np.zeros(N, np.float32))
    with pytest.raises(ValueError, match="flush"):
        svc.compact_log()
    svc.flush()


@pytest.mark.parametrize("solver", SOLVERS)
def test_warmup_leaves_state_bitwise_untouched(solver):
    svc = two_tenant_service(solver)
    random_flushes(svc, 1, seed=9)
    before = svc.snapshot()
    svc.warmup(max_batch=8)
    after = svc.snapshot()
    for k in before:
        for x, y in zip(before[k], after[k]):
            np.testing.assert_array_equal(x, y, err_msg=k)
    ctrl = two_tenant_service(solver)
    random_flushes(ctrl, 1, seed=9)
    d1 = random_flushes(svc, 1, seed=10)[0]
    d2 = random_flushes(ctrl, 1, seed=10)[0]
    for nm in ("a", "b"):
        assert_same_decision(d1[nm], d2[nm], nm)


def test_cuda_solver_bucket(monkeypatch):
    """solver='cuda' serves a configuration-homogeneous bucket through the
    solve kernel, one call for the whole group, matching the stitched
    service to the kernel's float32 round-off; a mixed bucket is rejected
    at its first flush, which then logs nothing."""
    scfg, ch = configs(n=64)
    rng = np.random.default_rng(0)
    gains = [gains_of(rng, 64) + 0.04 for _ in range(3)]
    u = [raw_of(rng, 64, "proposed") for _ in range(3)]
    svc_s = SchedulerService(solver="stitched", device="cpu")
    svc_c = SchedulerService(solver="cuda", device="cpu")
    for svc in (svc_s, svc_c):
        for i in range(3):
            svc.add_tenant(f"t{i}", scfg, ch)
            svc.submit(f"t{i}", gains[i], raw=u[i])
    import repro_torch.fl.engine as engine_mod
    calls = []

    def spy(gains, z, **kw):
        calls.append(tuple(gains.shape))
        return scheduler_solve(gains, z, **kw)

    monkeypatch.setattr(engine_mod, "scheduler_solve", spy)
    dc = svc_c.flush()
    assert calls == [(4 * 64,)]  # one call over the padded batch
    ds = svc_s.flush()
    for i in range(3):
        np.testing.assert_allclose(dc[f"t{i}"].q, ds[f"t{i}"].q, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dc[f"t{i}"].p, ds[f"t{i}"].p, rtol=1e-5,
                                   atol=1e-3)
    bad = SchedulerService(solver="cuda", device="cpu")
    bad.add_tenant("x", scfg, ch)
    bad.add_tenant("y", dataclasses.replace(scfg, V=17.0), ch)
    bad.submit("x", gains[0], raw=u[0])
    bad.submit("y", gains[1], raw=u[1])
    with pytest.raises(ValueError, match="homogeneous"):
        bad.flush()
    assert len(bad.log) == 0 and bad.log.n_requests == 0
    assert scheduler_solve.launches == 0  # CPU tensors: the plain version
