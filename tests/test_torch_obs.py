"""The port's telemetry layer (``repro_torch.obs``) against the reference's
(``repro.obs``), mirroring tests/test_obs.py case for case (the 2D-mesh
case excepted: the port has no mesh yet).

* The registry and the exporters: the same ``inc`` / ``set`` / ``record``
  calls give the reference's ``snapshot()`` and its ``prometheus_text``
  byte for byte; histogram edges, ring and percentiles, the ``NOOP`` path,
  ``configure`` inheritance, ``EventLog`` JSONL and ``once``.
* The service on ``device="cpu"`` against the reference service under
  ``solver="jnp"`` on the same request stream: telemetry on equals off bit
  for bit (decisions, tenant state, replay); the first-dispatch misses,
  warm hits, lifecycle counters, ``bytes_est``, the event sequence and the
  set of (metric, labels) equal the reference's (solver label mapped);
  ``staging=False`` equals ``staging=True`` bit for bit, and the legacy
  builder's host arrays equal the reference's.
* The engine: ``run_simulation_scan`` on and off bit for bit, its counters
  the reference's on its replayed draws; the chunk runner two chunks =
  one bit for bit, against the reference's at
  tests/test_torch_engine.py::test_final_params_match_reference's
  tolerances (params rtol 1e-3 / atol 1e-4, Z rtol 1e-5 / atol 1e-3).
* The tournament: on and off bit for bit, one regret gauge per policy
  equal to its leaderboard row, as the reference's instruments record it.
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import (ReplayDraws, record_draws,  # noqa: E402
                                  reference)

from repro_torch import obs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      heterogeneous_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.data.synthetic import from_numpy  # noqa: E402
from repro_torch.fl import engine as peng  # noqa: E402
from repro_torch.fl.tournament import run_tournament  # noqa: E402
from repro_torch.launch.distributed import is_main  # noqa: E402
from repro_torch.service import SchedulerService  # noqa: E402

pytestmark = pytest.mark.obs

N = 24
NB = 70                     # the second tenant's clients: a second bucket


@pytest.fixture(scope="module")
def ref():
    r = reference()
    import repro.obs as robs
    from repro.core import ChannelConfig as RC
    from repro.core import SchedulerConfig as RS
    from repro.service import SchedulerService as RefService
    r.obs, r.RC, r.RS, r.Service = robs, RC, RS, RefService
    return r


@pytest.fixture(autouse=True)
def _default_off():
    """Tests may flip the process-wide switches; always restore OFF."""
    yield
    obs.configure(False)
    import sys
    if "repro.obs" in sys.modules:
        sys.modules["repro.obs"].configure(False)


# --------------------------------------------------------------------------
# Registry semantics and the exporters, against the reference.
# --------------------------------------------------------------------------

def feed(mod, seed):
    """A seeded sequence of counter / gauge / histogram calls on a fresh
    enabled registry of ``mod`` (the port's obs or the reference's)."""
    rng = np.random.default_rng(seed)
    reg = mod.new_registry(True)
    for _ in range(200):
        kind = rng.integers(3)
        labels = ({} if rng.random() < 0.3 else
                  {"bucket": f"b{int(rng.integers(3))}",
                   "solver": ["x", "y"][int(rng.integers(2))]})
        if kind == 0:
            reg.counter(f"c{int(rng.integers(2))}_total", **labels).inc(
                float(rng.integers(1, 5)))
        elif kind == 1:
            reg.gauge(f"g{int(rng.integers(2))}", **labels).set(
                float(rng.normal()))
        else:
            edges = ((1.0, 2.0, 4.0, 8.0) if labels else
                     mod.metrics.TIME_EDGES)
            reg.histogram(f"h{int(rng.integers(2))}_seconds", edges=edges,
                          ring=16, **labels).record(
                float(rng.exponential(2.0)))
    return reg


def same_snapshot(got, want):
    """Snapshots equal, NaN percentiles of empty histograms included."""
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_and_prometheus_match_reference(ref, seed):
    """The same calls give the reference's snapshot and its Prometheus
    text byte for byte, and the same JSON snapshot but for ``ts``."""
    got, want = feed(obs, seed), feed(ref.obs, seed)
    same_snapshot(got.snapshot(), want.snapshot())
    assert obs.prometheus_text(got) == ref.obs.prometheus_text(want)
    a, b = obs.json_snapshot(got, k=1), ref.obs.json_snapshot(want, k=1)
    a.pop("ts"), b.pop("ts")
    same_snapshot(a, b)
    for name in ("c0_total", "c1_total"):
        assert got.total(name) == want.total(name)


def test_registry_get_or_create_and_values():
    r = obs.new_registry(True)
    c = r.counter("x_total", k="a")
    assert r.counter("x_total", k="a") is c     # get-or-create identity
    assert r.counter("x_total", k="b") is not c  # labels distinguish
    c.inc()
    c.inc(2.5)
    r.counter("x_total", k="b").inc(4)
    assert r.value("x_total", k="a") == 3.5
    assert r.total("x_total") == 7.5
    g = r.gauge("depth")
    g.set(7)
    g.set(3)
    assert r.value("depth") == 3.0
    with pytest.raises(TypeError):
        r.gauge("x_total", k="a")               # kind conflict
    r.reset()
    assert r.snapshot() == []


def test_histogram_buckets_percentiles_and_ring(ref):
    hs = []
    for mod in (obs, ref.obs):
        h = mod.new_registry(True).histogram("lat", edges=(1.0, 2.0, 4.0),
                                              ring=8)
        for v in (0.5, 1.5, 3.0, 100.0):
            h.record(v)
        assert list(h.counts) == [1, 1, 1, 1]   # last slot = overflow
        assert h.count == 4 and h.total == 105.0
        for v in range(16):                      # wrap the ring
            h.record(float(v))
        assert h.recent().shape == (8,)          # bounded
        assert 7.0 <= h.percentile(50) <= 13.0   # over the last 8 values
        hs.append(h)
    np.testing.assert_array_equal(hs[0].counts, hs[1].counts)
    np.testing.assert_array_equal(hs[0].ring, hs[1].ring)
    assert hs[0].percentile(99) == hs[1].percentile(99)
    with pytest.raises(ValueError):
        obs.new_registry(True).histogram("bad", edges=(2.0, 1.0))
    assert np.isnan(obs.Histogram().percentile(50))


def test_disabled_registry_hands_out_noop():
    r = obs.new_registry(False)
    assert r.counter("a") is obs.NOOP
    assert r.gauge("b") is obs.NOOP
    assert r.histogram("c") is obs.NOOP
    obs.NOOP.inc()
    obs.NOOP.set(3)
    obs.NOOP.record(0.1)                         # all no-ops
    assert r.snapshot() == []
    assert r.value("a") == 0.0
    assert obs.prometheus_text(r) == ""


def test_configure_switch_and_inheritance():
    assert not obs.enabled()                     # process default: OFF
    reg = obs.configure(True)
    assert obs.enabled() and reg is obs.default_registry()
    assert obs.configure(True) is reg            # on -> on keeps it
    assert obs.new_registry().enabled            # None inherits the switch
    assert not obs.new_registry(False).enabled   # explicit overrides
    obs.configure(False)
    assert not obs.enabled()
    assert not obs.new_registry().enabled


def test_noop_record_path_is_cheap():
    """The disabled hot path is one attribute load + empty call — assert
    LOOSELY (well under 5us/op even on a loaded runner) that nothing
    heavyweight snuck into the no-op recorder."""
    c = obs.new_registry(False).counter("x")
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        c.inc()
    per_op = (time.perf_counter() - t0) / n
    assert per_op < 5e-6, f"no-op inc() costs {per_op * 1e9:.0f} ns/op"


def test_compile_tracker_miss_warm_forget(ref):
    for mod in (obs, ref.obs):
        t = mod.CompileTracker(mod.new_registry(True), "x")
        assert t.miss(("b", 8)) is True
        assert t.miss(("b", 8)) is False         # seen: no new miss
        assert t.misses_total() == 1.0
        assert t.warm(("b", 16)) is True         # warmup-seeded
        assert t.miss(("b", 16)) is False
        assert t.warm_hits.value == 1.0          # hit on a warmed shape
        t.forget("b")
        assert t.miss(("b", 8)) is True          # cache drop mirrored
        assert t.misses_total() == 3.0
    # tracking runs with the counters disabled too
    t = obs.CompileTracker(obs.new_registry(False), "x")
    assert t.miss("k") is True and t.miss("k") is False


def test_prometheus_text_format():
    r = obs.new_registry(True)
    r.counter("req_total", bucket="b32").inc(3)
    r.gauge("depth").set(2)
    h = r.histogram("lat_seconds", edges=(1.0, 2.0))
    for v in (0.5, 1.5, 9.0):
        h.record(v)
    text = obs.prometheus_text(r)
    assert "# TYPE req_total counter" in text
    assert 'req_total{bucket="b32"} 3' in text
    assert "# TYPE depth gauge" in text and "depth 2" in text
    # histogram: cumulative buckets, +Inf == count, sum/count series
    assert 'lat_seconds_bucket{le="1"} 1' in text
    assert 'lat_seconds_bucket{le="2"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 3' in text
    assert "lat_seconds_sum 11" in text
    assert "lat_seconds_count 3" in text


def test_json_snapshot_is_serializable():
    r = obs.new_registry(True)
    r.counter("a").inc()
    r.histogram("b").record(0.01)
    snap = obs.json_snapshot(r, extra_field=7)
    parsed = json.loads(json.dumps(snap))
    assert parsed["extra_field"] == 7
    names = {m["name"] for m in parsed["metrics"]}
    assert names == {"a", "b"}


@pytest.mark.parametrize("package", ["port", "reference"])
def test_event_log_jsonl_and_once(ref, tmp_path, package):
    mod = obs if package == "port" else ref.obs
    path = tmp_path / "sub" / "events.jsonl"
    el = mod.EventLog(str(path), keep=3)
    el.emit("admit", tenant="t0")
    assert el.once("k", "warn", x=1) is not None
    assert el.once("k", "warn", x=2) is None     # suppressed repeat
    for i in range(5):
        el.emit("tick", i=i)
    assert len(el.events) == 3                   # bounded in-memory tail
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["event"] for ln in lines] == (
        ["admit", "warn"] + ["tick"] * 5)        # file keeps everything
    assert lines[1]["x"] == 1
    assert mod.EventLog().emit("x")["event"] == "x"   # no path: tail only


def test_event_log_writes_on_rank_zero_only(tmp_path, monkeypatch):
    """``emit`` writes the file only where ``is_main()``; the in-memory
    tail is kept on every rank."""
    import repro_torch.obs.export as export
    assert is_main()                             # no process group here
    monkeypatch.setattr(export, "is_main", lambda: False)
    el = obs.EventLog(str(tmp_path / "ev.jsonl"))
    el.emit("admit", tenant="t0")
    assert len(el.events) == 1
    assert not (tmp_path / "ev.jsonl").exists()


def test_trace_span_disabled_and_enabled():
    from torch.profiler import ProfilerActivity, profile
    assert obs.trace_span("x") is obs.trace_span("y")   # off: shared null
    with obs.trace_span("x"):
        pass
    obs.configure(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace_span("service.flush/wave0"):  # on: profiler span
            torch.ones(4).sum()
    assert "service.flush/wave0" in {e.key for e in prof.key_averages()}


# --------------------------------------------------------------------------
# The train step's spans (fl/round.py::make_train_step).
# --------------------------------------------------------------------------

STEP_SPANS = ("train_step", "train_step.forward", "train_step.update")


def tiny_lm_step(arch, n_batches=3):
    """``arch`` reduced: its SGD step (``make_train_step`` over
    ``functional_call`` of the LM module), its parameters and seeded
    (2, 16) token batches."""
    from repro_torch import configs
    from repro_torch.fl.round import make_train_step
    from repro_torch.models import model as M
    cfg = configs.get_config(arch).reduced()
    model = M.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    params = {k: p.detach() for k, p in model.named_parameters()}
    tokens = torch.randint(0, cfg.vocab_size, (n_batches, 2, 16),
                           generator=torch.Generator().manual_seed(1))
    batches = [M.Batch(tokens=t, labels=torch.roll(t, -1, dims=-1))
               for t in tokens]
    step = make_train_step(
        lambda p, b: torch.func.functional_call(model, p, (b, cfg)), 0.01)
    return step, params, batches


def run_steps(step, params, batches):
    losses = []
    for b in batches:
        params, loss = step(params, b)
        losses.append(loss)
    return params, losses


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m"])
def test_train_step_telemetry_is_neutral_bitwise(arch):
    """Three SGD steps with the step's spans on give the parameters and
    losses of the same steps with them off, bit for bit."""
    step, params, batches = tiny_lm_step(arch)
    off_params, off_losses = run_steps(step, params, batches)
    obs.configure(True)
    on_params, on_losses = run_steps(step, params, batches)
    assert off_params.keys() == on_params.keys()
    for k, w in off_params.items():
        assert torch.equal(w, on_params[k]), k
    for a, b in zip(off_losses, on_losses):
        assert torch.equal(a, b)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_spans_nest_in_order(steps):
    """With telemetry on, each step records ``train_step`` holding
    ``train_step.forward`` and then ``train_step.update``, one of each."""
    from torch.profiler import ProfilerActivity, profile
    step, params, batches = tiny_lm_step("yi-6b", steps)
    obs.configure(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_steps(step, params, batches)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name in STEP_SPANS)
    assert [name for *_, name in spans] == list(STEP_SPANS) * steps
    for i in range(steps):
        (s0, e0, _), (s1, e1, _), (s2, e2, _) = spans[3 * i:3 * i + 3]
        assert s0 <= s1 <= e1 <= s2 <= e2 <= e0


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m"])
def test_train_step_opens_no_span_with_telemetry_off(arch):
    """Off, the step records no span and every span of the step is the
    shared null context."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import profile as obs_profile
    step, params, batches = tiny_lm_step(arch, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_steps(step, params, batches)
    assert not {e.name for e in prof.events()} & set(STEP_SPANS)
    assert all(obs.trace_span(name) is obs_profile._NULL
               for name in STEP_SPANS)


# --------------------------------------------------------------------------
# The service: neutrality, and every counter against the reference's.
# --------------------------------------------------------------------------

def configs(scfg_cls, ch_cls, n=N):
    return (scfg_cls(n_clients=n, model_bits=32 * 50000.0),
            ch_cls(n_clients=n))


def mixed(cls, scfg_cls, ch_cls, **kw):
    """Tenant "a" (proposed, N = 24, b32) and "b" (uniform, N = 70,
    b128)."""
    svc = cls(**kw)
    svc.add_tenant("a", *configs(scfg_cls, ch_cls))
    svc.add_tenant("b", *configs(scfg_cls, ch_cls, NB), policy="uniform",
                   m_avg=5.0)
    return svc


def port_mixed(telemetry, solver="stitched", **kw):
    return mixed(SchedulerService, SchedulerConfig, ChannelConfig,
                 telemetry=telemetry, solver=solver, device="cpu", **kw)


def ref_mixed(ref, telemetry, **kw):
    return mixed(ref.Service, ref.RS, ref.RC, telemetry=telemetry,
                 solver="jnp", **kw)


def mixed_stream(rounds=5, seed=0):
    """Per round the (gains, raw) of "a" and of "b", numpy from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        ga = rng.uniform(0.2, 3.0, N).astype(np.float32)
        gb = rng.uniform(0.2, 3.0, NB).astype(np.float32)
        rb = {"take": np.float32(rng.random()),
              "scores": rng.random(NB, dtype=np.float32)}
        out.append(((ga, rng.random(N, dtype=np.float32)), (gb, rb)))
    return out


def serve_mixed(svc, streams, evict_at=2, after=None):
    """Drive both tenants, with an evict/reload cycle for 'b' midway;
    ``after(svc)`` runs after every flush."""
    out = []
    for t, ((ga, ra), (gb, rb)) in enumerate(streams):
        if t == evict_at:
            svc.evict("b")
            svc.reload("b")
        svc.submit("a", ga, raw=ra)
        svc.submit("b", gb, raw=rb)
        out.append(svc.flush())
        if after is not None:
            after(svc)
    return out


def assert_responses_equal(got, want):
    for r_got, r_want in zip(got, want):
        assert set(r_got) == set(r_want)
        for name in r_want:
            for f_got, f_want in zip(r_got[name], r_want[name]):
                np.testing.assert_array_equal(f_got, f_want)


@pytest.mark.parametrize("solver", ["stitched", "cuda_fused"])
def test_service_flush_replay_neutrality_bitwise(solver, tmp_path):
    streams = mixed_stream()
    svc_on = port_mixed(True, solver, log_warn_bytes=1.0,
                        event_log=str(tmp_path / "ev.jsonl"))
    svc_off = port_mixed(False, solver)
    svc_on.warmup(max_batch=2)
    svc_off.warmup(max_batch=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got_on = serve_mixed(svc_on, streams)
        got_off = serve_mixed(svc_off, streams)
    assert_responses_equal(got_on, got_off)
    for name in ("a", "b"):                      # live queue state too
        for l_on, l_off in zip(svc_on.tenant_state(name),
                               svc_off.tenant_state(name)):
            np.testing.assert_array_equal(l_on, l_off)
    # replaying the telemetry-on log through a FRESH telemetry-on service
    # reproduces the recorded decisions bit for bit
    replayed = svc_on.log.replay(port_mixed(True, solver))
    flat = {}
    for entry in replayed:
        flat.update(entry)
    assert_responses_equal([flat], [got_on[-1]])
    reg = svc_on.obs.registry
    assert reg.value("service_flushes_total") == len(streams)
    assert reg.value("service_requests_served_total") == 2 * len(streams)
    assert reg.value("service_groups_served_total") == 2 * len(streams)
    assert svc_off.obs.registry.snapshot() == []


def service_counters(svc):
    reg = svc.obs.registry
    names = ("service_submits_total", "service_flushes_total",
             "service_requests_served_total", "service_groups_served_total",
             "service_tenant_admits_total", "service_tenant_evicts_total",
             "service_tenant_reloads_total", "service_tenant_spills_total",
             "service_resident_tenants", "service_spilled_tenants",
             "service_log_entries", "service_log_bytes_est",
             "service_log_compactions_total", "service_warmup_hits_total",
             "service_queue_depth")
    out = {n: reg.value(n) for n in names}
    out["misses"] = svc.obs.compiles.misses_total()
    return out


def strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def label_set(svc, solver_label=None):
    out = set()
    for m in svc.metrics_snapshot()["metrics"]:
        labels = dict(m["labels"])
        if "solver" in labels and solver_label is not None:
            labels["solver"] = solver_label[labels["solver"]]
        out.add((m["name"], m["kind"], tuple(sorted(labels.items()))))
    return out


@pytest.mark.parametrize("solver", ["stitched", "cuda_fused"])
def test_service_counters_and_events_match_reference(ref, solver, tmp_path):
    """On the same stream (warmup, flushes, an evict/reload cycle, a
    compaction): every counter and gauge, ``bytes_est`` after every flush,
    the events with their fields and the set of (metric, labels) are the
    reference's; the port's decisions agree with the reference's."""
    streams = mixed_stream()
    sides = {}
    for side in ("port", "ref"):
        svc = (port_mixed(True, solver, spill_dir=str(tmp_path / side),
                          log_warn_bytes=2000.0)
               if side == "port" else
               ref_mixed(ref, True, spill_dir=str(tmp_path / side),
                         log_warn_bytes=2000.0))
        svc.warmup(max_batch=2)
        sizes = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            resp = serve_mixed(svc, streams[:3],
                               after=lambda s: sizes.append(s.log.bytes_est))
            svc.compact_log()
            resp += serve_mixed(svc, streams[3:], evict_at=-1,
                                after=lambda s: sizes.append(s.log.bytes_est))
        sides[side] = (svc, resp, sizes)
    (p, p_resp, p_sizes), (r, r_resp, r_sizes) = sides["port"], sides["ref"]
    assert p_sizes == r_sizes and p_sizes[0] > 0
    assert service_counters(p) == service_counters(r)
    p_events, r_events = strip_ts(p.events.events), strip_ts(r.events.events)
    assert [e["event"] for e in p_events] == [e["event"] for e in r_events]
    assert p_events == r_events
    assert "log_growth_warning" in [e["event"] for e in p_events]
    # the reference ran "jnp": the port's own solver label maps onto it
    assert label_set(p, {solver: "jnp"}) == label_set(r)
    for rp, rr in zip(p_resp, r_resp):
        np.testing.assert_allclose(rp["a"].q, np.asarray(rr["a"].q),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(rp["b"].sel, np.asarray(rr["b"].sel))


def cold_stream(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.2, 3.0, N).astype(np.float32),
             rng.random(N, dtype=np.float32)) for _ in range(3)]


def serve_batches(svc, streams):
    """Flushes of 1, then 2, then 1 requests: batch shapes 1 and 2."""
    base = svc.obs.compiles.misses_total()
    for t, (gains, raw) in enumerate(streams):
        svc.submit("a", gains, raw=raw)
        if t == 1:
            svc.submit("b", gains, raw=raw)
        svc.flush()
    return svc.obs.compiles.misses_total() - base


def two_tenants(cls, scfg_cls, ch_cls, **kw):
    svc = cls(telemetry=True, **kw)
    svc.add_tenant("a", *configs(scfg_cls, ch_cls))
    svc.add_tenant("b", *configs(scfg_cls, ch_cls))
    return svc


def test_recompile_counter_reproduces_warmup_story(ref):
    """Cold: the serving path pays first dispatches (as many as the
    reference's jit misses); after ``warmup(2)``: none, and the warm hits
    and misses are the reference's."""
    streams = cold_stream()
    port = lambda: two_tenants(SchedulerService, SchedulerConfig,  # noqa
                               ChannelConfig, solver="stitched",
                               device="cpu")
    refs = lambda: two_tenants(ref.Service, ref.RS, ref.RC,  # noqa
                               solver="jnp")
    cold = serve_batches(port(), streams)
    assert cold > 0 and cold == serve_batches(refs(), streams)
    got = []
    for make in (port, refs):
        svc = make()
        svc.warmup(max_batch=2)
        warmed = svc.obs.compiles.misses_total()
        assert serve_batches(svc, streams) == 0          # all warm
        got.append((warmed, svc.obs.compiles.warm_hits.value))
        assert svc.obs.registry.total("service_compile_seconds_total") > 0
    assert got[0] == got[1] and got[0][1] > 0


def test_admitting_a_tenant_invalidates_warm_shapes(ref):
    """Admission changes the bucket's tenant count T: a fresh signature
    the tracker must count, as the reference's does."""
    rng = np.random.default_rng(0)
    gains = np.full(N, 1.0, np.float32)
    raw = rng.random(N, dtype=np.float32)
    for cls, rs, rc, kw in ((SchedulerService, SchedulerConfig,
                             ChannelConfig, dict(solver="stitched",
                                                 device="cpu")),
                            (ref.Service, ref.RS, ref.RC,
                             dict(solver="jnp"))):
        svc = cls(telemetry=True, **kw)
        svc.add_tenant("a", *configs(rs, rc))
        svc.warmup(max_batch=1)
        base = svc.obs.compiles.misses_total()
        svc.add_tenant("c", *configs(rs, rc))    # same bucket, new T
        svc.submit("a", gains, raw=raw)
        svc.flush()
        assert svc.obs.compiles.misses_total() - base == 1.0


def test_cuda_solver_rebuild_forgets_the_bucket():
    """Under ``solver="cuda"`` a tenant-set change rebuilds the bucket's
    step, and the tracker forgets the bucket with it: a previously seen
    shape counts again, as under the reference's ``pallas``."""
    svc = SchedulerService(telemetry=True, solver="cuda", device="cpu")
    scfg, ch = configs(SchedulerConfig, ChannelConfig)
    svc.add_tenant("a", scfg, ch)
    svc.add_tenant("b", scfg, ch)
    gains = np.full(N, 1.0, np.float32)
    raw = np.random.default_rng(0).random(N, dtype=np.float32)
    svc.submit("a", gains, raw=raw)
    svc.flush()
    assert svc.obs.compiles.misses_total() == 1.0
    svc.evict("b")
    svc.reload("b")                              # T back to 2: seen shape
    svc.submit("a", gains, raw=raw)
    svc.flush()
    assert svc.obs.compiles.misses_total() == 2.0


def test_log_growth_warning_fires_once_and_compact_resets():
    svc = port_mixed(True, log_warn_bytes=64.0)
    rng = np.random.default_rng(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            svc.submit("a", rng.uniform(0.2, 3.0, N).astype(np.float32),
                       raw=rng.random(N, dtype=np.float32))
            svc.flush()
    growth = [w for w in caught if "compact_log" in str(w.message)]
    assert len(growth) == 1                      # once, not per flush
    events = [e["event"] for e in svc.events.events]
    assert events.count("log_growth_warning") == 1
    reg = svc.obs.registry
    assert reg.value("service_log_entries") == 3.0
    assert reg.value("service_log_bytes_est") > 64.0
    # 3 entries of one proposed N = 24 request: gains + uniforms + name
    assert svc.log.bytes_est == 3 * (4 * N + 4 * N + 1 + 64)
    svc.compact_log()
    assert svc.log.bytes_est == 0
    assert reg.value("service_log_entries") == 0.0
    assert reg.value("service_log_compactions_total") == 1.0
    assert "compact" in [e["event"] for e in svc.events.events]


def test_metrics_snapshot_formats():
    svc = port_mixed(True)
    svc.submit("a", np.full(N, 1.0, np.float32),
               raw=np.random.default_rng(0).random(N, dtype=np.float32))
    svc.flush()
    snap = svc.metrics_snapshot()
    assert snap["tenants"] == {"resident": 2, "spilled": 0}
    assert snap["log"]["entries"] == 1
    names = {m["name"] for m in snap["metrics"]}
    assert {"service_flush_seconds", "service_z_mean",
            "service_submits_total"} <= names
    z = {m["labels"]["bucket"]: m["value"] for m in snap["metrics"]
         if m["name"] == "service_z_mean"}
    for bkey, b in svc.store.buckets().items():
        assert z[bkey.as_string()] == float(b.state.z.numpy().mean())
    parsed = json.loads(svc.metrics_snapshot(fmt="json"))
    assert parsed["queued"] == 0
    prom = svc.metrics_snapshot(fmt="prometheus")
    assert "# TYPE service_flush_seconds histogram" in prom
    assert 'service_z_mean{bucket="' in prom
    with pytest.raises(ValueError):
        svc.metrics_snapshot(fmt="xml")
    # disabled service: empty registry, and NO device pulls happen
    svc_off = port_mixed(False)
    assert svc_off.metrics_snapshot()["metrics"] == []
    assert svc_off.metrics_snapshot(fmt="prometheus") == ""


def test_lifecycle_counters_and_events(tmp_path):
    svc = port_mixed(True, spill_dir=str(tmp_path))
    reg = svc.obs.registry
    assert reg.value("service_resident_tenants") == 2.0
    assert reg.value("service_tenant_admits_total") == 2.0
    svc.evict("b")
    assert reg.value("service_resident_tenants") == 1.0
    assert reg.value("service_tenant_spills_total") == 1.0
    assert reg.value("service_spilled_tenants") == 1.0
    svc.reload("b")
    assert reg.value("service_tenant_reloads_total") == 1.0
    assert reg.value("service_spilled_tenants") == 0.0
    ev = [e["event"] for e in svc.events.events]
    assert ev == ["admit", "admit", "evict", "reload"]
    assert svc.events.events[2]["spill"] == "disk"


def test_tenant_store_defaults_to_noop_instruments():
    from repro_torch.service import TenantStore
    store = TenantStore("cpu")
    assert not store.obs.enabled and store.obs.admits is obs.NOOP


# --------------------------------------------------------------------------
# The legacy staging=False batch builder.
# --------------------------------------------------------------------------

GREEDY_N = 21


def three_policy_service(cls, scfg_cls, ch_cls, **kw):
    svc = mixed(cls, scfg_cls, ch_cls, **kw)
    svc.add_tenant("g", *configs(scfg_cls, ch_cls, GREEDY_N),
                   policy="greedy_channel", m_avg=3.0)
    svc.add_tenant("a2", *configs(scfg_cls, ch_cls))
    return svc


def three_policy_stream(rounds=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for t, ((ga, ra), (gb, rb)) in enumerate(mixed_stream(rounds, seed)):
        reqs = [("a", ga, ra), ("b", gb, rb),
                ("g", rng.uniform(0.2, 3.0, GREEDY_N).astype(np.float32),
                 ())]
        if t % 2:
            reqs += [("a2", rng.uniform(0.2, 3.0, N).astype(np.float32),
                      rng.random(N, dtype=np.float32)),
                     ("a", ga[::-1].copy(), ra[::-1].copy())]  # 2nd wave
        out.append(reqs)
    return out


@pytest.mark.parametrize("solver", ["stitched", "cuda_fused"])
def test_staging_false_equals_staging_true_bitwise(solver):
    """The legacy pad-per-request builder serves every decision and every
    queue bit for bit as the staged arenas do (three policies, a tenant
    twice in one flush: two waves)."""
    runs = []
    for staging in (True, False):
        svc = three_policy_service(SchedulerService, SchedulerConfig,
                                   ChannelConfig, solver=solver,
                                   device="cpu", staging=staging)
        resp = []
        for reqs in three_policy_stream():
            for name, gains, raw in reqs:
                svc.submit(name, gains, raw=raw)
            resp.append(svc.flush())
        runs.append((svc, resp))
    (a, ra), (b, rb) = runs
    assert_responses_equal(ra, rb)
    for x, y in zip(a.snapshot().values(), b.snapshot().values()):
        for lx, ly in zip(x, y):
            np.testing.assert_array_equal(lx, ly)
    assert not b._pool                           # no arena was staged


def test_legacy_batch_host_arrays_match_reference(ref):
    """The port's ``_legacy_batch`` builds the reference's host arrays
    (rows as int64, the port's index type) for every policy's bucket,
    with sentinel rows padding the batch to a power of two."""
    svcs = [three_policy_service(SchedulerService, SchedulerConfig,
                                 ChannelConfig, solver="stitched",
                                 device="cpu", staging=False),
            three_policy_service(ref.Service, ref.RS, ref.RC, solver="jnp",
                                 staging=False)]
    reqs = three_policy_stream()[1]
    for svc in svcs:
        for name, gains, raw in reqs[:4]:
            svc.submit(name, gains, raw=raw)
    batches = []
    for svc in svcs:
        wave = svc._waves[0]
        out = {}
        for bkey, group in wave.groups.items():
            bucket = svc.store.buckets()[bkey]
            row_ids = [svc.store.row(r.tenant) for r in group]
            b_pad = 1 << max(0, len(group) - 1).bit_length()
            out[bkey.as_string()] = svc._legacy_batch(bkey, bucket, group,
                                                      row_ids, b_pad)
        batches.append(out)
    got, want = batches
    assert set(got) == set(want) and len(got) == 3
    for key in want:
        (gr, gg, graw), (wr, wg, wraw) = got[key], want[key]
        assert gr.dtype == np.int64
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gg, wg)
        g_leaves = ref.jax.tree.leaves(graw)
        w_leaves = ref.jax.tree.leaves(wraw)
        assert len(g_leaves) == len(w_leaves)
        for x, y in zip(g_leaves, w_leaves):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------
# The engine and the chunk runner.
# --------------------------------------------------------------------------

EN = 12
SIM = dict(rounds=4, eval_every=2, m_cap=4, batch=4, local_steps=2,
           eval_size=32, model="mlp")
BITS = 1e5


@pytest.fixture(scope="module")
def world(ref):
    """A small federated problem on the reference side and its port."""
    jax = ref.jax
    ds = ref.synthetic.make_cifar10_like(jax.random.PRNGKey(0),
                                         n_clients=EN, per_client=16,
                                         n_test=32, h=8, w=8)
    params = ref.registry.make_model("mlp", ds).init_fn(
        jax.random.PRNGKey(1))
    pds = from_numpy(ds.client_images, ds.client_labels, ds.test_images,
                     ds.test_labels, ds.n_classes, device="cpu")
    pparams = params_from_jax({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    return ds, params, pds, pparams


def port_draws(ref, key, rounds):
    return ReplayDraws(record_draws(ref, key, rounds, EN,
                                    (SIM["m_cap"], SIM["local_steps"],
                                     SIM["batch"]), 16))


def port_args(solver="cuda_fused", **kw):
    sim = peng.SimConfig(solver=solver, **dict(SIM, **kw))
    return (sim, SchedulerConfig(n_clients=EN, model_bits=BITS),
            ChannelConfig(n_clients=EN), heterogeneous_sigmas(EN,
                                                              device="cpu"))


def engine_metrics(reg):
    """(name, labels) -> value or histogram counts, but the wall-clock
    metrics and the Eq. 8 histogram's buckets (comm times agree across
    the frameworks at rtol 1e-5, not bit for bit)."""
    out = {}
    for m in reg.snapshot():
        if m["name"] in ("engine_run_seconds", "engine_chunk_seconds",
                         "engine_rounds_per_sec",
                         "engine_compile_seconds_total"):
            continue
        key = (m["name"], tuple(sorted(m["labels"].items())))
        out[key] = (m["count"] if m["name"] == "engine_t_comm_seconds"
                    else m["counts"] if m["kind"] == "histogram"
                    else m["value"])
    return out


@pytest.mark.parametrize("solver,ref_solver", [("stitched", "jnp"),
                                               ("cuda_fused",
                                                "pallas_fused")])
def test_engine_neutrality_and_counters_match_reference(ref, world, solver,
                                                        ref_solver):
    """``run_simulation_scan`` is bit-equal with telemetry on and off; on,
    it records what the reference records on its replayed draws (runs,
    rounds, one first use, the n_selected histogram, the comm-time count)
    and rounds/s > 0."""
    ds, params, pds, pparams = world
    jax = ref.jax
    key = jax.random.PRNGKey(2)
    sim, scfg, ch, sig = port_args(solver)
    h_off = peng.run_simulation_scan(port_draws(ref, key, SIM["rounds"]),
                                     pparams, pds, sim, scfg, ch, sig)
    reg = obs.configure(True)
    h_on = peng.run_simulation_scan(port_draws(ref, key, SIM["rounds"]),
                                    pparams, pds, sim, scfg, ch, sig)
    for k in h_off:
        np.testing.assert_array_equal(h_off[k], h_on[k], err_msg=k)
    assert reg.value("engine_runs_total") == 1.0
    assert reg.value("engine_rounds_total") == SIM["rounds"]
    assert reg.value("engine_rounds_per_sec") > 0.0
    rreg = ref.obs.configure(True)
    ref.engine.run_simulation_scan(
        key, params, ds, ref.engine.SimConfig(solver=ref_solver, **SIM),
        ref.scheduler.SchedulerConfig(n_clients=EN, model_bits=BITS),
        ref.channel.ChannelConfig(n_clients=EN),
        ref.channel.heterogeneous_sigmas(EN))
    assert engine_metrics(reg) == engine_metrics(rreg)


def run_chunks(run_chunk, carry, lengths):
    for n in lengths:
        carry, acc, nsel = run_chunk(carry, n)
    return carry, acc, nsel


def assert_carry_equal(a, b):
    (pa, sa, ca, ra, ta, qa), (pb, sb, cb, rb, tb, qb) = a, b
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert ra == rb and torch.equal(ta, tb) and torch.equal(qa, qb)
    for x, y in zip(torch.utils._pytree.tree_leaves(ca),
                    torch.utils._pytree.tree_leaves(cb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("solver,population", [
    ("stitched", None), ("cuda", None), ("cuda_fused", None),
    ("cuda_fused", (("p_leave", 0.2), ("p_join", 0.3), ("p_fail", 0.25)))])
def test_two_chunks_equal_one_and_telemetry_is_neutral(ref, world, solver,
                                                       population):
    """Chunks of 2 and 3 rounds equal one chunk of 5 bit for bit (params,
    queues, channel carry, round index, accounting, accuracy, n_selected),
    with telemetry off and on; on, the Z gauges equal the host copy of
    the carry's queues and each chunk length counts one first use."""
    _, _, pds, pparams = world
    sim, scfg, ch, sig = port_args(solver, population=population)
    draws = port_draws(ref, ref.jax.random.PRNGKey(4), 5)
    run_chunk = peng.make_chunk_runner(pds, sim, scfg, ch, sig, draws)
    one = run_chunks(run_chunk, peng.init_carry(draws, pparams, scfg, sim,
                                                sig, ch), [5])
    reg = obs.configure(True)
    run_chunk = peng.make_chunk_runner(pds, sim, scfg, ch, sig, draws)
    two = run_chunks(run_chunk, peng.init_carry(draws, pparams, scfg, sim,
                                                sig, ch), [2, 3])
    assert_carry_equal(one[0], two[0])
    assert torch.equal(one[1], two[1]) and torch.equal(one[2], two[2])
    assert two[0][3] == 5
    z = two[0][1].z.numpy()
    assert reg.value("engine_z_mean") == float(z.mean())
    assert reg.value("engine_z_max") == float(z.max())
    assert reg.total("engine_compile_misses_total") == 2.0
    snap = {m["name"]: m for m in reg.snapshot()}
    assert snap["engine_chunk_seconds"]["count"] == 2
    with pytest.raises(ValueError):
        run_chunk(two[0], 0)


def test_chunk_runner_matches_reference(ref, world):
    """Chunks of 1 and 2 rounds (fused decision) against the reference's
    chunk runner on its own key: the final params at rtol 1e-3 / atol
    1e-4, Z at rtol 1e-5 / atol 1e-3, the accounting at rtol 1e-5, and
    the same first-use counters."""
    ds, params, pds, pparams = world
    jax = ref.jax
    key = jax.random.PRNGKey(3)
    rsim = ref.engine.SimConfig(solver="pallas_fused", **SIM)
    rcfg = ref.scheduler.SchedulerConfig(n_clients=EN, model_bits=BITS)
    rch = ref.channel.ChannelConfig(n_clients=EN)
    rsig = ref.channel.heterogeneous_sigmas(EN)
    draws = port_draws(ref, key, 3)        # before the runner donates key
    rreg = ref.obs.configure(True)
    run_ref = ref.engine.make_chunk_runner(ds, rsim, rcfg, rch, rsig)
    carry = ref.engine.init_carry(key, params, rcfg, rsim, rsig, rch)
    for n in (1, 2):
        carry, want_acc, _ = run_ref(carry, n)
    reg = obs.configure(True)
    sim, scfg, ch, sig = port_args("cuda_fused")
    run_chunk = peng.make_chunk_runner(pds, sim, scfg, ch, sig, draws)
    got, acc, _ = run_chunks(run_chunk, peng.init_carry(
        draws, pparams, scfg, sim, sig, ch), [1, 2])
    want = params_from_jax({k: np.asarray(v) for k, v in carry[0].items()},
                           device="cpu")
    for k in want:
        torch.testing.assert_close(got[0][k], want[k], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got[1].z,
                               torch.as_tensor(np.array(carry[1].z)),
                               rtol=1e-5, atol=1e-3)
    for i in (4, 5):
        np.testing.assert_allclose(float(got[i]), float(carry[i]),
                                   rtol=1e-5)
    assert float(acc) == pytest.approx(float(want_acc), abs=2 / 32)
    assert engine_metrics(reg).keys() == engine_metrics(rreg).keys()
    assert reg.total("engine_compile_misses_total") == \
        rreg.total("engine_compile_misses_total") == 2.0
    np.testing.assert_allclose(reg.value("engine_z_mean"),
                               rreg.value("engine_z_mean"), rtol=1e-5,
                               atol=1e-3)


# --------------------------------------------------------------------------
# The tournament.
# --------------------------------------------------------------------------

def test_tournament_neutrality_and_regret_gauges(ref, world):
    """``run_tournament`` on and off bit for bit; on, the sweep's scale
    and one regret gauge per policy equal to its leaderboard row, the
    gauges and counters the reference's instruments record from the same
    leaderboard."""
    _, _, pds, pparams = world
    sim, scfg, ch, sig = port_args("cuda", uniform_m=3.0, rounds=3)
    spec = dict(populations=((), (("p_fail", 0.25),)),
                policies=("proposed", "uniform", "greedy_channel"),
                seeds=(0,))

    def draws(one, seed):
        return port_draws(ref, ref.jax.random.fold_in(
            ref.jax.random.PRNGKey(9), seed), one.rounds)

    off = run_tournament(draws, pparams, pds, sim, scfg, ch, **spec)
    reg = obs.configure(True)
    on = run_tournament(draws, pparams, pds, sim, scfg, ch, **spec)
    for k in ("comm_time", "test_acc", "avg_power", "n_selected",
              "regret_acc", "time_to_acc"):
        np.testing.assert_array_equal(off[k], on[k], err_msg=k)
    assert off["leaderboard"] == on["leaderboard"]
    assert reg.value("tournament_sweeps_total") == 1.0
    assert reg.value("tournament_configs_total") == 6.0
    assert reg.value("tournament_configs_per_sec") > 0.0
    gauges = {m["labels"]["policy"]: m["value"] for m in reg.snapshot()
              if m["name"] == "tournament_regret_acc"}
    assert gauges == {r["policy"]: r["mean_regret_acc"]
                      for r in on["leaderboard"]}
    ti = ref.obs.TournamentInstruments(ref.obs.new_registry(True))
    ti.record(6, 1.0, on["leaderboard"])
    want = {(m["name"], tuple(m["labels"].items())): m.get("value")
            for m in ti.registry.snapshot()
            if m["kind"] != "histogram" and m["name"] !=
            "tournament_configs_per_sec"}
    got = {(m["name"], tuple(m["labels"].items())): m.get("value")
           for m in reg.snapshot()
           if m["name"].startswith("tournament_") and m["kind"] !=
           "histogram" and m["name"] != "tournament_configs_per_sec"}
    assert got == want
