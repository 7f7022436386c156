"""Instrumentation bundles: the named metrics each subsystem records (twin
of ``repro/obs/instrument.py``).

One bundle class per instrumented component, built once at component
construction against a :class:`~repro_torch.obs.metrics.MetricsRegistry`
— when the registry is disabled every attribute is the shared no-op
metric, so the record sites stay a single attribute load + empty call.
The bundles are the single place the metric NAMES live (the reference's
``docs/paper_map.md`` maps them to paper quantities), and the names are
the reference's, so one exporter and one dashboard read both packages.

HOST-SIDE-ONLY RULE (the telemetry-neutrality contract): every recording
site runs on the host, on values that are already on the host (or are
pulled ONLY when telemetry is enabled and only off the serving hot path,
e.g. Z-queue summaries in ``metrics_snapshot``). Nothing here adds device
work or a synchronisation to a served flush or a simulated round — that is
what keeps telemetry-on trajectories bitwise-equal to telemetry-off
(tests/test_torch_obs.py).

Recompile tracking (:class:`CompileTracker`): the reference's service
steps and chunk runners compile one XLA program per operand SHAPE
signature, and the tracker mirrors that cache on the host — a seen-set of
signature keys, a labelled miss the first time a key appears. PyTorch has
no jit cache, and the port keeps the tracker with the reference's keys and
semantics, so both packages count the same misses and warm hits on the
same request stream. What a "miss" costs here is the first dispatch at
that shape: on a CUDA device, the caching allocator growing to the new
batch, fresh pinned staging buffers, and the kernel library's first load
(``kernels/_build.py``) if nothing loaded it yet; on the CPU, the first
allocation of those sizes. ``*_compile_seconds_total`` sums those first
dispatches' host wall time (the enqueue, not the device work, which
lands after the flush's one synchronisation). The metric names stay the
reference's for exporter parity.
"""

from __future__ import annotations

import time
from typing import Dict, Hashable

import numpy as np

from repro_torch.obs.metrics import TIME_EDGES, MetricsRegistry

perf = time.perf_counter

# occupancy / pad-waste edges: group sizes are powers of two <= 64ish,
# waste is a ratio in [0, 1)
OCCUPANCY_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
RATIO_EDGES = (0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)


class CompileTracker:
    """Host mirror of the reference's jit cache: new signature -> labelled
    miss counter.

    ``miss(key)`` returns whether the signature is fresh and counts the
    labelled miss when it is; ``warm(key)`` additionally marks it
    warmup-seeded, so serving-path dispatches landing on a warmed shape
    count ``*_warmup_hits_total`` — the measure of whether ``warmup()``
    actually moved first dispatches off the serving path. Tracking runs
    even when metrics are disabled (a Python set add — the counters are
    no-ops then), so enabling telemetry later cannot change what counts as
    a miss.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self.registry = registry
        self.prefix = prefix
        self._seen: set = set()
        self._warmed: set = set()
        self.compile_s = registry.counter(f"{prefix}_compile_seconds_total")
        self.warm_hits = registry.counter(f"{prefix}_warmup_hits_total")

    def miss(self, key: Hashable, **labels) -> bool:
        """True (and counted) when ``key`` is a fresh signature."""
        if key in self._seen:
            if key in self._warmed:
                self.warm_hits.inc()
            return False
        self._seen.add(key)
        self.registry.counter(f"{self.prefix}_compile_misses_total",
                              **labels).inc()
        return True

    def warm(self, key: Hashable, **labels) -> bool:
        """Like :meth:`miss` but marks the signature as warmup-seeded."""
        fresh = self.miss(key, **labels)
        self._warmed.add(key)
        return fresh

    def forget(self, prefix: Hashable) -> None:
        """Drop every tracked signature whose key starts with ``prefix``
        — mirrors a cache drop (the service rebuilding a bucket's
        ``solver='cuda'`` step), so the next dispatch of a previously
        seen shape counts as fresh."""
        stale = {k for k in self._seen
                 if isinstance(k, tuple) and k and k[0] == prefix}
        self._seen -= stale
        self._warmed -= stale

    def misses_total(self) -> float:
        return self.registry.total(f"{self.prefix}_compile_misses_total")


class ServiceInstruments:
    """Every metric the multi-tenant scheduler service records."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.enabled = registry.enabled
        c, g, h = registry.counter, registry.gauge, registry.histogram
        # serving hot path
        self.submits = c("service_submits_total")
        self.flushes = c("service_flushes_total")
        self.requests = c("service_requests_served_total")
        self.groups = c("service_groups_served_total")
        self.queue_depth = g("service_queue_depth")
        self.flush_s = h("service_flush_seconds")
        # flush wave latency split: host segments. On a CUDA device
        # dispatch_s is the enqueue of the copy and the step's launches,
        # and the device time lands in pull_s, which holds the flush's one
        # synchronisation
        self.stage_s = h("service_flush_stage_seconds")
        self.dispatch_s = h("service_flush_dispatch_seconds")
        self.pull_s = h("service_flush_pull_seconds")
        self.t_comm = h("service_t_comm_seconds")  # Eq. 8 per decision
        # tenant lifecycle
        self.admits = c("service_tenant_admits_total")
        self.evicts = c("service_tenant_evicts_total")
        self.reloads = c("service_tenant_reloads_total")
        self.spills = c("service_tenant_spills_total")
        self.resident = g("service_resident_tenants")
        self.spilled = g("service_spilled_tenants")
        # replay-log growth (unbounded by design; surfaced, not footnoted)
        self.log_entries = g("service_log_entries")
        self.log_bytes = g("service_log_bytes_est")
        self.log_compactions = c("service_log_compactions_total")
        self.compiles = CompileTracker(registry, "service")
        self._per_bucket: Dict[str, tuple] = {}

    def bucket(self, bstr: str) -> tuple:
        """(occupancy, pad_waste) histograms for one bucket, cached so the
        flush path does one dict lookup, not a label-key build."""
        pair = self._per_bucket.get(bstr)
        if pair is None:
            pair = (self.registry.histogram("service_group_occupancy",
                                            edges=OCCUPANCY_EDGES,
                                            bucket=bstr),
                    self.registry.histogram("service_group_pad_waste",
                                            edges=RATIO_EDGES, bucket=bstr))
            self._per_bucket[bstr] = pair
        return pair


class EngineInstruments:
    """Engine / chunk-runner metrics (module default registry).

    Everything is recorded from the HISTORY arrays after the run's one
    read back — rounds/s, per-chunk wall, per-round comm time, selection
    counts — so every engine bitwise contract is untouched.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.enabled = registry.enabled
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.runs = c("engine_runs_total")
        self.rounds = c("engine_rounds_total")
        self.run_s = h("engine_run_seconds")
        self.chunk_s = h("engine_chunk_seconds")
        self.rounds_per_sec = g("engine_rounds_per_sec")
        self.t_comm = h("engine_t_comm_seconds")   # Eq. 8 objective
        self.n_selected = h("engine_n_selected",
                            edges=OCCUPANCY_EDGES)  # q feasibility
        self.z_mean = g("engine_z_mean")            # Eq. 9 virtual queues
        self.z_max = g("engine_z_max")
        self.compiles = CompileTracker(registry, "engine")

    def record_history(self, hist: dict, wall: float) -> None:
        """Record one finished trajectory from its history dict."""
        rounds = int(np.asarray(hist["round"])[-1]) + 1
        self.runs.inc()
        self.rounds.inc(rounds)
        self.run_s.record(wall)
        if wall > 0:
            self.rounds_per_sec.set(rounds / wall)
        comm = np.asarray(hist["comm_time"], np.float64)
        # comm_time is cumulative at eval points; per-interval deltas are
        # the operator-facing per-round scale
        for d in np.diff(comm, prepend=0.0):
            self.t_comm.record(float(d))
        for ns in np.asarray(hist["n_selected"]):
            self.n_selected.record(float(ns))

    def record_policy_state(self, pol_state) -> None:
        """Z-queue summary gauges off a policy state (the host copy of
        ``pol_state.z`` waits for the device, so only call when telemetry
        is enabled and off any hot path)."""
        if not self.enabled:
            return
        z = pol_state.z.detach().cpu().numpy()
        self.z_mean.set(float(z.mean()))
        self.z_max.set(float(z.max()))


class TournamentInstruments:
    """Tournament-driver metrics: sweep scale + scored outcomes."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.enabled = registry.enabled
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.sweeps = c("tournament_sweeps_total")
        self.configs = c("tournament_configs_total")
        self.sweep_s = h("tournament_sweep_seconds", edges=TIME_EDGES)
        self.configs_per_sec = g("tournament_configs_per_sec")

    def record(self, n_configs: int, wall: float, board: list) -> None:
        self.sweeps.inc()
        self.configs.inc(n_configs)
        self.sweep_s.record(wall)
        if wall > 0:
            self.configs_per_sec.set(n_configs / wall)
        for row in board:
            self.registry.gauge("tournament_regret_acc",
                                policy=row["policy"]).set(
                                    row["mean_regret_acc"])


def noop_instruments() -> ServiceInstruments:
    """A ServiceInstruments against a disabled registry (every metric is
    :data:`~repro_torch.obs.metrics.NOOP`) — the default hook for
    components that can be used standalone (TenantStore)."""
    return ServiceInstruments(MetricsRegistry(enabled=False))
