"""Telemetry demo: watch the paper's control loop run, at 1,020 tenants
(twin of the reference's ``examples/telemetry.py``).

The scheduler is an ONLINE stochastic-optimization loop — Eq. 9 virtual
power queues, Eq. 8 per-round comm time, Theorem-2 selection counts — so
an operator needs to see those quantities live. This demo turns on the
``repro_torch.obs`` telemetry layer over the service's demo population
(``service/demo.py``: the ~1,020-tenant heterogeneous mix) and shows what
the layer is for:

* **The cold vs. warmed small-flush story, as counters.** A cold service
  pays each batch shape's first dispatch (allocator growth, fresh pinned
  staging buffers, the kernels' first load) on the serving path;
  ``warmup()`` moves it off. The demo serves small flushes cold, prints
  the ``service_compile_misses_total`` they paid, warms a second service,
  serves the same stream, and prints zero serving-path misses and the
  warm-hit count.
* **Operational signals**: the flush split into its host segments (on a
  GPU the device time lands in the pull, which holds the flush's one
  synchronisation), per-decision Eq. 8 comm time, per-bucket Z-queue
  summaries (copied to the host at snapshot time only) and occupancy.
* **A scrape-able exporter**: ``metrics_snapshot(fmt="prometheus")`` is
  /metrics-ready text; a JSONL event log captures lifecycle events.

All recording is on the host, so the decisions served here are
bitwise-identical to a telemetry-off run (tests/test_torch_obs.py).

    PYTHONPATH=src python -m repro_torch.examples.telemetry [--device cpu]
        [--events out/telemetry_events.jsonl]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.service import SchedulerService
from repro_torch.service.demo import demo_request, register_demo_tenants

ROUNDS = 4


def build(rng, device, **kw):
    svc = SchedulerService(telemetry=True, device=device, **kw)
    return svc, register_demo_tenants(svc, rng)


def serve_stream(svc, tenants, rounds=ROUNDS):
    stream = np.random.default_rng(1)
    for _ in range(rounds):
        for t in tenants:
            name, gains, raw = demo_request(stream, *t)
            svc.submit(name, gains, raw=raw)
        svc.flush()


def small_flush_stream(svc, tenants, sizes=(11, 3, 7, 11)):
    """Steady-state traffic: a few tenants per flush (batch shapes <= 16
    after power-of-two padding — exactly what ``warmup(16)`` covers)."""
    stream = np.random.default_rng(2)
    for k in sizes:
        for t in tenants[:k]:
            name, gains, raw = demo_request(stream, *t)
            svc.submit(name, gains, raw=raw)
        svc.flush()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", default="out/telemetry_events.jsonl",
                    help="JSONL path of the lifecycle event log")
    args = ap.parse_args(argv)

    # --- cold: small-flush serving pays each shape's first dispatch -----
    svc, tenants = build(np.random.default_rng(0), args.device)
    print(f"tenants: {len(tenants)} across buckets "
          f"{sorted({k.n_bucket for k in svc.store.buckets()})}, "
          f"telemetry ON, device {svc.device}")
    small_flush_stream(svc, tenants)
    cold = svc.obs.compiles.misses_total()
    cold_s = svc.obs.registry.value("service_compile_seconds_total")
    print(f"cold small-flush serve: {cold:.0f} first dispatches ON the "
          f"serving path ({cold_s * 1e3:.1f} ms of host time inside flush "
          "latency)")

    # --- warmed: same stream, zero serving-path misses ------------------
    svc, tenants = build(np.random.default_rng(0), args.device,
                         event_log=args.events)
    svc.warmup(max_batch=16)
    warm_base = svc.obs.compiles.misses_total()
    warm_s = svc.obs.registry.value("service_compile_seconds_total")
    small_flush_stream(svc, tenants)
    misses = svc.obs.compiles.misses_total() - warm_base
    hits = svc.obs.registry.value("service_warmup_hits_total")
    print(f"after warmup(max_batch=16) ({warm_s * 1e3:.1f} ms): "
          f"{misses:.0f} serving-path misses, {hits:.0f} dispatches landed "
          "on warmed shapes")

    # --- full-population rounds for the operational gauges (the three
    # full-size batch shapes are first dispatches, visible in the
    # counters) ----------------------------------------------------------
    serve_stream(svc, tenants)

    # --- the operational signals, straight from the snapshot ------------
    snap = svc.metrics_snapshot()
    by_name = {}
    for m in snap["metrics"]:
        by_name.setdefault(m["name"], []).append(m)
    for seg in ("stage", "dispatch", "pull"):
        h = by_name[f"service_flush_{seg}_seconds"][0]
        print(f"flush {seg:8s}: p50 {h['p50'] * 1e3:7.3f} ms  "
              f"(n={h['count']})")
    t_comm = by_name["service_t_comm_seconds"][0]
    print(f"Eq. 8 comm time: p50 {t_comm['p50']:.3f} s per decision "
          f"({t_comm['count']} decisions)")
    for m in by_name["service_z_mean"]:
        print(f"Eq. 9 queues, bucket {m['labels']['bucket']}: "
              f"mean Z = {m['value']:.3f}")
    occ = by_name["service_group_occupancy"]
    print("bucket occupancy p50: " + ", ".join(
        f"{m['labels']['bucket']}={m['p50']:.0f}" for m in occ))
    print(f"events logged: "
          f"{[e['event'] for e in svc.events.events[-3:]]} -> "
          f"{svc.events.path}")

    # --- scrape it ------------------------------------------------------
    prom = svc.metrics_snapshot(fmt="prometheus")
    wanted = ("service_flushes_total", "service_requests_served_total",
              "service_compile_misses_total", "service_z_max")
    print("\n/metrics sample (full text is one scrape handler away):")
    for line in prom.splitlines():
        if line.startswith(wanted):
            print(f"  {line}")


if __name__ == "__main__":
    main()
