"""Multi-tenant online scheduling demo: about a thousand FL deployments
served from one process (twin of the reference's
``examples/scheduler_service.py``).

Each *tenant* is an independent FL deployment (its own client count N,
power budget, lambda/V trade-off and selection policy) with its Eq. 9
virtual power queues held server-side. The scheduler needs only the
instantaneous channel state, so a request is just (tenant, this round's
measured gains, selection draws) and serving is one batched Theorem-2
decision per power-of-two bucket (``repro_torch.service``; the
``proposed`` buckets through the bucket-batched fused CUDA kernel).

The demo registers the ~1,020 heterogeneous tenants of
``service/demo.py`` across three N-buckets, drives a request stream,
prints serving throughput and latency, and checks the service's
operational contract: snapshot mid-stream, keep serving, restore the
snapshot into a fresh service and replay the logged tail, and every queue
comes back bit-identical. Then the tenant lifecycle: evict a tenant
(state spilled), reload it bitwise, a full evict-LRU / reload / serve
cycle, and the replay log compacted against a snapshot.

    PYTHONPATH=src python -m repro_torch.examples.scheduler_service \\
        [--device cpu] [--scale 0.05]

Runs on the card unless ``--device cpu`` is given; ``--scale`` shrinks
the tenant mix (1.0: the reference's ~1,020 tenants).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.service import RequestLog, SchedulerService
from repro_torch.service.demo import (DEFAULT_MIX, demo_request,
                                      lifecycle_cycle,
                                      register_demo_tenants)

ROUNDS = 6


def build_service(rng, device, scale):
    svc = SchedulerService(device=device)
    return svc, register_demo_tenants(svc, rng, DEFAULT_MIX, scale)


def same_z(a, b) -> bool:
    return np.array_equal(np.asarray(a.z), np.asarray(b.z))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    svc, tenants = build_service(np.random.default_rng(0), args.device,
                                 args.scale)
    print(f"tenants: {len(tenants)} across buckets "
          f"{sorted({k.n_bucket for k in svc.store.buckets()})} "
          f"(policies: proposed + uniform)")

    svc.warmup()    # each batch shape's first dispatch, off the path
    snap_at = ROUNDS // 2
    snapshot, log_mark = None, 0
    stream_rng = np.random.default_rng(1)
    walls = []
    for r in range(ROUNDS):
        if r == snap_at:
            snapshot = svc.snapshot()       # mid-stream checkpoint
            log_mark = len(svc.log)         # the replay tail starts here
        reqs = [demo_request(stream_rng, *t) for t in tenants]
        t0 = time.perf_counter()
        for name, gains, raw in reqs:
            svc.submit(name, gains, raw=raw)
        resp = svc.flush()
        wall = time.perf_counter() - t0
        walls.append(wall)
        n_sel = sum(int(d.n_sel) for d in resp.values())
        print(f"round {r}: served {len(resp)} tenants in "
              f"{wall * 1e3:6.1f} ms ({len(resp) / wall:7.0f} "
              f"decisions/s), {n_sel} devices scheduled")
    steady = np.asarray(walls[1:]) * 1e3
    print(f"steady-state: p50 {np.percentile(steady, 50):.1f} ms, "
          f"p99 {np.percentile(steady, 99):.1f} ms per flush")

    name = tenants[0][0]
    st = svc.tenant_state(name)
    print(f"tenant {name!r}: round {int(st.t)}, mean Z = "
          f"{float(np.mean(np.asarray(st.z))):.3f} (Eq. 9 virtual power "
          "queues, held server-side)")

    # the operational contract: restore + replay is bit-exact
    svc2, _ = build_service(np.random.default_rng(0), args.device,
                            args.scale)
    svc2.restore(snapshot)
    tail = RequestLog()
    tail.entries = svc.log.entries[log_mark:]   # one entry per serve group
    replayed = tail.replay(svc2)
    ok = all(same_z(svc.tenant_state(n), svc2.tenant_state(n))
             for n, _, _ in tenants[:50])
    print(f"replayed {tail.n_requests} logged requests ({len(replayed)} "
          f"serve groups) from the mid-stream snapshot: queues "
          f"bit-identical = {ok}")

    # tenant lifecycle: evict / spill -> reload -> serve, bitwise
    by_name = {nm: (n, p) for nm, n, p in tenants}
    live = svc.tenant_state(name)
    svc.evict(name)                             # spill + bucket compaction
    svc.reload(name)
    same = same_z(live, svc.tenant_state(name))
    print(f"evicted + reloaded tenant {name!r}: queues bit-identical = "
          f"{same}")
    cycled = lifecycle_cycle(svc, stream_rng, by_name)
    print(f"full churn cycle (evict_lru -> reload -> serve) on {cycled!r}")

    # bounded replay log: compact against a snapshot
    n_before = len(svc.log)
    svc.compact_log()
    print(f"compact_log(): {n_before} entries -> {len(svc.log)} "
          "(the snapshot rides in the log; replay stays bit-exact)")
    return dict(tenants=len(tenants), replay_exact=ok, reload_exact=same)


if __name__ == "__main__":
    main()
