"""Shared demo fixtures: a heterogeneous multi-bucket tenant population
(twin of ``repro/service/demo.py``; numpy only, so the same seed gives
both packages the same tenants and the same request stream).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import SchedulerConfig

# (clients, tenants, policy) -> buckets 32 / 128 / 512; >= 1000 tenants
DEFAULT_MIX = (
    (24, 600, "proposed"),
    (100, 300, "proposed"),
    (400, 120, "uniform"),
)


def register_demo_tenants(svc, rng: np.random.Generator, mix=DEFAULT_MIX,
                          scale: float = 1.0):
    """Register a heterogeneous tenant population (each its own V, lam,
    ell, Pmax). Returns ``[(name, n, policy), ...]`` for the stream."""
    tenants = []
    for n, count, policy in mix:
        for i in range(max(1, int(count * scale))):
            scfg = SchedulerConfig(
                n_clients=n, model_bits=float(rng.uniform(1e5, 1e7)),
                lam=float(rng.uniform(0.5, 30.0)),
                V=float(rng.uniform(10.0, 1e4)))
            ch = ChannelConfig(n_clients=n,
                               p_max=float(rng.uniform(20.0, 150.0)))
            m_avg = 0.0 if policy == "proposed" else max(1.0, 0.05 * n)
            name = f"{policy[0]}{n}-{i}"
            svc.add_tenant(name, scfg, ch, policy=policy, m_avg=m_avg)
            tenants.append((name, n, policy))
    return tenants


def lifecycle_cycle(svc, rng: np.random.Generator, by_name):
    """One tenant-lifecycle churn cycle: evict the least-recently-used
    resident, reload it (bitwise), then serve it one round. ``by_name``
    maps tenant name -> ``(n, policy)``; returns the cycled name."""
    name = svc.evict_lru()
    svc.reload(name)
    n, policy = by_name[name]
    _, gains, raw = demo_request(rng, name, n, policy)
    svc.submit(name, gains, raw=raw)
    svc.flush(log=False)
    return name


def demo_request(rng: np.random.Generator, name: str, n: int, policy: str):
    """One round's request payload: Rayleigh-ish measured gains (clipped
    positive, as every channel model guarantees) + the policy's raw
    selection draws in the ``POLICY_DRAWS`` layout."""
    gains = -2.0 * np.log(rng.random(n, dtype=np.float32) + 1e-12)
    gains = np.clip(gains, 1e-3, 1e3).astype(np.float32)
    if policy == "proposed":
        raw = rng.random(n, dtype=np.float32)
    elif policy == "uniform":
        raw = {"take": np.float32(rng.random()),
               "scores": rng.random(n, dtype=np.float32)}
    else:
        raw = ()
    return name, gains, raw
