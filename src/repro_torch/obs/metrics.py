"""Process-local metrics registry: counters, gauges, fixed-bucket histograms
(twin of ``repro/obs/metrics.py``, the port's own copy).

The paper's algorithm is an ONLINE control loop — Eq. 9 virtual queues,
per-round comm time, selection counts — so a deployment needs to watch
those quantities while it runs, not after. This registry is the substrate:
plain host-side Python/numpy state, single-writer (no locks — every
recording site lives on the host driving thread), OFF by default.

Design constraints, in order:

* **Zero influence on the numerics.** Nothing here touches a device
  tensor on the record path; instrumented code paths are bitwise-identical
  with telemetry on and off (tests/test_torch_obs.py pins this for the
  engine, the chunk runner, the tournament and the service's flush +
  replay).
* **Near-zero cost when disabled.** A disabled registry hands every caller
  the shared :data:`NOOP` metric, whose ``inc``/``set``/``record`` are
  empty ``__slots__`` methods — the hot path pays one attribute load and
  one no-op call.
* **No allocation on the record path when enabled.** Histograms write into
  preallocated numpy count arrays and a fixed ring buffer of recent raw
  values (for percentile snapshots); counters/gauges mutate a slot.

Metrics are keyed by ``(name, sorted label items)``; ``counter`` /
``gauge`` / ``histogram`` are get-or-create, so instrumentation sites can
be declared where they record. Snapshots (:meth:`MetricsRegistry.snapshot`)
are plain-Python lists of dicts consumed by ``repro_torch.obs.export``.

The module-level default registry starts DISABLED; ``configure(True)``
turns it on process-wide (engines and drivers record against it).
Components that want isolated metrics (each ``SchedulerService``) build
their own registry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Default histogram edges: seconds, log-spaced from 50us to ~50s — wide
# enough for flush segments and whole-trajectory walls alike.
TIME_EDGES = tuple(float(x) for x in (
    5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 50.0))


class _Noop:
    """The disabled-path metric: every record op is an empty method."""

    __slots__ = ()

    def inc(self, v=1):
        pass

    def set(self, v):
        pass

    def record(self, x):
        pass


NOOP = _Noop()


class Counter:
    """Monotone event count (float so it can carry seconds totals)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, v=1):
        self.value += v


class Gauge:
    """Last-written value (queue depth, resident tenants, Z summaries)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram + ring buffer of recent raw observations.

    ``counts[i]`` counts observations with ``edges[i-1] < x <= edges[i]``
    (``counts[0]`` is ``x <= edges[0]``, the last slot the overflow). The
    ring holds the most recent ``ring`` raw values so snapshots can report
    honest p50/p99 without storing the full stream; both arrays are
    preallocated — the record path is two slot writes and two scalar adds.
    """

    __slots__ = ("edges", "counts", "total", "count", "ring", "_pos")
    kind = "histogram"

    def __init__(self, edges=TIME_EDGES, ring: int = 512):
        self.edges = np.asarray(edges, np.float64)
        if self.edges.ndim != 1 or np.any(np.diff(self.edges) <= 0):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = np.zeros(self.edges.shape[0] + 1, np.int64)
        self.total = 0.0
        self.count = 0
        self.ring = np.empty(int(ring), np.float64)
        self._pos = 0

    def record(self, x):
        self.counts[np.searchsorted(self.edges, x)] += 1
        self.total += x
        self.count += 1
        self.ring[self._pos] = x
        self._pos += 1
        if self._pos == self.ring.shape[0]:
            self._pos = 0

    def recent(self) -> np.ndarray:
        """The ring's live values (unordered; at most ``ring`` of them)."""
        if self.count >= self.ring.shape[0]:
            return self.ring
        return self.ring[: self._pos]

    def percentile(self, p: float) -> float:
        vals = self.recent()
        if vals.size == 0:
            return float("nan")
        return float(np.percentile(vals, p))


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create registry; disabled instances hand out :data:`NOOP`."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}

    # ------------------------------------------------------------ creation
    def _get(self, cls, name: str, labels: Dict[str, object], **kw):
        if not self.enabled:
            return NOOP
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(**kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, edges=TIME_EDGES, ring: int = 512,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, edges=edges, ring=ring)

    # ------------------------------------------------------------- reading
    def value(self, name: str, **labels) -> float:
        """One counter/gauge value (0.0 if never recorded or disabled)."""
        m = self._metrics.get((name, _label_key(labels)))
        return float(m.value) if m is not None and hasattr(m, "value") \
            else 0.0

    def total(self, name: str) -> float:
        """Sum of a counter across every label combination it was recorded
        under (e.g. compile misses over all (bucket, shape, solver))."""
        return float(sum(m.value for (n, _), m in self._metrics.items()
                         if n == name and isinstance(m, Counter)))

    def snapshot(self) -> List[dict]:
        """Plain-Python metric list (the exporters' input format)."""
        out = []
        for (name, labels), m in sorted(self._metrics.items()):
            entry = {"name": name, "kind": m.kind, "labels": dict(labels)}
            if m.kind == "histogram":
                entry.update(
                    edges=[float(e) for e in m.edges],
                    counts=[int(c) for c in m.counts],
                    sum=float(m.total), count=int(m.count),
                    p50=m.percentile(50), p99=m.percentile(99))
            else:
                entry["value"] = float(m.value)
            out.append(entry)
        return out

    def reset(self) -> None:
        self._metrics.clear()


class _Disabled(MetricsRegistry):
    """The default-off module registry before anyone calls configure()."""

    def __init__(self):
        super().__init__(enabled=False)


_DEFAULT: MetricsRegistry = _Disabled()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the engines/drivers record against."""
    return _DEFAULT


def configure(enabled: bool = True) -> MetricsRegistry:
    """Turn process-wide telemetry on (or back off). Returns the registry.

    Off -> on installs a fresh enabled registry; on -> off installs a
    disabled one (previously handed-out metric objects keep working but
    stop being exported — callers that cached NOOP stay no-op, which is
    why long-lived components snapshot ``default_registry()`` at
    construction time).
    """
    global _DEFAULT
    if _DEFAULT.enabled != bool(enabled):
        _DEFAULT = MetricsRegistry(enabled=bool(enabled))
    return _DEFAULT


def enabled() -> bool:
    return _DEFAULT.enabled


def new_registry(enabled: Optional[bool] = None) -> MetricsRegistry:
    """A fresh isolated registry; ``enabled=None`` inherits the module
    default's switch (so ``SchedulerService()`` follows ``configure``)."""
    return MetricsRegistry(_DEFAULT.enabled if enabled is None
                           else bool(enabled))
