"""Scrape-able exporters: Prometheus text, JSON snapshots, JSONL events
(twin of ``repro/obs/export.py``, the port's own copy).

Three consumer-facing formats over :meth:`MetricsRegistry.snapshot`:

* :func:`prometheus_text` — the Prometheus text exposition format
  (``# TYPE`` headers, cumulative ``_bucket{le=...}`` histogram series
  with ``+Inf``, ``_sum``/``_count``), so ``curl``/a scraper can ingest a
  service's ``metrics_snapshot(fmt="prometheus")`` directly.
* :func:`json_snapshot` — the same snapshot as one JSON-serializable dict.
* :class:`EventLog` — an append-only JSONL lifecycle log (admit / evict /
  reload / compact / warmup / log-growth warnings) with a bounded
  in-memory tail. File writes are RANK-0 GATED through
  ``repro_torch.launch.distributed.is_main`` so a multi-process job emits
  ONE event stream.

Events and metric snapshots are host-side reads of already-recorded state;
nothing here touches the serving or simulation hot paths.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from repro_torch.launch.distributed import is_main
from repro_torch.obs.metrics import MetricsRegistry


def _labels(labels: dict, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format."""
    by_name: dict = {}
    for entry in registry.snapshot():
        by_name.setdefault((entry["name"], entry["kind"]), []).append(entry)
    lines: List[str] = []
    for (name, kind), entries in sorted(by_name.items()):
        lines.append(f"# TYPE {name} {kind}")
        for e in entries:
            lab = e["labels"]
            if kind == "histogram":
                cum = 0
                for edge, c in zip(e["edges"], e["counts"]):
                    cum += c
                    le = 'le="%g"' % edge
                    lines.append(f"{name}_bucket{_labels(lab, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(f"{name}_bucket{_labels(lab, inf)} "
                             f"{e['count']}")
                lines.append(f"{name}_sum{_labels(lab)} {e['sum']:g}")
                lines.append(f"{name}_count{_labels(lab)} {e['count']}")
            else:
                lines.append(f"{name}{_labels(lab)} {e['value']:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def json_snapshot(registry: MetricsRegistry, **extra) -> dict:
    """One JSON-serializable dict: metrics list + caller extras (e.g. the
    service's on-demand Z-queue summaries)."""
    return {"ts": time.time(), "metrics": registry.snapshot(), **extra}


class EventLog:
    """Append-only JSONL lifecycle event log, rank-0 gated.

    ``emit`` appends to a bounded in-memory tail (``events``) always, and
    to ``path`` (one JSON object per line) on the main process only.
    ``once`` suppresses repeats of the same event key — the one-time
    replay-log growth warning rides it.
    """

    def __init__(self, path: Optional[str] = None, keep: int = 256):
        self.path = path
        self.keep = int(keep)
        self.events: List[dict] = []
        self._fired: set = set()
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)

    def emit(self, event: str, **fields) -> dict:
        rec = {"ts": time.time(), "event": event, **fields}
        self.events.append(rec)
        if len(self.events) > self.keep:
            del self.events[: len(self.events) - self.keep]
        if self.path is not None and is_main():
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        return rec

    def once(self, key: str, event: str, **fields) -> Optional[dict]:
        """Emit at most once per ``key`` for the lifetime of the log."""
        if key in self._fired:
            return None
        self._fired.add(key)
        return self.emit(event, **fields)
