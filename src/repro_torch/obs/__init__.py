"""Runtime telemetry: metrics registry, instrumentation, exporters (twin of
``repro/obs``).

Off-by-default observability for the online control loop the paper
deploys (Eq. 9 queues, per-round comm time, selection counts) and for the
serving machinery around it (flush latency segments, first-dispatch
tracking, tenant lifecycle, replay-log growth). The contract that makes it
safe to thread through every hot path: ALL recording is host-side, on
values already on the host — telemetry-on runs are bitwise-equal to
telemetry-off runs (tests/test_torch_obs.py).

Quickstart::

    from repro_torch import obs
    obs.configure(True)                       # process-wide switch
    svc = SchedulerService(telemetry=True)    # or per-service
    ...serve...
    print(svc.metrics_snapshot(fmt="prometheus"))
"""

from repro_torch.obs.export import EventLog, json_snapshot, prometheus_text
from repro_torch.obs.instrument import (CompileTracker, EngineInstruments,
                                        ServiceInstruments,
                                        TournamentInstruments,
                                        noop_instruments)
from repro_torch.obs.metrics import (NOOP, Counter, Gauge, Histogram,
                                     MetricsRegistry, configure,
                                     default_registry, enabled, new_registry)
from repro_torch.obs.profile import trace_span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NOOP",
    "configure", "default_registry", "enabled", "new_registry",
    "CompileTracker", "EngineInstruments", "ServiceInstruments",
    "TournamentInstruments", "noop_instruments",
    "EventLog", "json_snapshot", "prometheus_text", "trace_span",
]
