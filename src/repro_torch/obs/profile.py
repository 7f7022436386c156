"""Optional profiler spans around flush waves (twin of
``repro/obs/profile.py``).

For the deep dives the metric counters cannot answer ("WHAT inside this
flush was staging vs dispatch vs device compute"), the service can
annotate each flush wave with a named span so a captured trace
(``torch.profiler`` -> its Chrome trace, or Nsight Systems through the
NVTX range) shows the serve groups as labelled spans. The twin of the
reference's ``jax.profiler.TraceAnnotation``: a
``torch.profiler.record_function`` range, plus an NVTX range once CUDA is
initialised.

Spans cost a call into the profiler even when no trace is being captured,
so :func:`trace_span` is a no-op unless process-wide telemetry is on
(``repro_torch.obs.configure(True)``) — the hot path pays one bool check.
Spans are host-side markers: they add no device work and no
synchronisation.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.obs import metrics

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _span(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def trace_span(name: str):
    """Context manager: a named profiler span when telemetry is enabled.

    >>> with trace_span("service.flush/wave0"):
    ...     dispatch_group(...)
    """
    if not metrics.enabled():
        return _NULL
    return _span(name)
