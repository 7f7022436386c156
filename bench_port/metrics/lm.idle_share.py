"""Share of the traced stretch in which no operation ran on the device:
one minus the device's busy seconds (the union of its operation
intervals, from the profiler's trace) over the stretch's own length,
from its first recorded call to the sync that ends it. Both come from
the one trace, so the share lies in [0, 100]; it counts the tracer's own
gaps ("Activity Buffer Request") as idle."""


def read(record, cfg, traffic):
    if not record or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
