"""What every cell shares: the paths of the checkout, loading a cell's
files by name, the precision a configuration states, the measured window,
the traced stretch and its reduction to a record, the checks that decide
``correct``, and the scan for JAX in the process.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``bench_port/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(workload: str, bench: Optional[dict] = None):
    """A cell's entry of ``BENCHMARK.json``, its configuration and its
    traffic mix (``configs/<config>.json``, ``traffic/<cell>.json``)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    return (cell, load_json(BENCH / "configs" / f"{cell['config']}.json"),
            load_json(BENCH / "traffic" / f"{workload}.json"))


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones that list it, else its end-to-end ones (those with no
    list are every cell's)."""
    if trace:
        return [m for m in bench["per_layer"] if workload in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def set_precision(torch, precision: str):
    """The products a configuration's precision allows: float32 keeps
    every product in float32 (no TF32 in matmuls or convolutions)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


# ----------------------------------------------------------------- checks

class Check(NamedTuple):
    """One number compared with the reference, and its limit: the run is
    correct where every value is finite and at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        v = float(self.value)
        return v == v and abs(v) != float("inf") and v <= self.limit


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   floor_share: float = 1e-3):
    """The widest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger. Leaves whose reference norm is under
    ``floor_share`` of the median leaf's are left out (they move by
    round-off alone). Returns (gap, leaf, number of leaves left out)."""
    norms = sorted(ref.values())
    median = norms[len(norms) // 2]
    worst, at, skipped = 0.0, None, 0
    for k, r in ref.items():
        if r < floor_share * median:
            skipped += 1
            continue
        gap = abs(prog[k] - r) / max(r, median)
        if not gap <= worst:          # NaN counts as the worst
            worst, at = gap, k
    return worst, at, skipped


# ------------------------------------------------------------------ trace

def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_stretch(torch, fn: Callable):
    """Run ``fn`` and a device sync under ``torch.profiler``, recording
    the device's activity and the CUDA runtime calls only (recording
    every host operator as well slows the host), and reduce the
    trace: the stretch's seconds (the first recorded call to the sync's
    end), the union of device operations in it, device seconds by
    operation name, the longest idle gaps with the runtime call that ran
    through each. Returns (fn's value, record)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.time_range.end
              > e.time_range.start]
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CUDA]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != DeviceType.CUDA]
    busy = _union([(s, t) for s, t, _ in dev])
    by_name: Dict[str, List[float]] = {}
    for s, t, name in dev:
        c = by_name.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (t - s) / 1e6
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    named = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + t) / 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        pick = max(around, key=lambda h: h[0], default=None)
        named.append([pick[2] if pick else "host between runtime calls",
                      (t - s) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    record = dict(window_s=(t1 - t0) / 1e6,
                  busy_s=sum(e - s for s, e in busy) / 1e6,
                  kernels={k: v for k, v in by_name.items()},
                  device_ops=[[k, v[1]] for k, v in top],
                  idle_gaps=named)
    return out, record


def warm_profiler(torch):
    """One short profiler session, so the traced stretch does not pay
    the profiler's first start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def kernel_seconds(record: dict, *symbols: str):
    """(launch events, device seconds) of the operations whose names hold
    any of ``symbols``."""
    n, s = 0, 0.0
    for name, (count, secs) in record["kernels"].items():
        if any(x in name for x in symbols):
            n += count
            s += secs
    return n, s


class Context(NamedTuple):
    """What a driver gets: the modules, the cell's data and the run's
    arguments, and the clock that starts the window."""

    torch: object
    device: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    start_window: Callable[[], float]


class Outcome(NamedTuple):
    """What a driver returns."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    record: Optional[dict] = None     # the traced stretch (--trace 1)


def clock() -> float:
    return time.perf_counter()
