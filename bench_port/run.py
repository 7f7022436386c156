"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration in
``bench_port/configs/`` and its traffic mix in ``bench_port/traffic/``,
runs the driver the configuration names (``bench_port/drivers/``): set-up
from the seed, a window of ``--seconds`` seconds, then the comparison
with the plain reference that decides ``correct``. With ``--trace 1`` it
reports the cell's per-layer metrics instead of its end-to-end ones, each
read from the traced stretch by ``bench_port/metrics/<metric>.py``. The
last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each with its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness  # noqa: E402


def fail(msg: str, code: int = 1) -> int:
    print(msg, file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, cfg, traffic = harness.cell_files(args.workload, bench)
    src = harness.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        return fail(f"no program: {src / 'repro_torch'} is missing")
    sys.path.insert(0, str(src))

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} devices, "
                    f"{torch.cuda.device_count()} visible")

    window = {}

    def start_window() -> float:
        window["t0"] = time.perf_counter()
        return window["t0"]

    driver = harness.load_module("drivers", cfg["driver"])
    ctx = harness.Context(torch=torch, device="cuda", cfg=cfg,
                          traffic=traffic, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          start_window=start_window)
    out = driver.run(ctx)

    found = harness.forbidden_modules()
    if found:
        return fail(f"JAX or the JAX package loaded in the run: {found}", 3)
    if "t0" not in window:
        return fail(f"driver {cfg['driver']} never opened its window")

    values = dict(out.end_to_end, setup_s=window["t0"] - T_START)
    metrics = {}
    for m in harness.metrics_of(bench, args.workload, bool(args.trace)):
        if args.trace:
            value = harness.load_module("metrics", m["name"]).read(
                out.record, cfg, traffic)
        else:
            value = values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if args.trace:
        device.update(busy_s=out.record["busy_s"],
                      window_s=out.record["window_s"])
        result["breakdown"] = {"device_ops": out.record["device_ops"],
                               "idle_gaps": out.record["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
