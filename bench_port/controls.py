"""The readings that the limits of ``correct`` are set from, at a cell's
own size on the card: the control (the plain reference in the program's
place, computed in TF32, the precision below the configuration's
float32) and the planted faults (a state left unchanged; each minibatch's
first half alone, the mean over it), each judged by the cell's numbers
against the float32 reference.

    python3 bench_port/controls.py --workload <cell> --seeds 11 12 13

Prints one JSON line a seed. The program's own readings, the lower ends
of the limits, are the ``checks`` of ordinary runs (``run.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness  # noqa: E402


def readings(ctx):
    """The control's and the faults' numbers, as the cell's driver reads
    them (its ``control_readings``)."""
    driver = harness.load_module("drivers", ctx.cfg["driver"])
    return driver.control_readings(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _, cfg, traffic = harness.cell_files(args.workload)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.Context(torch=torch, device="cuda", cfg=cfg,
                              traffic=traffic, seed=seed, seconds=0.0,
                              trace=False, start_window=time.perf_counter)
        out = readings(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
