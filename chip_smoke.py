#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. print the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), timing the build;
3. hold each kernel against its plain PyTorch version on the card, at
   N in {1, 100, 1025, 3597, 1048576}, with and without masks: q at
   rtol 1e-5 / atol 1e-6, P and the other power-like outputs at
   rtol 1e-5 / atol 1e-3, tc at rtol 1e-5, ``sel`` exact where
   |u - q| > 1e-6;
4. drive the main path at full width through ``run_simulation``: the
   paper's CIFAR-10 configuration (100 clients, 500 examples each, 2000
   test images, CNN 32/64/120, lambda 10, m_cap 32, I = 10, batch 32),
   5 rounds, ``proposed`` under ``solver="cuda_fused"`` (the default),
   ``"cuda"`` and ``"stitched"`` on the same draws, then ``uniform`` at the
   matched M. Each run starts with the launch counters at 0; the fused
   run must launch only the fused kernel, the cuda run only the solve
   kernel, and all three must select the same clients in every round;
5. profile one more fused run (``torch.profiler``): device time by op
   and the device's busy share;
6. time each kernel and its plain version with CUDA events: device time
   at the main path's N = 100 (L2 warm, as the rounds leave it) and at
   N = 2^20 (L2 flushed before each call), and at N = 100 also the time
   per call with the host's share, calls back to back; beside the least
   time the card needs for the same work.

Prints one JSON line per kernel set (``{"kernels": [...]}``), then, last,
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
CHECK_SIZES = (1, 100, 1025, 3597, 1 << 20)
ROUNDS = 5


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# --------------------------------------------------------------------------

def lanes(torch, n, seed, device):
    """Random solver states with every third lane a branch-boundary state
    (Z = 0, gains at the clip bounds, huge queues), uniforms and a mask."""
    from repro_torch.core.channel import ChannelConfig
    g = torch.Generator(device=device).manual_seed(seed)
    gains = torch.exp(torch.randn(n, generator=g, device=device) * 2.0)
    z = torch.randn(n, generator=g, device=device).abs() * 50.0
    lo, hi = ChannelConfig(n_clients=100).gain_bounds()
    bg = torch.tensor([lo, hi, 1.0, 1e-3, 1e3, 37.0], device=device)
    bz = torch.tensor([0.0, 0.0, 1e4, 5.0, 0.0, 1e-6], device=device)
    idx = torch.arange(0, n, 3, device=device)
    gains[idx] = bg[(idx // 3) % 6]
    z[idx] = bz[(idx // 3) % 6]
    u = torch.rand(n, generator=g, device=device)
    mask = torch.rand(n, generator=g, device=device) < 0.8
    return gains, z, u, mask


def solve_kwargs(scfg, ch):
    return dict(n=scfg.n_clients, v=scfg.V, lam=scfg.lam,
                ell=scfg.model_bits, bandwidth=ch.bandwidth_hz,
                noise=ch.noise_power, p_max=ch.p_max, p_bar=ch.p_bar,
                q_floor=scfg.q_floor)


def compare(torch, name, got, want, rtol, atol):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max())


def check_kernels(torch, scfg, ch, ops):
    from repro_torch.kernels.decision_fused import (decision_fused,
                                                    decision_fused_plain)
    from repro_torch.kernels.scheduler_solve import (scheduler_solve,
                                                     scheduler_solve_plain,
                                                     solve_scalars)
    kw = solve_kwargs(scfg, ch)
    err = {"scheduler_solve": 0.0, "decision_fused": 0.0}
    for n in CHECK_SIZES:
        gains, z, u, mask = lanes(torch, n, n, "cuda")
        q, p = scheduler_solve(gains, z, **kw)
        q0, p0 = scheduler_solve_plain(gains, z, solve_scalars(**kw))
        torch.cuda.synchronize()
        e = max(compare(torch, f"solve q N={n}", q, q0, 1e-5, 1e-6),
                compare(torch, f"solve P N={n}", p, p0, 1e-5, 1e-3))
        err["scheduler_solve"] = max(err["scheduler_solve"], e)
        for masked in (False, True):
            m = mask if masked else None
            got = decision_fused(gains, z, u, ops, active=m, valid=m)
            want = decision_fused_plain(gains, z, u, ops, m, m)
            torch.cuda.synchronize()
            tag = f"fused N={n} masks={masked}"
            e = max(compare(torch, f"{tag} q", got[1], want[1], 1e-5, 1e-6),
                    compare(torch, f"{tag} P", got[2], want[2], 1e-5, 1e-3),
                    compare(torch, f"{tag} Z'", got[3], want[3], 1e-5, 1e-3),
                    compare(torch, f"{tag} tc", got[4], want[4], 1e-5, 0.0),
                    compare(torch, f"{tag} pq", got[5], want[5], 1e-5,
                            1e-3))
            far = (u - want[1]).abs() > 1e-6
            if not torch.equal(got[0][far], want[0][far]):
                raise AssertionError(f"{tag}: selection differs")
            for out in got[1:]:
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{tag}: non-finite output")
            err["decision_fused"] = max(err["decision_fused"], e)
        print(f"kernels agree with plain versions at N={n}", flush=True)
    return err


# --------------------------------------------------------------------------
# Phase 4: the main path at full width.
# --------------------------------------------------------------------------

def main_path(torch):
    import numpy as np

    from repro_torch.configs.cifar10_cnn import CONFIG
    from repro_torch.core.channel import heterogeneous_sigmas
    from repro_torch.data.synthetic import make_cifar10_like
    from repro_torch.fl.simulation import (SimConfig, match_uniform_m,
                                           run_simulation)
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.scheduler_solve import scheduler_solve
    from repro_torch.models.registry import make_model

    # full float32 convolutions and products, as the reference computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = CONFIG.n_clients
    ch, scfg = CONFIG.channel(), CONFIG.scheduler(lam=10.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    ds = make_cifar10_like(gen, n_clients=n, per_client=500, n_test=2000,
                           h=CONFIG.cnn.height, w=CONFIG.cnn.width,
                           c=CONFIG.cnn.channels,
                           n_classes=CONFIG.cnn.n_classes)
    spec = make_model("cnn", ds, conv1=CONFIG.cnn.conv1,
                      conv2=CONFIG.cnn.conv2, hidden=CONFIG.cnn.hidden)
    params = spec.init_fn(gen)
    sig = heterogeneous_sigmas(n)
    torch.cuda.synchronize()
    print(f"data {tuple(ds.client_images.shape)} and CNN "
          f"({sum(p.numel() for p in params.values())} parameters) made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    base = dict(rounds=ROUNDS, eval_every=ROUNDS, m_cap=32,
                gamma=CONFIG.gamma, local_steps=CONFIG.local_steps,
                batch=CONFIG.batch, eval_size=2000,
                model_params=(("conv1", CONFIG.cnn.conv1),
                              ("conv2", CONFIG.cnn.conv2),
                              ("hidden", CONFIG.cnn.hidden)))

    def run(label, **kw):
        scheduler_solve.launches = 0
        decision_fused.launches = 0
        t = time.perf_counter()
        hist = run_simulation(None, params, ds, SimConfig(**base, **kw),
                              scfg, ch, sig, keep_selection=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = {"scheduler_solve": scheduler_solve.launches,
                  "decision_fused": decision_fused.launches}
        comm = hist["comm_time"]
        if not (comm.shape == (2,) and (comm > 0).all()
                and (np.diff(comm) >= 0).all()
                and all(np.isfinite(hist[k]).all()
                        for k in ("comm_time", "test_acc", "avg_power"))
                and ((hist["test_acc"] >= 0) & (hist["test_acc"] <= 1)).all()
                and (hist["n_selected"] >= 1).all()):
            raise AssertionError(f"{label}: bad history {hist}")
        print(f"{label}: {dt:.2f} s for {ROUNDS} rounds, launches {counts}, "
              f"comm_time {comm.tolist()}, test_acc "
              f"{hist['test_acc'].tolist()}, avg_power "
              f"{hist['avg_power'].tolist()}, n_selected "
              f"{hist['n_selected'].tolist()}", flush=True)
        return hist, counts

    fused, c_fused = run("proposed/cuda_fused")
    solve, c_solve = run("proposed/cuda", solver="cuda")
    plain, c_plain = run("proposed/stitched", solver="stitched")
    if not (c_fused == {"scheduler_solve": 0, "decision_fused": ROUNDS}
            and c_solve == {"scheduler_solve": ROUNDS, "decision_fused": 0}
            and c_plain == {"scheduler_solve": 0, "decision_fused": 0}):
        raise AssertionError("the runs did not launch the kernels of their "
                             f"paths: {c_fused} {c_solve} {c_plain}")
    for label, other in (("cuda", solve), ("stitched", plain)):
        if not (fused["selected"] == other["selected"]).all():
            raise AssertionError(f"cuda_fused and {label} selected "
                                 "different clients on the same draws")
        for key in ("comm_time", "avg_power"):
            rel = abs(other[key] / fused[key] - 1.0).max()
            if not rel <= 1e-5:
                raise AssertionError(f"{key}: cuda_fused vs {label} rel "
                                     f"diff {rel}")
    print("cuda_fused, cuda and stitched selected the same clients in every "
          "round", flush=True)
    m = match_uniform_m(torch.Generator(device="cuda").manual_seed(3), sig,
                        scfg, ch, rounds=300)
    uni, _ = run(f"uniform (M={m:.3f})", policy="uniform", uniform_m=m)
    saving = 1.0 - fused["comm_time"][-1] / uni["comm_time"][-1]
    print(f"comm-time saving of proposed vs M-matched uniform after "
          f"{ROUNDS} rounds: {saving:.1%}", flush=True)
    return ({"scheduler_solve": c_solve["scheduler_solve"],
             "decision_fused": c_fused["decision_fused"]}, run)


# --------------------------------------------------------------------------
# Phase 5: where a round's time goes.
# --------------------------------------------------------------------------

def profile_rounds(torch, run):
    """One more fused run under torch.profiler: device time by op name and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run("proposed/cuda_fused under the profiler")
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []  # device-side kernel events only (host ops repeat them)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"profile of {ROUNDS} rounds: wall {wall_ms:.1f} ms, kernels "
          f"{busy:.1f} ms ({busy / wall_ms:.1%} of wall); top kernels:",
          flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:15]:
        print(f"  {ms:10.3f} ms {count:7d}x  {key[:100]}", flush=True)
    ours = [r for r in rows if "decision_fused" in r[2]]
    print(f"  decision_fused kernel: {ours}", flush=True)


# --------------------------------------------------------------------------
# Phase 6: timings.
# --------------------------------------------------------------------------

def time_calls(torch, fn, iters=200):
    """Mean ms per call, host included: calls back to back, as the rounds
    make them (inputs stay in L2)."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_device(torch, fn, cold, iters=20):
    """Mean device ms per call. A spin kernel holds the stream while the
    host enqueues the call, so the events bracket device work only;
    ``cold`` flushes the 50 MB L2 before each call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        if cold:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# Per-lane float32 operations of the solve (each arithmetic op,
# comparison, select and transcendental counted once): Lambert-W ~78,
# two Eq. 17 evaluations 28, two objectives 32, the rest ~19.
SOLVE_OPS = 157
KERNELS = {
    "scheduler_solve": dict(
        source="src/repro_torch/kernels/csrc/scheduler_solve.cu",
        replaces="src/repro/kernels/scheduler_solve.py:91",
        bytes_per_lane=16, ops_per_lane=SOLVE_OPS + 2),
    "decision_fused": dict(
        source="src/repro_torch/kernels/csrc/decision_fused.cu",
        replaces="src/repro/kernels/decision_fused.py:151",
        bytes_per_lane=33, ops_per_lane=SOLVE_OPS + 15),
}


def bound(spec, n):
    t_bytes = spec["bytes_per_lane"] * n / HBM_BYTES_PER_S * 1e3
    t_ops = spec["ops_per_lane"] * n / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def timings(torch, scfg, ch, ops):
    from repro_torch.kernels.decision_fused import (decision_fused,
                                                    decision_fused_plain)
    from repro_torch.kernels.scheduler_solve import (scheduler_solve,
                                                     scheduler_solve_plain,
                                                     solve_scalars)
    kw = solve_kwargs(scfg, ch)
    s = solve_scalars(**kw)
    ops_dev = ops.to("cuda")  # the plain version then copies nothing
    out = {}
    for n in (scfg.n_clients, 1 << 20):
        gains, z, u, _ = lanes(torch, n, 7, "cuda")
        calls = {
            "scheduler_solve": (lambda: scheduler_solve(gains, z, **kw),
                                lambda: scheduler_solve_plain(gains, z, s)),
            "decision_fused": (
                lambda: decision_fused(gains, z, u, ops),
                lambda: decision_fused_plain(gains, z, u, ops_dev)),
        }
        cold = n > scfg.n_clients
        for name, (kernel, plain) in calls.items():
            b, by = bound(KERNELS[name], n)
            row = dict(ms=time_device(torch, kernel, cold),
                       plain_ms=time_device(torch, plain, cold),
                       bound_ms=b, bound_by=by)
            if not cold:
                row.update(call_ms=time_calls(torch, kernel),
                           plain_call_ms=time_calls(torch, plain))
            out[(name, n)] = row
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs the port on a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"{ROOT} holds no src/repro_torch: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.cifar10_cnn import CONFIG
    from repro_torch.fl.decision import decision_coeffs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decision_fused import pack_decision_operands

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {', '.join(logs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    ch, scfg = CONFIG.channel(), CONFIG.scheduler(lam=10.0)
    co = decision_coeffs(scfg, ch)
    ops = pack_decision_operands(co.solve, co.acct)
    err = check_kernels(torch, scfg, ch, ops)
    launches, run = main_path(torch)
    profile_rounds(torch, run)
    times = timings(torch, scfg, ch, ops)

    rows = []
    for name, spec in KERNELS.items():
        small = times[(name, scfg.n_clients)]
        large = times[(name, 1 << 20)]
        rows.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name],
            "launches_per_round": launches[name] / ROUNDS,
            "max_abs_err": err[name], "n": scfg.n_clients,
            "ms": small["ms"], "plain_ms": small["plain_ms"],
            "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
            "library_ms": None, "call_ms": small["call_ms"],
            "plain_call_ms": small["plain_call_ms"],
            "large": dict(n=1 << 20, **large)})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
