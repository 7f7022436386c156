#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), timing the build and printing
   each kernel's registers and spills from ``ptxas``; K2/K3, K4 and K5
   must not spill;
3. hold each kernel against its plain PyTorch version on the card: the
   solve at N in {1, 100, 1025, 3597, 1048576} and at the sweep's 4 x
   3597 = 14388 flattened lanes, bit for bit (and at q rtol 1e-5 / atol
   1e-6, P rtol 1e-5 / atol 1e-3); the fused decision (K2) at the first
   five N
   and at 3, 5 and 1027, with and without masks, bit for bit (and at the
   solve's tolerances, tc at rtol 1e-5, ``sel`` exact where
   |u - q| > 1e-6), also with every lane and mask at storage offset 1;
   the bucket-batched fused decision (K3) at (B, N) in {(1, 8), (7, 1029),
   (1024, 32), (512, 128), (64, 16384), (1, 3), (70000, 4)} (the last past
   CUDA's grid-y limit) with and without ``valid``, heterogeneous operand
   rows, bit for bit, also at storage offset 1; and the SSD scan (K4,
   through ``ops.ssd``, which pads)
   at (b, S, H, P, N) = (1, 100, 2, 32, 16) chunk 32, (2, 384, 24, 64,
   128), generate's prefill (4, 2000, 24, 64, 128), the forward shape
   (4, 2048, 24, 64, 128) and jamba-v0.1-52b's prefill and forward
   (4, 2000 and 2048, 128, 64, 16: N = 16, padded to 32 state columns)
   chunk 128, from a zero and a random
   state (y
   rtol 1e-4 / atol 2e-4, the final state rtol 1e-4 / atol 2e-5: float32
   sums in another order, the kernel's products 3xTF32); and flash
   attention (K5) at the reference tests' shapes (S = 200, windows 128
   and 32, D = 128 bidirectional, bfloat16), Sq != Sk both ways, a
   non-causal window, non-causal (2, 300, 77, 64) (a ragged key tile)
   and (2, 70, 150, 64), and yi-6b's (BH, S, D) = (128, 2000 and 2048,
   128) causal (2e-5 in float32, 2e-2 in bfloat16, the reference tests'
   own), each also with the masked key tiles run instead of skipped (the
   same bits), and on the unexpanded KV heads as the models call it: at
   yi-6b's two shapes (``kv_group=8``) and at each of phase 13's calls
   (``ZOO_FLASH``: chatglm3-6b's ``kv_group`` 16, minicpm-2b's D = 64,
   granite-20b's 48, llama-3.2-vision-11b's self and cross-attention over
   1,601 media keys, seamless-m4t-large-v2's encoder over 4,096 frames,
   its decoder's self and cross-attention; phase 14's mixtral-8x22b
   (96, 8192 and its prefill's 8000, 128) causal with its window of 4,096
   and ``kv_group`` 6, jamba-v0.1-52b's (128, 2048 and 2000, 128)
   ``kv_group`` 4 and kimi-k2-1t-a32b's (64, 1024 and 1000, 128)
   ``kv_group`` 8): bit for bit the
   kernel on the expanded KV and with the masked tiles run, and 2e-5
   from the plain version (run on whole KV groups at a time, so that no
   block of scores passes 4 GB); ``ptxas`` must report no spills in K4
   and K5;
4. drive the main path at full width through ``run_simulation``: the
   paper's CIFAR-10 configuration (100 clients, 500 examples each, 2000
   test images, CNN 32/64/120, lambda 10, m_cap 32, I = 10, batch 32),
   5 rounds, ``proposed`` under ``solver="cuda_fused"`` (the default),
   ``"cuda"`` and ``"stitched"`` on the same draws, then ``uniform`` at the
   matched M. Each run starts with the launch counters at 0; the fused
   run must launch only the fused kernel, the cuda run only the solve
   kernel, and all three must select the same clients in every round;
10. (run right after phase 4) the paper's FEMNIST experiment at full
   width through ``run_simulation``: N = 3,597 writers of 40 examples
   (``make_femnist_like``: 451 MB of images on the card), 10,000 test
   images, CNN 32/64/120 on 28x28x1 with 62 classes, lambda 10, the
   paper's 500/1,500/1,597 sigma split (``resolve_sigmas`` on an
   explicit array), m_cap 32, I = 10, batch 32, 5 rounds, ``proposed``
   under ``"cuda_fused"``, ``"cuda"`` and ``"stitched"`` on the same
   draws: the fused run must launch only K2, 5 times, the cuda run only
   K1, 5 times; then ``run_sweep`` on the same network, seeds (0, 1, 2,
   3), 100 rounds: ``proposed`` under each solver (``"cuda"`` and
   ``"cuda_fused"`` launch K1 exactly once a round for all four seeds,
   ``"stitched"`` nothing) and ``uniform`` at the matched M (no kernel).
   The solvers must select the same clients in every round of the
   FEMNIST run and every (seed, round) of the sweep but at lanes whose
   uniform lies within 1e-6 of q (printed; a farther one fails), and
   ``proposed`` must spend less mean comm time than M-matched uniform;
11. (run right after phase 10) scenarios at full width: the population
   engine (``population = (("p_leave", 0.1), ("p_join", 0.2),
   ("p_fail", 0.25), ("init_active", 0.8))``) through ``run_simulation``
   on phase 4's network (N = 100) and phase 10's (N = 3,597), 5 rounds,
   ``proposed`` under the three solvers on the same draws: the fused run
   must launch only K2 with its activity mask (5), the cuda run only K1
   (5); no inactive lane may be selected or have q != 0; the selections
   must agree but at lanes within 1e-6 of q; ``population=()`` under
   ``"cuda_fused"`` must equal the population-free fused run of phase 4
   or 10 bit for bit (K2 with an all-True mask against K2 unmasked); then
   ``run_tournament`` on the CIFAR-10 network (rayleigh and
   outage_burst(0.2, 4.0) x the populations (), churn (p_leave 0.1,
   p_join 0.2) and stragglers (p_fail 0.25) x all six policies, seed 0,
   5 rounds, phase 4's matched M) under ``solver="cuda"``: K1 exactly 30
   launches, K2 none, the layout (2, 3, 1, 6, 1, 2), regret >= 0 and 0
   for each scenario's oracle; then ``run_sweep`` at N = 3,597, seeds
   0-3, 100 rounds, under ``"cuda"``: all six policies under rayleigh,
   ``proposed`` and ``uniform`` under each of the five other channels at
   their default params, M matched under each channel; ``proposed``
   must launch K1 100 times a sweep, the baselines nothing;
5. profile one more fused run (``torch.profiler``): device time by op
   and the device's busy share;
6. the scheduler service at full width: the demo's deployment mix
   (``service/demo.py::DEFAULT_MIX``: 1,020 tenants, 92,400 clients,
   buckets 32/128/512) under ``solver="stitched"`` and ``"cuda_fused"`` on
   the same seeded request stream (warmup, 6 full flushes, 20 flushes of
   64 random tenants). Same selections in every decision; the fused run
   launches the bucket-batched kernel once per ``proposed`` group and no
   other kernel; snapshot/restore/replay and evict/reload bitwise; a
   homogeneous 64-tenant bucket under ``"cuda"`` launches the solve
   kernel once per group; flush times per solver, and a profile of two
   fused flushes (device time against host time);
12. (run right after phase 6) telemetry (``repro_torch.obs``) on the
   card: the demo mix at full width under ``cuda_fused`` with telemetry
   on (an event log in ``build/``) and off on phase 6's stream (warmup,
   6 full flushes, 20 of 64 tenants, an evict/reload cycle), every
   group's dispatch under ``torch.cuda.set_sync_debug_mode("error")``:
   decisions and tenant state bit-equal, K3 launches equal, the on
   service's log replayed through a fresh telemetry-on service bitwise,
   the flush / request / group counters what was served, the event log
   1,020 admits, warmup, evict, reload; the reference's small-flush
   story (11/3/7/11 tenants: first dispatches > 0 cold, 0 after
   ``warmup(16)`` with warm hits); the flush p50 of telemetry-on and -off
   100-tenant services on 200 16-tenant flushes in turns, and the median
   of the pairs' ratios (fails above a 1.5 p50 ratio); one ``torch.profiler`` session over two full flushes whose
   ``service.flush/wave...`` spans hold every K3 launch; on phase 4's
   network under cuDNN's deterministic algorithms, ``run_simulation``
   (``cuda_fused``, K2 5 each) on and off and the chunk runner (``cuda``,
   K1 5 each) at 2 + 3 against 5 rounds, bit for bit, with the engine
   counters and Z gauges; a 6-config tournament (rayleigh, all-active,
   six policies, ``cuda``) on and off, bit for bit, its counters and one
   regret gauge per policy;
7. (run right after phase 3, before any profiler session) time K1-K3
   and their plain versions with CUDA events: device time at the
   engine's N = 100, FEMNIST's 3,597 and the service's bucket shapes (L2
   warm, as the rounds leave it) and at N = 2^20 or (64, 16384) (L2
   flushed before each call), the time per call with the host's share at
   the warm shapes, calls back to back; beside the least time the card
   needs for the same work; K1's time per call in turns with its earlier
   launch path (old, new, new, old: scalars through numpy on every call,
   two allocations, a device context); for each kernel also the launch
   floor (the empty ``scheduler_solve_launch_floor`` or
   ``decision_launch_floor`` on the same grid), the static SASS count of
   a lane (``cuobjdump -sass``) and the issue-rate floor it gives at the
   card's max SM clock, and, where ``build/decision_fused_pr16.cu`` holds
   the PR-16 design (``git show
   2e05f3b:src/repro_torch/kernels/csrc/decision_fused.cu``, with its
   ``theorem2.cuh`` beside it or the current one), that design behind its
   own launch path, checked bit for bit and timed in turns with this one
   (old, new, new, old), device and per call; and K2 with the
   population's one mask as ``active`` and ``valid`` at N = 100 and
   3,597, device time in turns with the unmasked call, beside its plain
   version and its bound;
8. Mamba-2 (``mamba2-130m``, full width: 24 layers, d_model 768, 129 M
   random float32 parameters from a seed) on the card: with the counts at
   0, a forward at batch 4 x 2048 and ``launch/serve.py::generate``
   (prompt 2000, padded to 2048 inside the scan, 64 greedy tokens); K4
   must launch once per layer in each (24 + 24) and no other kernel;
   prefill plus teacher-forced decode reproduce the forward's logits
   (< 2e-4, decode launching no K4); a batch-1, S-256 forward on the card
   (kernel path) against the same weights' forward on the CPU (plain path)
   at rtol 1e-4 / atol 1e-4; forward ms, prefill s, decode ms per token, a
   profile of one forward and 16 decode steps, and K4's device time at the
   forward shape (each of its four device kernels' share by the profiler)
   beside its plain version's and its bound, and, where
   ``build/ssd_scan_cuda_cores.cu`` holds the earlier K4 that ran on the
   CUDA cores (``git show 3f5cf30:src/repro_torch/kernels/csrc/ssd_scan.cu``),
   that kernel in turns with this one;
9. dense GQA attention (``yi-6b``, full width: 32 layers, d_model 4096,
   32 query heads sharing 4 KV heads of 128, d_ff 11008, untied head,
   6.06 B random float32 parameters from a seed) the same way, after the
   Mamba model is freed: K5 must launch 32 times per forward and 32 per
   prefill (one per layer), never in decode, and no other kernel, and no
   ``repeat_interleave`` may run (K5 reads the unexpanded KV heads); the
   card-against-CPU forward runs the embedding, the first 2 layers and
   the head; then K5's device time at (128, 2048, 128) causal on 16 KV
   heads, as the model calls it, beside its plain version's, its bound and
   PyTorch's ``scaled_dot_product_attention(enable_gqa=True)`` (the
   yardstick; the port never calls it), and, where
   ``build/flash_attention_cuda_cores.cu`` holds the earlier K5 that ran
   on the CUDA cores
   (``git show 3f5cf30:src/repro_torch/kernels/csrc/flash_attention.cu``),
   that kernel on the expanded KV in the same run;
13. the rest of the dense zoo the same way, one id after another, each
   freed before the next: chatglm3-6b (28 layers, 32 query heads on 2 KV
   heads, partial rotary 0.5), minicpm-2b (40 layers, 36 heads of 64,
   tied head), granite-20b (its first 20 of 52 layers, 44.8 GB; 48 query
   heads on one KV head), llama-3.2-vision-11b (40 layers, every 5th a
   cross-attention layer over seeded media embeddings (4, 1601, 4096))
   and seamless-m4t-large-v2 (24 bidirectional encoder layers over seeded
   frames (4, 4096, 1024), 24 decoder layers each with a cross block),
   random float32 weights at full width: K5 must launch 28, 40, 20, 40
   (32 self + 8 cross) and 72 (24 encoder + 24 self + 24 cross) times per
   forward and per prefill, never in decode, and no other kernel; prefill
   plus teacher-forced decode against the forward (< 2e-4; the cross K / V
   computed once at prefill); the card-against-CPU forward runs the first
   2 layers (5 for llama, which holds its first cross-attention layer; 2
   encoder and 2 decoder layers for seamless); forward ms, prefill s and
   decode ms per token by id; then K5's device time at each of the zoo's
   calls (``ZOO_FLASH``) beside its plain version's, its bound and
   ``scaled_dot_product_attention(enable_gqa=True)`` (with a window: the
   band as its boolean mask, memory-efficient backend);
14. the MoE zoo the same way (``MOE_ZOO``), one id after another, each
   freed before the next, random float32 weights at published widths:
   mixtral-8x22b (its first 4 of 56 layers, 41.68 GB; 8 experts top-2,
   window 4,096; forward 2 x 8192, prefill 2 x 8000 into a cache of
   ``cache_len`` 8192, so 4,096 rolling slots, and 16 decode steps past
   the window: K5 4 launches a forward and a prefill, each with
   ``window=4096``), jamba-v0.1-52b (its first period, 8 of 32 layers:
   one attention layer, 7 Mamba, 4 MoE of 16 experts top-2; 53.07 GB;
   forward 4 x 2048, prefill 4 x 2000: K5 1 and K4 7 launches a forward
   and a prefill) and kimi-k2-1t-a32b (its dense prefix layer and one MoE
   layer of 384 experts top-8, 2 of 61 layers, 79.69 GB, drawn in place;
   forward 1 x 1024, prefill 1 x 1000: K5 2 launches), none in decode,
   no other kernel and no ``repeat_interleave``; the (token, k) pairs
   that capacity dropped in the forward and in ``generate``, and the
   largest expert load, counted by hooks in runs of their own (no timed
   run carries them); prefill plus 16 teacher-forced decode steps
   against the forward (< 2e-4; where capacity dropped pairs, forward,
   prefill and decode again at a capacity that drops none, since a
   forward and a prefill over other token counts drop other pairs); the
   card against the CPU at 1 x 256 on mixtral's first layer, jamba's
   first 5 (the attention layer and 2 MoE layers; host copies made
   parameter by parameter) and kimi's prefix layer (the head and the
   embedding with it); the first MoE layer past those on the card: its
   router against the CPU's on the same input (experts equal where the
   k-th / (k+1)-th margin exceeds 1e-5, the slots of the config's
   dispatch, drops included, equal where no near-tie can move them), then
   its output at the config's capacity and at one that drops nothing
   against the explicit mixture of each token's kept top-k experts (rtol
   1e-4 / atol 1e-4, the reference's
   ``test_high_capacity_equals_dense_mixture``; kimi's 67.6 GB MoE layer
   does not go to the host); forward ms, prefill s, decode ms per token,
   a profile and ``torch.cuda.max_memory_allocated`` by id; then K4's
   device time at jamba's shape beside its plain version and its bound
   (phase 3 checks K4 at jamba's forward and prefill shapes, and K5 at
   each id's forward and prefill calls, ``ZOO_FLASH``);
15. training on the card (``train_path``): K5's backward kernel
   (``csrc/flash_attention_bwd.cu``: 3xTF32 ``wgmma`` fed by TMA, a
   prepare pass, dK / dV and dQ, on the lse K5 writes) against its plain
   version (``flash_attention_bwd_ref``, on the card) at
   ``FLASH_BWD_SHAPES``: yi-6b's (128, 2048, 128) causal ``kv_group`` 8,
   minicpm-2b's D = 64, mixtral-8x22b's window of 4,096 at (12, 8192,
   128) ``kv_group`` 6, llama-3.2-vision-11b's non-causal ragged cross
   (2048 x 1,601) ``kv_group`` 4 and transformer_lm's D = 16 padded to
   32; dq, dk, dv within 1e-4 of each one's largest |plain| entry, the
   same bits with the masked tiles run (lse from its own K5 run) and on a
   rerun, and the grouped call against the call on the expanded KV (dq
   bit-equal, dk and dv summed back per group within 3e-5); at each of
   those calls its device ms beside its plain version's, the bound (five
   products over the live pairs in 3xTF32; 2.08 ms at yi's) and
   ``torch.autograd.grad`` through ``scaled_dot_product_attention``
   (``enable_gqa=True``; mixtral's with the band as its boolean mask on
   the memory-efficient backend), and, where
   ``build/flash_attention_bwd_pr23.cu`` holds the PR-23 design
   (``git show ba41782:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``),
   that kernel in turns with this one; then yi-6b at published widths, 4
   of its 32 layers, float32, batch 4 x 2048: a step with K5 against the
   same step with ``_grouped_attention`` on the card on the batch's first
   sequence (loss rtol 1e-5, gradients 1e-4 of each leaf's largest
   |plain|), then, counts at 0, 3 SGD steps (``make_train_step`` over
   ``functional_call`` of the LM module) and one Adam step
   (``optim.adam``), K5 and its backward exactly 4 launches each a step,
   the losses finite; the step's seconds (median of the last 2) and
   ``max_memory_allocated``; one more SGD step under ``torch.profiler``
   (its launches not counted): device time by kernel, K5's and its
   backward's shares, and the same step's device time with the PR-23
   backward's time in place of this one's where that source is at hand;
   then the
   ``transformer_lm`` leg of ``examples/model_zoo_fl.py`` (N = 40, 10
   rounds, ``cuda_fused``) on the card, its draws recorded, and on the
   CPU from the same draws and weights: K2 once a round, K5's forward and
   backward once per layer a local step inside ``vmap(grad)`` (and the
   forward once per layer an evaluation), the selections equal but at
   lanes within 1e-6 of q, the final accuracy within 10 of the 6,400 test
   tokens; and ``ops.ssd`` raising ``NotImplementedError`` on the card
   under grad (K4 has no backward yet).

TF32 is off for every product and convolution in every phase.

Prints the service's, telemetry's, FEMNIST's, the scenarios', Mamba's,
yi's, the zoo's, the MoE zoo's and training's JSON lines, the card line,
one JSON line of the kernels (``{"kernels": [...]}``, K5's backward a row
of its own), then, last, ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the float32 rate
# outside the tensor cores and the dense TF32 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
CHECK_SIZES = (1, 100, 1025, 3597, 1 << 20)
# K2 only: short and ragged vectors
FUSED_EDGE_SIZES = (3, 5, 1027)
ROUNDS = 5
# FEMNIST (paper VI-B) and the policy x seed sweep on its network
FEMNIST_N = 3597
SWEEP_SEEDS = (0, 1, 2, 3)
SWEEP_ROUNDS = 100
# K1's lanes in one sweep round: every seed's clients flattened
SWEEP_LANES = len(SWEEP_SEEDS) * FEMNIST_N
# K1 only: the checked sizes and the sweep's flattened lanes
SOLVE_SIZES = CHECK_SIZES + (SWEEP_LANES,)
# two solvers may select differently only where |u - q| is within this
FLIP_GAP = 1e-6
# The bucket-batched kernel's (B, N) checks; (1024, 32) and (512, 128) are
# the service's proposed groups at full width, (64, 16384) a cold large one.
BATCHED_SHAPES = ((1, 8), (7, 1029), (1024, 32), (512, 128), (64, 16384))
# a single ragged row, and rows past CUDA's grid-y limit (65,535)
BATCHED_EDGE_SHAPES = ((1, 3), (70000, 4))
SERVICE_FULL_FLUSHES = 6
SERVICE_PARTIAL_FLUSHES = 20
SERVICE_PARTIAL_SIZE = 64


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


def offset_view(torch, x):
    """A copy of ``x`` as a contiguous view at storage offset 1 (the tail of
    a flat buffer one element longer)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def bitwise(torch, tag, got, want):
    """Each output equal to the plain version's bit for bit; max |d|."""
    for name, x, y in zip(("sel", "q", "P", "Z'", "tc", "pq"), got, want):
        e = float((x.float() - y.float()).abs().max())
        if not torch.equal(x, y):
            raise AssertionError(f"{tag} {name}: not bitwise equal to the "
                                 f"plain version (max |d| {e})")
    for out in got[1:]:
        if not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: non-finite output")
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(got, want))


def check_kernels(torch, scfg, ch, ops):
    from repro_torch.kernels.decision_fused import (decision_fused,
                                                    decision_fused_plain)
    from repro_torch.kernels.scheduler_solve import (scheduler_solve,
                                                     scheduler_solve_plain,
                                                     solve_scalars)
    kw = solve_kwargs(scfg, ch)
    err = {"scheduler_solve": 0.0, "decision_fused": 0.0}
    for n in sorted(set(SOLVE_SIZES + FUSED_EDGE_SIZES)):
        gains, z, u, mask = lanes(torch, n, n, "cuda")
        if n in SOLVE_SIZES:
            q, p = scheduler_solve(gains, z, **kw)
            q0, p0 = scheduler_solve_plain(gains, z, solve_scalars(**kw))
            torch.cuda.synchronize()
            e = max(compare(torch, f"solve q N={n}", q, q0, 1e-5, 1e-6),
                    compare(torch, f"solve P N={n}", p, p0, 1e-5, 1e-3))
            if not (torch.equal(q, q0) and torch.equal(p, p0)):
                raise AssertionError(f"solve N={n}: not bitwise equal to "
                                     f"the plain version (max |d| {e})")
            err["scheduler_solve"] = max(err["scheduler_solve"], e)
        if n not in CHECK_SIZES + FUSED_EDGE_SIZES:
            print(f"solve kernel equals its plain version at N={n}",
                  flush=True)
            continue
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
            e = max(e, bitwise(torch, tag, got, want))
            # the same lanes at storage offset 1, masks included
            views = [offset_view(torch, x) for x in (gains, z, u)]
            mv = None if m is None else offset_view(torch, m)
            got = decision_fused(*views, ops, active=mv, valid=mv)
            torch.cuda.synchronize()
            bitwise(torch, f"{tag} offset 1", got, want)
            err["decision_fused"] = max(err["decision_fused"], e)
        print(f"kernels agree with plain versions at N={n} (the fused one "
              f"bit for bit, also at storage offset 1)", flush=True)
    return err


def batched_lanes(torch, b, n, seed, device):
    """(B, N) solver states as :func:`lanes` makes them, a ragged ``valid``
    mask and B heterogeneous operand rows (each its own V, lam, ell,
    Pmax, as the service's tenants), on ``device``."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fl.decision import decision_coeffs
    from repro_torch.kernels.decision_fused import pack_decision_operands
    gains, z, u, _ = lanes(torch, b * n, seed, device)
    rng = np.random.default_rng(seed)
    n_real = torch.from_numpy(rng.integers(1, n + 1, b)).to(device)
    valid = torch.arange(n, device=device) < n_real[:, None]
    rows = []
    for _ in range(b):
        m = int(rng.integers(1, 500))
        co = decision_coeffs(
            SchedulerConfig(n_clients=m,
                            model_bits=float(rng.uniform(1e5, 1e7)),
                            lam=float(rng.uniform(0.5, 30.0)),
                            V=float(rng.uniform(10.0, 1e4))),
            ChannelConfig(n_clients=m, p_max=float(rng.uniform(20.0, 150.0))))
        rows.append(pack_decision_operands(co.solve, co.acct))
    ops = torch.stack(rows).to(device)
    return (gains.view(b, n), z.view(b, n), u.view(b, n), valid, ops)


def check_batched(torch):
    """The bucket-batched kernel against its plain version, bit for bit, at
    the checked shapes and the edge shapes, and at storage offset 1."""
    from repro_torch.kernels.decision_fused import (
        decision_fused_batched, decision_fused_batched_plain)
    err = 0.0
    for b, n in BATCHED_SHAPES + BATCHED_EDGE_SHAPES:
        gains, z, u, valid, ops = batched_lanes(torch, b, n, b * n, "cuda")
        for masked in (False, True):
            v = valid if masked else None
            want = decision_fused_batched_plain(gains, z, u, ops, v)
            got = decision_fused_batched(gains, z, u, ops, valid=v)
            torch.cuda.synchronize()
            tag = f"batched ({b}, {n}) valid={masked}"
            err = max(err, bitwise(torch, tag, got, want))
            views = [offset_view(torch, x) for x in (gains, z, u)]
            got = decision_fused_batched(
                *views, ops, valid=None if v is None else offset_view(
                    torch, v))
            torch.cuda.synchronize()
            bitwise(torch, f"{tag} offset 1", got, want)
        print(f"batched kernel equals its plain version at (B, N) = "
              f"({b}, {n}), also at storage offset 1", flush=True)
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
    from repro_torch.models.registry import make_model

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
        reset_counts()
        t = time.perf_counter()
        hist = run_simulation(None, params, ds, SimConfig(**base, **kw),
                              scfg, ch, sig, keep_selection=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = read_counts()
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
    if not (c_fused == launch_counts(decision_fused=ROUNDS)
            and c_solve == launch_counts(scheduler_solve=ROUNDS)
            and c_plain == launch_counts()):
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
    ctx = dict(ds=ds, params=params, sig=sig, scfg=scfg, ch=ch, m=m,
               sim=SimConfig(**base), fused=fused)
    return ({"scheduler_solve": c_solve["scheduler_solve"],
             "decision_fused": c_fused["decision_fused"]}, run, ctx)


# --------------------------------------------------------------------------
# Phase 10 (run right after phase 4): FEMNIST and the sweep at full width.
# --------------------------------------------------------------------------

def same_selections(tag, sel, other, u, q):
    """``sel`` and ``other`` (bool arrays of one shape) agree but at lanes
    whose uniform lies within FLIP_GAP of q; each such lane is printed, a
    differing lane farther from q fails. Returns the count of flips."""
    import numpy as np
    flips = np.argwhere(sel != other)
    for idx in map(tuple, flips):
        gap = abs(float(u[idx]) - float(q[idx]))
        print(f"{tag}: selection differs at {idx}, |u - q| = {gap:.3g}",
              flush=True)
        if gap > FLIP_GAP:
            raise AssertionError(f"{tag}: selection differs at {idx} with "
                                 f"|u - q| = {gap} > {FLIP_GAP}")
    return len(flips)


def femnist_path(torch):
    """The paper's FEMNIST experiment at N = 3,597 through
    ``run_simulation`` under each solver, then the policy x seed sweep
    on its network through ``run_sweep``; launch counts, selections
    across solvers, and proposed's comm-time saving."""
    import numpy as np

    from repro_torch.configs.femnist_cnn import CONFIG, paper_sigmas
    from repro_torch.core.channel import resolve_sigmas
    from repro_torch.data.synthetic import make_femnist_like
    from repro_torch.fl.engine import GeneratorSweepDraws, default_draws
    from repro_torch.fl.engine import run_sweep
    from repro_torch.fl.simulation import SimConfig, run_simulation
    from repro_torch.models.registry import make_model

    n = CONFIG.n_clients
    ch, scfg = CONFIG.channel(), CONFIG.scheduler(lam=10.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    ds = make_femnist_like(gen, n_clients=n, per_client=40, n_test=10000,
                           h=CONFIG.cnn.height, w=CONFIG.cnn.width,
                           c=CONFIG.cnn.channels,
                           n_classes=CONFIG.cnn.n_classes)
    cnn = (("conv1", CONFIG.cnn.conv1), ("conv2", CONFIG.cnn.conv2),
           ("hidden", CONFIG.cnn.hidden))
    params = make_model("cnn", ds, **dict(cnn)).init_fn(gen)
    sig = resolve_sigmas(paper_sigmas(), n, device="cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    counts = torch.nn.functional.one_hot(ds.client_labels, 62).sum(1)
    top = float((counts.max(1).values / 40.0).mean())
    if not (torch.isfinite(ds.client_images).all() and top > 0.12):
        raise AssertionError(f"FEMNIST data: bad images or top-class share "
                             f"{top}")
    print(f"FEMNIST data {tuple(ds.client_images.shape)} "
          f"({ds.client_images.numel() * 4 / 1e6:.0f} MB on the card; mean "
          f"top-class share {top:.3f}) and CNN "
          f"({sum(p.numel() for p in params.values())} parameters) made in "
          f"{data_s:.2f} s", flush=True)
    sim = SimConfig(rounds=ROUNDS, eval_every=ROUNDS, m_cap=32,
                    gamma=CONFIG.gamma, local_steps=CONFIG.local_steps,
                    batch=CONFIG.batch, eval_size=10000, model_params=cnn)

    def run(solver):
        reset_counts()
        t = time.perf_counter()
        hist = run_simulation(None, params, ds,
                              dataclasses.replace(sim, solver=solver),
                              scfg, ch, sig, keep_selection=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = read_counts()
        comm = hist["comm_time"]
        if not (comm.shape == (2,) and (comm > 0).all()
                and (np.diff(comm) >= 0).all()
                and all(np.isfinite(hist[k]).all()
                        for k in ("comm_time", "test_acc", "avg_power"))
                and ((hist["test_acc"] >= 0) & (hist["test_acc"] <= 1)).all()
                and (hist["n_selected"] >= 1).all()):
            raise AssertionError(f"FEMNIST {solver}: bad history {hist}")
        print(f"FEMNIST proposed/{solver}: {dt:.2f} s for {ROUNDS} rounds, "
              f"launches {got}, comm_time {comm.tolist()}, test_acc "
              f"{hist['test_acc'].tolist()}, n_selected "
              f"{hist['n_selected'].tolist()}", flush=True)
        return hist, got, dt

    runs = {s: run(s) for s in ("cuda_fused", "cuda", "stitched")}
    want = {"cuda_fused": launch_counts(decision_fused=ROUNDS),
            "cuda": launch_counts(scheduler_solve=ROUNDS),
            "stitched": launch_counts()}
    for solver, (_, got, _) in runs.items():
        if got != want[solver]:
            raise AssertionError(f"FEMNIST {solver} launched {got}, want "
                                 f"{want[solver]}")
    draws = default_draws(sim, ds)
    u = torch.stack([draws.selection_u(r) for r in range(ROUNDS)])
    u = u.cpu().numpy()
    fused = runs["cuda_fused"][0]
    flips = {}
    for solver in ("cuda", "stitched"):
        other = runs[solver][0]
        flips[solver] = same_selections(
            f"FEMNIST cuda_fused vs {solver}", fused["selected"],
            other["selected"], u, fused["q"])
        if not flips[solver]:
            for key in ("comm_time", "avg_power"):
                rel = abs(other[key] / fused[key] - 1.0).max()
                if not rel <= 1e-5:
                    raise AssertionError(f"FEMNIST {key}: cuda_fused vs "
                                         f"{solver} rel diff {rel}")
    print(f"FEMNIST: cuda_fused, cuda and stitched selected the same "
          f"clients in every round but {flips} lanes within {FLIP_GAP} of "
          f"q", flush=True)

    def sweep(solver, policy):
        reset_counts()
        t = time.perf_counter()
        out = run_sweep(None, sig, scfg, ch, rounds=SWEEP_ROUNDS,
                        policies=(policy,), seeds=SWEEP_SEEDS, seed=0,
                        solver=solver, keep_selection=True)
        dt = time.perf_counter() - t
        got = read_counts()
        for k in ("comm_time", "power", "avg_power"):
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"sweep {policy}/{solver}: non-finite "
                                     f"{k}")
        if not ((out["n_selected"] >= 1).all()
                and (np.diff(out["comm_time"], axis=-1) >= 0).all()):
            raise AssertionError(f"sweep {policy}/{solver}: bad trajectory")
        print(f"sweep {policy}/{solver}: {dt:.3f} s for {SWEEP_ROUNDS} "
              f"rounds x {len(SWEEP_SEEDS)} seeds, launches {got}, mean "
              f"final comm_time {out['comm_time'][0, :, -1].mean():.2f} s, "
              f"mean selected {out['n_selected'].mean():.2f}", flush=True)
        return out, got, dt

    sweeps = {s: sweep(s, "proposed") for s in ("cuda_fused", "cuda",
                                                "stitched")}
    uni, uni_counts, uni_s = sweep("cuda_fused", "uniform")
    for solver in ("cuda_fused", "cuda"):
        if sweeps[solver][1] != launch_counts(scheduler_solve=SWEEP_ROUNDS):
            raise AssertionError(f"sweep proposed/{solver} launched "
                                 f"{sweeps[solver][1]}, want the solve "
                                 f"kernel once per round")
    if sweeps["stitched"][1] != launch_counts() or uni_counts != (
            launch_counts()):
        raise AssertionError("the stitched or uniform sweep launched a "
                             f"kernel: {sweeps['stitched'][1]} {uni_counts}")
    sdraws = GeneratorSweepDraws(0, SWEEP_SEEDS, n, "cuda")
    su = torch.stack([sdraws.selection_u(r) for r in range(SWEEP_ROUNDS)],
                     1).cpu().numpy()
    ref_out = sweeps["cuda"][0]
    sweep_flips = {s: same_selections(
        f"sweep cuda vs {s}", ref_out["selected"][0], sweeps[s][0][
            "selected"][0], su, ref_out["q"][0]) for s in ("cuda_fused",
                                                          "stitched")}
    prop = ref_out["comm_time"][0, :, -1].mean()
    base = uni["comm_time"][0, :, -1].mean()
    saving = 1.0 - prop / base
    if not prop < base:
        raise AssertionError(f"sweep: proposed's mean comm time {prop} is "
                             f"not below M-matched uniform's {base}")
    print(f"sweep: the solvers selected the same clients in every (seed, "
          f"round) but {sweep_flips} lanes within {FLIP_GAP} of q; proposed "
          f"saves {saving:.1%} of mean comm time against M-matched uniform "
          f"(M = {float(uni['uniform_m']):.3f}) over {SWEEP_ROUNDS} rounds",
          flush=True)
    summary = dict(
        n_clients=n, per_client=40, n_test=10000, data_s=data_s,
        top_class_share=top,
        s_per_5_rounds={s: r[2] for s, r in runs.items()},
        launches={s: r[1] for s, r in runs.items()},
        comm_time={s: r[0]["comm_time"].tolist() for s, r in runs.items()},
        test_acc={s: r[0]["test_acc"].tolist() for s, r in runs.items()},
        n_selected=fused["n_selected"].tolist(), flips=flips,
        sweep=dict(rounds=SWEEP_ROUNDS, seeds=list(SWEEP_SEEDS),
                   s_proposed={s: r[2] for s, r in sweeps.items()},
                   s_uniform=uni_s,
                   launches={s: r[1]["scheduler_solve"]
                             for s, r in sweeps.items()},
                   uniform_m=float(uni["uniform_m"]),
                   comm_time_proposed=float(prop),
                   comm_time_uniform=float(base), saving=float(saving),
                   mean_selected_proposed=float(
                       ref_out["n_selected"].mean()),
                   mean_selected_uniform=float(uni["n_selected"].mean()),
                   avg_power_proposed=float(
                       ref_out["avg_power"][0, :, -1].mean()),
                   flips=sweep_flips))
    launches = {
        "femnist": {"scheduler_solve": runs["cuda"][1]["scheduler_solve"],
                    "decision_fused": runs["cuda_fused"][1]["decision_fused"]},
        "sweep": {"scheduler_solve": sum(r[1]["scheduler_solve"]
                                         for r in sweeps.values()),
                  "decision_fused": 0}}
    ctx = dict(ds=ds, params=params, sig=sig, scfg=scfg, ch=ch,
               sim=dataclasses.replace(sim, solver="cuda_fused"),
               fused=runs["cuda_fused"][0])
    return launches, summary, ctx


# --------------------------------------------------------------------------
# Phase 11 (run right after phase 10): scenarios at full width.
# --------------------------------------------------------------------------

# churn and stragglers from a partly active start
POPULATION = (("p_leave", 0.1), ("p_join", 0.2), ("p_fail", 0.25),
              ("init_active", 0.8))
TOURNAMENT = dict(
    channels=("rayleigh",
              ("outage_burst", (("outage_p", 0.2), ("burst_len", 4.0)))),
    populations=((), (("p_leave", 0.1), ("p_join", 0.2)),
                 (("p_fail", 0.25),)),
    policies=("proposed", "uniform", "greedy_channel", "proportional_gain",
              "update_aware", "aoi_capped"),
    seeds=(0,))
NEW_CHANNELS = ("rician", "lognormal", "gauss_markov", "mobility",
                "outage_burst")


def check_history(tag, hist):
    import numpy as np
    comm = hist["comm_time"]
    if not ((comm > 0).all() and (np.diff(comm) >= 0).all()
            and all(np.isfinite(hist[k]).all()
                    for k in ("comm_time", "test_acc", "avg_power"))
            and ((hist["test_acc"] >= 0) & (hist["test_acc"] <= 1)).all()
            and (hist["n_selected"] >= 1).all()):
        raise AssertionError(f"{tag}: bad history {hist}")


def deterministic(torch, fn):
    """``fn()`` under cuDNN's deterministic algorithms (the GPU's training
    is not bitwise reproducible across runs without them)."""
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = flag


def population_runs(torch, width, ctx):
    """The population engine under the three solvers on the same draws,
    and the all-active run against phase 4's / 10's population-free fused
    run: launches, inactive lanes, selections, bits."""
    import numpy as np

    from repro_torch.fl.engine import default_draws
    from repro_torch.fl.simulation import run_simulation

    sim = dataclasses.replace(ctx["sim"], population=POPULATION)
    out, counts, secs = {}, {}, {}
    for solver in ("cuda_fused", "cuda", "stitched"):
        reset_counts()
        t = time.perf_counter()
        hist = run_simulation(None, ctx["params"], ctx["ds"],
                              dataclasses.replace(sim, solver=solver),
                              ctx["scfg"], ctx["ch"], ctx["sig"],
                              keep_selection=True)
        torch.cuda.synchronize()
        secs[solver] = time.perf_counter() - t
        counts[solver] = read_counts()
        check_history(f"{width} population {solver}", hist)
        active = hist["active"]
        if hist["selected"][~active].any() or hist["q"][~active].any():
            raise AssertionError(f"{width} population {solver}: an inactive "
                                 "lane was selected or has q != 0")
        out[solver] = hist
        print(f"{width} population proposed/{solver}: {secs[solver]:.3f} s "
              f"for {ROUNDS} rounds, launches {counts[solver]}, active "
              f"{active.sum(1).tolist()} of {active.shape[1]}, n_selected "
              f"{hist['n_selected'].tolist()}, comm_time "
              f"{hist['comm_time'].tolist()}", flush=True)
    want = {"cuda_fused": launch_counts(decision_fused=ROUNDS),
            "cuda": launch_counts(scheduler_solve=ROUNDS),
            "stitched": launch_counts()}
    for solver, got in counts.items():
        if got != want[solver]:
            raise AssertionError(f"{width} population {solver} launched "
                                 f"{got}, want {want[solver]}")
    fused = out["cuda_fused"]
    draws = default_draws(sim, ctx["ds"])
    u = torch.stack([draws.selection_u(r) for r in range(ROUNDS)])
    u = u.cpu().numpy()
    flips = {}
    for solver in ("cuda", "stitched"):
        if not np.array_equal(out[solver]["active"], fused["active"]):
            raise AssertionError(f"{width}: the activity masks differ "
                                 f"between cuda_fused and {solver}")
        flips[solver] = same_selections(
            f"{width} population cuda_fused vs {solver}", fused["selected"],
            out[solver]["selected"], u, fused["q"])
    # The all-active contract: population=() against the population-free
    # run, back to back with cuDNN's deterministic algorithms, so that the
    # training, too, is bitwise reproducible between the two runs
    degenerate, all_active_counts, all_active_s = {}, {}, {}
    for label, pop in (("free", None), ("all_active", ())):
        reset_counts()
        t = time.perf_counter()
        degenerate[label] = deterministic(torch, lambda: run_simulation(
            None, ctx["params"], ctx["ds"],
            dataclasses.replace(ctx["sim"], population=pop),
            ctx["scfg"], ctx["ch"], ctx["sig"], keep_selection=True))
        torch.cuda.synchronize()
        all_active_s[label] = time.perf_counter() - t
        all_active_counts[label] = read_counts()
    for label, got in all_active_counts.items():
        if got != want["cuda_fused"]:
            raise AssertionError(f"{width} {label} run launched {got}")
    for key in ("comm_time", "test_acc", "avg_power", "n_selected",
                "selected", "q"):
        if not np.array_equal(degenerate["all_active"][key],
                              degenerate["free"][key]):
            raise AssertionError(f"{width}: population=() differs from the "
                                 f"population-free run in {key}")
    # the scheduling outputs also equal the earlier phase's fused run (its
    # training ran without cuDNN's deterministic algorithms)
    for key in ("comm_time", "avg_power", "n_selected", "selected", "q"):
        if not np.array_equal(degenerate["free"][key], ctx["fused"][key]):
            raise AssertionError(f"{width}: the population-free fused run "
                                 f"differs from the earlier phase's in {key}")
    same_acc = bool(np.array_equal(degenerate["free"]["test_acc"],
                                   ctx["fused"]["test_acc"]))
    print(f"{width}: the three solvers selected the same clients in every "
          f"round but {flips} lanes within {FLIP_GAP} of q; no inactive lane "
          f"selected, q = 0 on every one; population=() equals the "
          f"population-free cuda_fused run bit for bit, test accuracy "
          f"included (K2 with an all-True mask against K2 unmasked); the "
          f"earlier phase's run {'has' if same_acc else 'lacks'} the same "
          f"test accuracy {ctx['fused']['test_acc'].tolist()} against "
          f"{degenerate['free']['test_acc'].tolist()}", flush=True)
    launches = {"scheduler_solve": counts["cuda"]["scheduler_solve"],
                "decision_fused": counts["cuda_fused"]["decision_fused"]
                + sum(c["decision_fused"]
                      for c in all_active_counts.values())}
    summary = dict(n_clients=ctx["ds"].n_clients, s_per_5_rounds=secs,
                   all_active_s=all_active_s, flips=flips,
                   earlier_run_same_test_acc=same_acc,
                   active_per_round=fused["active"].sum(1).tolist(),
                   n_selected=fused["n_selected"].tolist(),
                   comm_time={s: h["comm_time"].tolist()
                              for s, h in out.items()},
                   test_acc={s: h["test_acc"].tolist()
                             for s, h in out.items()})
    return launches, summary


def tournament_run(torch, ctx):
    """The 36-config tournament on the CIFAR-10 network under
    ``solver="cuda"``: K1 30 times (6 proposed configs x 5 rounds), the
    reference's layout, regret >= 0 and 0 for each scenario's oracle."""
    import numpy as np

    from repro_torch.fl.engine import eval_rounds
    from repro_torch.fl.tournament import AXES, run_tournament

    sim = dataclasses.replace(ctx["sim"], solver="cuda", uniform_m=ctx["m"])
    reset_counts()
    t = time.perf_counter()
    out = run_tournament(None, ctx["params"], ctx["ds"], sim, ctx["scfg"],
                         ctx["ch"], **TOURNAMENT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    n_prop = (len(TOURNAMENT["channels"]) * len(TOURNAMENT["populations"])
              * len(TOURNAMENT["seeds"]))
    if counts != launch_counts(scheduler_solve=n_prop * ROUNDS):
        raise AssertionError(f"tournament launched {counts}, want K1 "
                             f"{n_prop * ROUNDS} times and nothing else")
    e = len(eval_rounds(sim.rounds, sim.eval_every))
    shape = (2, 3, 1, 6, 1)
    regret = out["regret_acc"]
    if not (out["test_acc"].shape == shape + (e,) and regret.shape == shape
            and (regret >= 0).all()
            and (regret.min(axis=AXES.index("policies")) == 0).all()
            and all(np.isfinite(out[k]).all()
                    for k in ("comm_time", "test_acc", "avg_power"))):
        raise AssertionError(f"tournament: bad layout or regret "
                             f"{out['test_acc'].shape} {regret}")
    configs = int(regret.size)
    print(f"tournament: {configs} configs x {sim.rounds} rounds in "
          f"{wall:.2f} s ({configs / wall:.2f} configs/s), launches "
          f"{counts}; layout {out['test_acc'].shape}", flush=True)
    for row in out["leaderboard"]:
        print(f"  {row['policy']:>17}: mean final acc "
              f"{row['mean_final_acc']:.4f}, regret "
              f"{row['mean_regret_acc']:.4f}, oracle wins "
              f"{row['oracle_wins']}, unreached {row['unreached']}",
              flush=True)
    return counts["scheduler_solve"], dict(
        configs=configs, rounds=sim.rounds, wall_s=wall,
        configs_per_s=configs / wall, matched_m=float(ctx["m"]),
        leaderboard=out["leaderboard"],
        mean_comm_time={p: float(out["comm_time"][..., i, :, -1].mean())
                        for i, p in enumerate(out["policies"])})


def scenario_sweeps(torch, ctx):
    """``run_sweep`` at N = 3,597, seeds 0-3, 100 rounds: all six policies
    under rayleigh, proposed and uniform under each new channel, M matched
    under each channel; proposed under ``cuda`` launches K1 once a round."""
    import numpy as np

    from repro_torch.fl.engine import run_sweep
    from repro_torch.fl.simulation import match_uniform_m

    sig, scfg, ch = ctx["sig"], ctx["scfg"], ctx["ch"]
    plan = [("rayleigh", TOURNAMENT["policies"])] + [
        (c, ("proposed", "uniform")) for c in NEW_CHANNELS]
    k1, rows = 0, {}
    for channel, policies in plan:
        t = time.perf_counter()
        m = match_uniform_m(torch.Generator(device="cuda").manual_seed(5),
                            sig, scfg, ch, rounds=300, channel=channel)
        match_s = time.perf_counter() - t
        row = dict(matched_m=m, match_s=match_s, s={}, mean_comm_time={},
                   mean_selected={})
        for policy in policies:
            reset_counts()
            t = time.perf_counter()
            out = run_sweep(None, sig, scfg, ch, rounds=SWEEP_ROUNDS,
                            policies=(policy,), seeds=SWEEP_SEEDS, seed=0,
                            uniform_m=m, solver="cuda", channel=channel)
            dt = time.perf_counter() - t
            got = read_counts()
            want = launch_counts(scheduler_solve=SWEEP_ROUNDS
                                 if policy == "proposed" else 0)
            if got != want:
                raise AssertionError(f"sweep {policy}/{channel} launched "
                                     f"{got}, want {want}")
            if not (all(np.isfinite(out[k]).all()
                        for k in ("comm_time", "power", "avg_power"))
                    and (out["n_selected"] >= 1).all()
                    and (np.diff(out["comm_time"], axis=-1) >= 0).all()):
                raise AssertionError(f"sweep {policy}/{channel}: bad "
                                     f"trajectory")
            k1 += got["scheduler_solve"]
            row["s"][policy] = dt
            row["mean_comm_time"][policy] = float(
                out["comm_time"][0, :, -1].mean())
            row["mean_selected"][policy] = float(out["n_selected"].mean())
        row["saving"] = 1.0 - (row["mean_comm_time"]["proposed"]
                               / row["mean_comm_time"]["uniform"])
        rows[channel] = row
        print(f"sweep {channel}: M = {m:.3f} (matched in {match_s:.3f} s); "
              + ", ".join(f"{p} {row['s'][p]:.3f} s / comm "
                          f"{row['mean_comm_time'][p]:.1f} s"
                          for p in policies)
              + f"; proposed saves {row['saving']:.1%} against M-matched "
              f"uniform", flush=True)
    return k1, rows


def scenarios_path(torch, cifar, femnist):
    """Phase 11: the population engine at N = 100 and 3,597, the policy
    tournament on the CIFAR-10 network, and the sweeps under every channel
    and policy at N = 3,597."""
    t0 = time.perf_counter()
    pop_cifar, sum_cifar = population_runs(torch, "cifar10", cifar)
    pop_femnist, sum_femnist = population_runs(torch, "femnist", femnist)
    k1_tournament, tournament = tournament_run(torch, cifar)
    k1_sweeps, sweeps = scenario_sweeps(torch, femnist)
    wall = time.perf_counter() - t0
    print(f"phase 11 took {wall:.1f} s", flush=True)
    launches = {
        "scenarios": {
            "scheduler_solve": (pop_cifar["scheduler_solve"]
                                + pop_femnist["scheduler_solve"]
                                + k1_tournament + k1_sweeps),
            "decision_fused": (pop_cifar["decision_fused"]
                               + pop_femnist["decision_fused"])}}
    summary = dict(population=POPULATION, wall_s=wall,
                   cifar10=sum_cifar, femnist=sum_femnist,
                   tournament=tournament, sweeps=sweeps,
                   launches=dict(population_cifar10=pop_cifar,
                                 population_femnist=pop_femnist,
                                 tournament_k1=k1_tournament,
                                 sweeps_k1=k1_sweeps))
    return launches, summary


# --------------------------------------------------------------------------
# Phase 6: the scheduler service at full width.
# --------------------------------------------------------------------------

def counters():
    from repro_torch.kernels.decision_fused import (decision_fused,
                                                    decision_fused_batched)
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    from repro_torch.kernels.scheduler_solve import scheduler_solve
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"scheduler_solve": scheduler_solve,
            "decision_fused": decision_fused,
            "decision_fused_batched": decision_fused_batched,
            "ssd_scan": ssd_scan,
            "flash_attention_bhsd": flash_attention_bhsd,
            "flash_attention_bwd": flash_attention_bwd}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def set_counts(counts):
    """Put the counts back as :func:`read_counts` read them (around a run
    made to measure, not on a path)."""
    for k, fn in counters().items():
        fn.launches = counts[k]


def launch_counts(**nonzero):
    """Every kernel's count: 0 but for ``nonzero``."""
    return dict({k: 0 for k in counters()}, **nonzero)


def percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q))


def service_stream(tenants, seed, full, partial, size):
    """The request stream, made once on the host: ``full`` flushes of
    every tenant, then ``partial`` flushes of ``size`` random tenants."""
    import numpy as np

    from repro_torch.service.demo import demo_request
    rng = np.random.default_rng(seed)
    flushes = [[demo_request(rng, *t) for t in tenants] for _ in range(full)]
    for _ in range(partial):
        pick = sorted(rng.choice(len(tenants), size, replace=False))
        flushes.append([demo_request(rng, *tenants[i]) for i in pick])
    return flushes


def make_service(solver):
    """A service on the card holding the demo mix at scale 1.0."""
    import numpy as np

    from repro_torch.service import SchedulerService
    from repro_torch.service.demo import register_demo_tenants
    svc = SchedulerService(solver=solver)
    tenants = register_demo_tenants(svc, np.random.default_rng(0))
    return svc, tenants


def drive(torch, svc, flushes, full):
    """Serve ``flushes``; per flush the responses, host seconds of the
    submits and of the flush, and the kernel launches it made; a snapshot
    after each full flush, and the log mark after the third."""
    out = dict(resp=[], submit_s=[], flush_s=[], launches=[], snaps=[])
    for f, reqs in enumerate(flushes):
        before = read_counts()
        t0 = time.perf_counter()
        for name, gains, raw in reqs:
            svc.submit(name, gains, raw=raw)
        t1 = time.perf_counter()
        resp = svc.flush()   # ends in one synchronisation
        t2 = time.perf_counter()
        after = read_counts()
        out["resp"].append(resp)
        out["submit_s"].append(t1 - t0)
        out["flush_s"].append(t2 - t1)
        out["launches"].append({k: after[k] - before[k] for k in after})
        if f < full:
            out["snaps"].append(svc.snapshot())
        if f == full // 2 - 1:
            out["mid"] = (svc.snapshot(), len(svc.log))
    torch.cuda.synchronize()
    return out


def max_diffs(a, b):
    """Largest |d| of q, P, t_comm, power over matched decisions, after
    checking that every decision selects the same clients."""
    import numpy as np
    d = dict(q=0.0, p=0.0, t_comm=0.0, power=0.0)
    for ra, rb in zip(a, b):
        if set(ra) != set(rb):
            raise AssertionError("the solvers served different tenants")
        for name, x in ra.items():
            y = rb[name]
            if not np.array_equal(x.sel, y.sel) or x.n_sel != y.n_sel:
                raise AssertionError(f"{name}: stitched and cuda_fused "
                                     "selected different clients")
            for k in d:
                diff = np.abs(np.asarray(getattr(x, k), np.float64)
                              - np.asarray(getattr(y, k), np.float64))
                d[k] = max(d[k], float(np.max(diff)))
    return d


def snaps_equal(a, b):
    import numpy as np
    return set(a) == set(b) and all(
        np.array_equal(x, y) for k in a for x, y in zip(a[k], b[k]))


def service_path(torch):
    """The service's main path over the demo mix. Returns the fused run's
    launch counts, its launches per full flush, a timing summary and the
    fused service with its full flushes."""
    import numpy as np

    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.service import RequestLog, SchedulerService
    from repro_torch.service.demo import demo_request

    full = SERVICE_FULL_FLUSHES
    runs, tenants = {}, None
    for solver in ("stitched", "cuda_fused"):
        svc, tenants = make_service(solver)
        if solver == "stitched":
            flushes = service_stream(tenants, 1, full,
                                     SERVICE_PARTIAL_FLUSHES,
                                     SERVICE_PARTIAL_SIZE)
        t0 = time.perf_counter()
        svc.warmup(1024)
        warm_s = time.perf_counter() - t0
        reset_counts()
        run = drive(torch, svc, flushes, full)
        run["counts"] = read_counts()
        run["svc"], run["warm_s"] = svc, warm_s
        runs[solver] = run
        print(f"service/{solver}: {len(tenants)} tenants, "
              f"{sum(n for _, n, _ in tenants)} clients, warmup "
              f"{warm_s:.2f} s, launches {run['counts']}", flush=True)
    st, fu = runs["stitched"], runs["cuda_fused"]
    d = max_diffs(st["resp"], fu["resp"])
    dz = 0.0
    for a, b in zip(st["snaps"], fu["snaps"]):
        for k in a:
            dz = max(dz, float(np.max(np.abs(a[k].z - b[k].z))))
    print(f"service: stitched and cuda_fused selected the same clients in "
          f"all {sum(len(r) for r in fu['resp'])} decisions; max |d| "
          f"q {d['q']:.3g} P {d['p']:.3g} t_comm {d['t_comm']:.3g} power "
          f"{d['power']:.3g} Z {dz:.3g}", flush=True)
    # the kernel equals its plain version bit for bit, and the fused step
    # sums the same summands in the same order as the stitched one
    if max(dz, *d.values()) != 0.0:
        raise AssertionError("stitched and cuda_fused decisions or Z are "
                             "not bitwise equal")

    n_prop = {k.as_string() for k in fu["svc"].store.buckets()
              if k.policy == "proposed"}
    if st["counts"] != {k: 0 for k in st["counts"]}:
        raise AssertionError(f"stitched launched kernels: {st['counts']}")
    for f, got in enumerate(fu["launches"]):
        names = {r_name for r_name in fu["resp"][f]}
        groups = {fu["svc"].store.spec(nm).bucket.as_string() for nm in names}
        want = launch_counts(decision_fused_batched=len(groups & n_prop))
        if got != want:
            raise AssertionError(f"cuda_fused flush {f} launched {got}, "
                                 f"want {want}")
    per_full = {c["decision_fused_batched"] for c in fu["launches"][:full]}
    if len(per_full) != 1:
        raise AssertionError(f"full flushes launched the batched kernel "
                             f"{sorted(per_full)} times")
    per_full = per_full.pop()
    print(f"service: every cuda_fused flush launched the batched kernel "
          f"once per proposed group ({per_full} per full flush) and no "
          f"other kernel", flush=True)

    # snapshot mid-stream -> fresh service -> replay the tail: bitwise
    svc = fu["svc"]
    snap, mark = fu["mid"]
    fresh, _ = make_service("cuda_fused")
    fresh.restore(snap)
    tail = RequestLog()
    tail.entries = svc.log.entries[mark:]
    tail.replay(fresh, restore=False)
    if not snaps_equal(svc.snapshot(), fresh.snapshot()):
        raise AssertionError("replay from the mid-stream snapshot is not "
                             "bitwise equal to the live state")
    # evict + reload: the tenant's state and the next decisions bitwise
    name = svc.evict_lru()
    before = fresh.tenant_state(name)
    svc.reload(name)
    after = svc.tenant_state(name)
    if not all(np.array_equal(x, y) for x, y in zip(before, after)):
        raise AssertionError(f"evict/reload changed {name}'s state")
    again = service_stream(tenants, 2, 1, 0, 0)[0]
    outs = [drive(torch, s, [again], 1)["resp"][0]
            for s in (svc, fresh)]
    for nm, x in outs[0].items():
        if not all(np.array_equal(a, b) for a, b in zip(x, outs[1][nm])):
            raise AssertionError(f"{nm}: decision after evict/reload differs")
    print(f"service: replay of {len(tail)} logged groups from the "
          f"mid-stream snapshot and evict/reload of {name} are bitwise",
          flush=True)

    # solver="cuda": a configuration-homogeneous 64-tenant N = 100 bucket
    scfg = SchedulerConfig(n_clients=100, model_bits=32 * 555178.0, lam=10.0)
    ch = ChannelConfig(n_clients=100)
    homo = {}
    rng = np.random.default_rng(4)
    reqs = [[demo_request(rng, f"h{i}", 100, "proposed") for i in range(64)]
            for _ in range(3)]
    for solver in ("cuda", "stitched"):
        hs = SchedulerService(solver=solver)
        for i in range(64):
            hs.add_tenant(f"h{i}", scfg, ch)
        reset_counts()
        homo[solver] = drive(torch, hs, reqs, 0)
    want = [launch_counts(scheduler_solve=1)] * len(reqs)
    if homo["cuda"]["launches"] != want:
        raise AssertionError(f"cuda: launches {homo['cuda']['launches']}")
    near = 0
    for ra, rb, fl in zip(homo["cuda"]["resp"], homo["stitched"]["resp"],
                          reqs):
        for nm, _, u in fl:
            far = np.abs(u - rb[nm].q) > 1e-6
            near += int((~far).sum())
            if not np.array_equal(ra[nm].sel[far], rb[nm].sel[far]):
                raise AssertionError(f"cuda vs stitched: {nm} selects "
                                     "differently")
    print(f"service/cuda: homogeneous 64-tenant bucket, the solve kernel "
          f"once per group, same selections as stitched ({near} lanes "
          f"within 1e-6 of q left out)", flush=True)

    summary = {}
    for solver, run in runs.items():
        for mode, sl in (("full", slice(0, full)),
                         ("partial", slice(full, None))):
            fl, sb = run["flush_s"][sl], run["submit_s"][sl]
            summary[f"{solver}/{mode}"] = dict(
                flush_p50_ms=percentile(fl, 50) * 1e3,
                flush_p99_ms=percentile(fl, 99) * 1e3,
                submit_p50_ms=percentile(sb, 50) * 1e3)
    for key, row in summary.items():
        print(f"service {key}: flush p50 {row['flush_p50_ms']:.2f} ms p99 "
              f"{row['flush_p99_ms']:.2f} ms, submits p50 "
              f"{row['submit_p50_ms']:.2f} ms", flush=True)
    return fu["counts"], per_full, summary, (fu["svc"], flushes[:full])


def flush_split(svc, flushes):
    """Host time of full flushes split into the submits, the groups'
    dispatch (staging, the copy and the step's launches) and the rest of
    ``flush`` (its one synchronisation, the pulls and the Decisions),
    medians in ms."""
    import numpy as np
    orig, spent = svc._dispatch_group, []

    def timed(*args):
        t = time.perf_counter()
        out = orig(*args)
        spent.append(time.perf_counter() - t)
        return out

    svc._dispatch_group = timed
    rows = []
    try:
        for reqs in flushes:
            spent.clear()
            t0 = time.perf_counter()
            for name, gains, raw in reqs:
                svc.submit(name, gains, raw=raw)
            t1 = time.perf_counter()
            svc.flush()
            t2 = time.perf_counter()
            rows.append((t1 - t0, sum(spent), t2 - t1 - sum(spent)))
    finally:
        svc._dispatch_group = orig
    med = np.median(np.asarray(rows), axis=0) * 1e3
    split = dict(submit_ms=float(med[0]), dispatch_ms=float(med[1]),
                 sync_pull_ms=float(med[2]))
    print(f"full cuda_fused flush, host split (median of {len(rows)}): "
          f"submits {split['submit_ms']:.2f} ms, group dispatch "
          f"{split['dispatch_ms']:.2f} ms, sync + pulls + decisions "
          f"{split['sync_pull_ms']:.2f} ms", flush=True)
    return split


def profile_flushes(torch, svc, flushes):
    """Two fused full flushes under torch.profiler: device kernel time
    against the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for reqs in flushes[:2]:
            for name, gains, raw in reqs:
                svc.submit(name, gains, raw=raw)
            svc.flush()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    print(f"profile of 2 full cuda_fused flushes: wall {wall_ms:.1f} ms, "
          f"kernels {busy:.3f} ms ({busy / wall_ms:.2%} of wall, "
          f"{sum(r[1] for r in rows)} device ops); top:", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:10.4f} ms {count:7d}x  {key[:90]}", flush=True)
    return dict(wall_ms=wall_ms, device_ms=busy)


# --------------------------------------------------------------------------
# Phase 12 (run right after phase 6): telemetry on the card.
# --------------------------------------------------------------------------

# the reference's obs_overhead leg: 100-tenant services, 16-tenant
# flushes, arms interleaved in alternating order (200 pairs: at 80 the p50
# ratio moved 0.94-1.04 between two runs on one card)
OVERHEAD_SCALE = 0.1
OVERHEAD_BATCH = 16
OVERHEAD_FLUSHES = 200
OVERHEAD_LIMIT = 1.5
# the reference's small-flush story (examples/telemetry.py)
SMALL_FLUSHES = (11, 3, 7, 11)
EVENTS_PATH = ROOT / "build" / "telemetry_events.jsonl"


def set_telemetry(on):
    from repro_torch import obs
    obs.configure(on)


def no_sync_dispatch(torch, svc):
    """Run ``svc``'s group dispatches (staging, the copy, the step's
    launches and the telemetry recorded around them) under
    ``torch.cuda.set_sync_debug_mode("error")``: any implicit
    synchronisation there raises."""
    orig = svc._dispatch_group

    def checked(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    svc._dispatch_group = checked


def serve_logged(torch, svc, flushes):
    """Serve ``flushes``; per flush the responses and the replay log's
    length after it."""
    resp, marks = [], []
    for reqs in flushes:
        for name, gains, raw in reqs:
            svc.submit(name, gains, raw=raw)
        resp.append(svc.flush())
        marks.append(len(svc.log))
    torch.cuda.synchronize()
    return resp, marks


def decisions_equal(a, b):
    import numpy as np
    return set(a) == set(b) and all(
        all(np.array_equal(x, y) for x, y in zip(a[k], b[k])) for k in a)


def telemetry_service(torch):
    """The demo mix at full width under ``cuda_fused``, telemetry on and
    off on phase 6's stream (warmup, full and partial flushes, one
    evict/reload cycle): bitwise neutrality, replay, the counters, the
    event log, and no synchronisation in any group's dispatch."""
    import numpy as np

    from repro_torch.service import SchedulerService
    from repro_torch.service.demo import register_demo_tenants

    full = SERVICE_FULL_FLUSHES
    if EVENTS_PATH.exists():
        EVENTS_PATH.unlink()
    arms, flushes = {}, None
    for arm in ("off", "on"):
        set_telemetry(arm == "on")
        svc = SchedulerService(
            solver="cuda_fused", telemetry=arm == "on",
            event_log=str(EVENTS_PATH) if arm == "on" else None)
        tenants = register_demo_tenants(svc, np.random.default_rng(0))
        if flushes is None:
            flushes = service_stream(tenants, 1, full,
                                     SERVICE_PARTIAL_FLUSHES,
                                     SERVICE_PARTIAL_SIZE)
        svc.warmup(1024)
        no_sync_dispatch(torch, svc)
        reset_counts()
        t = time.perf_counter()
        resp, marks = serve_logged(torch, svc, flushes)
        wall = time.perf_counter() - t
        counts = read_counts()
        name = svc.evict_lru()
        svc.reload(name)
        arms[arm] = dict(svc=svc, resp=resp, marks=marks, counts=counts,
                         wall=wall, cycled=name)
        print(f"telemetry service/{arm}: {len(flushes)} flushes in "
              f"{wall:.3f} s, launches {counts}, evict/reload of {name}",
              flush=True)
    set_telemetry(False)
    on, off = arms["on"], arms["off"]
    if on["counts"] != off["counts"] or on["counts"] != launch_counts(
            decision_fused_batched=on["counts"]["decision_fused_batched"]):
        raise AssertionError(f"telemetry on/off launched {on['counts']} / "
                             f"{off['counts']}")
    for f, (a, b) in enumerate(zip(on["resp"], off["resp"])):
        if not decisions_equal(a, b):
            raise AssertionError(f"telemetry on/off: flush {f} decisions "
                                 "differ")
    if not snaps_equal(on["svc"].snapshot(), off["svc"].snapshot()):
        raise AssertionError("telemetry on/off: tenant state differs")
    if on["cycled"] != off["cycled"] or not all(
            np.array_equal(x, y) for x, y in zip(
                on["svc"].tenant_state(on["cycled"]),
                off["svc"].tenant_state(off["cycled"]))):
        raise AssertionError("telemetry on/off: the evicted and reloaded "
                             "tenant's state differs")
    # the on-service's log through a fresh telemetry-on service
    set_telemetry(True)
    fresh = SchedulerService(solver="cuda_fused", telemetry=True)
    register_demo_tenants(fresh, np.random.default_rng(0))
    replayed = on["svc"].log.replay(fresh)
    set_telemetry(False)
    starts = [0] + on["marks"][:-1]
    for f, (lo, hi) in enumerate(zip(starts, on["marks"])):
        merged = {}
        for entry in replayed[lo:hi]:
            merged.update(entry)
        if not decisions_equal(merged, on["resp"][f]):
            raise AssertionError(f"replay of flush {f} through a fresh "
                                 "telemetry-on service differs")
    reg = on["svc"].obs.registry
    store = on["svc"].store
    groups = sum(len({store.spec(nm).bucket for nm, _, _ in reqs})
                 for reqs in flushes)
    want = {"service_flushes_total": len(flushes),
            "service_requests_served_total": sum(map(len, flushes)),
            "service_groups_served_total": groups,
            "service_log_entries": on["marks"][-1]}
    got = {k: reg.value(k) for k in want}
    if got != want or groups != on["marks"][-1]:
        raise AssertionError(f"telemetry counters {got}, served {want}")
    if off["svc"].metrics_snapshot()["metrics"]:
        raise AssertionError("the telemetry-off service recorded metrics")
    events = [json.loads(ln)["event"]
              for ln in EVENTS_PATH.read_text().splitlines()]
    n_admit = len(store.tenants)
    if events != ["admit"] * n_admit + ["warmup", "evict", "reload"]:
        raise AssertionError(f"event log: {events[:3]}...{events[-4:]} "
                             f"({len(events)} events)")
    snap = on["svc"].metrics_snapshot()
    hist = {m["name"]: m for m in snap["metrics"]
            if m["kind"] == "histogram" and not m["labels"]}
    split = {seg: dict(p50_ms=hist[f"service_flush_{seg}_seconds"]["p50"]
                       * 1e3,
                       count=hist[f"service_flush_{seg}_seconds"]["count"])
             for seg in ("stage", "dispatch", "pull")}
    z = {m["labels"]["bucket"]: m["value"] for m in snap["metrics"]
         if m["name"] == "service_z_mean"}
    print(f"telemetry service: on and off bit-equal in {len(flushes)} "
          f"flushes ({sum(map(len, flushes))} decisions), the tenant state "
          f"and the evict/reload cycle; K3 {on['counts']} in each; replay "
          f"through a fresh telemetry-on service bitwise; counters "
          f"{got}; {len(events)} events ({n_admit} admit, warmup, evict, "
          f"reload); no synchronisation in any group's dispatch; flush "
          f"segments p50 " + ", ".join(f"{k} {v['p50_ms']:.3f} ms"
                                        for k, v in split.items())
          + f"; Eq. 8 t_comm p50 {hist['service_t_comm_seconds']['p50']:.4g}"
          f" s; mean Z per bucket {z}", flush=True)
    return on["counts"]["decision_fused_batched"] * 2, dict(
        flushes=len(flushes), decisions=sum(map(len, flushes)),
        groups=groups, launches_per_arm=on["counts"],
        wall_s={a: arms[a]["wall"] for a in arms}, segments=split,
        t_comm_p50_s=hist["service_t_comm_seconds"]["p50"],
        z_mean=z, events=len(events)), on["svc"], flushes[:2]


def small_flush_story(torch):
    """A cold service serving 11/3/7/11-tenant flushes pays first
    dispatches on the serving path; after ``warmup(16)`` the same stream
    pays none and lands on warmed shapes."""
    import numpy as np

    from repro_torch.service import SchedulerService
    from repro_torch.service.demo import demo_request, register_demo_tenants

    out = {}
    for label in ("cold", "warmed"):
        svc = SchedulerService(solver="cuda_fused", telemetry=True)
        tenants = register_demo_tenants(svc, np.random.default_rng(0))
        warm_s = 0.0
        if label == "warmed":
            svc.warmup(max_batch=16)
            warm_s = svc.obs.registry.value("service_compile_seconds_total")
        base = svc.obs.compiles.misses_total()
        rng = np.random.default_rng(2)
        reset_counts()
        for k in SMALL_FLUSHES:
            for t in tenants[:k]:
                name, gains, raw = demo_request(rng, *t)
                svc.submit(name, gains, raw=raw)
            svc.flush()
        torch.cuda.synchronize()
        reg = svc.obs.registry
        out[label] = dict(
            misses=svc.obs.compiles.misses_total() - base,
            warm_hits=reg.value("service_warmup_hits_total"),
            compile_s=reg.value("service_compile_seconds_total") - warm_s,
            warmup_compile_s=warm_s,
            k3=read_counts()["decision_fused_batched"])
    cold, warmed = out["cold"], out["warmed"]
    if not (cold["misses"] > 0 and warmed["misses"] == 0
            and warmed["warm_hits"] > 0):
        raise AssertionError(f"small-flush story: {out}")
    print(f"small flushes {SMALL_FLUSHES}: cold {cold['misses']:.0f} first "
          f"dispatches on the serving path ({cold['compile_s'] * 1e3:.3f} ms "
          f"service_compile_seconds_total); after warmup(16) "
          f"({warmed['warmup_compile_s'] * 1e3:.3f} ms) "
          f"{warmed['misses']:.0f} misses, {warmed['warm_hits']:.0f} warm "
          f"hits ({warmed['compile_s'] * 1e3:.3f} ms)", flush=True)
    return cold["k3"] + warmed["k3"], out


def telemetry_overhead(torch):
    """The flush p50 of a telemetry-on and a telemetry-off 100-tenant
    service on the same 16-tenant flushes, arms in alternating order."""
    import numpy as np

    from repro_torch.service import SchedulerService
    from repro_torch.service.demo import demo_request, register_demo_tenants

    svcs, tenants = {}, None
    for arm in ("on", "off"):
        svcs[arm] = SchedulerService(solver="cuda_fused",
                                     telemetry=arm == "on")
        tenants = register_demo_tenants(svcs[arm], np.random.default_rng(7),
                                        scale=OVERHEAD_SCALE)
        svcs[arm].warmup(max_batch=OVERHEAD_BATCH)
    rng = np.random.default_rng(11)
    walls = {"on": [], "off": []}
    reset_counts()
    for i in range(OVERHEAD_FLUSHES):
        pick = rng.choice(len(tenants), OVERHEAD_BATCH, replace=False)
        reqs = [demo_request(rng, *tenants[j]) for j in pick]
        order = ("on", "off") if i % 2 == 0 else ("off", "on")
        for arm in order:
            t = time.perf_counter()
            for name, gains, raw in reqs:
                svcs[arm].submit(name, gains, raw=raw)
            svcs[arm].flush(log=False)
            walls[arm].append(time.perf_counter() - t)
    k3 = read_counts()["decision_fused_batched"]
    p50 = {arm: percentile(w, 50) * 1e3 for arm, w in walls.items()}
    ratio = p50["on"] / p50["off"]
    # each pair served the same requests back to back
    paired = percentile([a / b for a, b in zip(walls["on"], walls["off"])],
                        50)
    print(f"telemetry overhead: {len(tenants)} tenants, {OVERHEAD_FLUSHES} "
          f"flushes of {OVERHEAD_BATCH} per arm in turns: p50 on "
          f"{p50['on']:.4f} ms, off {p50['off']:.4f} ms, ratio "
          f"{ratio:.4f}; median of the pairs' ratios {paired:.4f}",
          flush=True)
    if ratio > OVERHEAD_LIMIT:
        raise AssertionError(f"telemetry-on flush p50 is {ratio:.3f}x the "
                             f"off one (limit {OVERHEAD_LIMIT})")
    return k3, dict(tenants=len(tenants), flushes=OVERHEAD_FLUSHES,
                    batch=OVERHEAD_BATCH, p50_ms_enabled=p50["on"],
                    p50_ms_disabled=p50["off"], p50_ratio=ratio,
                    paired_ratio_p50=paired)


def span_check(torch, svc, flushes):
    """One ``torch.profiler`` session over two telemetry-on full flushes:
    the ``service.flush/wave...`` spans are in the trace, every K3 launch
    falls inside one, and the device ran one K3 kernel per launch."""
    import repro_torch.service.step as step_mod
    from torch.profiler import ProfilerActivity, profile
    k3 = step_mod.decision_fused_batched

    def marked(*args, **kw):
        with torch.profiler.record_function("k3_launch"):
            return k3(*args, **kw)

    set_telemetry(True)
    step_mod.decision_fused_batched = marked
    reset_counts()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for reqs in flushes:
                for name, gains, raw in reqs:
                    svc.submit(name, gains, raw=raw)
                svc.flush()
            torch.cuda.synchronize()
    finally:
        step_mod.decision_fused_batched = k3
        set_telemetry(False)
    launches = read_counts()["decision_fused_batched"]
    events = prof.events()
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    spans = [e.time_range for e in host
             if e.name.startswith("service.flush/wave")]
    marks = [e.time_range for e in host if e.name == "k3_launch"]
    inside = sum(any(s.start <= m.start and m.end <= s.end for s in spans)
                 for m in marks)
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "decision_kernel" in e.key)
    if not (spans and len(marks) == launches == inside == kernels):
        raise AssertionError(f"spans {len(spans)}, K3 launches {launches}, "
                             f"marked {len(marks)}, inside a span {inside}, "
                             f"device kernels {kernels}")
    print(f"profiler spans: {len(spans)} service.flush/wave spans over 2 "
          f"full flushes; all {launches} K3 launches inside one, "
          f"{kernels} K3 kernels on the device", flush=True)
    return launches, dict(spans=len(spans), k3_launches=launches,
                          k3_device_kernels=kernels)


def telemetry_engine(torch, ctx):
    """``run_simulation`` at CIFAR-10 width under ``cuda_fused``, telemetry
    on and off back to back (deterministic cuDNN): histories bit-equal,
    K2 5 launches each, the engine counters; then the chunk runner under
    ``cuda``: chunks of 2 + 3 rounds equal one of 5 bit for bit (K1 5
    launches each), the Z gauges the host copy of the carry's queues."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.fl.engine import (default_draws, init_carry,
                                       make_chunk_runner)
    from repro_torch.fl.simulation import run_simulation

    sim = ctx["sim"]
    args = (ctx["scfg"], ctx["ch"], ctx["sig"])
    hists, counts, secs = {}, {}, {}
    for arm in ("off", "on"):
        set_telemetry(arm == "on")
        reset_counts()
        t = time.perf_counter()
        hists[arm] = deterministic(torch, lambda: run_simulation(
            None, ctx["params"], ctx["ds"], sim, *args,
            keep_selection=True))
        secs[arm] = time.perf_counter() - t
        counts[arm] = read_counts()
    reg = obs.default_registry()
    rounds_per_s = reg.value("engine_rounds_per_sec")
    engine = {k: reg.value(k) for k in ("engine_runs_total",
                                        "engine_rounds_total")}
    set_telemetry(False)
    want = launch_counts(decision_fused=ROUNDS)
    if counts["on"] != want or counts["off"] != want:
        raise AssertionError(f"engine on/off launched {counts}")
    for key, x in hists["off"].items():
        if not np.array_equal(x, hists["on"][key]):
            raise AssertionError(f"engine on/off: {key} differs")
    if not (engine == {"engine_runs_total": 1.0,
                       "engine_rounds_total": float(ROUNDS)}
            and rounds_per_s > 0):
        raise AssertionError(f"engine counters {engine}, rounds/s "
                             f"{rounds_per_s}")
    csim = dataclasses.replace(sim, solver="cuda")
    draws = default_draws(csim, ctx["ds"])
    chunks, chunk_counts = {}, {}
    for lengths in ((ROUNDS,), (2, ROUNDS - 2)):
        set_telemetry(lengths != (ROUNDS,))
        reset_counts()

        def run():
            run_chunk = make_chunk_runner(ctx["ds"], csim, *args[:2],
                                          ctx["sig"], draws)
            carry = init_carry(draws, ctx["params"], ctx["scfg"], csim,
                               ctx["sig"], ctx["ch"])
            for n in lengths:
                carry, acc, nsel = run_chunk(carry, n)
            return carry, acc, nsel

        chunks[lengths] = deterministic(torch, run)
        torch.cuda.synchronize()
        chunk_counts[lengths] = read_counts()
    reg = obs.default_registry()
    z_gauges = (reg.value("engine_z_mean"), reg.value("engine_z_max"))
    chunk_s = [m for m in reg.snapshot()
               if m["name"] == "engine_chunk_seconds"][0]
    set_telemetry(False)
    (c1, a1, n1), (c2, a2, n2) = chunks[(ROUNDS,)], chunks[(2, ROUNDS - 2)]
    same = (all(torch.equal(c1[0][k], c2[0][k]) for k in c1[0])
            and all(torch.equal(x, y) for x, y in zip(c1[1], c2[1]))
            and torch.equal(c1[2], c2[2]) and c1[3] == c2[3] == ROUNDS
            and torch.equal(c1[4], c2[4]) and torch.equal(c1[5], c2[5])
            and torch.equal(a1, a2) and torch.equal(n1, n2))
    if not same:
        raise AssertionError("chunks of 2 + 3 rounds differ from one of 5")
    for lengths, got in chunk_counts.items():
        if got != launch_counts(scheduler_solve=ROUNDS):
            raise AssertionError(f"chunks {lengths} launched {got}")
    z = c2[1].z.cpu().numpy()
    if z_gauges != (float(z.mean()), float(z.max())):
        raise AssertionError(f"Z gauges {z_gauges} against the carry's "
                             f"{float(z.mean())}, {float(z.max())}")
    print(f"telemetry engine: run_simulation on and off bit-equal "
          f"({secs['off']:.3f} / {secs['on']:.3f} s for {ROUNDS} rounds, K2 "
          f"{ROUNDS} each), engine_rounds_per_sec {rounds_per_s:.2f}; "
          f"chunks 2 + {ROUNDS - 2} equal one of {ROUNDS} bit for bit under "
          f"cuda (K1 {ROUNDS} "
          f"each), Z gauges {z_gauges} = the carry's, chunk p50 "
          f"{chunk_s['p50'] * 1e3:.1f} ms", flush=True)
    return {"decision_fused": 2 * ROUNDS,
            "scheduler_solve": 2 * ROUNDS}, dict(
        run_s=secs, rounds_per_sec=rounds_per_s, z_gauges=list(z_gauges),
        chunk_p50_ms=chunk_s["p50"] * 1e3)


def telemetry_tournament(torch, ctx):
    """``run_tournament`` (rayleigh x all-active x six policies, seed 0, 5
    rounds: 6 configs) under ``cuda``, telemetry on and off back to back
    (deterministic cuDNN): leaderboards and trajectories bit-equal, K1 the
    same, and the counters and regret gauges."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.fl.tournament import run_tournament

    sim = dataclasses.replace(ctx["sim"], solver="cuda", uniform_m=ctx["m"])
    spec = dict(channels=("rayleigh",), populations=((),),
                policies=TOURNAMENT["policies"], seeds=(0,))
    outs, counts = {}, {}
    for arm in ("off", "on"):
        set_telemetry(arm == "on")
        reset_counts()
        outs[arm] = deterministic(torch, lambda: run_tournament(
            None, ctx["params"], ctx["ds"], sim, ctx["scfg"], ctx["ch"],
            **spec))
        counts[arm] = read_counts()
    reg = obs.default_registry()
    configs = reg.value("tournament_configs_total")
    per_s = reg.value("tournament_configs_per_sec")
    gauges = {m["labels"]["policy"]: m["value"] for m in reg.snapshot()
              if m["name"] == "tournament_regret_acc"}
    set_telemetry(False)
    on, off = outs["on"], outs["off"]
    if on["leaderboard"] != off["leaderboard"] or not all(
            np.array_equal(on[k], off[k])
            for k in ("comm_time", "test_acc", "avg_power", "n_selected")):
        raise AssertionError("tournament on/off differ")
    if counts["on"] != counts["off"] or counts["on"] != launch_counts(
            scheduler_solve=ROUNDS):
        raise AssertionError(f"tournament on/off launched {counts}")
    n = len(TOURNAMENT["policies"])
    want = {r["policy"]: r["mean_regret_acc"] for r in on["leaderboard"]}
    if configs != n or gauges != want or not per_s > 0:
        raise AssertionError(f"tournament counters: configs {configs}, "
                             f"gauges {gauges}, want {want}")
    print(f"telemetry tournament: {n} configs on and off bit-equal, K1 "
          f"{counts['on']['scheduler_solve']} each; "
          f"tournament_configs_total {configs:.0f}, configs/s {per_s:.2f}, "
          f"regret gauges {gauges}", flush=True)
    return 2 * ROUNDS, dict(configs=n, configs_per_sec=per_s,
                            regret_acc=gauges)


def telemetry_path(torch, ctx):
    """Phase 12: telemetry on the card, through the service, the engine,
    the chunk runner and the tournament. Returns the launches by kernel
    and the phase's summary."""
    t0 = time.perf_counter()
    k3_service, service, svc, two = telemetry_service(torch)
    k3_story, story = small_flush_story(torch)
    k3_over, overhead = telemetry_overhead(torch)
    k3_spans, spans = span_check(torch, svc, two)
    del svc
    engine_counts, engine = telemetry_engine(torch, ctx)
    k1_tournament, tournament = telemetry_tournament(torch, ctx)
    wall = time.perf_counter() - t0
    print(f"phase 12 took {wall:.1f} s", flush=True)
    launches = {"decision_fused_batched": (k3_service + k3_story + k3_over
                                           + k3_spans),
                "decision_fused": engine_counts["decision_fused"],
                "scheduler_solve": (engine_counts["scheduler_solve"]
                                    + k1_tournament)}
    return launches, dict(wall_s=wall, service=service, small_flushes=story,
                          overhead=overhead, spans=spans, engine=engine,
                          tournament=tournament, launches=launches)


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
# Phase 7: timings.
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
    # K2 under the population's one mask (``active`` and ``valid`` are
    # the same tensor, read once): 12 B + 1 B read, 21 B written, two
    # more selects a lane
    "decision_fused_masked": dict(
        source="src/repro_torch/kernels/csrc/decision_fused.cu",
        replaces="src/repro/kernels/decision_fused.py:151",
        bytes_per_lane=34, ops_per_lane=SOLVE_OPS + 17),
    # 12 B read + 1 B valid + 21 B written per lane, and each row's 14
    # float32 operands read once
    "decision_fused_batched": dict(
        source="src/repro_torch/kernels/csrc/decision_fused.cu",
        replaces="src/repro/kernels/decision_fused.py:208",
        bytes_per_lane=34, bytes_per_row=56, ops_per_lane=SOLVE_OPS + 15),
}


def bound(spec, n, rows=0):
    t_bytes = ((spec["bytes_per_lane"] * n
                + spec.get("bytes_per_row", 0) * rows)
               / HBM_BYTES_PER_S * 1e3)
    t_ops = spec["ops_per_lane"] * n / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def main_path_sass(text, func):
    """Instructions of ``func`` in ``cuobjdump -sass`` output ``text``
    from its entry to its last EXIT before the first RET (the slow paths
    of the divisions and square roots, called out of line, come after),
    NOPs left out: the static count of one lane's main path."""
    body = text.split(f"Function : {func}", 1)[1].split("Function : ")[0]
    ops = [re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0]
           for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)]
    ret = next((k for k, op in enumerate(ops) if op.startswith("RET")),
               len(ops))
    end = max(k for k, op in enumerate(ops[:ret]) if op == "EXIT")
    return sum(1 for op in ops[:end + 1] if op != "NOP")


def sass_per_lane(libraries, funcs=None):
    """{(library tag, kernel): static SASS instructions of one lane}, read
    with ``cuobjdump -sass`` from the built libraries: by default K2
    without masks and K3 with ``valid``, as the engine and the service
    call them. ``funcs`` maps a kernel to a substring of its mangled name
    (a pair: this design's, the earlier design's)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    # mangled names: decision_kernel<kActive, kValid, kRowOps> of this
    # design; the PR-16 design's two kernels
    funcs = funcs or {
        "decision_fused": ("decision_kernelILb0ELb0ELb0EE",
                           "decision_fused_kernel"),
        "decision_fused_batched": ("decision_kernelILb0ELb1ELb1EE",
                                   "decision_fused_batched_kernel")}
    out = {}
    for tag, lib in libraries.items():
        text = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        names = re.findall(r"Function : (\S+)", text)
        for kernel, keys in funcs.items():
            key = keys if isinstance(keys, str) else keys[tag != "this"]
            name = next(x for x in names if key in x)
            out[(tag, kernel)] = main_path_sass(text, name)
    return out


def solve_sass_per_lane():
    """K1's static SASS of a lane (its grid-stride loop's body once), read
    with ``cuobjdump -sass`` from the built library."""
    from repro_torch.kernels import _build
    return sass_per_lane({"this": _build.library_path("scheduler_solve")},
                         {"scheduler_solve": "scheduler_solve_kernel"})[
        ("this", "scheduler_solve")]


def max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def busy_sm_clock_hz(torch, fn):
    """The SM clock ``nvidia-smi`` reads while ``fn`` runs back to back on
    the card (the queue filled first, then kept full until the query
    returns)."""
    for _ in range(300):
        fn()
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        fn()
    torch.cuda.synchronize()
    return float(proc.stdout.read().split()[0]) * 1e6


def pr16_decision(torch):
    """The PR-16 design of K2 and K3 (commit 2e05f3b: a 1-D grid-stride
    loop over the flattened lanes, 256-thread blocks, each K3 lane finding
    its row by a 64-bit division) from ``build/decision_fused_pr16.cu``,
    behind the PR-16 wrappers' launch path (the same checks, six output
    allocations, a device context, K2's operands converted per call), as
    (k2(gains, z, u, ops), k3(gains, z, u, ops, valid), library path);
    None when that file is absent."""
    import ctypes

    from repro_torch.kernels._launch import check_lanes
    lib = earlier_kernel("decision_fused_pr16")
    if lib is None:
        return None
    k2 = lib.decision_fused_f32
    k2.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    k3 = lib.decision_fused_batched_f32
    k3.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]

    def outputs(gains):
        sel = torch.empty(gains.shape, dtype=torch.bool, device=gains.device)
        return [sel] + [torch.empty_like(gains) for _ in range(5)]

    def launched(code, outs):
        if code != 0:
            raise RuntimeError(f"PR-16 decision kernel: cudaError {code}")
        return tuple(outs)

    def call2(gains, z, u, ops):
        check_lanes("pr16", torch.float32, gains, gains=gains, z=z, u=u)
        check_lanes("pr16", torch.bool, gains)
        if (ops.dtype != torch.float32 or ops.device.type != "cpu"
                or ops.shape != (14,)):
            raise ValueError("pr16: bad ops")
        outs = outputs(gains)
        host = (ctypes.c_float * 14)(*[float(v) for v in ops.tolist()])
        with torch.cuda.device(gains.device):
            code = k2(gains.data_ptr(), z.data_ptr(), u.data_ptr(), None,
                      None, *(x.data_ptr() for x in outs), gains.shape[0],
                      host, torch.cuda.current_stream(gains.device)
                      .cuda_stream)
        return launched(code, outs)

    def call3(gains, z, u, ops, valid):
        check_lanes("pr16", torch.float32, gains, 2, gains=gains, z=z, u=u)
        check_lanes("pr16", torch.bool, gains, 2, valid=valid)
        if (ops.dtype != torch.float32 or ops.shape != (gains.shape[0], 14)
                or ops.device != gains.device or not ops.is_contiguous()):
            raise ValueError("pr16: bad ops")
        outs = outputs(gains)
        with torch.cuda.device(gains.device):
            code = k3(gains.data_ptr(), z.data_ptr(), u.data_ptr(),
                      ops.data_ptr(), valid.data_ptr(),
                      *(x.data_ptr() for x in outs), *gains.shape,
                      torch.cuda.current_stream(gains.device).cuda_stream)
        return launched(code, outs)

    return call2, call3, ROOT / "build" / "decision_fused_pr16.so"


def earlier_solve(torch):
    """K1 behind its earlier launch path (commit e1056e4): the same checks,
    its 13 scalars folded and rounded through numpy and copied into a new
    ctypes array on every call, two output allocations, a device context
    on every call; the same kernel. Counts no launch."""
    from repro_torch.kernels._launch import (check_lanes, host_f32, ptr,
                                             raise_on_error, stream_of)
    from repro_torch.kernels.scheduler_solve import (SCALARS, _lib,
                                                     solve_scalars)

    def call(gains, z, **kw):
        check_lanes("scheduler_solve", torch.float32, gains, gains=gains,
                    z=z)
        s = solve_scalars(**kw)
        q, p = torch.empty_like(gains), torch.empty_like(gains)
        scalars = host_f32("scheduler_solve", (s[k] for k in SCALARS),
                           len(SCALARS))
        with torch.cuda.device(gains.device):
            code = _lib()(ptr(gains), ptr(z), ptr(q), ptr(p),
                          gains.shape[0], scalars, stream_of(gains.device))
        raise_on_error("scheduler_solve", code)
        return q, p

    return call


# what phase 7 adds to K1's rows of the kernels line
SOLVE_EXTRAS = ("call_ms_turns", "earlier_call_ms", "earlier_call_ms_turns",
                "launch_floor_ms", "sass_per_lane", "issue_floor_ms",
                "busy_sm_clock_mhz", "issue_floor_busy_clock_ms",
                "host_split_us")


def solve_timings(torch, scfg, ch, clock, sms):
    """Phase 7's K1 rows at the engine's N = 100, FEMNIST's 3,597 and
    2^20 lanes: device time beside the plain version's and the bound; the
    launch floor (the empty ``scheduler_solve_launch_floor`` on K1's
    grid), the static SASS of a lane and the issue floor it gives; at the
    warm shapes the time per call, taken in turns with the earlier launch
    path (old, new, new, old), and the wrapper's host split."""
    from repro_torch.kernels._launch import check_lanes, stream_of
    from repro_torch.kernels.scheduler_solve import (_lib, launch_floor,
                                                     launch_scalars,
                                                     scheduler_solve,
                                                     scheduler_solve_plain,
                                                     solve_scalars)
    kw = solve_kwargs(scfg, ch)
    s = solve_scalars(**kw)
    old = earlier_solve(torch)
    sass = solve_sass_per_lane()
    out = {}
    for n in (scfg.n_clients, FEMNIST_N, 1 << 20):
        gains, z, _, _ = lanes(torch, n, 7, "cuda")
        cold = n == 1 << 20

        def kernel():
            return scheduler_solve(gains, z, **kw)

        def earlier():
            return old(gains, z, **kw)

        new_out, old_out = kernel(), earlier()
        if not all(torch.equal(a, b) for a, b in zip(new_out, old_out)):
            raise AssertionError(f"solve N={n}: the two launch paths differ")
        b, by = bound(KERNELS["scheduler_solve"], n)
        q, p = new_out
        args = (gains.data_ptr(), z.data_ptr(), q.data_ptr(), p.data_ptr(),
                n, launch_scalars(*(kw[k] for k in (
                    "n", "v", "lam", "ell", "bandwidth", "noise", "p_max",
                    "p_bar", "q_floor")))[1], stream_of(gains.device))

        def empty():
            code = launch_floor()(*args)
            if code != 0:
                raise RuntimeError(f"scheduler_solve_launch_floor: "
                                   f"cudaError {code}")

        issue = sass * n / 32 / (4 * sms) * 1e3
        row = dict(n=n, ms=time_device(torch, kernel, cold),
                   plain_ms=time_device(
                       torch, lambda: scheduler_solve_plain(gains, z, s),
                       cold),
                   bound_ms=b, bound_by=by,
                   launch_floor_ms=time_device(torch, empty, False),
                   sass_per_lane=sass, issue_floor_ms=issue / clock,
                   l2="cold" if cold else "warm")
        if cold:
            busy = busy_sm_clock_hz(torch, kernel)
            row.update(busy_sm_clock_mhz=busy / 1e6,
                       issue_floor_busy_clock_ms=issue / busy)
        else:
            call, call17 = in_turns(torch, kernel, earlier,
                                    lambda f: time_calls(torch, f))
            row.update(call_ms=sum(call) / 2, call_ms_turns=call,
                       earlier_call_ms=sum(call17) / 2,
                       earlier_call_ms_turns=call17,
                       plain_call_ms=time_calls(
                           torch, lambda: scheduler_solve_plain(gains, z, s),
                           iters=50))
            row["host_split_us"] = host_split(torch, kernel, {
                "checks": lambda: check_lanes("scheduler_solve",
                                              torch.float32, gains,
                                              gains=gains, z=z),
                "outputs": lambda: gains.new_empty((2, n)).unbind(0),
                "launch": lambda: _lib()(*args)})
        print(f"scheduler_solve {n}: {row['ms'] * 1e3:.2f} us device"
              + (f", {row['call_ms'] * 1e3:.1f} us per call (the earlier "
                 f"launch path {row['earlier_call_ms'] * 1e3:.1f} in turns)"
                 if "call_ms" in row else "")
              + f"; launch floor {row['launch_floor_ms'] * 1e3:.2f} us, "
              f"issue floor {row['issue_floor_ms'] * 1e3:.3f} us ({sass} "
              f"SASS a lane)"
              + (f", {row['issue_floor_busy_clock_ms'] * 1e3:.2f} us at the "
                 f"{row['busy_sm_clock_mhz']:.0f} MHz read while it ran"
                 if cold else "")
              + f"; bound {b * 1e3:.3f} us; plain {row['plain_ms']:.3f} ms",
              flush=True)
        if "host_split_us" in row:
            print("  host us per call: " + ", ".join(
                f"{k} {v:.1f}" for k, v in row["host_split_us"].items()),
                flush=True)
        out[("scheduler_solve", n)] = row
    return out


# what phase 7 adds to K2's and K3's rows of the kernels line
DECISION_EXTRAS = ("ms_turns", "pr16_ms", "pr16_ms_turns", "pr16_call_ms",
                   "launch_floor_ms", "sass_per_lane", "issue_floor_ms",
                   "pr16_sass_per_lane", "busy_sm_clock_mhz",
                   "issue_floor_busy_clock_ms", "host_split_us",
                   "masked_ms", "masked_ms_turns", "unmasked_ms_turns",
                   "masked_plain_ms", "masked_bound_ms")


def host_split(torch, whole, pieces, iters=2000):
    """Host microseconds per call of a wrapper (``whole``) and of the
    ``pieces`` of its launch path, each run back to back on the host clock
    (the device work of a launch is shorter than its host time), and the
    rest of the wrapper (``whole`` less the pieces)."""
    def per_call(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e6
    out = {"whole": per_call(whole)}
    out.update((name, per_call(fn)) for name, fn in pieces.items())
    out["rest"] = out["whole"] - sum(out[k] for k in pieces)
    return out


def in_turns(torch, new, old, measure):
    """``measure`` of ``new`` and ``old`` taken old, new, new, old: (new's
    two, old's two)."""
    t = [measure(f) for f in (old, new, new, old)]
    return [t[1], t[2]], [t[0], t[3]]


def timings(torch, scfg, ch, ops):
    """Phase 7: K1's, K2's and K3's device time (and per call at the warm
    shapes) beside their plain versions' and their bound, K1 and K2 at
    N = 100, 3,597 and 2^20; K1's earlier launch path in turns with this
    one (:func:`solve_timings`); for each the launch floor, the static
    SASS count of a lane and the issue-rate
    floor it gives, and, where ``build/decision_fused_pr16.cu`` holds the
    PR-16 design, that design's times taken in turns with this one."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._launch import stream_of
    from repro_torch.kernels.decision_fused import _lib as launch_k2
    from repro_torch.kernels.decision_fused import _lib_batched as launch_k3
    from repro_torch.kernels.decision_fused import (
        check_args, check_batched_args, decision_fused,
        decision_fused_batched, decision_fused_batched_plain,
        decision_fused_plain, decision_outputs, launch_floor, launch_plan)
    ops_dev = ops.to("cuda")  # the plain version then copies nothing
    pr16 = pr16_decision(torch)
    libs = {"this": _build.library_path("decision_fused")}
    if pr16 is not None:
        libs["pr16"] = pr16[2]
    sass = sass_per_lane(libs)
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"phase 7: max SM clock {clock / 1e6:.0f} MHz, {sms} SMs; static "
          f"SASS per lane {({f'{k[0]} {k[1]}': v for k, v in sass.items()})}",
          flush=True)

    def floors(name, rows, n, like, kernel, cold):
        """The launch floor on this shape's plan and the issue floor:
        the lane's SASS over 4 schedulers an SM at the max clock and, at
        the cold shapes, at the clock read while the kernel runs."""
        stream = torch.cuda.current_stream().cuda_stream
        ptr = like.data_ptr()

        def empty():
            code = launch_floor()(*[ptr] * 7, rows, n,
                                  *launch_plan(rows, n), stream)
            if code != 0:
                raise RuntimeError(f"decision_launch_floor: cudaError {code}")
        issue = sass[("this", name)] * rows * n / 32 / (4 * sms) * 1e3
        row = dict(launch_floor_ms=time_device(torch, empty, False),
                   sass_per_lane=sass[("this", name)],
                   issue_floor_ms=issue / clock,
                   pr16_sass_per_lane=sass.get(("pr16", name)))
        if cold:
            busy = busy_sm_clock_hz(torch, kernel)
            row.update(busy_sm_clock_mhz=busy / 1e6,
                       issue_floor_busy_clock_ms=issue / busy)
        return row

    def compare_pr16(row, new, old, cold):
        row.update(pr16_ms=None, pr16_call_ms=None)
        if old is None:
            return
        bitwise(torch, "PR-16 design", old(), new())
        ms, ms16 = in_turns(torch, new, old,
                            lambda f: time_device(torch, f, cold))
        row.update(ms=sum(ms) / 2, ms_turns=ms, pr16_ms=sum(ms16) / 2,
                   pr16_ms_turns=ms16)
        if not cold:
            call, call16 = in_turns(torch, new, old,
                                    lambda f: time_calls(torch, f))
            row.update(call_ms=sum(call) / 2, pr16_call_ms=sum(call16) / 2)

    def split_k2(gains, z, u):
        """The K2 wrapper's host time: its checks, its output allocations
        and views, the bare C call (ctypes and the launch) and the rest."""
        sel, out = decision_outputs(gains)
        args = (gains.data_ptr(), z.data_ptr(), u.data_ptr(), None, None,
                sel.data_ptr(), out.data_ptr(), gains.shape[0],
                ops.data_ptr(), *launch_plan(1, gains.shape[0])[:2],
                stream_of(gains.device))
        return host_split(torch, lambda: decision_fused(gains, z, u, ops), {
            "checks": lambda: check_args(gains, z, u, ops),
            "outputs": lambda: decision_outputs(gains)[1].unbind(0),
            "launch": lambda: launch_k2()(*args)})

    def split_k3(gains, z, u, bops, valid):
        sel, out = decision_outputs(gains)
        args = (gains.data_ptr(), z.data_ptr(), u.data_ptr(),
                bops.data_ptr(), valid.data_ptr(), sel.data_ptr(),
                out.data_ptr(), *gains.shape, *launch_plan(*gains.shape),
                stream_of(gains.device))
        return host_split(torch, lambda: decision_fused_batched(
            gains, z, u, bops, valid=valid), {
            "checks": lambda: check_batched_args(gains, z, u, bops, valid),
            "outputs": lambda: decision_outputs(gains)[1].unbind(0),
            "launch": lambda: launch_k3()(*args)})

    def masked_k2(gains, z, u, mask, unmasked):
        """K2 as the population engine calls it (one mask as ``active``
        and ``valid``): device ms in turns with the unmasked call, the
        plain version's, and the bound (34 B a lane)."""
        def masked():
            return decision_fused(gains, z, u, ops, active=mask, valid=mask)
        ms, ms_un = in_turns(torch, masked, unmasked,
                             lambda f: time_device(torch, f, False))
        return dict(masked_ms=sum(ms) / 2, masked_ms_turns=ms,
                    unmasked_ms_turns=ms_un,
                    masked_plain_ms=time_device(
                        torch, lambda: decision_fused_plain(
                            gains, z, u, ops_dev, mask, mask), False),
                    masked_bound_ms=bound(KERNELS["decision_fused_masked"],
                                          gains.shape[0])[0])

    def report(name, shape, row):
        pr16_ms = row["pr16_ms"]
        print(f"{name} {shape}: {row['ms'] * 1e3:.2f} us device"
              + (f" (PR-16 design {pr16_ms * 1e3:.2f} us in turns)"
                 if pr16_ms else "")
              + (f", {row['call_ms'] * 1e3:.1f} us per call"
                 if "call_ms" in row else "")
              + (f" (PR-16 {row['pr16_call_ms'] * 1e3:.1f})"
                 if row.get("pr16_call_ms") else "")
              + f"; launch floor {row['launch_floor_ms'] * 1e3:.2f} us, "
              f"issue floor {row['issue_floor_ms'] * 1e3:.2f} us "
              f"({row['sass_per_lane']} SASS a lane)"
              + (f", {row['issue_floor_busy_clock_ms'] * 1e3:.2f} us at the "
                 f"{row['busy_sm_clock_mhz']:.0f} MHz read while it ran"
                 if "busy_sm_clock_mhz" in row else "")
              + "; bound "
              f"{row['bound_ms'] * 1e3:.3f} us", flush=True)
        if "masked_ms" in row:
            print(f"  with the population's mask: "
                  f"{row['masked_ms'] * 1e3:.2f} us device (turns "
                  f"{[round(t * 1e3, 2) for t in row['masked_ms_turns']]} "
                  f"against unmasked "
                  f"{[round(t * 1e3, 2) for t in row['unmasked_ms_turns']]}"
                  f"), plain {row['masked_plain_ms'] * 1e3:.1f} us, bound "
                  f"{row['masked_bound_ms'] * 1e3:.3f} us", flush=True)
        if "host_split_us" in row:
            print("  host us per call: " + ", ".join(
                f"{k} {v:.1f}" for k, v in row["host_split_us"].items()),
                flush=True)

    out = solve_timings(torch, scfg, ch, clock, sms)
    for n in (scfg.n_clients, FEMNIST_N, 1 << 20):
        gains, z, u, mask = lanes(torch, n, 7, "cuda")
        calls = {
            "decision_fused": (
                lambda: decision_fused(gains, z, u, ops),
                lambda: decision_fused_plain(gains, z, u, ops_dev)),
        }
        cold = n == 1 << 20
        for name, (kernel, plain) in calls.items():
            b, by = bound(KERNELS[name], n)
            row = dict(ms=time_device(torch, kernel, cold),
                       plain_ms=time_device(torch, plain, cold),
                       bound_ms=b, bound_by=by)
            if not cold:
                row.update(call_ms=time_calls(torch, kernel),
                           plain_call_ms=time_calls(torch, plain))
            if name == "decision_fused":
                compare_pr16(row, kernel, None if pr16 is None else
                             (lambda: pr16[0](gains, z, u, ops)), cold)
                row.update(floors(name, 1, n, gains, kernel, cold))
                if not cold:
                    row["host_split_us"] = split_k2(gains, z, u)
                    row.update(masked_k2(gains, z, u, mask, kernel))
                report(name, n, row)
            out[(name, n)] = row
    for b, n in BATCHED_SHAPES[2:]:
        gains, z, u, valid, bops = batched_lanes(torch, b, n, 11, "cuda")
        cold = (b, n) == BATCHED_SHAPES[-1]

        def kernel():
            return decision_fused_batched(gains, z, u, bops, valid=valid)

        def plain():
            return decision_fused_batched_plain(gains, z, u, bops, valid)

        t, by = bound(KERNELS["decision_fused_batched"], b * n, b)
        row = dict(shape=[b, n], n=b * n, ms=time_device(torch, kernel, cold),
                   plain_ms=time_device(torch, plain, cold), bound_ms=t,
                   bound_by=by, l2="cold" if cold else "warm")
        if not cold:
            row.update(call_ms=time_calls(torch, kernel),
                       plain_call_ms=time_calls(torch, plain, iters=50))
        compare_pr16(row, kernel, None if pr16 is None else
                     (lambda: pr16[1](gains, z, u, bops, valid)), cold)
        row.update(floors("decision_fused_batched", b, n, gains, kernel,
                          cold))
        if not cold:
            row["host_split_us"] = split_k3(gains, z, u, bops, valid)
        report("decision_fused_batched", (b, n), row)
        out[("decision_fused_batched", (b, n))] = row
    return out


# --------------------------------------------------------------------------
# Phases 8 and 9: mamba2-130m and yi-6b scoring and serving at full width.
# --------------------------------------------------------------------------

# (b, S, H, P, N, chunk) of the SSD checks: the reference tests' padded
# shape, a mid shape, generate's prefill (4 x 2000, padded to 2048 with
# dt = 0) and the forward shape at batch 4 x 2048 (last: time_ssd times it).
SSD_SHAPES = ((1, 100, 2, 32, 16, 32), (2, 384, 24, 64, 128, 128),
              (4, 2000, 24, 64, 128, 128), (4, 2048, 24, 64, 128, 128))
# jamba-v0.1-52b's Mamba layers in phase 14's prefill (4 x 2000, padded
# to 2048 with dt = 0) and forward (4 x 2048; time_ssd times it): 128
# heads of 64, N = 16 (padded to 32 state columns in the kernel), chunk 128
JAMBA_SSD_PREFILL = (4, 2000, 128, 64, 16, 128)
JAMBA_SSD = (4, 2048, 128, 64, 16, 128)
# y, then the final state: float32 sums in another order than the plain
# version's (as on the CPU, tests/test_torch_ssd.py)
SSD_TOL = (dict(rtol=1e-4, atol=2e-4), dict(rtol=1e-4, atol=2e-5))
# (BH, Sq, Sk, D, causal, window, bfloat16) of the flash attention checks:
# tests/test_kernels.py's six shapes, Sq != Sk both ways, a non-causal
# window, non-causal Sq > Sk with a ragged key tile and Sq < Sk without a
# window, yi-6b's prefill shape in generate (batch 4 x 32 heads, prompt
# 2000, hd 128: a ragged last tile) and its forward shape (2048; last, as
# time_flash times it)
FLASH_SHAPES = ((2, 256, 256, 64, True, None, False),
                (1, 200, 200, 64, True, None, False),
                (2, 384, 384, 64, True, 128, False),
                (3, 64, 64, 128, False, None, False),
                (2, 256, 256, 64, True, None, True),
                (1, 128, 128, 32, True, 32, False),
                (2, 100, 300, 64, True, None, False),
                (2, 150, 130, 128, True, 40, False),
                (2, 256, 256, 64, False, 48, True),
                (2, 300, 77, 64, False, None, False),
                (2, 70, 150, 64, False, None, False),
                (128, 2000, 2000, 128, True, None, False),
                (128, 2048, 2048, 128, True, None, False))
# the reference tests' own tolerances (tests/test_kernels.py)
FLASH_TOL = {False: 2e-5, True: 2e-2}
YI_GROUP = 8  # yi-6b's query heads per KV head (32 / 4)
# K5 as the zoo's forwards call it (phases 13 and 14): (call, BH = batch x
# query heads, Sq, Sk, D, causal, kv_group, window), float32; batch 4 x
# 2048 in phase 13; in phase 14 mixtral's 2 x 8192 with its window of 4096,
# jamba's 4 x 2048 and kimi's 1 x 1024, and each one's prefill (8000, 2000
# and 1000: ragged last tiles, mixtral's through the window); each checked
# (phase 3) and timed beside its bound and SDPA
ZOO_FLASH = (
    ("chatglm3-6b self", 128, 2048, 2048, 128, True, 16, None),
    ("minicpm-2b self", 144, 2048, 2048, 64, True, 1, None),
    ("granite-20b self", 192, 2048, 2048, 128, True, 48, None),
    ("llama-3.2-vision-11b self", 128, 2048, 2048, 128, True, 4, None),
    ("llama-3.2-vision-11b cross", 128, 2048, 1601, 128, False, 4, None),
    ("seamless-m4t-large-v2 encoder", 64, 4096, 4096, 64, False, 1, None),
    ("seamless-m4t-large-v2 self", 64, 2048, 2048, 64, True, 1, None),
    ("seamless-m4t-large-v2 cross", 64, 2048, 4096, 64, False, 1, None),
    ("mixtral-8x22b self", 96, 8192, 8192, 128, True, 6, 4096),
    ("mixtral-8x22b prefill", 96, 8000, 8000, 128, True, 6, 4096),
    ("jamba-v0.1-52b self", 128, 2048, 2048, 128, True, 4, None),
    ("jamba-v0.1-52b prefill", 128, 2000, 2000, 128, True, 4, None),
    ("kimi-k2-1t-a32b self", 64, 1024, 1024, 128, True, 8, None),
    ("kimi-k2-1t-a32b prefill", 64, 1000, 1000, 128, True, 8, None))
# phase 13's ids: (id, layers kept, K5 launches per forward and per
# prefill, layers in the card-vs-CPU forward). granite-20b keeps 20 of its
# 52 layers (44.8 GB of float32 weights); llama's first 5 layers hold its
# first cross-attention layer, seamless's first 2 decoder layers come with
# its first 2 encoder layers.
ZOO = tuple((arch, layers, {"flash_attention_bhsd": per_call}, cpu_layers)
            for arch, layers, per_call, cpu_layers in (
                ("chatglm3-6b", None, 28, 2), ("minicpm-2b", None, 40, 2),
                ("granite-20b", 20, 20, 2),
                ("llama-3.2-vision-11b", None, 40, 5),
                ("seamless-m4t-large-v2", None, 72, 2)))
LM_BATCH, LM_SEQ, LM_PROMPT, LM_GEN = 4, 2048, 2000, 64
# the plain attention's score blocks, at most this many bytes at a time
PLAIN_SCORE_BYTES = 4e9
# prefill + decode against the teacher-forced forward (the bound of the
# reference's tests/test_arch_smoke.py::test_decode_matches_forward), and
# the card's forward against the CPU's plain forward
DECODE_TOL = 2e-4
CPU_TOL = dict(rtol=1e-4, atol=1e-4)


def ssd_lanes(torch, b, s, h, p, n, seed):
    """SSD inputs drawn as the reference's kernel tests draw them:
    dt = softplus(N(0,1)) * 0.2, a = -exp(N(0,1)); x, B, C standard
    normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    dt = torch.nn.functional.softplus(randn(b, s, h)) * 0.2
    return (randn(b, s, h, p), dt, -torch.exp(randn(h)), randn(b, s, n),
            randn(b, s, n))


def check_ssd(torch):
    """K4 (through ``ops.ssd``, which pads) against its plain chunked
    version on the same padded inputs, from a zero and a random state."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_chunked_ref
    err = 0.0
    for b, s, h, p, n, chunk in SSD_SHAPES + (JAMBA_SSD_PREFILL,
                                              JAMBA_SSD):
        x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, s)
        for h0 in (None, torch.randn((b, h, n, p), device="cuda")):
            y, h_final = ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0,
                                 return_state=True)
            xp, dtp, bmp, cmp = ops.pad_to_chunk(chunk, x, dt, bm, cm)
            y0, h0_final = ssd_chunked_ref(xp, dtp, a, bmp, cmp, chunk=chunk,
                                           h0=h0)
            torch.cuda.synchronize()
            tag = (f"ssd_scan {(b, s, h, p, n)} chunk {chunk} "
                   f"h0={h0 is not None}")
            e = max(compare(torch, f"{tag} y", y, y0[:, :s], **SSD_TOL[0]),
                    compare(torch, f"{tag} state", h_final, h0_final,
                            **SSD_TOL[1]))
            if not (torch.isfinite(y).all() and torch.isfinite(h_final).all()):
                raise AssertionError(f"{tag}: non-finite output")
            err = max(err, e)
        print(f"ssd_scan agrees with its plain version at {(b, s, h, p, n)}, "
              f"chunk {chunk}", flush=True)
    return err


def check_no_spills(name, log):
    """The functions of ``name``'s library (K2 and K3, K4's four passes,
    K5), as ``ptxas -v`` reports them, spill nothing (a spill or a
    serialised wgmma would quietly cost most of their speed). An empty log
    means the library was already built."""
    bad = [line.strip() for line in log.splitlines()
           if ("spill" in line and not line.strip().startswith(
               "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
               "loads")) or "Performance Loss" in line]
    if bad:
        raise AssertionError(f"{name}: ptxas reports spills or serialised "
                             "products:\n" + "\n".join(bad))


def flash_lanes(torch, bh, sq, sk, d, bf16, seed):
    """q, k, v standard normal, as the reference's kernel tests draw
    them, in float32 or bfloat16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = torch.bfloat16 if bf16 else torch.float32
    return [torch.randn((bh, s, d), generator=g, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def check_flash(torch):
    """K5 against its plain version, and with the masked key tiles run
    instead of skipped (the same bits); at yi-6b's two shapes also on the
    unexpanded KV heads (``kv_group=8``) against the expanded call."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ref import flash_attention_ref
    err = 0.0
    for bh, sq, sk, d, causal, window, bf16 in FLASH_SHAPES:
        q, k, v = flash_lanes(torch, bh, sq, sk, d, bf16, sq)
        out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
        every = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                     skip_tiles=False)
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tag = (f"flash_attention {(bh, sq, sk, d)} causal={causal} "
               f"window={window} {q.dtype}")
        tol = FLASH_TOL[bf16]
        err = max(err, compare(torch, tag, out.float(), want.float(), tol,
                               tol))
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{tag}: non-finite output")
        if not torch.equal(out, every):
            raise AssertionError(f"{tag}: skipping the masked tiles changed "
                                 "the result")
        print(f"{tag} agrees with its plain version (max |d| "
              f"{float((out.float() - want.float()).abs().max()):.3g}); "
              "skipping masked tiles is exact", flush=True)
    # yi-6b's 32 query heads on 4 KV heads, batch 4: the model's calls in
    # generate's prefill (2000, ragged last tiles) and in the forward
    # (2048); then the zoo's calls (phase 13)
    gqa = [(f"yi-6b {s}", bh, s, s, d, True, YI_GROUP, None)
           for bh, s, _, d, _, _, _ in FLASH_SHAPES[-2:]] + list(ZOO_FLASH)
    for call, bh, sq, sk, d, causal, group, window in gqa:
        q, k, v = flash_gqa_lanes(torch, bh, sq, sk, d, group, sq + sk + 7)
        kw = dict(causal=causal, window=window)
        out = flash_attention_bhsd(q, k, v, kv_group=group, **kw)
        every = flash_attention_bhsd(q, k, v, kv_group=group,
                                     skip_tiles=False, **kw)
        expanded = flash_attention_bhsd(q, k.repeat_interleave(group, 0),
                                        v.repeat_interleave(group, 0), **kw)
        want = plain_flash(torch, q, k, v, group, **kw)
        torch.cuda.synchronize()
        tag = (f"flash_attention {(bh, sq, sk, d)} causal={causal} "
               f"window={window} kv_group={group} ({call})")
        err = max(err, compare(torch, tag, out, want, FLASH_TOL[False],
                               FLASH_TOL[False]))
        if not torch.isfinite(out).all():
            raise AssertionError(f"{tag}: non-finite output")
        if not torch.equal(out, expanded):
            raise AssertionError(f"{tag}: differs from the kernel on the "
                                 "expanded KV heads")
        if not torch.equal(out, every):
            raise AssertionError(f"{tag}: skipping the masked tiles changed "
                                 "the result")
        print(f"{tag} on {k.shape[0]} unexpanded KV heads equals the kernel "
              "on the expanded heads bit for bit, skipping masked tiles is "
              "exact, and it agrees with its plain version (max |d| "
              f"{float((out - want).abs().max()):.3g})", flush=True)
        del q, k, v, out, every, expanded, want
    return err


def plain_flash(torch, q, k, v, group, **kw):
    """K5's plain version on q (BH, Sq, D) and k / v (BH / group, Sk, D),
    whole KV groups at a time so that no block of scores passes
    ``PLAIN_SCORE_BYTES`` (each query row is its own softmax, so the
    blocks are the same function)."""
    from repro_torch.kernels.ref import flash_attention_ref
    bh, sq, _ = q.shape
    heads = group * max(1, int(PLAIN_SCORE_BYTES // (4 * sq * k.shape[1]
                                                     * group)))
    if heads >= bh:
        return flash_attention_ref(q, k, v, kv_group=group, **kw)
    return torch.cat([flash_attention_ref(
        q[i:i + heads], k[i // group:(i + heads) // group],
        v[i // group:(i + heads) // group], kv_group=group, **kw)
        for i in range(0, bh, heads)])


def flash_gqa_lanes(torch, bh, sq, sk, d, group, seed):
    """q (BH, Sq, D) and k, v (BH / group, Sk, D), standard normal,
    float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((n, s, d), generator=g, device="cuda")
            for n, s in ((bh, sq), (bh // group, sk), (bh // group, sk))]


def stub_inputs(torch, cfg, batch):
    """The reference's stubs, seeded standard normal on the card: a VLM's
    media embeddings (B, n_media_tokens, d), an encoder-decoder's frame
    embeddings (B, encoder_seq, d); None where the model reads none."""
    g = torch.Generator(device="cuda").manual_seed(2)
    media = (torch.randn((batch, cfg.n_media_tokens, cfg.d_model),
                         generator=g, device="cuda")
             if cfg.cross_attn_every else None)
    frames = (torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                          generator=g, device="cuda")
              if cfg.is_encoder_decoder else None)
    return media, frames


class LMShape(NamedTuple):
    """A model path's sizes: the forward's (batch, seq); generate's prompt
    and new tokens; the teacher-forced check's cache length (0: seq) and
    decode steps (0: from the prompt to seq - 1)."""

    batch: int = LM_BATCH
    seq: int = LM_SEQ
    prompt: int = LM_PROMPT
    gen: int = LM_GEN
    cache_len: int = 0
    decode_steps: int = 0


def host_copy(torch, module):
    """``module`` on the CPU, copied parameter by parameter (a deepcopy on
    the card first would hold it twice there)."""
    import copy
    memo = {id(p): torch.nn.Parameter(p.detach().cpu(), requires_grad=False)
            for p in module.parameters()}
    return copy.deepcopy(module, memo).to("cpu")


def moe_layers(params):
    """The MoE mlps of ``params``' layers, by layer index."""
    from repro_torch.models.moe import MoE
    return {i: layer.mlp for i, layer in enumerate(params.layers)
            if isinstance(layer.mlp, MoE)}


class MoETally:
    """Forward hooks on every MoE mlp: the (token, k) pairs that its
    capacity dropped, all pairs, and the largest expert load, over the
    calls made while it is on (routing recomputed from each call's input;
    ``with`` adds and removes the hooks). The hooks add device work, so no
    run under them is timed."""

    def __init__(self, params):
        self.mlps = moe_layers(params)
        self.dropped = self.pairs = self.max_load = self.tokens = 0
        self._calls = []

    def _hook(self, mlp, args, _out):
        import torch
        from repro_torch.models import moe
        x = args[0]
        xt = x.reshape(-1, x.shape[-1])
        r = moe.route(mlp, xt, mlp.cfg)
        cap = moe.capacity(xt.shape[0], mlp.cfg)
        kept = moe.dispatch(r, cap, mlp.cfg).dest < mlp.cfg.n_experts * cap
        # read on exit: no synchronisation inside the pass
        self._calls.append(((~kept).sum(), kept.numel(), xt.shape[0],
                            torch.bincount(r.ids.reshape(-1),
                                           minlength=mlp.cfg.n_experts)
                            .max()))

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._hook)
                        for m in self.mlps.values()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        for dropped, pairs, tokens, load in self._calls:
            self.dropped += int(dropped)
            self.pairs += pairs
            self.tokens = max(self.tokens, tokens)
            self.max_load = max(self.max_load, int(load))
        self._calls.clear()


def set_capacity_factor(params, cf):
    """Every MoE mlp's capacity factor (its module keeps its config)."""
    for mlp in moe_layers(params).values():
        mlp.cfg = dataclasses.replace(mlp.cfg, capacity_factor=cf)


def decode_window(shape):
    """The forward's positions the decode check reads: the prompt's last,
    then one per teacher-forced step."""
    steps = shape.decode_steps or shape.seq - 1 - shape.prompt
    return slice(shape.prompt - 1, shape.prompt + steps)


def decode_check(torch, params, tokens, prompt, want, cfg, shape, kernels):
    """Prefill of ``prompt`` plus teacher-forced decode of the next steps
    against ``want``, the forward's logits at ``decode_window(shape)``;
    returns (max |d|, prefill launches, decode launches, steps)."""
    from repro_torch.models import model as M
    cache_len = shape.cache_len or shape.seq
    steps = want.shape[1] - 1
    reset_counts()
    lg, st = M.prefill(params, prompt, cfg, cache_len)
    per_prefill = read_counts()
    errs = [float((lg[:, 0] - want[:, 0]).abs().max())]
    for i, t in enumerate(range(shape.prompt, shape.prompt + steps)):
        lg, st = M.decode_step(params, tokens[:, t:t + 1], st, cfg)
        errs.append(float((lg[:, 0] - want[:, i + 1]).abs().max()))
    counts = read_counts()
    per_decode = {k: counts[k] - per_prefill[k] for k in counts}
    del st
    return max(errs), per_prefill, per_decode, steps


def lm_path(torch, arch, kernels, cpu_layers=None, layers=None,
            shape=LMShape()):
    """``arch`` at full width with random weights (the first ``layers``
    layers, all by default; a VLM's media and an encoder-decoder's frames
    seeded on the card): a forward at ``shape.batch`` x ``shape.seq`` and
    ``generate`` (``shape.prompt``, ``shape.gen`` new tokens), with the
    counts at 0 before and read after; each kernel of ``kernels`` must
    launch its count (``None``: once per layer) in each and no other
    kernel may, nor ``repeat_interleave``; prefill plus teacher-forced
    decode against the forward, decode launching nothing (with MoE layers
    at a capacity where nothing drops, when the model's own drops some:
    other token counts drop other pairs); the card's forward against the
    CPU's plain one at batch 1 x 256 on the first ``cpu_layers`` layers
    (all by default; as many encoder layers) and the full head; the pairs
    MoE capacity dropped (counted in runs of their own, untimed) and the
    peak of allocated memory. Returns the launches by kernel and a
    summary."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.models.moe import capacity
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    kernels = {k: cfg.n_layers if n is None else n
               for k, n in kernels.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    tokens, labels = make_token_stream(
        torch.Generator(device="cuda").manual_seed(1), shape.batch,
        shape.seq, cfg.vocab_size)
    media, frames = stub_inputs(torch, cfg, shape.batch)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{arch}: {n_params} parameters ({cfg.n_layers} layers, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    batch = M.Batch(tokens=tokens, labels=labels, media=media, frames=frames)
    prompt = M.Batch(tokens=tokens[:, :shape.prompt], media=media,
                     frames=frames)

    # the main path: a forward, then generate; counts from 0, and every
    # repeat_interleave (a KV-head expansion) counted
    reset_counts()
    expansions = []
    interleave = torch.Tensor.repeat_interleave

    def counting(self, *args, **kw):
        expansions.append(tuple(self.shape))
        return interleave(self, *args, **kw)

    torch.Tensor.repeat_interleave = counting
    try:
        t0 = time.perf_counter()
        logits, aux = M.forward(params, batch, cfg)
        torch.cuda.synchronize()
        first_forward_s = time.perf_counter() - t0
        per_forward = read_counts()
        out = generate(params, prompt, cfg, shape.gen)
    finally:
        torch.Tensor.repeat_interleave = interleave
    counts = read_counts()
    if expansions:
        raise AssertionError(f"{arch}: repeat_interleave ran on "
                             f"{expansions[:4]} ({len(expansions)} calls)")
    per_generate = {k: counts[k] - per_forward[k] for k in kernels}
    if per_forward != launch_counts(**kernels) or counts != launch_counts(
            **{k: 2 * n for k, n in kernels.items()}):
        raise AssertionError(f"{arch}: launches {per_forward} per forward "
                             f"and {per_generate} per generate, want "
                             f"{kernels} each and no other kernel")
    if not (logits.shape == (shape.batch, shape.seq, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    if cfg.n_experts and not float(aux) > 0.0:
        raise AssertionError(f"{arch}: MoE aux loss {float(aux)}")
    # what the decode check reads; the rest is freed before the loss's
    # forward (kimi's card holds 79.69 GB of weights)
    logits = logits[:, decode_window(shape)].clone()
    gen = out.tokens
    if not (gen.shape == (shape.batch, shape.gen) and int(gen.min()) >= 0
            and int(gen.max()) < cfg.vocab_size):
        raise AssertionError(f"{arch}: bad tokens {tuple(gen.shape)}")
    # the pairs capacity dropped, counted by hooks on the loss's forward
    # (the same batch) and on a generate of their own, neither timed
    with MoETally(params) as fwd_drops:
        loss = float(M.loss_fn(params, batch, cfg))
    with MoETally(params) as gen_drops:
        if cfg.n_experts:
            generate(params, prompt, cfg, shape.gen)
    if not 0.0 < loss < 2 * math.log(cfg.vocab_size):
        raise AssertionError(f"{arch}: loss {loss}")
    launched = ", ".join(f"{k} {per_forward[k]}" for k in kernels)
    print(f"{arch} forward {tuple(tokens.shape)}: {launched} launches "
          f"(first call {first_forward_s * 1e3:.1f} ms), loss {loss:.4f} "
          f"(ln V = {math.log(cfg.vocab_size):.4f}, aux {float(aux):.4g}); "
          f"generate: prompt {shape.prompt}, {shape.gen} tokens, "
          f"{per_generate} launches, prefill {out.prefill_s:.3f} s, decode "
          f"{out.decode_s / shape.gen * 1e3:.2f} ms/token", flush=True)
    drops = {}
    if cfg.n_experts:
        drops = dict(forward=[fwd_drops.dropped, fwd_drops.pairs],
                     generate=[gen_drops.dropped, gen_drops.pairs],
                     forward_max_load=fwd_drops.max_load,
                     forward_capacity=capacity(fwd_drops.tokens, cfg))
        print(f"{arch}: MoE capacity dropped {fwd_drops.dropped} of "
              f"{fwd_drops.pairs} (token, k) pairs in the forward "
              f"({fwd_drops.dropped / fwd_drops.pairs:.3%}; largest expert "
              f"load {fwd_drops.max_load}, capacity "
              f"{drops['forward_capacity']}) and {gen_drops.dropped} of "
              f"{gen_drops.pairs} in generate", flush=True)

    # prefill + teacher-forced decode reproduce the forward's logits; the
    # forward and the prefill see other token counts, so where capacity
    # dropped pairs the check runs at a capacity that drops none
    check_cf = None
    if drops and (fwd_drops.dropped or gen_drops.dropped):
        check_cf = 1.5 * fwd_drops.max_load * cfg.n_experts / (
            fwd_drops.tokens * cfg.top_k)
        set_capacity_factor(params, check_cf)
        with MoETally(params) as check_drops:
            check_logits, _ = M.forward(params, batch, cfg)
        check_logits = check_logits[:, decode_window(shape)].clone()
        if check_drops.dropped:
            raise AssertionError(f"{arch}: capacity factor {check_cf} "
                                 f"still drops {check_drops.dropped} pairs")
    else:
        check_logits = logits
    with MoETally(params) as check_drops:
        err, per_prefill, per_decode, steps = decode_check(
            torch, params, tokens, prompt, check_logits, cfg, shape,
            kernels)
    if check_cf is not None:
        set_capacity_factor(params, cfg.capacity_factor)
        del check_logits
        if check_drops.dropped:
            raise AssertionError(f"{arch}: the decode check dropped "
                                 f"{check_drops.dropped} pairs")
    if per_decode != launch_counts() or per_prefill != launch_counts(
            **kernels):
        raise AssertionError(f"{arch}: prefill launched {per_prefill}, "
                             f"decode {per_decode}; want {kernels}, none")
    if not err < DECODE_TOL:
        raise AssertionError(f"{arch}: decode vs forward {err}")
    print(f"{arch}: prefill ({shape.prompt}, cache "
          f"{shape.cache_len or shape.seq}) + {steps} decode steps match "
          f"the forward's logits, max |d| {err:.3g} (< {DECODE_TOL})"
          + (f" at capacity factor {check_cf:.3g}, nothing dropped"
             if check_cf is not None else "")
          + f"; decode launched no {', '.join(kernels)}", flush=True)

    # the card's kernel path against the CPU's plain path, same weights
    sub, sub_cfg = params, cfg
    if cpu_layers is not None:
        n_enc = min(cpu_layers, cfg.n_encoder_layers)
        sub_cfg = dataclasses.replace(cfg, n_layers=cpu_layers,
                                      n_encoder_layers=n_enc)
        sub = M.LM(params.embed, list(params.layers[:cpu_layers]),
                   params.final_norm, params.lm_head,
                   params.encoder and list(params.encoder[:n_enc]),
                   params.enc_norm)
    one = M.Batch(tokens=tokens[:1, :256],
                  media=None if media is None else media[:1],
                  frames=None if frames is None else frames[:1])
    kinds = sorted({f"{s.mixer}+{s.mlp}" for s in sub_cfg.layer_specs()}
                   | ({"encoder", "cross block"}
                      if sub_cfg.is_encoder_decoder else set()))
    on_card, _ = M.forward(sub, one, sub_cfg)
    cpu_params = host_copy(torch, sub)
    on_cpu, _ = M.forward(cpu_params, M.Batch(*(
        None if t is None else t.cpu() for t in one)), sub_cfg)
    cpu_err = compare(torch, f"{arch} forward card vs CPU", on_card.cpu(),
                      on_cpu, **CPU_TOL)
    print(f"{arch}: forward (1, 256) over {sub_cfg.n_layers} layers "
          f"({', '.join(kinds)}) on the card vs the CPU's plain forward: "
          f"max |d| {cpu_err:.3g} (|logit| up to "
          f"{float(on_cpu.abs().max()):.3g})", flush=True)
    del cpu_params, on_cpu, sub, on_card
    mixture = None
    if cpu_layers is not None and any(i >= cpu_layers
                                      for i in moe_layers(params)):
        mixture = moe_mixture_check(torch, params, one, cfg, cpu_layers)

    fwd_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        M.forward(params, batch, cfg)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    again = generate(params, prompt, cfg, shape.gen)
    summary = dict(
        config=cfg.name, n_params=n_params, batch=shape.batch,
        seq=shape.seq, prompt=shape.prompt, generated=shape.gen, loss=loss,
        aux=float(aux), forward_ms=sorted(fwd_ms)[1],
        prefill_s=[out.prefill_s, again.prefill_s],
        decode_ms_per_token=[out.decode_s / shape.gen * 1e3,
                             again.decode_s / shape.gen * 1e3],
        decode_vs_forward_max_abs=err, decode_steps=steps,
        decode_check_capacity_factor=check_cf, card_vs_cpu_max_abs=cpu_err,
        card_vs_cpu_layers=sub_cfg.n_layers, card_vs_cpu_kinds=kinds,
        layers=cfg.n_layers, kernel_per_call=kernels,
        sample_output=gen[0, :16].tolist())
    if drops:
        summary.update(moe_dropped=drops, moe_mixture=mixture)
    del logits
    summary["profile"] = profile_lm(torch, params, batch, prompt, cfg,
                                    kernels, shape)
    summary["max_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9)
    return {k: dict(launches=counts[k], per_forward=per_forward[k],
                    per_generate=per_generate[k],
                    per_prefill=per_prefill[k], per_decode=per_decode[k])
            for k in kernels}, summary


# a token's k-th / (k+1)-th router probability margin above which its
# experts must be the same on the card and the CPU (tests/test_torch_moe.py)
ROUTER_MARGIN = 1e-5


def moe_mixture_check(torch, params, one, cfg, first):
    """The first MoE layer at or past ``first`` on the card, on its input
    in a forward of ``one``, for a layer too large to copy to the host:
    its router (copied to the host with that input) against the CPU's, the
    experts equal on every token whose margin exceeds ``ROUTER_MARGIN``
    and the weights within rtol 1e-4 / atol 1e-5; at the config's capacity
    each kept or dropped (token, expert) pair's slot against the CPU's
    dispatch, wherever no near-tie on another token can move it; then its
    output, at the config's capacity and at one that drops nothing,
    against the explicit mixture of each token's kept top-k experts with
    the same weights (the reference's tests/test_moe.py::test_high_
    capacity_equals_dense_mixture, rtol 1e-4 / atol 1e-4)."""
    import types
    from repro_torch.models import model as M
    from repro_torch.models import moe
    i = min(j for j in moe_layers(params) if j >= first)
    mlp = params.layers[i].mlp
    seen = []
    hook = mlp.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].reshape(-1, cfg.d_model)))
    try:
        M.forward(params, one, cfg)
    finally:
        hook.remove()
    xt = seen[0]
    t, k, e = xt.shape[0], cfg.top_k, cfg.n_experts
    r = moe.route(mlp, xt, cfg)
    host = types.SimpleNamespace(router=types.SimpleNamespace(
        w=mlp.router.w.detach().cpu()))
    r_cpu = moe.route(host, xt.cpu(), cfg)
    top = torch.sort(r_cpu.probs, dim=-1, descending=True).values
    trusted = (top[:, k - 1] - top[:, k]) > ROUTER_MARGIN
    ids, perm = torch.sort(r.ids.cpu(), dim=-1)
    ids_cpu, perm_cpu = torch.sort(r_cpu.ids, dim=-1)
    if not torch.equal(ids[trusted], ids_cpu[trusted]):
        raise AssertionError(f"{cfg.name} layer {i}: the card's experts "
                             "differ from the CPU's beyond the margin rule")
    w_err = compare(torch, f"{cfg.name} layer {i} router weights",
                    torch.gather(r.weights.cpu(), 1, perm)[trusted],
                    torch.gather(r_cpu.weights, 1, perm_cpu)[trusted],
                    1e-4, 1e-5)
    cap = moe.capacity(t, cfg)
    dest = torch.gather(moe.dispatch(r, cap, cfg).dest.cpu().reshape(t, k),
                        1, perm)
    dest_cpu = torch.gather(moe.dispatch(r_cpu, cap, cfg).dest.reshape(t, k),
                            1, perm_cpu)
    # a near-tie swaps a token between its k-th and (k+1)-th experts on one
    # side, which moves only those experts' later slots
    near = torch.zeros(e + 1, dtype=torch.bool)
    for side in (r.probs.cpu(), r_cpu.probs):
        ranked = torch.sort(side, dim=-1, descending=True, stable=True)[1]
        near[ranked[~trusted, k - 1:k + 1].reshape(-1)] = True
    held = trusted[:, None] & ~near[ids]
    if not torch.equal(dest[held], dest_cpu[held]):
        raise AssertionError(f"{cfg.name} layer {i}: the card's dispatch "
                             f"at capacity {cap} differs from the CPU's")
    dropped = int((dest_cpu >= e * cap).sum())
    print(f"{cfg.name}: layer {i}'s router on the card (1, 256) against "
          f"the CPU's: experts equal on {int(trusted.sum())} of {t} tokens "
          f"with a margin above {ROUTER_MARGIN}, weights max |d| "
          f"{w_err:.3g}; at capacity {cap} the slots of {int(held.sum())} "
          f"of {t * k} pairs equal the CPU's ({dropped} dropped there)",
          flush=True)

    load = int(torch.bincount(r.ids.reshape(-1), minlength=e).max())
    wide = dataclasses.replace(cfg, capacity_factor=load * e / (t * k))
    if moe.capacity(t, wide) < load:
        raise AssertionError(f"{cfg.name}: capacity below the load {load}")
    errs = {}
    for name, c in (("config", cfg), ("dropless", wide)):
        slots = moe.capacity(t, c)
        kept = (moe.dispatch(r, slots, c).dest < e * slots).reshape(t, k)
        y, _ = moe.apply_moe(mlp, xt, c)
        want = torch.zeros_like(xt)
        for x in torch.unique(r.ids[kept]).tolist():
            rows, cols = ((r.ids == x) & kept).nonzero(as_tuple=True)
            xe = xt[rows]
            h = torch.nn.functional.silu(xe @ mlp.wg[x]) * (xe @ mlp.wi[x])
            want.index_add_(0, rows, r.weights[rows, cols, None]
                            * (h @ mlp.wo[x]))
        errs[name] = compare(torch, f"{cfg.name} layer {i} MoE at the "
                             f"{name} capacity vs its mixture", y, want,
                             1e-4, 1e-4)
        errs[f"{name}_dropped"] = int((~kept).sum())
    print(f"{cfg.name}: layer {i}'s MoE on the card (1, 256) against the "
          f"explicit mixture of each token's kept top {k} of {e} experts: "
          f"at capacity {cap} ({errs['config_dropped']} pairs dropped) max "
          f"|d| {errs['config']:.3g}, at {moe.capacity(t, wide)} >= the "
          f"largest load {load} max |d| {errs['dropless']:.3g}", flush=True)
    return dict(layer=i, tokens=t, largest_load=load,
                capacity=moe.capacity(t, wide), max_abs=errs["dropless"],
                config_capacity=cap, config_dropped=errs["config_dropped"],
                config_max_abs=errs["config"],
                router_trusted_tokens=int(trusted.sum()),
                router_weights_max_abs=w_err,
                dispatch_pairs_held=int(held.sum()),
                cpu_dropped=dropped)


def profile_lm(torch, params, batch, prompt, cfg, kernels, shape):
    """One forward and 16 decode steps under torch.profiler: device time by
    kernel, each of ``kernels``' share and the device's busy share of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M
    out = {}
    _, st = M.prefill(params, prompt, cfg, shape.cache_len or shape.seq)
    nxt = prompt.tokens[:, -1:]

    def decode16():
        s = st
        for _ in range(16):
            _, s = M.decode_step(params, nxt, s, cfg)

    # the compiled kernels' symbols carry their sources' names
    symbols = {k: k.removesuffix("_bhsd") for k in kernels}
    for label, fn in (("forward", lambda: M.forward(params, batch, cfg)),
                      ("decode16", decode16)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(r[0] for r in rows)
        ours = {k: sum(r[0] for r in rows if sym in r[2])
                for k, sym in symbols.items()}
        shares = ", ".join(f"{k} {ms:.2f} ms ({ms / max(busy, 1e-9):.1%} "
                           "of kernels)" for k, ms in ours.items())
        print(f"profile of {cfg.name} {label}: wall {wall_ms:.1f} ms, "
              f"kernels {busy:.2f} ms ({busy / wall_ms:.1%} of wall), "
              f"{shares}, {sum(r[1] for r in rows)} device ops; top:",
              flush=True)
        top = sorted(rows, reverse=True)[:8]
        for ms, count, key in top:
            print(f"  {ms:10.3f} ms {count:6d}x  {key[:90]}", flush=True)
        out[label] = dict(wall_ms=wall_ms, device_ms=busy,
                          kernel_ms=sum(ours.values()), kernels_ms=ours,
                          device_ops=sum(r[1] for r in rows),
                          top=[[key[:60], ms, count] for ms, count, key
                               in top[:5]])
    return out


def ssd_bound(b, s, h, p, n, chunk, with_state):
    """Least time of one K4 call. Bytes: inputs read once, outputs written
    once, at HBM rate. Operations: the products (C.B^T once per (batch,
    chunk) over the causal triangle; per (batch, head, chunk) m @ x over
    the triangle, the inter-chunk product and the state update), each a
    float32 product that float32-accurate tensor-core work takes as three
    TF32 products (3xTF32) at the TF32 rate; the decay weights, the scaling
    and the sums on the CUDA cores at the float32 rate. The bound is the
    largest of the three times; ``f32_ms`` is everything in float32 on the
    CUDA cores, the bound of a design without tensor cores (commit
    3f5cf30's)."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    n_bytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                   + (b * h * n * p if with_state else 0))
    products = (b * nc * 2 * tri * n              # C.B^T
                + b * h * nc * (2 * tri * p       # m @ x
                                + 2 * chunk * n * p    # (C exp(lc)) @ state
                                + 2 * chunk * n * p))  # (B bw)^T @ x
    other = b * h * nc * (6 * chunk + 1           # g, lc, exp(lc), B weights
                          + 6 * tri               # decay, min, exp, where, m
                          + chunk * n             # C exp(lc)
                          + chunk * p             # y = intra + inter
                          + chunk * n             # B bw
                          + 2 * n * p)            # carry * state + update
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * products / TF32_OPS_PER_S * 1e3
    t_cuda = other / F32_OPS_PER_S * 1e3
    t = max(t_bytes, t_tc, t_cuda)
    return dict(bound_ms=t,
                bound_by="bytes" if t == t_bytes else "operations",
                bound_detail=("bytes" if t == t_bytes else
                              "tensor-core operations (3xTF32)"
                              if t == t_tc else "CUDA-core operations"),
                bytes=n_bytes, flops=products + other,
                tensor_core_ms=t_tc, cuda_core_ms=t_cuda, bytes_ms=t_bytes,
                f32_ms=max(t_bytes, (products + other) / F32_OPS_PER_S
                           * 1e3))


def earlier_kernel(stem):
    """The library of ``build/<stem>.cu``, an earlier design of a kernel put
    there by hand, built with the port's flags and its headers on the
    include path (a header beside the source, from the same commit, wins);
    None when that file is absent."""
    import ctypes
    from repro_torch.kernels import _build
    src = ROOT / "build" / f"{stem}.cu"
    if not src.is_file():
        return None
    lib = src.with_suffix(".so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def cuda_core_ssd(torch):
    """The earlier K4 (CUDA cores, one block per (batch, head), commit
    3f5cf30) from ``build/ssd_scan_cuda_cores.cu``, as a function of (x,
    dt, a, bm, cm, chunk) returning (y, the final state); None when that
    file is absent."""
    import ctypes
    lib = earlier_kernel("ssd_scan_cuda_cores")
    if lib is None:
        return None
    fn = lib.ssd_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, dt, a, bm, cm, chunk):
        b, s, h, p = x.shape
        n = bm.shape[-1]
        y = torch.empty_like(x)
        h_final = torch.empty((b, h, n, p), device=x.device)
        code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                  cm.data_ptr(), None, y.data_ptr(), h_final.data_ptr(), b,
                  s, h, p, n, chunk, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"CUDA-core ssd_scan: cudaError {code}")
        return y, h_final
    return call


# K4's device kernels, launched in this order by one ssd_scan call
SSD_PASSES = ("ssd_scan_chunk_state", "ssd_scan_state_pass", "ssd_scan_cb",
              "ssd_scan_chunk_out")


def ssd_pass_ms(torch, fn, calls=10):
    """Device ms per call of each of K4's device kernels, from
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(SSD_PASSES, 0.0)
    for e in prof.key_averages():
        for name in SSD_PASSES:
            if name in e.key:
                out[name] += e.self_device_time_total / 1e3 / calls
    return out


def time_ssd(torch, shape=SSD_SHAPES[-1]):
    """K4 and its plain version at a forward shape (mamba2-130m's by
    default; with the final state), device ms by CUDA events, each device
    kernel's share by the profiler; the earlier CUDA-core kernel where its
    source is at hand, timed in turns with this one."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, s, h, p, n, chunk = shape
    x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, 5)

    def kernel():
        return ssd_scan(x, dt, a, bm, cm, chunk=chunk, return_state=True)

    row = dict(
        shape=[b, s, h, p, n], chunk=chunk,
        ms=time_device(torch, kernel, False),
        plain_ms=time_device(torch, lambda: ssd_chunked_ref(
            x, dt, a, bm, cm, chunk=chunk), False, iters=5),
        device_kernels_ms=ssd_pass_ms(torch, kernel),
        **ssd_bound(b, s, h, p, n, chunk, True))
    old = cuda_core_ssd(torch)
    if old is not None:
        (y_old, h_old), (y, h_new) = old(x, dt, a, bm, cm, chunk), kernel()
        err = max(float((y_old - y).abs().max()),
                  float((h_old - h_new).abs().max()))
        turns = [time_device(torch, lambda: old(x, dt, a, bm, cm, chunk),
                             False),
                 time_device(torch, kernel, False),
                 time_device(torch, kernel, False),
                 time_device(torch, lambda: old(x, dt, a, bm, cm, chunk),
                             False)]
        row["cuda_core_kernel"] = dict(ms=[turns[0], turns[3]],
                                       new_ms=turns[1:3], max_abs_diff=err)
    passes = ", ".join(f"{k.removeprefix('ssd_scan_')} {v:.4f}"
                       for k, v in row["device_kernels_ms"].items())
    print(f"ssd_scan at {row['shape']}: {row['ms']:.3f} ms device ({passes}"
          f" ms by the profiler), plain {row['plain_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_detail']}; "
          f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP; "
          f"bytes {row['bytes_ms']:.4f} ms; all float32 on the CUDA cores "
          f"{row['f32_ms']:.4f} ms)"
          + (f"; the CUDA-core kernel {row['cuda_core_kernel']['ms']} ms "
             f"against {row['cuda_core_kernel']['new_ms']} in turns"
             if "cuda_core_kernel" in row else ""),
          flush=True)
    return row


def flash_bound(bh, sq, sk, d, causal, window, itemsize, kv_group=1):
    """Least time of one K5 call. Bytes: q and o (BH heads) and k and v
    (BH / kv_group heads, unexpanded) read or written once at HBM rate.
    Operations: per live (q, k) pair 2 D for q . k and 2 D for p v, each a
    float32 product that float32-accurate tensor-core work takes as three
    TF32 products (3xTF32) at the TF32 rate; per live pair its max, exp and
    sum, and per output element the scale and the division, on the CUDA
    cores at the float32 rate. Masked pairs need no work, so the causal
    half is counted once. The bound is the largest of the three times;
    ``f32_ms`` is the same products and softmax all on the CUDA cores in
    float32, the bound of a design without tensor cores."""
    from repro_torch.kernels.ref import flash_mask
    live = int(flash_mask(sq, sk, causal, window, "cpu").sum())
    n_bytes = itemsize * d * (2 * bh * sq + 2 * (bh // kv_group) * sk)
    products = bh * live * 4 * d
    softmax = bh * (live * 3 + 2 * sq * d)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * products / TF32_OPS_PER_S * 1e3
    t_cuda = softmax / F32_OPS_PER_S * 1e3
    t = max(t_bytes, t_tc, t_cuda)
    return dict(bound_ms=t,
                bound_by="bytes" if t == t_bytes else "operations",
                bound_detail=("bytes" if t == t_bytes else
                              "tensor-core operations (3xTF32)"
                              if t == t_tc else "CUDA-core operations"),
                bytes=n_bytes, flops=products + softmax,
                tensor_core_ms=t_tc, cuda_core_ms=t_cuda, bytes_ms=t_bytes,
                f32_ms=max(t_bytes, (products + softmax) / F32_OPS_PER_S
                           * 1e3))


def cuda_core_flash(torch):
    """The earlier K5 (CUDA cores, expanded KV, commit 3f5cf30) from
    ``build/flash_attention_cuda_cores.cu``, as a function of (q, k, v)
    (causal); None when that file is absent."""
    import ctypes
    lib = earlier_kernel("flash_attention_cuda_cores")
    if lib is None:
        return None
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v):
        o = torch.empty_like(q)
        bh, sq, d = q.shape
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                  sq, k.shape[1], d, 0, 1, 0, d ** -0.5, 1,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"CUDA-core flash_attention: cudaError "
                               f"{code}")
        return o
    return call


def flash_row(torch, bh, sq, sk, d, causal, group, seed, window=None):
    """K5 as a model calls it (q (BH, Sq, D) on BH / ``group`` unexpanded
    KV heads, float32, ``window`` with ``causal``), its plain version and
    PyTorch's ``scaled_dot_product_attention`` (the yardstick, never on
    the path) on the same inputs (as (4, BH / 4, S, D): every BH / 4 here
    is a multiple of ``group``, so the heads group as K5's), device ms
    by CUDA events, beside the bound. SDPA takes the unexpanded heads
    (``enable_gqa=True``) without a window; with one, the band (k <= q,
    k > q - window) as its boolean mask over KV heads expanded outside the
    timing, on the memory-efficient backend (the math backend would hold
    the whole (batch, heads, Sq, Sk) scores). Returns the row and the
    inputs."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ref import flash_mask
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = flash_gqa_lanes(torch, bh, sq, sk, d, group, seed)
    b = LM_BATCH

    def kernel():
        return flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                    kv_group=group)

    if window is None:
        def library():
            # (B, H, Sq, D), in whatever strides the chosen backend gives
            return sdpa(q.view(b, -1, sq, d), k.view(b, -1, sk, d),
                        v.view(b, -1, sk, d), is_causal=causal,
                        enable_gqa=True)
    else:
        band = flash_mask(sq, sk, causal, window, "cuda")
        ke, ve = (t.repeat_interleave(group, 0).view(b, -1, sk, d)
                  for t in (k, v))

        def library():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return sdpa(q.view(b, -1, sq, d), ke, ve, attn_mask=band)

    lib_err = float((library().reshape(bh, sq, d) - kernel()).abs().max())
    row = dict(shape=[bh, sq, sk, d], kv_heads=bh // group, causal=causal,
               window=window, ms=time_device(torch, kernel, False),
               plain_ms=time_device(torch, lambda: plain_flash(
                   torch, q, k, v, group, causal=causal, window=window),
                   False, iters=5),
               library_ms=time_device(torch, library, False),
               library_max_abs_diff=lib_err,
               **flash_bound(bh, sq, sk, d, causal, window, 4, group))
    return row, (q, k, v, kernel)


def print_flash_row(row, what):
    print(f"flash_attention_bhsd at {row['shape']} ({what}) on "
          f"{row['kv_heads']} KV heads, causal={row['causal']}, "
          f"window={row['window']}: "
          f"{row['ms']:.3f} ms device, plain {row['plain_ms']:.3f} ms, "
          f"scaled_dot_product_attention {row['library_ms']:.3f} ms (max "
          f"|d| {row['library_max_abs_diff']:.3g}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_detail']}; "
          f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP; "
          f"all float32 on the CUDA cores {row['f32_ms']:.4f} ms)"
          + (f"; the CUDA-core kernel {row['cuda_core_kernel']['ms']} ms "
             f"against {row['cuda_core_kernel']['new_ms']} in turns"
             if "cuda_core_kernel" in row else ""),
          flush=True)


def time_flash(torch):
    """K5 at yi-6b's forward shape (q (128, 2048, 128) on 16 unexpanded KV
    heads, ``kv_group=8``, causal), as :func:`flash_row` times it; the
    earlier CUDA-core kernel on the expanded KV where its source is at
    hand, timed in turns with this one."""
    bh, s, _, d, causal, _, _ = FLASH_SHAPES[-1]
    row, (q, k, v, kernel) = flash_row(torch, bh, s, s, d, causal, YI_GROUP,
                                       6)
    old = cuda_core_flash(torch)
    if old is not None:
        ke, ve = (t.repeat_interleave(YI_GROUP, 0) for t in (k, v))
        err = float((old(q, ke, ve) - kernel()).abs().max())
        turns = [time_device(torch, lambda: old(q, ke, ve), False),
                 time_device(torch, kernel, False),
                 time_device(torch, kernel, False),
                 time_device(torch, lambda: old(q, ke, ve), False)]
        row["cuda_core_kernel"] = dict(ms=[turns[0], turns[3]],
                                       new_ms=turns[1:3], max_abs_diff=err)
        del ke, ve
    print_flash_row(row, "yi-6b self")
    return row


def time_zoo_flash(torch):
    """K5 at each of the zoo's calls (``ZOO_FLASH``), as
    :func:`flash_row` times them."""
    rows = []
    for call, bh, sq, sk, d, causal, group, window in ZOO_FLASH:
        row, _ = flash_row(torch, bh, sq, sk, d, causal, group, 6, window)
        print_flash_row(row, call)
        rows.append(dict(call=call, **row))
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# Phase 13: the zoo's dense, VLM and encoder-decoder ids at full width.
# --------------------------------------------------------------------------

def zoo_path(torch, zoo):
    """Each id of ``zoo`` (``ZOO``, phase 13, or ``MOE_ZOO``, phase 14)
    through :func:`lm_path`, freeing the card between ids. Returns the
    launches by id and kernel and a summary by id."""
    launches, summary = {}, {}
    for arch, layers, kernels, cpu_layers, *shape in zoo:
        launches[arch], summary[arch] = lm_path(
            torch, arch, kernels, cpu_layers=cpu_layers, layers=layers,
            shape=shape[0] if shape else LMShape())
        torch.cuda.empty_cache()
    return launches, summary


# --------------------------------------------------------------------------
# Phase 14: the MoE zoo at full width, K5's window and the rolling cache.
# --------------------------------------------------------------------------

# (id, layers kept, launches per forward and per prefill, layers in the
# card-vs-CPU forward, sizes (batch, seq, prompt, generated, cache_len,
# decode steps)). mixtral keeps 4 of 56 layers (41.68 GB), its prompt of
# 8,000 rolls a 4,096-slot window cache and its 16 decode steps lie past
# the window; jamba its first period, 8 of 32 layers (one attention, 7
# Mamba, 4 MoE; 53.07 GB), its first 5 (the attention layer and 2 MoE
# layers) on the CPU; kimi its dense prefix layer and 1 MoE layer of 384
# experts (79.69 GB), the prefix layer on the CPU and the MoE layer held
# against its dense mixture on the card.
MOE_ZOO = (
    ("mixtral-8x22b", 4, {"flash_attention_bhsd": 4}, 1,
     LMShape(2, 8192, 8000, 16, 8192, 16)),
    ("jamba-v0.1-52b", 8, {"flash_attention_bhsd": 1, "ssd_scan": 7}, 5,
     LMShape(4, 2048, 2000, 16, 2048, 16)),
    ("kimi-k2-1t-a32b", 2, {"flash_attention_bhsd": 2}, 1,
     LMShape(1, 1024, 1000, 16, 1024, 16)))


# --------------------------------------------------------------------------
# Phase 15: training on the card, K5's backward kernel.
# --------------------------------------------------------------------------

# (call, BH, Sq, Sk, D, causal, kv_group, window) of the K5-backward
# checks: yi-6b's causal GQA, minicpm-2b's D = 64, mixtral-8x22b's window
# of 4,096 (BH cut to 12, so the plain version's (BH, 8192, 8192) blocks
# stay ~3 GB), llama-3.2-vision-11b's non-causal ragged cross shape, and
# transformer_lm's D = 16 padded to 32 (the FL leg's 6 participants x 8
# sequences x 2 heads of 16 tokens, scale 16^-0.5)
FLASH_BWD_SHAPES = (
    ("yi-6b self", 128, 2048, 2048, 128, True, 8, None),
    ("minicpm-2b self", 144, 2048, 2048, 64, True, 1, None),
    ("mixtral-8x22b self", 12, 8192, 8192, 128, True, 6, 4096),
    ("llama-3.2-vision-11b cross", 128, 2048, 1601, 128, False, 4, None),
    ("transformer_lm (D 16 padded)", 96, 16, 16, 32, True, 1, None))
# of each gradient's largest |plain| entry, float32: the kernel's 3xTF32
# products (lo.lo dropped, ~2^-22) sum in another order than the plain
# version's cuBLAS products (3.6e-6 at most on an H100)
FLASH_BWD_TOL = 1e-4
# the expanded KV call's dK and dV, summed back per group, against the
# grouped call (which sums the group's heads inside its loop), of the
# largest |entry|: the same products in another order of the group sum
# (6.4e-6 at yi's kv_group 8 on an H100)
FLASH_BWD_GROUP_TOL = 3e-5
TRAIN_LAYERS, TRAIN_SGD_STEPS, TRAIN_GAMMA = 4, 3, 1e-3
# a step with K5 against the same step with _grouped_attention on the
# card, on the batch's first sequence (the plain path's autograd holds
# (4, 32, 2048, 2048) float32 scores a layer: at the full batch of 4 it
# does not fit beside the model): the loss rtol, and each gradient leaf's
# max |d| over its largest |plain| entry
# (1.2e-5 measured on an H100)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# the FL transformer_lm leg's final accuracy, card against CPU: 10 of the
# 400 x 16 test tokens (an argmax near a tie can flip)
FL_ACC_TOL = 10 / 6400
# the FL transformer_lm leg against the CPU: the gradients of the engine's
# m_cap participants (vmap(grad)) at the initial weights, and the global
# params after the run's rounds; each leaf's max |d| over its largest
# |CPU| entry
FL_GRAD_TOL, FL_PARAM_TOL = 1e-4, 1e-4


def flash_bwd_bound(bh, sq, sk, d, causal, window, itemsize, kv_group=1):
    """Least time of one K5-backward call. Bytes: q, o, dO and dq (BH
    heads) and k, v, dk, dv (BH / kv_group) read or written once.
    Operations: per live (q, k) pair the five products of the gradient
    (q k^T, dO V^T, P^T dO, dS K, dS^T q), 2 D each, in 3xTF32 at the TF32
    rate, and its exp, subtract and product (P, dP - delta, P (dP -
    delta)) on the CUDA cores; the bound is the largest of the three."""
    from repro_torch.kernels.ref import flash_mask
    live = int(flash_mask(sq, sk, causal, window, "cpu").sum())
    n_bytes = itemsize * d * (4 * bh * sq + 4 * (bh // kv_group) * sk)
    products = bh * live * 5 * 2 * d
    elementwise = bh * live * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * products / TF32_OPS_PER_S * 1e3
    t_cuda = elementwise / F32_OPS_PER_S * 1e3
    t = max(t_bytes, t_tc, t_cuda)
    return dict(bound_ms=t,
                bound_by="bytes" if t == t_bytes else "operations",
                bound_detail=("bytes" if t == t_bytes else
                              "tensor-core operations (3xTF32)"
                              if t == t_tc else "CUDA-core operations"),
                bytes=n_bytes, flops=products + elementwise,
                f32_ms=max(t_bytes, (products + elementwise)
                           / F32_OPS_PER_S * 1e3))


def bwd_lanes(torch, bh, sq, sk, d, group, seed):
    """q, k, v (as flash_gqa_lanes) and a standard normal dO."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    q, k, v = flash_gqa_lanes(torch, bh, sq, sk, d, group, seed)
    return q, k, v, torch.randn(q.shape, device="cuda", generator=(
        torch.Generator(device="cuda").manual_seed(seed + 1)))


def check_flash_bwd(torch):
    """K5-backward against its plain version at ``FLASH_BWD_SHAPES``, the
    same bits with the masked tiles run, and the grouped call against the
    call on the expanded KV summed back per group. Returns the largest
    |d| over the checks."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    err = 0.0
    for call, bh, sq, sk, d, causal, group, window in FLASH_BWD_SHAPES:
        q, k, v, do = bwd_lanes(torch, bh, sq, sk, d, group, sq + sk + d)
        kw = dict(causal=causal, window=window, kv_group=group)
        if "padded" in call:
            # D = 16 padded with zero columns, as ops.flash_attention runs it
            for t in (q, k, v, do):
                t[..., 16:] = 0.0
            kw["scale"] = 16 ** -0.5
        with torch.no_grad():
            o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
        # the main path's call (the forward's lse), then the bare one (its
        # own K5 run for lse) with the masked tiles run, and a rerun
        got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        every = flash_attention_bwd(q, k, v, o, do, skip_tiles=False, **kw)
        again = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        tag = (f"flash_attention_bwd {(bh, sq, sk, d)} causal={causal} "
               f"window={window} kv_group={group} ({call})")
        rels = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            diff = float((g - w).abs().max())
            rels.append(diff / float(w.abs().max()))
            err = max(err, diff)
            if not (torch.isfinite(g).all() and rels[-1] <= FLASH_BWD_TOL):
                raise AssertionError(f"{tag}: {name} off its plain version "
                                     f"by {rels[-1]:.3g} of max |plain|")
        if not all(torch.equal(a, b) for a, b in zip(got, every)):
            raise AssertionError(f"{tag}: running the masked tiles changed "
                                 "the result")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: a rerun changed the result")
        group_rel = 0.0
        if group > 1:
            kw_e = dict(kw, kv_group=1)
            dq, dk, dv = flash_attention_bwd(
                q, k.repeat_interleave(group, 0),
                v.repeat_interleave(group, 0), o, do, **kw_e)
            if not torch.equal(dq, got[0]):
                raise AssertionError(f"{tag}: dq differs on the expanded KV")
            for g, e in ((got[1], dk), (got[2], dv)):
                e = e.unflatten(0, (-1, group)).sum(1)
                group_rel = max(group_rel, float((g - e).abs().max())
                                / float(e.abs().max()))
            if group_rel > FLASH_BWD_GROUP_TOL:
                raise AssertionError(f"{tag}: dk / dv off the expanded call "
                                     f"summed per group by {group_rel:.3g}")
            del dq, dk, dv
        print(f"{tag} agrees with its plain version (dq, dk, dv max |d| / "
              f"max |plain|: {', '.join(f'{r:.3g}' for r in rels)}); "
              "running the masked tiles and a rerun give the same bits"
              + (f"; the expanded call: dq bit-equal, dk / dv summed per "
                 f"group within {group_rel:.3g}" if group > 1 else ""),
              flush=True)
        del q, k, v, do, o, lse, got, every, again, want
        torch.cuda.empty_cache()
    return err


def pr23_flash_bwd(torch):
    """The PR-23 K5 backward (float32 FMAs on the CUDA cores, three
    kernels, commit ba41782) from ``build/flash_attention_bwd_pr23.cu``,
    as a function of (q, k, v, o, do, causal, window, scale, kv_group);
    None when that file is absent."""
    import ctypes
    lib = earlier_kernel("flash_attention_bwd_pr23")
    if lib is None:
        return None
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, o, do, causal, window, scale, kv_group):
        bh, sq, d = q.shape
        out = [torch.empty_like(t) for t in (q, k, v)]
        stats = torch.empty((2, bh, sq), dtype=torch.float32, device="cuda")
        code = fn(*(t.data_ptr() for t in (q, k, v, o, do, *out)),
                  stats[0].data_ptr(), stats[1].data_ptr(), bh, kv_group,
                  sq, k.shape[1], d, 0, int(causal),
                  0 if window is None else window, scale, 1,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"PR-23 flash_attention_bwd: cudaError {code}")
        return out
    return call


def flash_bwd_row(torch, call, bh, sq, sk, d, causal, group, window, old):
    """K5-backward at one ``FLASH_BWD_SHAPES`` call as the main path runs
    it (the forward's lse), float32: device ms, its plain version's, the
    bound, and the library's: ``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` (the yardstick; the port never calls
    it) on (4, BH / 4, S, D) views, with ``enable_gqa=True`` and no
    window, else the band (k <= q, k > q - window) as its boolean mask
    over KV heads expanded outside the timing, on the memory-efficient
    backend, as :func:`flash_row` times the forward; the PR-23 design
    (``old``) in turns with this one where its source is at hand."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_mask
    q, k, v, do = bwd_lanes(torch, bh, sq, sk, d, group, 6)
    kw = dict(causal=causal, window=window, kv_group=group,
              scale=d ** -0.5)
    if "padded" in call:
        for t in (q, k, v, do):
            t[..., 16:] = 0.0
        kw["scale"] = 16 ** -0.5
    with torch.no_grad():
        o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)

    def kernel():
        return flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)

    b = LM_BATCH
    if window is None:
        ql, kl, vl = (t.view(b, -1, t.shape[1], d).detach().requires_grad_()
                      for t in (q, k, v))
        with torch.enable_grad():
            out = torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, is_causal=causal, enable_gqa=True,
                scale=kw["scale"])
    else:
        band = flash_mask(sq, sk, causal, window, "cuda")
        ql, kl, vl = (t.view(b, -1, t.shape[1], d).detach().requires_grad_()
                      for t in (q, k.repeat_interleave(group, 0),
                                v.repeat_interleave(group, 0)))
        with torch.enable_grad(), sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=band, scale=kw["scale"])
    dol = do.view(out.shape)

    def library():
        return torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True)

    lib_dq = library()[0].reshape(bh, sq, d)
    new = kernel()
    row = dict(call=call, shape=[bh, sq, sk, d], kv_heads=bh // group,
               causal=causal, window=window,
               ms=time_device(torch, kernel, False),
               plain_ms=time_device(torch, lambda: flash_attention_bwd_ref(
                   q, k, v, o, do, **kw), False, iters=3),
               library_ms=time_device(torch, library, False),
               library_dq_max_abs_diff=float((lib_dq - new[0]).abs().max()),
               **flash_bwd_bound(bh, sq, sk, d, causal, window, 4, group))
    if old is not None:
        args = (q, k, v, o, do, causal, window, kw["scale"], group)
        diff = max(float((a - b).abs().max())
                   for a, b in zip(old(*args), new))
        turns = [time_device(torch, lambda: old(*args), False, iters=5),
                 time_device(torch, kernel, False),
                 time_device(torch, kernel, False),
                 time_device(torch, lambda: old(*args), False, iters=5)]
        row["pr23_kernel"] = dict(ms=[turns[0], turns[3]], new_ms=turns[1:3],
                                  max_abs_diff=diff)
    print(f"flash_attention_bwd at {row['shape']} ({call}) on "
          f"{row['kv_heads']} KV heads, causal={causal}, window={window}: "
          f"{row['ms']:.3f} ms device, plain {row['plain_ms']:.3f} ms, "
          f"autograd through scaled_dot_product_attention "
          f"{row['library_ms']:.3f} ms (dq max |d| "
          f"{row['library_dq_max_abs_diff']:.3g}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_detail']}; "
          f"{row['bytes'] / 1e6:.1f} MB, {row['flops'] / 1e9:.2f} GFLOP; "
          f"all float32 on the CUDA cores {row['f32_ms']:.4f} ms)"
          + (f"; the PR-23 kernel {row['pr23_kernel']['ms']} ms against "
             f"{row['pr23_kernel']['new_ms']} in turns (max |d| "
             f"{row['pr23_kernel']['max_abs_diff']:.3g})"
             if old is not None else ""), flush=True)
    return row


def time_flash_bwd(torch):
    """K5-backward at every ``FLASH_BWD_SHAPES`` call (:func:`flash_bwd_row`);
    the first, yi-6b's, is the kernels line's row."""
    old = pr23_flash_bwd(torch)
    rows = []
    for call, bh, sq, sk, d, causal, group, window in FLASH_BWD_SHAPES:
        rows.append(flash_bwd_row(torch, call, bh, sq, sk, d, causal, group,
                                  window, old))
        torch.cuda.empty_cache()
    return dict(rows[0], shapes=rows[1:])


def profile_train_step(torch, step):
    """One more SGD step under torch.profiler: wall ms, device ms by
    kernel, the device's busy share, and the shares of K5 (its prepare
    pass and attention kernel) and of its backward (prepare, dK / dV, dQ),
    by their device kernels' symbols."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    symbols = {"flash_attention_bhsd": ("flash_attention_kernel",
                                        "flash_attention_prepare_kv"),
               "flash_attention_bwd": ("flash_bwd_",),
               "gemm": ("gemm", "Gemm")}
    ours = {k: sum(r[0] for r in rows if any(x in r[2] for x in syms))
            for k, syms in symbols.items()}
    top = sorted(rows, reverse=True)[:12]
    print(f"profile of a yi-6b SGD step: wall {wall_ms:.1f} ms, kernels "
          f"{busy:.1f} ms ({busy / wall_ms:.1%} of wall), "
          + ", ".join(f"{k} {ms:.2f} ms ({ms / max(busy, 1e-9):.1%})"
                      for k, ms in ours.items())
          + f", {sum(r[1] for r in rows)} device ops; top:", flush=True)
    for ms, count, key in top:
        print(f"  {ms:10.3f} ms {count:6d}x  {key[:100]}", flush=True)
    return dict(wall_ms=wall_ms, device_ms=busy, kernels_ms=ours,
                device_ops=sum(r[1] for r in rows),
                top=[[key[:80], ms, count] for ms, count, key in top])


def train_yi(torch):
    """yi-6b at published widths, its first ``TRAIN_LAYERS`` of 32 layers,
    float32, at batch 4 x 2048 (phase 9's shape): a step's loss and
    gradients with K5 against the same with ``_grouped_attention`` on the
    card, on the batch's first sequence; then, counts at 0,
    ``TRAIN_SGD_STEPS`` SGD steps
    (``make_train_step`` over ``functional_call`` of the LM module) and one
    Adam step (``optim.adam``), K5 and its backward launching once per
    layer a step. Returns the launches and a summary."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.fl.round import make_train_step
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens, labels = make_token_stream(
        torch.Generator(device="cuda").manual_seed(1), LM_BATCH, LM_SEQ,
        cfg.vocab_size)
    batch = M.Batch(tokens=tokens, labels=labels)
    params = {k: p.detach() for k, p in model.named_parameters()}
    n_params = sum(p.numel() for p in params.values())
    torch.cuda.synchronize()
    print(f"yi-6b train: {n_params} parameters ({TRAIN_LAYERS} layers, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def loss_fn(p, b):
        return torch.func.functional_call(model, p, (b, cfg))

    per_layer = launch_counts(flash_attention_bhsd=TRAIN_LAYERS,
                              flash_attention_bwd=TRAIN_LAYERS)
    first = M.Batch(tokens=tokens[:1], labels=labels[:1])
    reset_counts()
    grads, loss = torch.func.grad_and_value(loss_fn)(params, first)
    if read_counts() != per_layer:
        raise AssertionError(f"yi-6b train: a step launched {read_counts()},"
                             f" want {per_layer}")
    # the same step with the plain grouped attention (the check only)
    flash = attn._flash_attention
    attn._flash_attention = attn._grouped_attention
    try:
        plain_grads, plain_loss = torch.func.grad_and_value(loss_fn)(
            params, first)
    finally:
        attn._flash_attention = flash
    loss_rel = abs(float(loss) / float(plain_loss) - 1.0)
    grad_rel = max(float((grads[k] - g).abs().max()) / float(g.abs().max())
                   for k, g in plain_grads.items())
    print(f"yi-6b train: a step on 1 x {LM_SEQ} with K5 against the plain "
          f"grouped attention: loss {float(loss):.7f} / "
          f"{float(plain_loss):.7f} (rel "
          f"{loss_rel:.3g}), gradients max |d| / max |plain| {grad_rel:.3g}",
          flush=True)
    if not (math.isfinite(float(loss)) and loss_rel <= TRAIN_LOSS_TOL
            and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"yi-6b train: K5's step off the plain step "
                             f"(loss {loss_rel:.3g}, gradients "
                             f"{grad_rel:.3g})")
    del grads, plain_grads
    torch.cuda.empty_cache()

    # the main path: SGD steps, then an Adam step, counts from 0
    step = make_train_step(loss_fn, TRAIN_GAMMA)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, secs = [], []
    for _ in range(TRAIN_SGD_STEPS):
        before = read_counts()
        t = time.perf_counter()
        params, loss = step(params, batch)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t)
        after = read_counts()
        if {k: after[k] - before[k] for k in after} != per_layer:
            raise AssertionError(f"yi-6b train: SGD step launched "
                                 f"{after} - {before}, want {per_layer}")
    sgd_peak = torch.cuda.max_memory_allocated()
    # one more SGD step under the profiler (its launches not counted, its
    # update dropped)
    counts = read_counts()
    profiled = profile_train_step(torch, lambda: step(params, batch))
    set_counts(counts)
    torch.cuda.empty_cache()
    init, update = optim.adam()
    state = init(params)
    before = read_counts()
    t = time.perf_counter()
    grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
    params, state = update(grads, state, params, TRAIN_GAMMA)
    adam_loss = float(loss)
    adam_s = time.perf_counter() - t
    launches = read_counts()
    if {k: launches[k] - before[k] for k in launches} != per_layer:
        raise AssertionError(f"yi-6b train: the Adam step launched "
                             f"{launches} - {before}, want {per_layer}")
    if not (all(math.isfinite(x) for x in losses + [adam_loss])
            and int(state.step) == 1
            and all(bool(torch.isfinite(p).all()) for p in params.values())):
        raise AssertionError(f"yi-6b train: losses {losses}, Adam "
                             f"{adam_loss}")
    summary = dict(layers=TRAIN_LAYERS, batch=[LM_BATCH, LM_SEQ],
                   params=n_params, sgd_losses=losses, sgd_step_s=secs,
                   step_s=statistics.median(secs[1:]),
                   sgd_peak_bytes=sgd_peak, adam_loss=adam_loss,
                   adam_step_s=adam_s,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   check=dict(loss_rel=loss_rel, grad_rel=grad_rel),
                   profile=profiled)
    print(f"yi-6b train: SGD losses {losses}, step s {secs} (median of the "
          f"last {len(secs) - 1}: {summary['step_s']:.3f}), peak "
          f"{sgd_peak / 1e9:.2f} GB; Adam step {adam_s:.3f} s, loss "
          f"{adam_loss:.6f}, peak {summary['peak_bytes'] / 1e9:.2f} GB; "
          f"launches {launches}", flush=True)
    del model, params, state, grads
    torch.cuda.empty_cache()
    return launches, summary


class RecordedDraws:
    """A draws source that records every draw it hands out (by method and
    round), so the same draws can be replayed elsewhere."""

    def __init__(self, draws):
        self.draws, self.log = draws, {}

    def __getattr__(self, name):
        fn = getattr(self.draws, name)

        def call(*args):
            if (name, args) not in self.log:
                self.log[(name, args)] = fn(*args)
            return self.log[(name, args)]
        return call


class ReplayedDraws:
    """A :class:`RecordedDraws` log moved to another device."""

    def __init__(self, log, device):
        def move(x):
            if isinstance(x, (tuple, list)):
                return type(x)(move(y) for y in x)
            if isinstance(x, dict):
                return {k: move(y) for k, y in x.items()}
            return x.to(device) if hasattr(x, "to") else x
        self.log = {k: move(v) for k, v in log.items()}

    def __getattr__(self, name):
        return lambda *args: self.log[(name, args)]


def leaf_errors(card, cpu):
    """Each leaf's max |card - CPU| over its largest |CPU| entry."""
    return {k: float((card[k].cpu() - c).abs().max()) / float(c.abs().max())
            for k, c in cpu.items()}


def fl_lm_grads(torch, zoo, ds, params):
    """The FL engine's participant gradient, vmap(grad(lm_loss)) over the
    first ``m_cap`` clients' first batch at the initial weights, on the
    card and on the CPU: one K5 forward and one backward launch per layer
    for all participants (the vmap rules fold them into BH), each leaf
    within ``FL_GRAD_TOL``. (The participants' updates y - x are not
    compared: both sides round w - gamma g to float32, and a weight's ulp
    is not small against a few steps' update at gamma 0.01.) Returns the
    largest leaf error."""
    from repro_torch.models.registry import make_model
    m, b = zoo.BASE["m_cap"], zoo.BASE["batch"]
    batch = (ds.client_images[:m, :b], ds.client_labels[:m, :b])
    grad = torch.func.vmap(
        torch.func.grad(make_model("transformer_lm", ds).loss_fn),
        in_dims=(None, 0))
    reset_counts()
    card = grad(params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    want = launch_counts(flash_attention_bhsd=2, flash_attention_bwd=2)
    if launches != want:
        raise AssertionError(f"FL transformer_lm vmap(grad): launches "
                             f"{launches}, want {want}")
    cpu = grad({k: p.cpu() for k, p in params.items()},
               tuple(t.cpu() for t in batch))
    errs = leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    if not errs[worst] <= FL_GRAD_TOL:
        raise AssertionError(f"FL transformer_lm vmap(grad) over {m} "
                             f"participants: {worst} off by {errs[worst]} "
                             f"of its largest |CPU| (> {FL_GRAD_TOL})")
    print(f"FL transformer_lm: vmap(grad(lm_loss)) over {m} participants "
          f"x {b} sequences on the card vs the CPU: each leaf's max |d| / "
          f"max |CPU| <= {errs[worst]:.3g} ({worst}); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return errs[worst]


def fl_lm_final_params(torch, zoo, ds, host, log, params):
    """The leg's rounds once more through the engine's chunk runner on the
    card and on the CPU, from the recorded draws and the same initial
    weights: the global params after the last round, each leaf within
    ``FL_PARAM_TOL`` and moved from its start. Returns the largest leaf
    error and the smallest move."""
    from repro_torch.fl.engine import init_carry, make_chunk_runner
    finals = []
    for data, device, start in ((ds, "cuda", params),
                                (host, "cpu", {k: p.cpu() for k, p in
                                               params.items()})):
        sim, scfg, ch, sig = zoo.configs("transformer_lm", (), device)
        draws = ReplayedDraws(log, device)
        run = make_chunk_runner(data, sim, scfg, ch, sig, draws)
        carry, _, _ = run(init_carry(draws, start, scfg, sim, sig, ch),
                          sim.rounds)
        finals.append(carry[0])
    errs = leaf_errors(*finals)
    worst = max(errs, key=errs.get)
    moved = min(float((p - params[k].cpu()).abs().max()) / float(
        params[k].abs().max()) for k, p in finals[1].items())
    if not (errs[worst] <= FL_PARAM_TOL and moved > 0):
        raise AssertionError(f"FL transformer_lm final params: {worst} off "
                             f"by {errs[worst]} of its largest |CPU| (> "
                             f"{FL_PARAM_TOL}), smallest move {moved}")
    print(f"FL transformer_lm: global params after {sim.rounds} rounds on "
          f"the card vs the CPU: each leaf's max |d| / max |CPU| <= "
          f"{errs[worst]:.3g} ({worst}); each leaf moved by at least "
          f"{moved:.3g} of its largest initial |entry|", flush=True)
    return errs[worst], moved


def fl_lm_leg(torch):
    """The ``transformer_lm`` leg of ``examples/model_zoo_fl.py`` (N = 40,
    10 rounds, cuda_fused) on the card, its draws recorded, then on the
    CPU from the same draws and weights: K2 once a round, K5's forward
    and backward inside vmap(grad) (D = 16 padded to 32) once per layer a
    local step and K5 once per layer an evaluation, the same selections
    but at lanes within FLIP_GAP of q, the final accuracy within
    ``FL_ACC_TOL``; then the participants' gradients and the final global
    params against the CPU (:func:`fl_lm_grads`,
    :func:`fl_lm_final_params`). Returns the launches and a summary."""
    import numpy as np

    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.examples import model_zoo_fl as zoo
    from repro_torch.fl.engine import default_draws
    _, ds = zoo.datasets(torch.device("cuda"))
    sim, *_ = zoo.configs("transformer_lm", (), ds.device)
    draws = RecordedDraws(default_draws(sim, ds))
    reset_counts()
    t = time.perf_counter()
    hist, params = zoo.leg("transformer_lm", (), ds, draws=draws,
                           keep_selection=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    launches = read_counts()
    rounds, steps, layers = (zoo.BASE["rounds"], zoo.BASE["local_steps"], 2)
    evals = len(hist["round"])
    want = launch_counts(
        decision_fused=rounds,
        flash_attention_bhsd=layers * (rounds * steps + evals),
        flash_attention_bwd=layers * rounds * steps)
    if launches != want:
        raise AssertionError(f"FL transformer_lm: launches {launches}, want "
                             f"{want}")
    host = FederatedDataset(*(t.cpu() for t in (
        ds.client_images, ds.client_labels, ds.test_images,
        ds.test_labels)), n_classes=ds.n_classes)
    t = time.perf_counter()
    cpu_hist, _ = zoo.leg("transformer_lm", (), host,
                          draws=ReplayedDraws(draws.log, "cpu"),
                          params={k: p.cpu() for k, p in params.items()},
                          keep_selection=True)
    cpu_s = time.perf_counter() - t
    u = np.stack([draws.log[("selection_u", (r,))].cpu().numpy()
                  for r in range(rounds)])
    flips = same_selections("FL transformer_lm card vs CPU",
                            hist["selected"], cpu_hist["selected"], u,
                            hist["q"])
    acc, cpu_acc = float(hist["test_acc"][-1]), float(cpu_hist["test_acc"][-1])
    if not (abs(acc - cpu_acc) <= FL_ACC_TOL
            and np.isfinite(hist["comm_time"]).all()):
        raise AssertionError(f"FL transformer_lm: accuracy {acc} on the "
                             f"card, {cpu_acc} on the CPU")
    grad_err = fl_lm_grads(torch, zoo, ds, params)
    param_err, moved = fl_lm_final_params(torch, zoo, ds, host, draws.log,
                                          params)
    summary = dict(rounds=rounds, card_s=card_s, cpu_s=cpu_s, flips=flips,
                   vmap_grad_rel_err=grad_err, final_params_rel_err=param_err,
                   final_params_min_move=moved,
                   test_acc=hist["test_acc"].tolist(),
                   cpu_test_acc=cpu_hist["test_acc"].tolist(),
                   comm_time=float(hist["comm_time"][-1]),
                   n_selected=hist["n_selected"].tolist())
    print(f"FL transformer_lm: {rounds} rounds in {card_s:.2f} s on the card"
          f" ({cpu_s:.2f} s on the CPU), launches {launches}; selections "
          f"equal but {flips} lanes within {FLIP_GAP} of q; accuracy "
          f"{hist['test_acc'].tolist()} (CPU {cpu_hist['test_acc'].tolist()})",
          flush=True)
    return launches, summary


def ssd_refuses_grad(torch):
    """ops.ssd on the card under grad raises NotImplementedError (K4 has
    no backward yet) and runs under no_grad."""
    from repro_torch.kernels import ops
    x, dt, a, bm, cm = ssd_lanes(torch, 1, 128, 2, 32, 16, 3)
    x.requires_grad_()
    try:
        ops.ssd(x, dt, a, bm, cm, chunk=32)
    except NotImplementedError as e:
        if "item 13" not in str(e):
            raise AssertionError(f"ops.ssd under grad: {e}") from e
    else:
        raise AssertionError("ops.ssd ran under grad on the card")
    with torch.no_grad():
        ops.ssd(x, dt, a, bm, cm, chunk=32)
    print("ops.ssd raises NotImplementedError on the card under grad "
          "(ROADMAP §A item 13) and runs under no_grad", flush=True)


def train_path(torch):
    """Phase 15. Returns the K5-backward check's error, its timing row,
    the launches by path and the summary."""
    t0 = time.perf_counter()
    err = check_flash_bwd(torch)
    row = time_flash_bwd(torch)
    torch.cuda.empty_cache()
    yi_launches, yi = train_yi(torch)
    prof = yi["profile"]
    bwd_ms = prof["kernels_ms"]["flash_attention_bwd"]
    if "pr23_kernel" in row:
        # the same step with the PR-23 backward: its kernel time at yi's
        # shape in this run in place of the new kernel's profiled time
        old_ms = TRAIN_LAYERS * statistics.mean(row["pr23_kernel"]["ms"])
        prof["with_pr23_bwd"] = dict(
            device_ms=prof["device_ms"] - bwd_ms + old_ms,
            flash_attention_bwd_ms=old_ms)
    print(f"yi-6b SGD step, device time: K5 "
          f"{prof['kernels_ms']['flash_attention_bhsd']:.2f} ms, its "
          f"backward {bwd_ms:.2f} ms of {prof['device_ms']:.1f} ms"
          + (f"; with the PR-23 backward {old_ms:.2f} ms of "
             f"{prof['with_pr23_bwd']['device_ms']:.1f} ms"
             if "pr23_kernel" in row else ""), flush=True)
    fl_launches, fl = fl_lm_leg(torch)
    ssd_refuses_grad(torch)
    wall = time.perf_counter() - t0
    print(f"phase 15 took {wall:.1f} s", flush=True)
    return err, row, {"yi-6b train": yi_launches,
                      "transformer_lm FL": fl_launches}, dict(
        yi=yi, fl=fl, wall_s=wall)


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
    # full float32 products and convolutions in every phase and every plain
    # version, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "Performance Loss")):
                print(f"  {name}: {line.strip()}", flush=True)
    for name in ("decision_fused", "ssd_scan", "flash_attention",
                 "flash_attention_bwd"):
        check_no_spills(name, logs.get(name, ""))

    ch, scfg = CONFIG.channel(), CONFIG.scheduler(lam=10.0)
    co = decision_coeffs(scfg, ch)
    ops = pack_decision_operands(co.solve, co.acct)
    err = check_kernels(torch, scfg, ch, ops)
    err["decision_fused_batched"] = check_batched(torch)
    # phase 7's K1-K3 timings run here, next to their checks and before
    # phases 5 and 6 run torch.profiler in this process
    times = timings(torch, scfg, ch, ops)
    err["ssd_scan"] = check_ssd(torch)
    err["flash_attention_bhsd"] = check_flash(torch)
    launches, run, cifar_ctx = main_path(torch)
    by_path = {"cifar10": dict(launches)}
    more, femnist, femnist_ctx = femnist_path(torch)
    by_path.update(more)
    more, scenarios = scenarios_path(torch, cifar_ctx, femnist_ctx)
    by_path.update(more)
    del femnist_ctx
    torch.cuda.empty_cache()
    for name in launches:
        launches[name] = sum(p[name] for p in by_path.values())
    profile_rounds(torch, run)
    (svc_counts, per_full, svc_summary,
     (svc, full_flushes)) = service_path(torch)
    svc_profile = dict(flush_split(svc, full_flushes),
                       **profile_flushes(torch, svc, full_flushes))
    tele_launches, telemetry = telemetry_path(torch, cifar_ctx)
    del cifar_ctx
    torch.cuda.empty_cache()
    by_path["telemetry"] = {k: tele_launches[k]
                            for k in ("scheduler_solve", "decision_fused")}
    for name in ("scheduler_solve", "decision_fused"):
        launches[name] = sum(p[name] for p in by_path.values())
    k3_by_path = {"service": svc_counts["decision_fused_batched"],
                  "telemetry": tele_launches["decision_fused_batched"]}
    launches["decision_fused_batched"] = sum(k3_by_path.values())
    mamba_launches, mamba = lm_path(torch, "mamba2-130m", {"ssd_scan": None})
    ssd_time = time_ssd(torch)
    torch.cuda.empty_cache()
    yi_launches, yi = lm_path(torch, "yi-6b", {"flash_attention_bhsd": None},
                              cpu_layers=2)
    flash_time = time_flash(torch)
    torch.cuda.empty_cache()
    zoo_launches, zoo = zoo_path(torch, ZOO)
    zoo_flash = time_zoo_flash(torch)
    torch.cuda.empty_cache()
    moe_launches, moe_zoo = zoo_path(torch, MOE_ZOO)
    jamba_ssd_time = time_ssd(torch, JAMBA_SSD)
    torch.cuda.empty_cache()
    err["flash_attention_bwd"], bwd_time, train_launches, train = (
        train_path(torch))
    by_path["transformer_lm FL"] = {
        k: train_launches["transformer_lm FL"][k]
        for k in ("scheduler_solve", "decision_fused")}
    for name in ("scheduler_solve", "decision_fused"):
        launches[name] = sum(p[name] for p in by_path.values())
    flash_by_path = {arch: c["flash_attention_bhsd"] for arch, c in (
        ("yi-6b", yi_launches), *zoo_launches.items(),
        *moe_launches.items())}
    flash_by_path.update({path: dict(launches=c["flash_attention_bhsd"])
                          for path, c in train_launches.items()})
    bwd_by_path = {path: c["flash_attention_bwd"]
                   for path, c in train_launches.items()}
    ssd_by_path = {"mamba2-130m": mamba_launches["ssd_scan"],
                   "jamba-v0.1-52b": moe_launches["jamba-v0.1-52b"][
                       "ssd_scan"]}

    rows = []
    for name in ("scheduler_solve", "decision_fused"):
        spec = KERNELS[name]
        small = times[(name, scfg.n_clients)]
        rows.append({
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "launches_per_round": by_path["cifar10"][name] / ROUNDS,
            "max_abs_err": err[name], "n": scfg.n_clients,
            "ms": small["ms"], "plain_ms": small["plain_ms"],
            "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
            "library_ms": None, "call_ms": small["call_ms"],
            "plain_call_ms": small["plain_call_ms"],
            **{k: small[k] for k in DECISION_EXTRAS + SOLVE_EXTRAS
               if k in small},
            "femnist": dict(times[(name, FEMNIST_N)], n=FEMNIST_N),
            "large": dict(times[(name, 1 << 20)], n=1 << 20)})
    spec = KERNELS["decision_fused_batched"]
    main_shape, *others = BATCHED_SHAPES[2:]
    rows.append({
        "name": "decision_fused_batched", "route": "cuda",
        "source": spec["source"], "replaces": spec["replaces"],
        "launches": launches["decision_fused_batched"],
        "launches_by_path": k3_by_path,
        "launches_per_full_flush": per_full,
        "max_abs_err": err["decision_fused_batched"], "library_ms": None,
        **times[("decision_fused_batched", main_shape)],
        "other_shapes": [times[("decision_fused_batched", sh)]
                         for sh in others]})
    rows.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:72",
        "launches": sum(c["launches"] for c in ssd_by_path.values()),
        "launches_by_path": ssd_by_path,
        "launches_per_forward": ssd_by_path["mamba2-130m"]["per_forward"],
        "launches_per_generate": ssd_by_path["mamba2-130m"]["per_generate"],
        "max_abs_err": err["ssd_scan"], "library_ms": None, **ssd_time,
        "jamba_shape": jamba_ssd_time})
    rows.append({
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "launches": sum(c["launches"] for c in flash_by_path.values()),
        "launches_by_path": flash_by_path,
        "launches_per_forward": flash_by_path["yi-6b"]["per_forward"],
        "launches_per_prefill": flash_by_path["yi-6b"]["per_prefill"],
        "launches_per_decode": flash_by_path["yi-6b"]["per_decode"],
        "max_abs_err": err["flash_attention_bhsd"], **flash_time,
        "zoo_shapes": zoo_flash})
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "backward_of": "flash_attention_bhsd",
        "launches": sum(bwd_by_path.values()),
        "launches_by_path": bwd_by_path,
        "launches_per_train_step": TRAIN_LAYERS,
        "max_abs_err": err["flash_attention_bwd"], **bwd_time})
    print(json.dumps({"service": dict(svc_summary, profile=svc_profile)}),
          flush=True)
    print(json.dumps({"telemetry": telemetry}), flush=True)
    print(json.dumps({"femnist": femnist}), flush=True)
    print(json.dumps({"scenarios": scenarios}), flush=True)
    print(json.dumps({"mamba": mamba}), flush=True)
    print(json.dumps({"yi": yi}), flush=True)
    print(json.dumps({"zoo": zoo}), flush=True)
    print(json.dumps({"moe": moe_zoo}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
