#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together), timing the build and printing
   each kernel's registers and spills from ``ptxas``; K2/K3, K4, K5 and
   the two backwards must not spill;
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
   forward shape (each of its four device kernels' share by the profiler
   in a fresh process started for it, their sum beside the whole call's)
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
   ``max_memory_allocated``; then the
   ``transformer_lm`` leg of ``examples/model_zoo_fl.py`` (N = 40, 10
   rounds, ``cuda_fused``) on the card, its draws recorded, and on the
   CPU from the same draws and weights: K2 once a round, K5's forward and
   backward once per layer a local step inside ``vmap(grad)`` (and the
   forward once per layer an evaluation), the selections equal but at
   lanes within 1e-6 of q, the final accuracy within 10 of the 6,400 test
   tokens;
16. Mamba training on the card (``ssd_train_path``): K4's backward kernel
   (``csrc/ssd_scan_bwd.cu``: seven device kernels on the scratch K4's
   forward saves, 3xTF32 ``wgmma`` GEMMs and ``mma.sync``, no atomics)
   through ``ops.ssd`` under ``torch.func.grad`` against its plain
   version (``ssd_scan_bwd_ref``, on the card) and its kernel-order plain
   version (``ssd_scan_bwd_gemm_ref``) at ``SSD_BWD_SHAPES``: phase 3's
   SSD shapes (the padded (1, 100, ...) and prefill (4, 2000, 24, 64,
   128), mamba2-130m's (4, 2048, 24, 64, 128)) and jamba-v0.1-52b's (4,
   2048, 128, 64, 16), from a zero state and with an initial state and
   the final state's cotangent: dx, ddt, da, dB, dC, dh0 within 1e-4 of
   each one's largest |plain| entry, the same bits on a rerun, one K4 and
   one backward launch a call; ``vmap(grad)`` over 3 samples with their
   own a, one launch each way, bit-equal to the per-sample gradients; its
   device ms at mamba's and jamba's shapes beside its plain version's and
   its bound (``ssd_bwd_bound``: 16.4 GFLOP at mamba's, 3xTF32), each of
   its seven device kernels' ms by CUDA events around each launched alone
   (their sum beside the whole call's; no single PyTorch call computes
   it), and, where ``build/ssd_scan_bwd_cuda_cores.cu`` (the CUDA-core
   design, float32 FMAs) or ``build/ssd_scan_bwd_pr25.cu`` (the earlier
   3xTF32 ``mma.sync`` design, ``git show
   c5c94b9:src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``) is at hand,
   that design in turns with this one;
   then, per id of ``SSD_TRAIN``, a reduced config's step on
   the card against the CPU (loss rtol 1e-5, gradients 1e-4 of each
   leaf's largest |CPU|) and, counts at 0, 3 SGD steps at published
   widths, float32: mamba2-130m whole (24 layers) at 4 x 2048, K4 and its
   backward 24 + 24 launches a step; jamba-v0.1-52b's first 2 of 32
   layers (Mamba + dense MLP, Mamba + MoE; 14.9 GB) at 2 x 2048, 2 + 2;
   the losses and weights finite, the step's seconds (median of the last
   2) and peak memory.

17. (run right after phase 11) the sharded paths (ROADMAP §A item 8) on
   one rank: a world-size-1 NCCL group through
   ``launch.distributed.initialize`` (a ``file://`` store under
   ``build/``); phase 10's FEMNIST network (N = 3,597, the CNN, 5 rounds,
   m_cap 32) through ``client_shards=1`` under ``cuda_fused`` and under
   ``cuda``, ``participant_shards=1``, the ``(1, 1)`` composed mesh,
   phase 11's population on the client-sharded path and the delta
   aggregate on a bfloat16 wire through ``participant_shards=1``, each
   against its sequential run under cuDNN's deterministic algorithms:
   every history key, the selections and q (and the activity masks) bit
   for bit, K2 (K1 under ``cuda``) exactly 5 launches in each run; each
   run's ms a round between CUDA events; 2 rounds of the (1, 1) mesh and
   of the population round, sharded and sequential, under
   ``torch.cuda.set_sync_debug_mode("error")`` (the sharded rounds must
   not synchronise where the sequential ones do not); then
   ``examples/massive_n.py``'s runner (N = 100,000, lam = 0.3, 60 rounds,
   M matched over 150 rounds) for proposed and M-matched uniform under
   ``cuda_fused``, sequential against ``client_shards=1`` bit for bit
   (K2 60 launches a proposed run), rounds/s of each and the
   proposed/uniform comm-time ratio; a ``{"sharded": ...}`` JSON line
   with the card's name and power limit.

TF32 is off for every product and convolution in every phase.

Prints the service's, telemetry's, FEMNIST's, the scenarios', the sharded
paths', Mamba's,
yi's, the zoo's, the MoE zoo's, training's and Mamba training's JSON
lines, the card line, one JSON line of the kernels (``{"kernels":
[...]}``, K5's and K4's backwards rows of their own), then, last,
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
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
# the legacy loop engine against the scan engine on the same draws (phase
# 4 and phase 15's FL leg): comm_time and avg_power rtol (float64 host
# sums of per-round float32 sums against float32 device sums), and the
# accuracy within 20 of phase 4's 2,000 eval images (the participants
# train one after another in the loop, under vmap in the scan engine:
# other cuDNN algorithms, other float32 sums)
LOOP_RTOL, LOOP_ACC_TOL = 1e-5, 20 / 2000
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
    from repro_torch.fl.engine import default_draws
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

    seconds = {}

    def run(label, draws=None, **kw):
        reset_counts()
        t = time.perf_counter()
        hist = run_simulation(draws, params, ds, SimConfig(**base, **kw),
                              scfg, ch, sig, keep_selection=True)
        torch.cuda.synchronize()
        dt = seconds[label] = time.perf_counter() - t
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

    # the draws the fused run takes (sim.seed's), recorded for the loop
    draws = RecordedDraws(default_draws(SimConfig(**base), ds))
    fused, c_fused = run("proposed/cuda_fused", draws=draws)
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
    uni_label = f"uniform (M={m:.3f})"
    uni, _ = run(uni_label, policy="uniform", uniform_m=m, draws=draws)
    saving = 1.0 - fused["comm_time"][-1] / uni["comm_time"][-1]
    print(f"comm-time saving of proposed vs M-matched uniform after "
          f"{ROUNDS} rounds: {saving:.1%}", flush=True)
    # the scan engine's time a round for proposed: its fastest solver run
    # (the first run also pays the vmapped convolutions' first calls)
    warm = min(seconds[k] for k in seconds if k.startswith("proposed/"))
    legs = (("proposed", fused, warm, {}),
            ("uniform", uni, seconds[uni_label],
             dict(policy="uniform", uniform_m=m)))
    loop, loop_launches = {}, launch_counts()
    for policy, scan, scan_s, kw in legs:
        counts, loop[policy] = loop_leg(
            torch, f"cifar10 {policy}", draws, params, ds,
            SimConfig(**base, **kw), scfg, ch, sig, scan, scan_s,
            launch_counts())
        loop_launches = {k: v + counts[k] for k, v in loop_launches.items()}
    ctx = dict(ds=ds, params=params, sig=sig, scfg=scfg, ch=ch, m=m,
               sim=SimConfig(**base), fused=fused, loop=loop,
               loop_launches=loop_launches)
    return ({"scheduler_solve": c_solve["scheduler_solve"],
             "decision_fused": c_fused["decision_fused"]}, run, ctx)


def loop_leg(torch, tag, draws, params, ds, sim, scfg, ch, sig, scan,
             scan_s, want, flips=0, acc_tol=LOOP_ACC_TOL, acc_points=None):
    """``run_simulation_loop`` (the legacy engine) on a scan run's draws,
    driven with the counts at 0: its launches must be ``want``; ``round``
    and ``n_selected`` must equal the scan run's history ``scan``
    (``n_selected`` within ``flips``, the scan run's lanes whose uniform
    lies within FLIP_GAP of q), comm_time and avg_power within
    ``LOOP_RTOL`` of it unless a count actually differs (a flip that
    leaves every eval point's count as it was fails the leg: the check
    errs strict), test_acc within ``acc_tol`` at the eval points
    ``acc_points`` (a slice; None: all). ``scan_s`` is the scan run's
    wall time. Returns the launches and the leg's summary."""
    import numpy as np

    from repro_torch.fl.simulation import run_simulation_loop
    reset_counts()
    t = time.perf_counter()
    hist = run_simulation_loop(draws, params, ds, sim, scfg, ch, sig)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = read_counts()
    if launches != want:
        raise AssertionError(f"{tag} loop engine: launches {launches}, want "
                             f"{want}")
    check_history(f"{tag} loop engine", hist)
    rel = {k: float(abs(hist[k] / scan[k] - 1.0).max())
           for k in ("comm_time", "avg_power")}
    points = slice(None) if acc_points is None else acc_points
    acc = float(abs(hist["test_acc"][points]
                    - scan["test_acc"][points]).max())
    nsel = int(abs(hist["n_selected"] - scan["n_selected"]).max())
    if not (np.array_equal(hist["round"], scan["round"]) and nsel <= flips
            and (nsel or max(rel.values()) <= LOOP_RTOL)
            and acc <= acc_tol):
        raise AssertionError(
            f"{tag}: the loop engine's history {hist} against the scan "
            f"engine's {scan}: n_selected off by {nsel} ({flips} lanes near "
            f"q), rel {rel} (> {LOOP_RTOL}), test_acc off by {acc} (> "
            f"{acc_tol})")
    rounds = sim.rounds
    summary = dict(loop_s_per_round=loop_s / rounds,
                   scan_s_per_round=scan_s / rounds,
                   launches={k: v for k, v in launches.items() if v},
                   comm_time_rel=rel["comm_time"],
                   avg_power_rel=rel["avg_power"], test_acc_diff=acc,
                   n_selected=hist["n_selected"].tolist(),
                   test_acc=hist["test_acc"].tolist())
    print(f"{tag}: loop engine {loop_s / rounds:.3f} s a round, scan engine "
          f"{scan_s / rounds:.3f} s a round; launches "
          f"{summary['launches']}; round and n_selected equal, comm_time "
          f"rel {rel['comm_time']:.3g}, avg_power rel "
          f"{rel['avg_power']:.3g}, test_acc {hist['test_acc'].tolist()} "
          f"(scan {scan['test_acc'].tolist()})", flush=True)
    return launches, summary


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
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
    return {"scheduler_solve": scheduler_solve,
            "decision_fused": decision_fused,
            "decision_fused_batched": decision_fused_batched,
            "ssd_scan": ssd_scan,
            "flash_attention_bhsd": flash_attention_bhsd,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan_bwd": ssd_scan_bwd}


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


@functools.cache
def earlier_kernel(stem):
    """The library of ``build/<stem>.cu``, an earlier design of a kernel put
    there by hand, built once a run with the port's flags and its headers
    on the include path (a header beside the source, from the same commit,
    wins); None when that file is absent."""
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
    # CPU and CUDA activities: late in the run a CUDA-only session records
    # no kernel (seen at jamba's shape, phase 14)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(SSD_PASSES, 0.0)
    for e in prof.key_averages():
        for name in SSD_PASSES:
            if name in e.key:
                out[name] += e.self_device_time_total / 1e3 / calls
    return out


def ssd_pass_split(torch, shape):
    """K4's device kernels' ms per call at ``shape`` (with the final
    state), by :func:`ssd_pass_ms`; run in a fresh process by
    :func:`fresh_ssd_pass_ms`."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, s, h, p, n, chunk = shape
    x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, 5)
    return ssd_pass_ms(torch, lambda: ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                               return_state=True))


def fresh_ssd_pass_ms(shape):
    """:func:`ssd_pass_split` in a child process started for it: late in
    this run a profiler session reads some of K4's kernels low or 0, a
    fresh process's first session does not."""
    code = ("import json, sys, torch; sys.path.insert(0, 'src'); "
            "import chip_smoke as c; "
            f"print(json.dumps(c.ssd_pass_split(torch, {tuple(shape)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def time_ssd(torch, shape=SSD_SHAPES[-1]):
    """K4 and its plain version at a forward shape (mamba2-130m's by
    default; with the final state), device ms by CUDA events, each device
    kernel's share by the profiler in a fresh process (their sum printed
    beside the whole call's); the earlier CUDA-core kernel where its
    source is at hand, timed in turns with this one."""
    from repro_torch.kernels.ref import ssd_chunked_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, s, h, p, n, chunk = shape
    x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, 5)

    def kernel():
        return ssd_scan(x, dt, a, bm, cm, chunk=chunk, return_state=True)

    torch.cuda.empty_cache()  # room on the card for the split's process
    row = dict(
        shape=[b, s, h, p, n], chunk=chunk,
        ms=time_device(torch, kernel, False),
        plain_ms=time_device(torch, lambda: ssd_chunked_ref(
            x, dt, a, bm, cm, chunk=chunk), False, iters=5),
        device_kernels_ms=fresh_ssd_pass_ms(shape),
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
          f" ms by the profiler in a fresh process, sum "
          f"{sum(row['device_kernels_ms'].values()):.4f}), plain "
          f"{row['plain_ms']:.3f} ms, bound "
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
                   check=dict(loss_rel=loss_rel, grad_rel=grad_rel))
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


def fl_lm_grads(torch, zoo, ds, params, vmapped=True):
    """A participant's gradient at the initial weights, on the card and on
    the CPU, as each FL engine takes it: the scan engine's
    vmap(grad(lm_loss)) over the first ``m_cap`` clients' first batch
    (``vmapped``), or the loop engine's grad(lm_loss) of one participant,
    client 0's first batch, as ``local_sgd`` takes it. One K5 forward and
    one backward launch per layer either way (the vmap rules fold the
    participants into BH), each leaf within ``FL_GRAD_TOL``. (The
    participants' updates y - x are not compared: both sides round w -
    gamma g to float32, and a weight's ulp is not small against a few
    steps' update at gamma 0.01.) Returns the largest leaf error."""
    from repro_torch.models.registry import make_model
    m, b = zoo.BASE["m_cap"], zoo.BASE["batch"]
    grad = torch.func.grad(make_model("transformer_lm", ds).loss_fn)
    if vmapped:
        batch = (ds.client_images[:m, :b], ds.client_labels[:m, :b])
        grad = torch.func.vmap(grad, in_dims=(None, 0))
        tag, what = "vmap(grad)", (f"vmap(grad(lm_loss)) over {m} "
                                   f"participants x {b} sequences")
    else:
        batch = (ds.client_images[0, :b], ds.client_labels[0, :b])
        tag, what = "grad", (f"grad(lm_loss) of one participant (the loop "
                             f"engine's) x {b} sequences")
    reset_counts()
    card = grad(params, batch)
    torch.cuda.synchronize()
    launches = read_counts()
    want = launch_counts(flash_attention_bhsd=2, flash_attention_bwd=2)
    if launches != want:
        raise AssertionError(f"FL transformer_lm {tag}: launches "
                             f"{launches}, want {want}")
    cpu = grad({k: p.cpu() for k, p in params.items()},
               tuple(t.cpu() for t in batch))
    errs = leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    if not errs[worst] <= FL_GRAD_TOL:
        raise AssertionError(f"FL transformer_lm {what}: {worst} off by "
                             f"{errs[worst]} of its largest |CPU| (> "
                             f"{FL_GRAD_TOL})")
    print(f"FL transformer_lm: {what} on the card vs the CPU: each leaf's "
          f"max |d| / max |CPU| <= {errs[worst]:.3g} ({worst}); launches "
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
    ``FL_ACC_TOL``; then the legacy loop on the same draws
    (:func:`loop_leg`), the participants' gradients as each engine takes
    them (vmapped, and one participant at a time) and the final global
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
    # the legacy loop on the same draws: the m_cap participants train one
    # at a time, so K5 and its backward launch per participant and step
    sim, scfg, ch, sig = zoo.configs("transformer_lm", (), ds.device)
    m_cap = zoo.BASE["m_cap"]
    near = int((abs(u - hist["q"]) <= FLIP_GAP).sum())
    loop_launches, loop = loop_leg(
        torch, "FL transformer_lm", ReplayedDraws(draws.log, "cuda"), params,
        ds, sim, scfg, ch, sig, hist, card_s, launch_counts(
            flash_attention_bhsd=layers * (rounds * m_cap * steps + evals),
            flash_attention_bwd=layers * rounds * m_cap * steps),
        flips=near, acc_tol=FL_ACC_TOL, acc_points=slice(-1, None))
    grad_err = fl_lm_grads(torch, zoo, ds, params)
    loop_grad_err = fl_lm_grads(torch, zoo, ds, params, vmapped=False)
    param_err, moved = fl_lm_final_params(torch, zoo, ds, host, draws.log,
                                          params)
    summary = dict(rounds=rounds, card_s=card_s, cpu_s=cpu_s, flips=flips,
                   loop=dict(loop, lanes_near_q=near,
                             grad_rel_err=loop_grad_err),
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
    return launches, loop_launches, summary


def train_path(torch):
    """Phase 15. Returns the K5-backward check's error, its timing row,
    the launches by path and the summary."""
    t0 = time.perf_counter()
    err = check_flash_bwd(torch)
    row = time_flash_bwd(torch)
    torch.cuda.empty_cache()
    yi_launches, yi = train_yi(torch)
    fl_launches, loop_launches, fl = fl_lm_leg(torch)
    wall = time.perf_counter() - t0
    print(f"phase 15 took {wall:.1f} s", flush=True)
    return err, row, {"yi-6b train": yi_launches,
                      "transformer_lm FL": fl_launches,
                      "transformer_lm FL loop": loop_launches}, dict(
        yi=yi, fl=fl, wall_s=wall)



# --------------------------------------------------------------------------
# Phase 16: Mamba training on the card, K4's backward kernel.
# --------------------------------------------------------------------------

# (b, S, H, P, N, chunk) of the K4-backward checks: phase 3's SSD shapes
# (the reference tests' padded (1, 100, ...), a mid shape, the padded
# prefill (4, 2000, ...) and mamba2-130m's training shape (4, 2048, 24, 64,
# 128)) and jamba-v0.1-52b's (4, 2048, 128, 64, 16) (last two: timed)
SSD_BWD_SHAPES = SSD_SHAPES + (JAMBA_SSD,)
# of each gradient's largest |plain| entry: the kernel's 3xTF32 products
# (lo.lo dropped, ~2^-22) sum in another order than the plain version's
# einsums, around K4's 3xTF32 forward; da, one sum over every (b, S), is
# the loosest (1.3e-5 at most on an H100, the rest under 1.1e-6)
SSD_BWD_TOL = 1e-4
# (id, layers kept, batch, seq): mamba2-130m whole (24 Mamba layers, 0.52
# GB of float32 weights); jamba-v0.1-52b's first 2 of 32 layers (Mamba +
# dense MLP, Mamba + MoE of 16 experts: 3.73 B parameters, 14.9 GB), the
# batch cut to 2 x 2048 so that the weights, their gradients, the stepped
# weights and the activations stay under the card's 80 GB
SSD_TRAIN = (("mamba2-130m", None, 4, 2048), ("jamba-v0.1-52b", 2, 2, 2048))
# the reduced configs' step on the card against the CPU (2 x 256 tokens:
# 8 chunks of 32): the loss rtol, and each gradient leaf's max |d| over
# its largest |CPU| entry
SSD_STEP_LOSS_TOL, SSD_STEP_GRAD_TOL = 1e-5, 1e-4


def ssd_bwd_bound(b, s, h, p, n, chunk, with_state):
    """Least time of one K4-backward call. Bytes: the function's inputs
    (x, dt, a, B, C, dy; with the state h0 and its cotangent) read once and
    its gradients written once, at HBM rate (the forward's saved states
    are a choice of the design, not counted). Operations: per (batch,
    head, chunk) exp(lc) C^T dy, B dS, dy S^T and x dS^T (2 L N P each) and
    G = dy x^T and M^T dy over the causal triangle (2 tri P each); per
    (batch, chunk) dCB B and dCB^T C over the triangle (2 tri N each),
    dCB summed over the heads first; each a float32 product that
    float32-accurate tensor-core work takes as three TF32 products (3xTF32)
    at the TF32 rate; the weights, the lc terms and the head sums on the
    CUDA cores at the float32 rate. The bound is the largest of the three
    times; ``f32_ms`` is everything in float32 on the CUDA cores, the
    bound of a design without tensor cores (this one's)."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    state = b * h * n * p if with_state else 0
    # x, dy, dx; dt, ddt; a, da; B, C, dB, dC; h0, dh, dh0
    n_bytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 2 * h + 4 * b * s * n
                   + 3 * state)
    products = b * nc * (h * (4 * 2 * chunk * n * p + 2 * 2 * tri * p)
                         + 2 * 2 * tri * n)
    other = (b * h * nc * (10 * tri + 4 * chunk * p + 4 * chunk * n
                           + 20 * chunk + 2 * n * p)
             + 2 * b * s * h * n)
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


def ssd_grads(torch, x, dt, a, bm, cm, h0, dy, dh, chunk):
    """``ops.ssd``'s gradients in (x, dt, a, bm, cm[, h0]) of sum(y dy)
    [+ sum(h_final dh)], through ``torch.func.grad`` as training takes
    them."""
    from repro_torch.kernels import ops

    def loss(x, dt, a, bm, cm, h0):
        y, h_final = ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0,
                             return_state=True)
        return (y * dy).sum() + (0.0 if dh is None else (h_final * dh).sum())
    argnums = tuple(range(5 if h0 is None else 6))
    return torch.func.grad(loss, argnums=argnums)(x, dt, a, bm, cm, h0)


def check_ssd_bwd(torch):
    """K4's backward (through ``ops.ssd`` under ``torch.func.grad``, one K4
    and one backward launch a call) against ``ssd_scan_bwd_ref`` on the
    same padded inputs at ``SSD_BWD_SHAPES``, from a zero state and with
    an initial state and the final state's cotangent, the same bits on a
    rerun; then ``vmap(grad)`` over 3 samples, each with its own a, at
    (2, 256, 24, 64, 128): one launch each way, bit-equal to the
    per-sample gradients. Returns the largest |d| over the checks."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (ssd_scan_bwd_gemm_ref,
                                         ssd_scan_bwd_ref)
    from repro_torch.kernels.ssd_scan import bwd_head_group
    err = 0.0
    names = ("dx", "ddt", "da", "dbm", "dcm", "dh0")
    for b, s, h, p, n, chunk in SSD_BWD_SHAPES:
        x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, s + n)
        g = torch.Generator(device="cuda").manual_seed(s + 1)
        dy = torch.randn(x.shape, device="cuda", generator=g)
        for state in (False, True):
            h0, dh = ((torch.randn((b, h, n, p), device="cuda", generator=g)
                       for _ in range(2)) if state else (None, None))
            reset_counts()
            got = ssd_grads(torch, x, dt, a, bm, cm, h0, dy, dh, chunk)
            if read_counts() != launch_counts(ssd_scan=1, ssd_scan_bwd=1):
                raise AssertionError(f"ssd_scan_bwd check launched "
                                     f"{read_counts()}")
            again = ssd_grads(torch, x, dt, a, bm, cm, h0, dy, dh, chunk)
            xp, dtp, bmp, cmp = ops.pad_to_chunk(chunk, x, dt, bm, cm)
            dyp = ops.pad_to_chunk(chunk, dy, dt, bm, cm)[0]
            tag = f"ssd_scan_bwd {(b, s, h, p, n)} chunk {chunk} state={state}"
            hg = bwd_head_group(b, xp.shape[1], h, chunk)
            rels = {}
            for label, plain in (
                    ("plain", ssd_scan_bwd_ref), ("kernel-order plain",
                     lambda *v, **k: ssd_scan_bwd_gemm_ref(
                         *v, head_group=hg, **k))):
                want = plain(xp, dtp, a, bmp, cmp, dyp, chunk=chunk, h0=h0,
                             dh=dh)
                want = [want[0][:, :s], want[1][:, :s], want[2],
                        want[3][:, :s], want[4][:, :s], want[5]][:len(got)]
                torch.cuda.synchronize()
                rels[label] = []
                for name, gg, ww in zip(names, got, want):
                    diff = float((gg - ww).abs().max())
                    rels[label].append(diff / float(ww.abs().max()))
                    err = max(err, diff)
                    if not (torch.isfinite(gg).all()
                            and rels[label][-1] <= SSD_BWD_TOL):
                        raise AssertionError(
                            f"{tag}: {name} off its {label} version by "
                            f"{rels[label][-1]:.3g} of max |plain|")
                del want
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{tag}: a rerun changed the result")
            print(f"{tag} agrees with its plain version ("
                  + ", ".join(f"{k} {r:.3g}"
                              for k, r in zip(names, rels["plain"]))
                  + " of max |plain|) and its kernel-order plain version "
                  f"(hg {hg}: "
                  + ", ".join(f"{k} {r:.3g}" for k, r in zip(
                      names, rels["kernel-order plain"]))
                  + "); a rerun gives the same bits", flush=True)
            del got, again
        del x, dt, a, bm, cm, dy
        torch.cuda.empty_cache()

    samples = [ssd_lanes(torch, 2, 256, 24, 64, 128, 60 + i)
               for i in range(3)]
    xs = torch.stack([t[0] for t in samples])
    as_ = torch.stack([t[2] for t in samples])
    _, dt, _, bm, cm = samples[0]

    def loss(a, x):
        return ops.ssd(x, dt, a, bm, cm, chunk=128).square().sum()
    reset_counts()
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(as_, xs)
    if read_counts() != launch_counts(ssd_scan=1, ssd_scan_bwd=1):
        raise AssertionError(f"vmap(grad) through ops.ssd launched "
                             f"{read_counts()}, want one each way")
    for i in range(3):
        want = torch.func.grad(loss, argnums=(0, 1))(as_[i], xs[i])
        if not (torch.equal(got[0][i], want[0])
                and torch.equal(got[1][i], want[1])):
            raise AssertionError(f"vmap(grad) through ops.ssd: sample {i} "
                                 "differs from its own grad")
    print("vmap(grad) through ops.ssd over 3 samples (each its own a) at "
          "(2, 256, 24, 64, 128): one K4 and one backward launch, bit-equal "
          "to the per-sample gradients", flush=True)
    return err


def earlier_ssd_bwd(torch, stem):
    """An earlier design of K4's backward with commit c5c94b9's C interface and
    scratch (five passes; dS, the heads' dB and dC shares, the chunks' da
    shares) from ``build/<stem>.cu``: ``ssd_scan_bwd_cuda_cores`` (every
    product as float32 FMAs on the CUDA cores) or ``ssd_scan_bwd_pr25``
    (3xTF32 ``mma.sync``, commit c5c94b9), as a function of (x, dt, a, bm,
    cm, dy, chunk, saved) returning the gradients; None when that file is
    absent."""
    import ctypes

    from repro_torch.kernels.ssd_scan import a_group, state_cols
    lib = earlier_kernel(stem)
    if lib is None:
        return None
    fn = lib.ssd_scan_bwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, dt, a, bm, cm, dy, chunk, saved):
        b, s, h, p = x.shape
        n = bm.shape[-1]
        out = [torch.empty_like(t) for t in (x, dt, a, bm, cm)] + [
            torch.empty((b, h, n, p), device="cuda")]
        nc = s // chunk
        work = torch.empty(b * nc * h * p * state_cols(n) + 2 * b * s * h * n
                           + b * nc * h, device="cuda")
        code = fn(*(t.data_ptr() for t in (x, dt, a)), a_group(a, b),
                  *(t.data_ptr() for t in (bm, cm, dy)), None,
                  *(t.data_ptr() for t in (*saved, *out, work)), b, s, h, p,
                  n, chunk, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{stem}: cudaError {code}")
        return out
    return call


# earlier designs of K4's backward timed in turns with this one where
# their source is under build/: (key in the timing row, stem)
SSD_BWD_EARLIER = (("cuda_core_kernel", "ssd_scan_bwd_cuda_cores"),
                   ("pr25_kernel", "ssd_scan_bwd_pr25"))


def time_ssd_bwd(torch, shape):
    """K4's backward at a training shape (no initial state, as the models
    train), on its forward's saved scratch: device ms by CUDA events
    behind the spin kernel; each device kernel's ms by CUDA events around
    that pass launched alone on the scratch of a whole call (the whole
    call rerun before each, ``ssd_scan_bwd_passes``), their sum beside the
    whole call's; its plain version's ms, the bound
    (:func:`ssd_bwd_bound`; no single PyTorch call computes it); the
    earlier designs of ``SSD_BWD_EARLIER`` at hand in turns with this
    one."""
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import (BWD_PASSES, _launch_fwd,
                                              ssd_scan_bwd,
                                              ssd_scan_bwd_passes)
    b, s, h, p, n, chunk = shape
    x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, 6)
    dy = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(7))
    saved = _launch_fwd(x, dt, a, bm, cm, None, chunk)[2:]

    def kernel():
        return ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=chunk, saved=saved)

    counts = read_counts()
    launch = ssd_scan_bwd_passes(x, dt, a, bm, cm, dy, chunk=chunk,
                                 saved=saved)
    passes = {}
    for k, name in enumerate(BWD_PASSES):
        launch(-1)
        passes[name] = time_device(torch, lambda: launch(k), False)
    del launch
    row = dict(shape=[b, s, h, p, n], chunk=chunk,
               ms=time_device(torch, kernel, False),
               plain_ms=time_device(torch, lambda: ssd_scan_bwd_ref(
                   x, dt, a, bm, cm, dy, chunk=chunk), False, iters=5),
               library_ms=None, device_kernels_ms=passes,
               device_kernels_sum_ms=sum(passes.values()),
               **ssd_bwd_bound(b, s, h, p, n, chunk, False))
    for key, stem in SSD_BWD_EARLIER:
        old = earlier_ssd_bwd(torch, stem)
        if old is None:
            continue
        new = kernel()
        err = max(float((u - v).abs().max() / v.abs().max())
                  for u, v in zip(new, old(x, dt, a, bm, cm, dy, chunk,
                                           saved)))
        turns = [time_device(torch, lambda: old(x, dt, a, bm, cm, dy, chunk,
                                                saved), False),
                 time_device(torch, kernel, False),
                 time_device(torch, kernel, False),
                 time_device(torch, lambda: old(x, dt, a, bm, cm, dy, chunk,
                                                saved), False)]
        row[key] = dict(ms=[turns[0], turns[3]], new_ms=turns[1:3],
                        max_rel_diff=err)
    set_counts(counts)
    print(f"ssd_scan_bwd at {row['shape']}: {row['ms']:.4f} ms device ("
          + ", ".join(f"{k.removeprefix('ssd_bwd_')} {v:.4f}"
                      for k, v in passes.items())
          + f" ms, each pass alone by CUDA events, sum "
          f"{row['device_kernels_sum_ms']:.4f}), plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms ("
          f"{row['bound_detail']}; {row['bytes'] / 1e6:.1f} MB, "
          f"{row['flops'] / 1e9:.2f} GFLOP; all float32 on the CUDA cores "
          f"{row['f32_ms']:.4f} ms); no single PyTorch call computes it"
          + "".join(f"; {stem} {row[key]['ms']} ms against "
                    f"{row[key]['new_ms']} in turns"
                    for key, stem in SSD_BWD_EARLIER if key in row),
          flush=True)
    return row


def reduced_step_check(torch, arch):
    """A step of ``arch``'s reduced config on the card against the same
    step on the CPU (same weights, 2 x 256 seeded tokens): K4 and its
    backward launch once per Mamba layer (K5 and its backward once per
    attention layer); the loss within ``SSD_STEP_LOSS_TOL`` and every
    gradient within ``SSD_STEP_GRAD_TOL`` of its leaf's largest |CPU|.
    Returns the largest relative gradient difference."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    mamba = sum(spec.mixer == "mamba" for spec in cfg.layer_specs())
    host = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(host).to("cuda")
    tok = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(1))
    out = []
    for model, device in ((host, "cpu"), (card, "cuda")):
        params = {k: w.detach() for k, w in model.named_parameters()}
        batch = M.Batch(tokens=tok.to(device),
                        labels=tok.roll(-1, 1).to(device))
        counts = read_counts()
        reset_counts()
        grads, loss = torch.func.grad_and_value(
            lambda p, b, model=model: torch.func.functional_call(
                model, p, (b, cfg)))(params, batch)
        launches = read_counts()
        set_counts(counts)
        out.append((grads, float(loss), launches))
    (cpu_g, cpu_loss, _), (gpu_g, gpu_loss, launches) = out
    attn = len(cfg.layer_specs()) - mamba
    want = launch_counts(ssd_scan=mamba, ssd_scan_bwd=mamba,
                         flash_attention_bhsd=attn, flash_attention_bwd=attn)
    if launches != want:
        raise AssertionError(f"{arch} reduced step launched {launches}, "
                             f"want {want}")
    loss_rel = abs(gpu_loss / cpu_loss - 1.0)
    grad_rel = max(float((gpu_g[k].cpu() - g).abs().max())
                   / float(g.abs().max()) for k, g in cpu_g.items())
    print(f"{arch} reduced ({cfg.n_layers} layers, d_model {cfg.d_model}): "
          f"a step on 2 x 256 on the card against the CPU: loss {gpu_loss:.7f}"
          f" / {cpu_loss:.7f} (rel {loss_rel:.3g}), gradients max |d| / max "
          f"|CPU| {grad_rel:.3g}", flush=True)
    if not (loss_rel <= SSD_STEP_LOSS_TOL and grad_rel <= SSD_STEP_GRAD_TOL):
        raise AssertionError(f"{arch} reduced step off the CPU's (loss "
                             f"{loss_rel:.3g}, gradients {grad_rel:.3g})")
    return dict(loss_rel=loss_rel, grad_rel=grad_rel)


def train_ssd_model(torch, arch, layers, b, s):
    """``arch`` at published widths (its first ``layers`` layers, all when
    None), float32, random weights from a seed, at batch ``b`` x ``s``:
    with the counts at 0, ``TRAIN_SGD_STEPS`` SGD steps (``make_train_step``
    over ``functional_call`` of the LM module), K4 and its backward
    launching once per Mamba layer a step (K5 and its backward once per
    attention layer), the losses and the stepped weights finite; the
    step's seconds and peak memory. Returns the launches and a summary."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.fl.round import make_train_step
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    mamba = sum(spec.mixer == "mamba" for spec in cfg.layer_specs())
    attn = len(cfg.layer_specs()) - mamba
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens, labels = make_token_stream(
        torch.Generator(device="cuda").manual_seed(1), b, s, cfg.vocab_size)
    batch = M.Batch(tokens=tokens, labels=labels)
    params = {k: w.detach() for k, w in model.named_parameters()}
    n_params = sum(w.numel() for w in params.values())
    torch.cuda.synchronize()
    print(f"{arch} train: {n_params} parameters ({cfg.n_layers} layers: "
          f"{mamba} Mamba, {attn} attention; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def loss_fn(p, bt):
        return torch.func.functional_call(model, p, (bt, cfg))

    per_step = launch_counts(ssd_scan=mamba, ssd_scan_bwd=mamba,
                             flash_attention_bhsd=attn,
                             flash_attention_bwd=attn)
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
        if {k: after[k] - before[k] for k in after} != per_step:
            raise AssertionError(f"{arch} train: an SGD step launched "
                                 f"{after} - {before}, want {per_step}")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if not (all(math.isfinite(x) for x in losses)
            and all(bool(torch.isfinite(w).all()) for w in params.values())):
        raise AssertionError(f"{arch} train: losses {losses}")
    summary = dict(layers=cfg.n_layers, mamba_layers=mamba,
                   attention_layers=attn, batch=[b, s], params=n_params,
                   sgd_losses=losses, sgd_step_s=secs,
                   step_s=statistics.median(secs[1:]), peak_bytes=peak,
                   launches_per_step=per_step)
    print(f"{arch} train: SGD losses {losses}, step s {secs} (median of the "
          f"last {len(secs) - 1}: {summary['step_s']:.3f}), peak "
          f"{peak / 1e9:.2f} GB; launches {launches}", flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    return launches, summary


def ssd_train_path(torch):
    """Phase 16. Returns the K4-backward check's error, its timing rows
    (mamba's shape, jamba's), the launches by path and the summary."""
    t0 = time.perf_counter()
    err = check_ssd_bwd(torch)
    row = time_ssd_bwd(torch, SSD_SHAPES[-1])
    jamba_row = time_ssd_bwd(torch, JAMBA_SSD)
    torch.cuda.empty_cache()
    launches, summary = {}, {}
    for arch, layers, b, s in SSD_TRAIN:
        check = reduced_step_check(torch, arch)
        launches[f"{arch} train"], summary[arch] = train_ssd_model(
            torch, arch, layers, b, s)
        summary[arch]["reduced_check"] = check
    wall = time.perf_counter() - t0
    print(f"phase 16 took {wall:.1f} s", flush=True)
    return err, dict(row, jamba_shape=jamba_row), launches, dict(
        summary, wall_s=wall)

# ``--ssd-bwd-variants``: variants of csrc/ssd_scan_bwd.cu made by
# replacing text of its chunk pass (pass 3), each timed alone on the
# scratch of a whole call, in turns with the shipped build: one part taken
# out (the ablations PERF.md §6 quotes; their results are wrong), M^T dy
# over every K step (this design's first build) and G's A operand skipped on
# dead row tiles (slower: its branch costs more than it saves)
SSD_BWD_VARIANTS = {
    "no_G_mma": [("        mma3(gt, ln, 0, P,",
                  "        if (0) mma3(gt, ln, 0, P,")],
    "no_G_elementwise": [("              if (s <= t) {\n                // min",
                          "              if (gv == 1.25f) {\n                // min")],
    "no_MTdy": [("    mma3(dxm, sl, sl.row(0), L,",
                 "    if (0) mma3(dxm, sl, sl.row(0), L,")],
    "no_UY_loads": [
        ("*reinterpret_cast<const float2*>(uh + s * xrow + pp);",
         "make_float2(s, pp);"),
        ("*reinterpret_cast<const float2*>(yh + s * xrow + pp);",
         "make_float2(pp, s);")],
    "no_S_dS": [("      for (int e = tid; e < P * NP / 4; e += kThreads) {",
                 "      for (int e = tid; e < 0; e += kThreads) {")],
    "no_tail": [("    if (tid < 32) {\n      constexpr int R = L / 32;",
                 "    if (tid < 0) {\n      constexpr int R = L / 32;")],
    "MTdy_over_all_K": [("    mma3(dxm, sl, sl.row(0), L,",
                         "    mma3(dxm, sl, 0, L,")],
    "G_skip_dead_rows": [(
        "        for (int e = 0; e < 4; ++e)\n"
        "          split(a(ln.row(i) + ln.g + 8 * (e & 1), kk + ln.t + 4 * "
        "(e >> 1)),\n                ah[i][e], al[i][e]);",
        "        for (int e = 0; e < 4; ++e) {\n"
        "          if (live(i, 0, kk)) split(a(ln.row(i) + ln.g + 8 * (e & 1),"
        " kk + ln.t + 4 * (e >> 1)), ah[i][e], al[i][e]);\n"
        "          else ah[i][e] = al[i][e] = 0u;\n        }")],
}


def ssd_bwd_variants(torch):
    """Pass 3 of K4's backward at mamba's and jamba's training shapes:
    the shipped build and each of ``SSD_BWD_VARIANTS`` (built beside it
    under ``build/``) launched alone by CUDA events on the scratch of a
    whole call (shipped, variant, variant, shipped), and the whole call of
    each; with the shipped build's pass at other head groups. Prints a
    JSON line a shape."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import (_bwd_lib, _launch_fwd, a_group,
                                              bwd_head_group,
                                              bwd_work_floats)
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    procs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for name, reps in SSD_BWD_VARIANTS.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise AssertionError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        path = ROOT / "build" / f"ssd_scan_bwd_{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"shipped": _bwd_lib()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out[-2000:]}")
        fn = ctypes.CDLL(str(ROOT / "build" / f"ssd_scan_bwd_{name}.so")
                         ).ssd_scan_bwd_f32
        fn.argtypes, fn.restype = libs["shipped"].argtypes, ctypes.c_int
        libs[name] = fn
    for b, s, h, p, n, chunk in (SSD_SHAPES[-1], JAMBA_SSD):
        x, dt, a, bm, cm = ssd_lanes(torch, b, s, h, p, n, 1)
        dy = torch.randn_like(x)
        saved = _launch_fwd(x, dt, a, bm, cm, None, chunk)[2:]
        outs = [torch.empty_like(t) for t in (x, dt, a, bm, cm)] + [
            torch.empty((b, h, n, p), device="cuda")]

        def call(fn, only, hg):
            code = fn(*(t.data_ptr() for t in (x, dt, a)), a_group(a, b),
                      *(t.data_ptr() for t in (bm, cm, dy)), None,
                      *(t.data_ptr() for t in (*saved, *outs, work)), b, s,
                      h, p, n, chunk, hg, only,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"ssd_scan_bwd variant: cudaError {code}")
        row = dict(shape=[b, s, h, p, n], chunk=chunk)
        hg0 = bwd_head_group(b, s, h, chunk)
        for hg in sorted({1, 2, 4, 8, hg0}):
            if h % hg:
                continue
            work = torch.empty(bwd_work_floats(b, s, h, p, n, chunk, hg=hg),
                               device="cuda")
            call(libs["shipped"], -1, hg)
            row[f"pass 3 at hg {hg}"] = time_device(
                torch, lambda: call(libs["shipped"], 3, hg), False)
        work = torch.empty(bwd_work_floats(b, s, h, p, n, chunk),
                           device="cuda")
        for name in SSD_BWD_VARIANTS:
            call(libs["shipped"], -1, hg0)
            turns = [time_device(torch, lambda: call(fn, 3, hg0), False)
                     for fn in (libs["shipped"], libs[name], libs[name],
                                libs["shipped"])]
            whole = [time_device(torch, lambda: call(fn, -1, hg0), False)
                     for fn in (libs["shipped"], libs[name])]
            row[name] = dict(pass3_ms=turns, whole_ms=whole)
        print(json.dumps({"ssd_bwd_variants": row}), flush=True)
        del x, dt, a, bm, cm, dy, saved, outs, work
        torch.cuda.empty_cache()
    return 0


# ``--flash-bwd-variants``: csrc/flash_attention_bwd.cu with the products
# whose operands are both bfloat16 values left out (with bfloat16 inputs:
# dP = dO_hi V_hi in (b) and (c), and with probs_bf16 dV's dO_hi
# bf16(P)): a wrong gradient, timed only, whose saving bounds what a
# native bfloat16 wgmma for them could save (it would still take about
# half their TF32 time)
FLASH_BWD_VARIANTS = {
    "no_bf16_products": [
        ("(J >= 4 && J < 8 && (Z & kNoBLo))))",
         "(J >= 4 && J < 8 && (Z & kNoBLo)) || (J >= 8 && (Z & 8))))"),
        ("    if constexpr (Z & kHiSmem)\n      WgmmaSS<32, k_step(kk, kRes), "
         "k_step(kk, kStep)>::run(sc, rlo, xhi);\n    else\n      wgmma_rs32",
         "    if constexpr (Z & 8)\n      ;\n    else if constexpr (Z & "
         "kHiSmem)\n      WgmmaSS<32, k_step(kk, kRes), k_step(kk, kStep)>::"
         "run(sc, rlo, xhi);\n    else\n      wgmma_rs32"),
        ("  static constexpr int kDv = (kDo ? kNoALo : 0) | (kPb ? kNoBLo : 0);",
         "  static constexpr int kDv = (kDo ? kNoALo : 0) | (kPb ? kNoBLo : 0)"
         " | (kDo && kPb ? 8 : 0);"),
        ("  static constexpr int kS1b = (kV ? kNoALo | kHiSmem : 0) | (kDo ? "
         "kNoBLo : 0);", "  static constexpr int kS1b = (kV ? kNoALo | "
         "kHiSmem : 0) | (kDo ? kNoBLo : 0) | (kBf ? 8 : 0);"),
        ("  static constexpr int kS1c = (kDo ? kNoALo : 0) | (kV ? kNoBLo : 0);",
         "  static constexpr int kS1c = (kDo ? kNoALo : 0) | (kV ? kNoBLo : 0)"
         " | (kBf ? 8 : 0);")],
}


def flash_bwd_variants(torch):
    """K5's backward at yi-6b's shape with probs_bf16, bfloat16 and float32
    inputs: the shipped build and each of ``FLASH_BWD_VARIANTS`` (built
    beside it under ``build/``), whole calls by CUDA events in turns
    (shipped, variant, variant, shipped), and each pass of the call alone
    for both. Prints a JSON line a case."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (BWD_PASSES, PROBS_BF16,
                                                     _bwd_lib,
                                                     bwd_work_floats,
                                                     flash_attention_bhsd)
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    libs = {"shipped": _bwd_lib()}
    (ROOT / "build").mkdir(exist_ok=True)
    for name, reps in FLASH_BWD_VARIANTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        path = ROOT / "build" / f"flash_attention_bwd_{name}.cu"
        path.write_text(text)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                        f"-I{_build.CSRC}", "-o", str(path.with_suffix(".so")),
                        str(path)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(path.with_suffix(".so"))).flash_attention_bwd
        fn.argtypes, fn.restype = libs["shipped"].argtypes, ctypes.c_int
        libs[name] = fn
    _, bh, sq, sk, d, causal, group, _ = FLASH_MODE_SHAPES[-1]
    lanes = bwd_lanes(torch, bh, sq, sk, d, group, 6)
    for dtype in ("bfloat16", "float32"):
        q, k, v, do = (t.to(getattr(torch, dtype)) for t in lanes)
        o, lse = flash_attention_bhsd(q, k, v, return_lse=True,
                                      kv_group=group, probs_bf16=True)
        work = torch.empty(bwd_work_floats(bh, sq, sk, d, group),
                           device="cuda")
        out = [torch.empty_like(t) for t in (q, k, v)]

        def call(fn, only):
            code = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, *out,
                                               work)),
                      None, bh, group, sq, sk, d,
                      int(dtype == "bfloat16"), bh, int(causal), 0,
                      d ** -0.5, 1, PROBS_BF16, only,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"flash_attention_bwd variant: {code}")
        for name in FLASH_BWD_VARIANTS:
            turns = [time_device(torch, lambda: call(fn, -1), False)
                     for fn in (libs["shipped"], libs[name], libs[name],
                                libs["shipped"])]
            passes = {}
            for key in ("shipped", name):
                call(libs[key], -1)
                passes[key] = {
                    p_: time_device(torch, lambda: call(libs[key], i), False)
                    for i, p_ in enumerate(BWD_PASSES)
                    if p_ not in ("mask", "dead_rows")}
            print(json.dumps({"flash_bwd_variants": dict(
                variant=name, dtype=dtype, shape=[bh, sq, sk, d],
                shipped_ms=[turns[0], turns[3]], variant_ms=turns[1:3],
                passes_ms=passes)}), flush=True)
        del q, k, v, do, o, lse, work, out
        torch.cuda.empty_cache()
    return 0


# Text variants of K5's forward (csrc/flash_attention.cu), timed against
# the shipped build by ``--flash-fwd-variants``: the lse pass with none
# of Q_lo's k steps in registers (all in the shipped build); the lse
# pass with tile i + 1's scores waited before tile i's softmax (no
# overlap); the lse pass's K tiles in the K halves only (2 in flight at
# D = 128, not 4); a kv_valid block left no tile loading Q all the same
FLASH_FWD_VARIANTS = {
    "lse_ql_none": [("constexpr int kLseQlSteps = D / 8;",
                     "constexpr int kLseQlSteps = 0;")],
    "lse_no_overlap": [
        ("    issue_scores<D, kLseQlSteps<D>>(nxt, qh, qlo, ns.tile, ql);\n",
         "    issue_scores<D, kLseQlSteps<D>>(nxt, qh, qlo, ns.tile, ql);\n"
         "    wgmma_wait<0>();\n")],
    "lse_k_halves_only": [
        ("    const int u = i % (2 * kS), s = u % kS;\n"
         "    const bool vh = u >= kS;",
         "    const int u = i % kS, s = u;\n    const bool vh = false;"),
        ("    parity = (i / (2 * kS)) & 1;", "    parity = (i / kS) & 1;"),
        ("    return n / (2 * kS) * kS + min(n % (2 * kS), kS);",
         "    return n;"),
        ("      if ((nk + nv) % (2 * kS) < kS)", "      if (true)")],
    "kv_q_for_empty": [("  if (M == kModeNone || n_tiles > 0) {\n"
                        "    for (int e = wt;",
                        "  {\n    for (int e = wt;")],
}


def flash_fwd_variants(torch):
    """K5 at yi-6b's shape in the masked and probs_bf16 cases of
    ``FLASH_FWD_MODE_TIMES``: the shipped build and each of
    ``FLASH_FWD_VARIANTS`` (built beside it under ``build/``, all at
    once; ptxas's spill lines printed), whole calls by CUDA events in turns
    (shipped, variant, variant, shipped) and whether o is the same bits.
    Prints a JSON line a variant and case."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (PROBS_BF16, _lib,
                                                     flash_attention_bhsd,
                                                     fwd_work_floats)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    (ROOT / "build").mkdir(exist_ok=True)
    procs = {}
    for name, reps in FLASH_FWD_VARIANTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        path = ROOT / "build" / f"flash_attention_{name}.cu"
        path.write_text(text)
        procs[name] = (path, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-o", str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, spills = {"shipped": _lib()}, {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc exited "
                               f"{proc.returncode}\n{log}")
        spills[name] = [line.strip() for line in log.splitlines()
                        if "spill" in line and not line.strip().startswith(
                            "0 bytes stack frame, 0 bytes spill")]
        fn = ctypes.CDLL(str(path.with_suffix(".so"))).flash_attention_fwd
        fn.argtypes, fn.restype = libs["shipped"].argtypes, ctypes.c_int
        libs[name] = fn
    _, bh, sq, sk, d, causal, group, batch = FLASH_MODE_SHAPES[-1]
    q, k, v, _ = bwd_lanes(torch, bh, sq, sk, d, group, 6)
    o = torch.empty_like(q)
    for label, modes, kind in FLASH_FWD_MODE_TIMES:
        if not modes:
            continue
        kv = case_mask(torch, kind, batch, sk, sk)
        kv8 = None if kv is None else kv.to(torch.uint8).contiguous()
        work = torch.empty(fwd_work_floats(bh, sk, d, group,
                                           0 if kv is None else batch),
                           device="cuda")
        pb = "probs_bf16" in modes
        want = flash_attention_bhsd(q, k, v, causal=causal, kv_group=group,
                                    **mode_kw(modes, kv))

        def call(fn):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      None, work.data_ptr(),
                      None if kv8 is None else kv8.data_ptr(), bh, group, sq,
                      sk, d, 0, bh // batch, int(causal), 0, d ** -0.5, 1,
                      PROBS_BF16 if pb else 0,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"flash_attention_fwd variant: {code}")
        for name in FLASH_FWD_VARIANTS:
            call(libs[name])
            same = bool(torch.equal(o, want))
            turns = [time_device(torch, lambda: call(fn), False)
                     for fn in (libs["shipped"], libs[name], libs[name],
                                libs["shipped"])]
            print(json.dumps({"flash_fwd_variants": dict(
                variant=name, case=label, shape=[bh, sq, sk, d],
                shipped_ms=[turns[0], turns[3]], variant_ms=turns[1:3],
                same_bits=same, spills=spills[name])}), flush=True)
        del work
        torch.cuda.empty_cache()
    return 0


# --------------------------------------------------------------------------
# Phase 17 (run right after phase 11): the sharded paths on one rank.
# --------------------------------------------------------------------------

MASSIVE_N = 100_000
MASSIVE_ROUNDS = 60
MASSIVE_MATCH_ROUNDS = 150
# label -> (the sequential run's SimConfig fields, the sharded run's extra
# fields, the kernel launched once a round)
SHARDED_RUNS = {
    "client/cuda_fused": ({}, dict(client_shards=1), "decision_fused"),
    "client/cuda": (dict(solver="cuda"), dict(client_shards=1),
                    "scheduler_solve"),
    "part": ({}, dict(participant_shards=1), "decision_fused"),
    "mesh(1,1)": ({}, dict(client_shards=1, participant_shards=1),
                  "decision_fused"),
    "client/population": (dict(population=POPULATION),
                          dict(client_shards=1), "decision_fused"),
    "part/delta bf16": (dict(aggregation="delta", wire_dtype="bfloat16"),
                        dict(participant_shards=1), "decision_fused"),
}
SYNC_CHECK_ROUNDS = 2


def femnist_event_run(torch, ctx, sim):
    """``run_simulation`` on phase 10's FEMNIST network under cuDNN's
    deterministic algorithms: ``(history, launches, ms a round)``, the ms
    between CUDA events recorded around the run."""
    from repro_torch.fl.simulation import run_simulation

    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    hist = deterministic(torch, lambda: run_simulation(
        None, ctx["params"], ctx["ds"], sim, ctx["scfg"], ctx["ch"],
        ctx["sig"], keep_selection=True))
    end.record()
    torch.cuda.synchronize()
    return hist, read_counts(), start.elapsed_time(end) / sim.rounds


def rounds_sync_free(torch, ctx, sim):
    """Run ``SYNC_CHECK_ROUNDS`` rounds of ``sim`` (no evaluation) under
    ``torch.cuda.set_sync_debug_mode("error")``: None, or the error an
    implicit host synchronisation raised."""
    from repro_torch.fl.engine import (default_draws, init_carry,
                                       make_sim_round)

    draws = default_draws(sim, ctx["ds"])
    sim_round = make_sim_round(ctx["ds"], sim, ctx["scfg"], ctx["ch"],
                               ctx["sig"])
    params, pol_state, carry, *_ = init_carry(
        draws, ctx["params"], ctx["scfg"], sim, ctx["sig"], ctx["ch"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r in range(SYNC_CHECK_ROUNDS):
            params, pol_state, carry, *_ = sim_round(params, pol_state,
                                                     carry, draws, r)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return None


def massive_runs(torch):
    """The scheduling-only runner at ``examples/massive_n.py``'s size (N =
    100,000, lam = 0.3, 60 rounds), proposed and M-matched uniform under
    ``cuda_fused``, sequential and ``client_shards=1``: n_sel, t_comm and
    power bit for bit; K2 once a proposed round; rounds/s of each."""
    import numpy as np

    from repro_torch.examples.massive_n import configs
    from repro_torch.fl.client_shard import make_schedule_runner
    from repro_torch.fl.engine import GeneratorDraws
    from repro_torch.fl.simulation import match_uniform_m

    scfg, ch, sig = configs(MASSIVE_N, "cuda")
    t0 = time.perf_counter()
    m = match_uniform_m(torch.Generator(device="cuda").manual_seed(1), sig,
                        scfg, ch, rounds=MASSIVE_MATCH_ROUNDS)
    match_s = time.perf_counter() - t0
    draws = GeneratorDraws(0, MASSIVE_N, (1, 1, 1), 1, device="cuda")
    out, k2 = {}, 0
    for policy in ("proposed", "uniform"):
        for shards in (0, 1):
            runner = make_schedule_runner(
                sig, scfg, ch, rounds=MASSIVE_ROUNDS, policy=policy,
                m_avg=m, solver="cuda_fused", client_shards=shards)
            [x.cpu() for x in runner(draws)]          # warm
            reset_counts()
            t0 = time.perf_counter()
            got = [x.cpu().numpy() for x in runner(draws)]
            wall = time.perf_counter() - t0
            counts = read_counts()
            want = launch_counts(decision_fused=(
                MASSIVE_ROUNDS if policy == "proposed" else 0))
            if counts != want:
                raise AssertionError(f"massive {policy} shards={shards} "
                                     f"launched {counts}, want {want}")
            k2 += counts["decision_fused"]
            if not (np.isfinite(got[0]).all() and (got[2] >= 1).all()):
                raise AssertionError(f"massive {policy}: bad trajectory")
            out[(policy, shards)] = dict(
                t_comm=got[0], power=got[1], n_sel=got[2],
                rounds_per_s=MASSIVE_ROUNDS / wall)
        seq, shd = out[(policy, 0)], out[(policy, 1)]
        for k in ("n_sel", "t_comm", "power"):
            if not np.array_equal(seq[k], shd[k]):
                raise AssertionError(f"massive {policy}: client_shards=1 "
                                     f"differs from sequential in {k}")
        print(f"massive N = {MASSIVE_N} {policy}: sequential "
              f"{seq['rounds_per_s']:.1f} rounds/s, client_shards=1 "
              f"{shd['rounds_per_s']:.1f} rounds/s, mean participants "
              f"{seq['n_sel'].mean():.1f}; bit for bit", flush=True)
    ratio = float(out[("proposed", 0)]["t_comm"].sum()
                  / out[("uniform", 0)]["t_comm"].sum())
    print(f"massive N: proposed/uniform comm-time ratio {ratio:.3f} over "
          f"{MASSIVE_ROUNDS} rounds (M = {m:.1f}, matched in "
          f"{match_s:.1f} s)", flush=True)
    summary = dict(
        n=MASSIVE_N, rounds=MASSIVE_ROUNDS, uniform_m=m, ratio=ratio,
        rounds_per_s={f"{p}/{'sharded' if d else 'sequential'}":
                      o["rounds_per_s"] for (p, d), o in out.items()},
        mean_selected={p: float(out[(p, 0)]["n_sel"].mean())
                       for p in ("proposed", "uniform")})
    return k2, summary


def sharded_path(torch, ctx):
    """Phase 17: a world-size-1 NCCL group through
    ``launch.distributed.initialize`` (a ``file://`` store under
    ``build/``); phase 10's FEMNIST network (N = 3,597, the CNN, 5 rounds)
    through each sharded path against its sequential run bit for bit,
    one K2 (or K1) launch a round; the rounds under the sync-debug mode;
    the massive-N runner."""
    import os

    import numpy as np
    import torch.distributed as dist

    from repro_torch.launch.distributed import initialize

    t0 = time.perf_counter()
    store = ROOT / "build" / f"dist_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    initialize(f"file://{store}", 1, 0, 0, device="cuda")
    backend = dist.get_backend()
    try:
        print(f"phase 17: {backend} group of "
              f"{dist.get_world_size()} rank on "
              f"{torch.cuda.get_device_name(0)}", flush=True)
        runs, launches = {}, {"scheduler_solve": 0, "decision_fused": 0}
        keys = ("round", "comm_time", "test_acc", "avg_power", "n_selected",
                "selected", "q")
        for label, (fields, shards, kernel) in SHARDED_RUNS.items():
            seq_sim = dataclasses.replace(ctx["sim"], **fields)
            one = {}
            for side, sim in (("sequential", seq_sim),
                              ("sharded", dataclasses.replace(seq_sim,
                                                              **shards))):
                hist, counts, ms = femnist_event_run(torch, ctx, sim)
                check_history(f"phase 17 {label} {side}", hist)
                if counts != launch_counts(**{kernel: ROUNDS}):
                    raise AssertionError(f"phase 17 {label} {side} launched "
                                         f"{counts}, want {kernel} {ROUNDS}")
                launches[kernel] += counts[kernel]
                one[side] = (hist, ms)
            (seq, seq_ms), (shd, shd_ms) = one["sequential"], one["sharded"]
            extra = ("active",) if "population" in fields else ()
            for k in keys + extra:
                if not np.array_equal(seq[k], shd[k]):
                    raise AssertionError(f"phase 17 {label}: the sharded "
                                         f"run differs from the sequential "
                                         f"one in {k}")
            runs[label] = dict(sharded_ms_per_round=shd_ms,
                               sequential_ms_per_round=seq_ms,
                               comm_time=shd["comm_time"].tolist(),
                               test_acc=shd["test_acc"].tolist(),
                               n_selected=shd["n_selected"].tolist())
            print(f"phase 17 FEMNIST {label}: bit for bit the sequential "
                  f"run, {kernel} {ROUNDS} launches each; {shd_ms:.2f} ms a "
                  f"round sharded, {seq_ms:.2f} sequential (CUDA events)",
                  flush=True)
        sync = {}
        for label in ("mesh(1,1)", "client/population"):
            fields, shards, _ = SHARDED_RUNS[label]
            seq_sim = dataclasses.replace(ctx["sim"], **fields)
            sync[label] = {
                side: rounds_sync_free(torch, ctx, sim) for side, sim in (
                    ("sequential", seq_sim),
                    ("sharded", dataclasses.replace(seq_sim, **shards)))}
            if sync[label]["sharded"] and not sync[label]["sequential"]:
                raise AssertionError(f"phase 17 {label}: the sharded rounds "
                                     f"synchronise with the host: "
                                     f"{sync[label]['sharded']}")
        print(f"phase 17 host synchronisations in {SYNC_CHECK_ROUNDS} "
              f"rounds (None: none): {sync}", flush=True)
        k2_massive, massive = massive_runs(torch)
        launches["decision_fused"] += k2_massive
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    print(f"phase 17 took {wall:.1f} s", flush=True)
    summary = dict(card=card_line(), world_size=1, backend=backend,
                   n_clients=ctx["ds"].n_clients, rounds=ROUNDS,
                   femnist=runs, sync_debug=sync, massive=massive,
                   launches=launches, wall_s=wall)
    return {"sharded": launches}, summary


# --------------------------------------------------------------------------
# Phase 18: launch planning (ROADMAP item 11): K5's kv_valid and
# probs_bf16 modes, the port's remat, attn_probs_bf16 in a model, the dry
# run.
# --------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12
# (call, BH, Sq, Sk, D, causal, kv_group, batch) of K5's mode checks: a
# small causal GQA call, a non-causal ragged one (Sq > Sk is refused only
# with a window), and yi-6b's forward shape (batch 4 x 32 heads on 4 KV
# heads), the one timed
FLASH_MODE_SHAPES = (
    ("small causal", 8, 200, 200, 64, True, 2, 2),
    ("small non-causal ragged", 6, 77, 150, 32, False, 3, 2),
    ("yi-6b self", 128, 2048, 2048, 128, True, 8, 4))
# kv_valid against its plain version: the float32 tolerances of the
# unmasked calls (FLASH_TOL, FLASH_BWD_TOL). probs_bf16: the kernel rounds
# where the plain version (the reference) rounds (the normalised p after
# an lse pass, dP, dv; delta the sum of P bf16(dP)), from float32 values
# that differ by float32 noise, so a rounding lands apart only at a tie,
# one bfloat16 ulp of that term. Those ties bound the largest |d|: o
# within FLASH_PB_TOL x max |v| plus the float32 tolerance, each gradient
# within FLASH_PB_BWD_TOL of its largest |plain| entry. Ties are rare, so
# the control: the kernel's distance to the plain version (the Frobenius
# norm of the difference) at most FLASH_PB_CONTROL of the distance from
# the plain version without the mode (float32 p and v) to it, forward and
# each gradient; a kernel that skipped the roundings, or rounded p before
# normalising it, would sit about as far from the plain version as float32
# does (ratio near 1) and fail.
FLASH_PB_TOL = 2.0 ** -8
FLASH_PB_BWD_TOL = 2.0 ** -6
FLASH_PB_CONTROL = 0.25
FLASH_MODES = (("kv_valid",), ("probs_bf16",), ("kv_valid", "probs_bf16"))
# the checks of each shape: (modes, mask, input type), the mask phase 18's
# right padding (kv_mask) or a left padding (left_pad_mask), bfloat16
# inputs with probs_bf16 as the reference runs it (--attn-bf16, with
# param_dtype bfloat16)
FLASH_MODE_CASES = (
    (("kv_valid",), "right", "float32"), (("kv_valid",), "left", "float32"),
    (("probs_bf16",), None, "float32"), (("probs_bf16",), None, "bfloat16"),
    (("kv_valid", "probs_bf16"), "right", "float32"),
    (("kv_valid", "probs_bf16"), "left", "bfloat16"))


def kv_mask(torch, batch, sk, seed):
    """A (batch, Sk) key mask: each row but the last with its last 0-511
    keys dead (right padding, at least one key live), row 0 also every
    third key, and the last row with no live key."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    kv = torch.ones((batch, sk), dtype=torch.bool)
    for b in range(batch - 1):
        dead = int(torch.randint(0, min(512, sk - 1), (1,), generator=g))
        kv[b, sk - dead:] = False
    kv[0, 2::3] = False
    kv[-1] = False
    return kv.cuda()


def left_pad_mask(torch, batch, sk, seed):
    """A (batch, Sk) key mask as batched prompts padded on the left leave
    it: each row's first 0-511 keys dead (at least one key live)."""
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    kv = torch.ones((batch, sk), dtype=torch.bool)
    for b in range(batch):
        kv[b, :int(torch.randint(0, min(512, sk - 1), (1,), generator=g))] = (
            False)
    return kv.cuda()


def case_mask(torch, kind, batch, sk, seed):
    """The mask of a check or timing case: None, ``right`` (:func:`kv_mask`)
    or ``left`` (:func:`left_pad_mask`)."""
    if kind is None:
        return None
    return (kv_mask if kind == "right" else left_pad_mask)(torch, batch, sk,
                                                           seed)


def case_tag(modes, kind, dtype):
    return "+".join(modes) + (f", {kind} padding" if kind else "") + (
        f", {dtype}" if dtype != "float32" else "")


def mode_kw(modes, kv):
    return dict(kv_valid=kv if "kv_valid" in modes else None,
                probs_bf16="probs_bf16" in modes)


def pb_control(got, want, float32):
    """||got - want|| / ||float32 - want||: how far the kernel sits from
    the plain version in probs_bf16 mode, against how far the plain
    version without the mode sits from it."""
    return float((got - want).float().norm()) / float(
        (float32 - want).float().norm())


def check_flash_modes(torch):
    """K5 and its backward in the kv_valid and probs_bf16 modes and both,
    against their plain versions at ``FLASH_MODE_SHAPES`` in each of
    ``FLASH_MODE_CASES``: o, lse (+inf on exactly the rows with no live
    key), the same bits (o and lse) with the masked tiles run (the
    forward's skips of dead blocks and tiles, the backward's of dead rows,
    keys and words included), and dq, dk, dv on the kernel's o
    and lse; with probs_bf16 the control (FLASH_PB_CONTROL) on o and each
    gradient. Returns the largest |d| by kernel and mode (the modes of one
    check joined by +; and by kernel, mode, mask and input type) and the
    largest control ratios by kernel."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref, flash_lse_ref)
    err, ratios = {}, {}
    for call, bh, sq, sk, d, causal, group, batch in FLASH_MODE_SHAPES:
        lanes = bwd_lanes(torch, bh, sq, sk, d, group, sq + sk + d)
        for modes, kind, dtype in FLASH_MODE_CASES:
            q, k, v, do = (t.to(getattr(torch, dtype)) for t in lanes)
            kv = case_mask(torch, kind, batch, sk, sk)
            bf16 = dtype == "bfloat16"
            kw = dict(causal=causal, kv_group=group, **mode_kw(modes, kv))
            tag = (f"{call} {(bh, sq, sk, d)} kv_group={group} "
                   f"{case_tag(modes, kind, dtype)}")
            o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
            every = flash_attention_bhsd(q, k, v, skip_tiles=False,
                                         return_lse=True, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            kw_lse = dict(kw)
            kw_lse.pop("probs_bf16")
            want_lse = flash_lse_ref(q, k, **kw_lse)
            torch.cuda.synchronize()
            pb = "probs_bf16" in modes
            tol = FLASH_TOL[bf16] + (FLASH_PB_TOL * float(v.abs().max())
                                     if pb else 0.0)
            e = compare(torch, f"flash_attention_bhsd {tag}", o, want, 0.0,
                        tol)
            ctl = []
            if pb:
                ctl.append(pb_control(o, want, flash_attention_ref(
                    q, k, v, **dict(kw, probs_bf16=False))))
            if not (torch.equal(o, every[0]) and torch.equal(lse, every[1])):
                raise AssertionError(f"{tag}: running the masked tiles "
                                     "changed o or lse")
            dead = torch.isinf(want_lse)
            if not (torch.equal(torch.isinf(lse), dead)
                    and torch.isfinite(o).all()):
                raise AssertionError(f"{tag}: lse is +inf off the rows with "
                                     "no live key, or o is not finite")
            lse_d = float((lse[~dead] - want_lse[~dead]).abs().max())
            if lse_d > 1e-4:
                raise AssertionError(f"{tag}: lse off by {lse_d:.3g}")
            got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
            again = flash_attention_bwd(q, k, v, o, do, skip_tiles=False,
                                        **kw)
            gwant = flash_attention_bwd_ref(q, k, v, o, do, lse=lse, **kw)
            torch.cuda.synchronize()
            rels = []
            for name, g_, w_ in zip(("dq", "dk", "dv"), got, gwant):
                rels.append(float((g_ - w_).float().abs().max())
                            / float(w_.float().abs().max()))
                limit = FLASH_PB_BWD_TOL if pb else FLASH_BWD_TOL
                if not (torch.isfinite(g_).all() and rels[-1] <= limit):
                    raise AssertionError(f"{tag}: {name} off its plain "
                                         f"version by {rels[-1]:.3g} of "
                                         f"max |plain| (limit {limit:.3g})")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{tag}: the backward with the masked "
                                     "steps run changed the result")
            if pb:
                f32 = flash_attention_bwd_ref(q, k, v, o, do, lse=lse,
                                              **dict(kw, probs_bf16=False))
                ctl += [pb_control(g_, w_, f_)
                        for g_, w_, f_ in zip(got, gwant, f32)]
                del f32
                if max(ctl) > FLASH_PB_CONTROL:
                    raise AssertionError(
                        f"{tag}: the kernel is as far from its plain version "
                        f"as float32 is (o, dq, dk, dv: "
                        f"{', '.join(f'{c:.3g}' for c in ctl)}; limit "
                        f"{FLASH_PB_CONTROL})")
                for name, c in zip(("flash_attention_bhsd",
                                    "flash_attention_bwd"),
                                   (ctl[0], max(ctl[1:]))):
                    ratios[name] = max(ratios.get(name, 0.0), c)
            key = "+".join(modes)
            errs = {"flash_attention_bhsd": e,
                    "flash_attention_bwd": max(
                        float((g_ - w_).float().abs().max())
                        for g_, w_ in zip(got, gwant))}
            for name, x in errs.items():
                for k_ in ((name, key), (name, key, kind, dtype)):
                    err[k_] = max(err.get(k_, 0.0), x)
            print(f"{tag}: K5 agrees with its plain version (max |d| {e:.3g}"
                  f", tolerance {tol:.3g}; {int(dead.sum())} rows with no "
                  f"live key, lse +inf there); its backward too (dq, dk, dv "
                  f"max |d| / max |plain| {', '.join(f'{r:.3g}' for r in rels)}"
                  "); the masked tiles and steps run give the same bits"
                  + (f"; |kernel - plain| / |float32 - plain| (o, dq, dk, dv)"
                     f" {', '.join(f'{c:.3g}' for c in ctl)}" if pb else ""),
                  flush=True)
            del o, lse, every, want, want_lse, got, again, gwant, q, k, v, do
        del lanes
        torch.cuda.empty_cache()
    return err, ratios


def mode_live_pairs(torch, sq, sk, causal, kv, heads):
    """The (q, k) pairs this mask leaves live, summed over BH = batch x
    ``heads`` row-blocks: the causal pairs of each batch row's live keys."""
    from repro_torch.kernels.ref import flash_mask
    band = flash_mask(sq, sk, causal, None, "cuda")
    return heads * int(sum(int((band & row[None]).sum()) for row in kv))


def flash_mode_bound(bh, sq, sk, d, live, itemsize, kv_group, batch, modes,
                     backward):
    """The least time of K5 (or its backward) in ``modes`` on this run's
    inputs: ``live`` pairs (the mask's), bytes as flash_bound (plus the
    mask's), and the products, 2 D operations a live pair each: q . k and
    p v (in the backward q . k, dO V^T, P^T dO, dS K and dS^T q). Each
    product runs as few TF32 products as its operands' lo parts need (1 +
    one per operand with a lo part, of hi = tf32(x), lo = tf32(x - hi)),
    or as one bfloat16 product at the bfloat16 rate where both operands
    are bfloat16 values: q scale, dS and a float32 input or P have a lo
    part; a bfloat16 input, bf16(v) and bf16(p) (probs_bf16) none."""
    pb = "probs_bf16" in modes
    bf16_in = itemsize == 2
    lo = dict(q=True, k=not bf16_in, v=not (bf16_in or pb),
              do=not bf16_in, p=not pb, ds=True)
    pairs = ([("q", "k"), ("do", "v"), ("p", "do"), ("ds", "k"),
              ("ds", "q")] if backward else [("q", "k"), ("p", "v")])
    tf32_products = sum(1 + lo[a] + lo[b] for a, b in pairs
                        if lo[a] or lo[b])
    bf16_products = sum(1 for a, b in pairs if not (lo[a] or lo[b]))
    n_bytes = itemsize * d * ((4 if backward else 2) * bh * sq
                              + (4 if backward else 2) * (bh // kv_group)
                              * sk)
    if "kv_valid" in modes:
        n_bytes += batch * sk
    elementwise = live * (4 if backward else 3) + (0 if backward
                                                   else 2 * bh * sq * d)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_tc = live * 2 * d * (tf32_products / TF32_OPS_PER_S
                           + bf16_products / BF16_OPS_PER_S) * 1e3
    t_cuda = elementwise / F32_OPS_PER_S * 1e3
    t = max(t_bytes, t_tc, t_cuda)
    return dict(bound_ms=t, bound_by="bytes" if t == t_bytes
                else "operations", bytes=n_bytes,
                flops=live * 2 * d * len(pairs) + elementwise,
                live_pairs=live, tf32_products=tf32_products,
                bf16_products=bf16_products)


def flash_pass_ms(torch, fn, calls=10):
    """Device ms per call of each device kernel that ``fn``'s K5 (or
    backward) call launches, keyed by its name and template arguments
    (``flash_attention_kernel<128, float, 1>``: D, type, build), from
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        hit = re.search(r"(flash_\w+|pack_kv_bits)(<[^>]*>)?", e.key)
        if hit and e.self_device_time_total > 0:
            out[hit.group(0)] = (out.get(hit.group(0), 0.0)
                                 + e.self_device_time_total / 1e3 / calls)
    return out


def flash_mode_kernels(torch):
    """:func:`flash_pass_ms` of K5 at yi-6b's forward shape on
    :func:`time_flash_modes`'s inputs: each case of
    ``FLASH_FWD_MODE_TIMES``, and (``all_live``) kv_valid with a mask
    that leaves every key live; {label: ms by kernel} (the backward's
    passes are timed alone by CUDA events, :func:`bwd_pass_ms`)."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    _, bh, sq, sk, d, causal, group, batch = FLASH_MODE_SHAPES[-1]
    q, k, v, _ = bwd_lanes(torch, bh, sq, sk, d, group, 6)
    live = torch.ones((batch, sk), dtype=torch.bool, device="cuda")
    cases = [(label, mode_kw(modes, case_mask(torch, kind, batch, sk, sk)))
             for label, modes, kind in FLASH_FWD_MODE_TIMES]
    out = {}
    for name, kw in cases + [("all_live", dict(kv_valid=live))]:
        kw = dict(kw, causal=causal, kv_group=group)
        out[name] = flash_pass_ms(torch, lambda: flash_attention_bhsd(
            q, k, v, **kw))
    return out


def bwd_pass_ms(torch, q, k, v, o, do, lse, **kw):
    """Device ms of each pass of K5's backward (``BWD_PASSES``; the mask's
    two only with kv_valid), each launched alone by CUDA events on the
    scratch of a whole call (``flash_attention_bwd_passes``)."""
    from repro_torch.kernels.flash_attention import (
        BWD_PASSES, flash_attention_bwd_passes)
    launch = flash_attention_bwd_passes(q, k, v, o, do, lse=lse, **kw)
    passes = {}
    for i, name in enumerate(BWD_PASSES):
        if kw.get("kv_valid") is None and name in ("mask", "dead_rows"):
            continue
        launch(-1)
        passes[name] = time_device(torch, lambda: launch(i), False)
    return passes


def fresh_flash_mode_kernels():
    """:func:`flash_mode_kernels` in a child process started for it: late
    in this run a profiler session reads K5's kernels low or not at all
    (as :func:`fresh_ssd_pass_ms` found for K4's), a fresh process's first
    session does not."""
    code = ("import json, sys, torch; sys.path.insert(0, 'src'); "
            "import chip_smoke as c; "
            "print(json.dumps(c.flash_mode_kernels(torch)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def mask_build_probe(torch, q, k, v, do, group, batch, split):
    """What kv_valid's code costs a call that has no mask: the unmasked
    call against the same call with a mask that leaves every key live (the
    same function; K5 and its backward run their kv_valid builds there,
    template M, where the unmasked call runs build 0), timed in turns
    (unmasked, all-live, all-live, unmasked), each one's device kernels
    (K5's from ``split``, :func:`fresh_flash_mode_kernels`; the backward's
    passes alone, :func:`bwd_pass_ms`), and whether the two give the same
    bits."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    live = torch.ones((batch, k.shape[1]), dtype=torch.bool, device="cuda")
    kw = dict(causal=True, kv_group=group)
    with torch.no_grad():
        o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    calls = {
        "fwd": (lambda: flash_attention_bhsd(q, k, v, **kw),
                lambda: flash_attention_bhsd(q, k, v, kv_valid=live, **kw)),
        "bwd": (lambda: flash_attention_bwd(q, k, v, o, do, lse=lse, **kw),
                lambda: flash_attention_bwd(q, k, v, o, do, lse=lse,
                                            kv_valid=live, **kw))}
    out = {}
    for name, (plain_fn, live_fn) in calls.items():
        u1 = time_device(torch, plain_fn, False)
        a1 = time_device(torch, live_fn, False)
        a2 = time_device(torch, live_fn, False)
        u2 = time_device(torch, plain_fn, False)
        a, b = plain_fn(), live_fn()
        same = (torch.equal(a, b) if name == "fwd"
                else all(torch.equal(x, y) for x, y in zip(a, b)))
        if name == "fwd":
            kernels = split["unmasked"], split["all_live"]
        else:
            kernels = (bwd_pass_ms(torch, q, k, v, o, do, lse, **kw),
                       bwd_pass_ms(torch, q, k, v, o, do, lse, kv_valid=live,
                                   **kw))
        out[name] = dict(unmasked_ms=[u1, u2], all_live_ms=[a1, a2],
                         same_bits=bool(same), kernels_unmasked=kernels[0],
                         kernels_all_live=kernels[1])
        print(f"K5{' backward' if name == 'bwd' else ''} unmasked against "
              f"an all-live kv_valid mask, in turns: "
              f"{u1:.4f} / {a1:.4f} / {a2:.4f} / {u2:.4f} ms, same bits "
              f"{same}; kernels {out[name]['kernels_unmasked']} against "
              f"{out[name]['kernels_all_live']}", flush=True)
    del o, lse
    return out


# The K5 backward of commit f6a42b7 (a delta pass, products on zero lo
# parts, no mask skip) with a gate on each launch, so that a pass runs
# alone (``set_only``; -1 for the whole call): its source, with that
# commit's attention_modes.cuh and hopper.cuh beside it, in
# build/bwd_f6a42b7/, put there by hand (git show f6a42b7:<csrc file>)
EARLIER_BWD_SPLIT = (
    ("using namespace hopper;\n", "using namespace hopper;\n\nint g_only = -1;"
     "  // the pass launched alone, -1 for all\n"),
    ("    err = modes::launch_pack(kv, s.bits, bh / hq, sk, stream);",
     "    err = g_only < 0 || g_only == 0\n"
     "              ? modes::launch_pack(kv, s.bits, bh / hq, sk, stream)\n"
     "              : cudaSuccess;"),
    ("    flash_bwd_dead_rows<T><<<",
     "    if (g_only < 0 || g_only == 1) flash_bwd_dead_rows<T><<<"),
    ("  flash_bwd_prepare<D, T><<<",
     "  if (g_only < 0 || g_only == 2) flash_bwd_prepare<D, T><<<"),
    ("  dkdv<<<", "  if (g_only < 0 || g_only == 3) dkdv<<<"),
    ("  dqk<<<", "  if (g_only < 0 || g_only == 4) dqk<<<"),
    ("    dd<<<", "    if (g_only < 0 || g_only == 5) dd<<<"))
EARLIER_BWD_PASSES = ("mask", "dead_rows", "prepare", "dkdv", "dq", "delta")


def earlier_flash_bwd(torch):
    """The earlier K5 backward (``EARLIER_BWD_SPLIT``) as ``make(q, k, v,
    o, do, lse, kv, probs_bf16, causal, group)`` returning
    ``launch(only)``, which runs the whole call (-1) or pass ``only`` of
    ``EARLIER_BWD_PASSES`` alone into outputs of its own and returns them;
    None when build/bwd_f6a42b7/ holds no source."""
    import ctypes

    from repro_torch.kernels.flash_attention import (PROBS_BF16,
                                                     bwd_work_floats)
    src = ROOT / "build" / "bwd_f6a42b7" / "flash_attention_bwd.cu"
    if not src.is_file():
        return None
    text = src.read_text()
    for old, new in EARLIER_BWD_SPLIT:
        if text.count(old) != 1:
            raise AssertionError(f"f6a42b7 split: {old!r} not found once")
        text = text.replace(old, new)
    text += 'extern "C" void set_only(int only) { g_only = only; }\n'
    src.with_name("flash_attention_bwd_split.cu").write_text(text)
    lib = earlier_kernel("bwd_f6a42b7/flash_attention_bwd_split")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.set_only.argtypes = [ctypes.c_int]

    def make(q, k, v, o, do, lse, kv, pb, causal, group):
        bh, sq, d = q.shape
        sk = k.shape[1]
        out = [torch.empty_like(t) for t in (q, k, v)]
        kv8 = None if kv is None else kv.to(torch.uint8).contiguous()
        work = torch.empty(bwd_work_floats(
            bh, sq, sk, d, group, 0 if kv is None else kv.shape[0]),
            device="cuda")

        def launch(only):
            lib.set_only(only)
            code = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, *out,
                                               work)),
                      None if kv8 is None else kv8.data_ptr(), bh, group, sq,
                      sk, d, int(q.dtype == torch.bfloat16),
                      bh // (1 if kv8 is None else kv8.shape[0]),
                      int(causal), 0, d ** -0.5, 1,
                      PROBS_BF16 if pb else 0,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"f6a42b7 flash_attention_bwd: {code}")
            return out
        return launch
    return make


# K5's forward timed at yi-6b's shape in phase 18: (label, modes, mask);
# the unmasked call (the build without the modes) stands beside the
# earlier design's to show that build unchanged
FLASH_FWD_MODE_TIMES = (
    ("unmasked", (), None),
    ("kv_valid", ("kv_valid",), "right"),
    ("kv_valid, left padding", ("kv_valid",), "left"),
    ("probs_bf16", ("probs_bf16",), None),
    ("kv_valid+probs_bf16", ("kv_valid", "probs_bf16"), "right"))


def earlier_flash_fwd(torch):
    """The K5 forward of commit 3a1a54f (every tile of the band run under
    a kv_valid mask, probs_bf16's lse pass one score tile at a time), from
    build/fwd_3a1a54f/flash_attention.cu with that commit's
    attention_modes.cuh and hopper.cuh beside it, put there by hand (git
    show 3a1a54f:<csrc file>), as ``make(q, k, v, kv, probs_bf16, causal,
    group)`` returning ``launch()``, which runs the whole call into
    outputs of its own and returns (o, lse); None when that source is
    absent."""
    import ctypes

    from repro_torch.kernels.flash_attention import (PROBS_BF16,
                                                     fwd_work_floats)
    if not (ROOT / "build" / "fwd_3a1a54f" / "flash_attention.cu").is_file():
        return None
    fn = earlier_kernel("fwd_3a1a54f/flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def make(q, k, v, kv, pb, causal, group):
        bh, sq, d = q.shape
        sk = k.shape[1]
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device="cuda")
        kv8 = None if kv is None else kv.to(torch.uint8).contiguous()
        # this design's scratch, which holds the earlier one's
        work = torch.empty(fwd_work_floats(
            bh, sk, d, group, 0 if kv is None else kv.shape[0]),
            device="cuda")

        def launch():
            code = fn(*(t.data_ptr() for t in (q, k, v, o, lse, work)),
                      None if kv8 is None else kv8.data_ptr(), bh, group, sq,
                      sk, d, int(q.dtype == torch.bfloat16),
                      bh // (1 if kv8 is None else kv8.shape[0]),
                      int(causal), 0, d ** -0.5, 1, PROBS_BF16 if pb else 0,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"3a1a54f flash_attention_fwd: {code}")
            return o, lse
        return launch
    return make


def two_pass_floor(live, d):
    """The least time of a probs_bf16 forward that rounds the normalised
    p, so needs every row's lse before its first P.V and computes q . k
    twice: 2 D operations a live pair a product, q . k twice in 3xTF32
    (6 TF32 products) and P.V once, as one bfloat16 product
    (``bf16_pv``) or one TF32 product, as this kernel runs it
    (``tf32_pv``); ms. :func:`flash_mode_bound` (q . k once) stays the
    function's bound."""
    ops = live * 2 * d
    return dict(bf16_pv=ops * (6 / TF32_OPS_PER_S + 1 / BF16_OPS_PER_S) * 1e3,
                tf32_pv=ops * 7 / TF32_OPS_PER_S * 1e3)


def time_flash_fwd_modes(torch, lanes, split):
    """K5 at yi-6b's shape in each of ``FLASH_FWD_MODE_TIMES`` on
    ``lanes`` (q, k, v float32): device ms by CUDA events, its device
    kernels from ``split`` (:func:`fresh_flash_mode_kernels`), its plain
    version's ms, the bound on this run's mask (:func:`flash_mode_bound`;
    with probs_bf16 also :func:`two_pass_floor`), with kv_valid the
    library's call on the same inputs (:func:`sdpa_mask_calls`), and
    where build/fwd_3a1a54f/ holds the earlier design
    (:func:`earlier_flash_fwd`), that design in turns (earlier, this,
    this, earlier), whether o and lse are its bits and o's largest
    |difference|. It fails where they are not its bits, but for o with
    probs_bf16: there P.V is a bfloat16 product summing 16 exact
    products a tensor-core step, where the earlier design's TF32 product
    summed 8. Returns {label: row}."""
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.ref import flash_attention_ref, flash_mask
    _, bh, sq, sk, d, causal, group, batch = FLASH_MODE_SHAPES[-1]
    q, k, v, do = lanes
    old = earlier_flash_fwd(torch)
    rows = {}
    for label, modes, kind in FLASH_FWD_MODE_TIMES:
        kv = case_mask(torch, kind, batch, sk, sk)
        kw = dict(causal=causal, kv_group=group, **mode_kw(modes, kv))

        def kernel():
            return flash_attention_bhsd(q, k, v, **kw)

        counts = read_counts()
        live = (mode_live_pairs(torch, sq, sk, causal, kv, bh // batch)
                if kv is not None else
                bh * int(flash_mask(sq, sk, causal, None, "cpu").sum()))
        row = dict(label=label, modes=list(modes), mask=kind,
                   dtype="float32", shape=[bh, sq, sk, d], kv_group=group,
                   ms=time_device(torch, kernel, False),
                   kernels=split[label],
                   plain_ms=time_device(torch, lambda: flash_attention_ref(
                       q, k, v, **kw), False, iters=3),
                   library_ms=None,
                   **flash_mode_bound(bh, sq, sk, d, live, 4, group, batch,
                                      modes, False))
        if "probs_bf16" in modes:
            row["two_pass_floor_ms"] = two_pass_floor(live, d)
        if kv is not None:
            row["library_ms"] = sdpa_mask_calls(torch, q, k, v, do, kv, group,
                                                batch)[0]
        if old is not None:
            run = old(q, k, v, kv, "probs_bf16" in modes, causal, group)
            was = [t.clone() for t in run()]
            now = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
            turns = [time_device(torch, run, False),
                     time_device(torch, kernel, False),
                     time_device(torch, kernel, False),
                     time_device(torch, run, False)]
            same = [bool(torch.equal(a, b)) for a, b in zip(now, was)]
            row["earlier"] = dict(
                ms=[turns[0], turns[3]], new_ms=turns[1:3], same_bits=same,
                o_max_abs_diff=float((now[0] - was[0]).abs().max()))
            if not (all(same) or ("probs_bf16" in modes and same[1])):
                raise AssertionError(
                    f"flash_attention_bhsd ({label}): o, lse differ from "
                    f"the earlier design's ({same})")
            del run, was, now
        set_counts(counts)
        print(f"flash_attention_bhsd ({label}) at {row['shape']} ("
              f"{row['live_pairs']} live pairs): {row['ms']:.4f} ms device ("
              + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in split[label].items())
              + f" ms, a fresh process's profiler), plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
              + (f", two-pass floor {row['two_pass_floor_ms']}"
                 if "two_pass_floor_ms" in row else "")
              + (f"; the earlier design {row['earlier']['ms']} ms against "
                 f"{row['earlier']['new_ms']} in turns, o and lse its bits "
                 f"{row['earlier']['same_bits']} (o max |d| "
                 f"{row['earlier']['o_max_abs_diff']:.3g})"
                 if "earlier" in row else ""),
              flush=True)
        rows[label] = row
        torch.cuda.empty_cache()
    return rows


# K5's backward timed at yi-6b's shape in phase 18: (label, modes, mask,
# input type); the unmasked call (the build without the modes) stands
# beside the earlier design's to show that build unchanged
FLASH_BWD_MODE_TIMES = (
    ("unmasked", (), None, "float32"),
    ("kv_valid", ("kv_valid",), "right", "float32"),
    ("kv_valid, left padding", ("kv_valid",), "left", "float32"),
    ("probs_bf16", ("probs_bf16",), None, "float32"),
    ("probs_bf16, bfloat16", ("probs_bf16",), None, "bfloat16"))


def sdpa_mask_calls(torch, q, k, v, do, kv, group, batch):
    """``scaled_dot_product_attention`` with the causal band and ``kv`` as
    its boolean mask (KV expanded outside the timing, memory-efficient
    backend), as (forward, backward) device ms; a batch row with no live
    key is made live (SDPA gives NaN on it), rows that see no live key
    (left padding) stay (their NaN costs no time)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.ref import flash_mask
    bh, sq, d = q.shape
    live_kv = kv.clone()
    for b in range(batch):
        if not bool(live_kv[b].any()):
            live_kv[b] = kv[0]
    mask = (flash_mask(sq, k.shape[1], True, None, "cuda")[None, None]
            & live_kv[:, None, None, :])
    ql, kl, vl = (t.view(batch, -1, t.shape[1], d).detach().requires_grad_()
                  for t in (q, k.repeat_interleave(group, 0),
                            v.repeat_interleave(group, 0)))

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask)

    with torch.no_grad():
        fwd = time_device(torch, library, False)
    with torch.enable_grad():
        out = library()
    dol = do.view(out.shape)
    bwd = time_device(torch, lambda: torch.autograd.grad(
        out, (ql, kl, vl), dol, retain_graph=True), False)
    return fwd, bwd


def time_flash_bwd_modes(torch, lanes):
    """K5's backward at yi-6b's shape in each of ``FLASH_BWD_MODE_TIMES``
    on ``lanes`` (q, k, v, dO float32, cast for a bfloat16 case): device
    ms by CUDA events; each pass launched alone by CUDA events on the
    scratch of a whole call (``flash_attention_bwd_passes``), their sum
    beside the call's; its plain version's ms; the bound on this run's
    mask (:func:`flash_mode_bound`); with kv_valid autograd through SDPA
    (:func:`sdpa_mask_calls`); and where build/bwd_f6a42b7/ holds the
    earlier design (:func:`earlier_flash_bwd`), that design in turns
    (earlier, this, this, earlier), its passes alone, and each gradient's largest difference from
    this one over its largest |entry| (and whether the bits are equal).
    Returns {label: row}."""
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_mask
    _, bh, sq, sk, d, causal, group, batch = FLASH_MODE_SHAPES[-1]
    old = earlier_flash_bwd(torch)
    rows = {}
    for label, modes, kind, dtype in FLASH_BWD_MODE_TIMES:
        q, k, v, do = (t.to(getattr(torch, dtype)) for t in lanes)
        kv = case_mask(torch, kind, batch, sk, sk)
        kw = dict(causal=causal, kv_group=group, **mode_kw(modes, kv))
        counts = read_counts()
        with torch.no_grad():
            o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)

        def kernel():
            return flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)

        passes = bwd_pass_ms(torch, q, k, v, o, do, lse, **kw)
        live = (mode_live_pairs(torch, sq, sk, causal, kv, bh // batch)
                if kv is not None else
                bh * int(flash_mask(sq, sk, causal, None, "cpu").sum()))
        row = dict(label=label, modes=list(modes), mask=kind, dtype=dtype,
                   shape=[bh, sq, sk, d], kv_group=group,
                   ms=time_device(torch, kernel, False), passes_ms=passes,
                   passes_sum_ms=sum(passes.values()),
                   plain_ms=time_device(torch, lambda: flash_attention_bwd_ref(
                       q, k, v, o, do, lse=lse, **kw), False, iters=3),
                   library_ms=None,
                   **flash_mode_bound(bh, sq, sk, d, live, q.element_size(),
                                      group, batch, modes, True))
        if kv is not None:
            row["library_fwd_ms"], row["library_ms"] = sdpa_mask_calls(
                torch, q, k, v, do, kv, group, batch)
        if old is not None:
            run = old(q, k, v, o, do, lse, kv, "probs_bf16" in modes, causal,
                      group)
            new = kernel()
            was = [t.clone() for t in run(-1)]
            turns = [time_device(torch, lambda: run(-1), False),
                     time_device(torch, kernel, False),
                     time_device(torch, kernel, False),
                     time_device(torch, lambda: run(-1), False)]
            old_passes = {}
            for i, name in enumerate(EARLIER_BWD_PASSES):
                if ((kv is None and name in ("mask", "dead_rows"))
                        or (name == "delta" and "probs_bf16" not in modes)):
                    continue
                run(-1)
                old_passes[name] = time_device(torch, lambda: run(i), False)
            row["earlier"] = dict(
                ms=[turns[0], turns[3]], new_ms=turns[1:3],
                passes_ms=old_passes,
                max_rel_diff=[float((a - b).float().abs().max())
                              / float(b.float().abs().max())
                              for a, b in zip(new, was)],
                same_bits=[bool(torch.equal(a, b)) for a, b in zip(new, was)])
            del run, new, was
        set_counts(counts)
        print(f"flash_attention_bwd ({label}) at {row['shape']} ("
              f"{row['live_pairs']} live pairs): {row['ms']:.4f} ms device ("
              + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in passes.items())
              + f" ms, each pass alone by CUDA events, sum "
              f"{row['passes_sum_ms']:.4f}), plain {row['plain_ms']:.3f} ms, "
              f"library {row['library_ms']} ms, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}; {row['tf32_products']} TF32 + "
              f"{row['bf16_products']} bfloat16 products a live pair)"
              + (f"; the earlier design {row['earlier']['ms']} ms against "
                 f"{row['earlier']['new_ms']} in turns, its passes "
                 f"{row['earlier']['passes_ms']}, gradients' max |d| / max "
                 f"| | {row['earlier']['max_rel_diff']}, same bits "
                 f"{row['earlier']['same_bits']}" if "earlier" in row
                 else ""),
              flush=True)
        rows[label] = row
        del o, lse, q, k, v, do
        torch.cuda.empty_cache()
    return rows


def time_flash_modes(torch):
    """K5 and its backward in each mode at yi-6b's shape: the forward's
    rows (:func:`time_flash_fwd_modes`, each call split into its device
    kernels by :func:`fresh_flash_mode_kernels`) and the backward's
    (:func:`time_flash_bwd_modes`). Returns {(kernel, label): row} of the
    mode rows, each with its ``mode``; the rows of the builds without a
    mode and of both modes at once, by name; and
    :func:`mask_build_probe`'s record."""
    call, bh, sq, sk, d, causal, group, batch = FLASH_MODE_SHAPES[-1]
    q, k, v, do = bwd_lanes(torch, bh, sq, sk, d, group, 6)
    torch.cuda.empty_cache()  # room on the card for the split's process
    split = fresh_flash_mode_kernels()
    fwd = time_flash_fwd_modes(torch, (q, k, v, do), split)
    bwd = time_flash_bwd_modes(torch, (q, k, v, do))
    rows, others = {}, {}
    for name, table in (("flash_attention_bhsd", fwd),
                        ("flash_attention_bwd", bwd)):
        for label, row in table.items():
            if len(row["modes"]) == 1:
                rows[(name, label)] = dict(row, mode=row["modes"][0])
            else:
                others[f"{name} ({label})"] = row
    build = mask_build_probe(torch, q, k, v, do, group, batch, split)
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows, others, build


# yi-6b's first 4 of 32 layers and mamba2-130m whole, at batch 4 x 2048,
# float32, TRAIN_SGD_STEPS SGD steps with remat_layers off and on from the
# same weights; then yi-6b's first 8 layers with it on (off, that depth
# needs about twice the 4-layer step's memory)
REMAT_RUNS = (("yi-6b", 4), ("mamba2-130m", None))
REMAT_DEEP = ("yi-6b", 8)
# remat on against off: the same kernels and cuBLAS products on the same
# inputs in the same order, so the same bits where the algorithms are
# deterministic (cuDNN's deterministic mode on; no atomics in K4 or K5);
# else within these of the losses' and the stepped weights' largest
# |off| entry (float32 noise of one step at gamma 1e-3)
REMAT_LOSS_TOL, REMAT_PARAM_TOL = 1e-6, 1e-6
# attn_probs_bf16 against float32 probabilities on yi-6b's 4 layers: p and
# v rounded to bfloat16 (2^-9 each) move each attention output by at most
# 2^-8 of max |v|; the loss within 2^-8 of itself, each gradient leaf
# within 2^-5 of its largest |float32| entry (a few such roundings
# through 4 layers and their backward)
PB_LOSS_TOL, PB_GRAD_TOL = 2.0 ** -8, 2.0 ** -5
# the kv_valid mode through apply_attention on one of those layers'
# mixers, against the same call through the plain _grouped_attention on
# the batch's first sequence (the plain path's scores of 4 sequences are
# 2 GB a head group): float32 sums in other orders
KV_MODEL_TOL = 1e-4
DRYRUN_ARGS = ("--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
               "both", "--debug-mesh")


def mode_counts():
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    return {(fn.__name__, m): n for fn in (flash_attention_bhsd,
                                           flash_attention_bwd)
            for m, n in fn.mode_launches.items()}


def reset_mode_counts():
    from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                     flash_attention_bwd)
    for fn in (flash_attention_bhsd, flash_attention_bwd):
        fn.mode_launches = dict.fromkeys(fn.mode_launches, 0)


def sgd_run(torch, cfg, model, batch, params, remat):
    """``TRAIN_SGD_STEPS`` SGD steps with ``remat_layers`` set to
    ``remat``: the stepped weights, losses, step seconds, peak bytes and
    each step's launches (all equal, else it raises)."""
    from repro_torch.fl.round import make_train_step
    c = dataclasses.replace(cfg, remat_layers=remat)

    def loss_fn(p, b):
        return torch.func.functional_call(model, p, (b, c))

    step = make_train_step(loss_fn, TRAIN_GAMMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per = [], [], []
    for _ in range(TRAIN_SGD_STEPS):
        before = read_counts()
        t = time.perf_counter()
        params, loss = deterministic(torch, lambda: step(params, batch))
        losses.append(float(loss))
        secs.append(time.perf_counter() - t)
        after = read_counts()
        per.append({k: after[k] - before[k] for k in after
                    if after[k] != before[k]})
    if any(p != per[0] for p in per):
        raise AssertionError(f"{cfg.name} remat={remat}: steps launched {per}")
    return params, losses, secs, torch.cuda.max_memory_allocated(), per[0]


def remat_model(torch, arch, layers):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models import model as M
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens, labels = make_token_stream(
        torch.Generator(device="cuda").manual_seed(1), LM_BATCH, LM_SEQ,
        cfg.vocab_size)
    return cfg, model, M.Batch(tokens=tokens, labels=labels)


def remat_pair(torch, arch, layers):
    """(b): the same SGD steps with remat off and on from one set of
    weights: launches a step (the forward's kernels twice a layer with
    remat, the backwards once), losses and stepped weights equal (bit for
    bit, else within REMAT_*_TOL), step seconds and peak bytes each."""
    cfg, model, batch = remat_model(torch, arch, layers)
    mamba = sum(s.mixer == "mamba" for s in cfg.layer_specs())
    attn = cfg.n_layers - mamba
    fwd = dict(ssd_scan=mamba, flash_attention_bhsd=attn)
    bwd = dict(ssd_scan_bwd=mamba, flash_attention_bwd=attn)
    runs = {}
    for remat in (False, True):
        params = {k: w.detach().clone() for k, w in model.named_parameters()}
        out = sgd_run(torch, cfg, model, batch, params, remat)
        want = {k: v for k, v in {**{k: (2 if remat else 1) * n
                                     for k, n in fwd.items()},
                                  **bwd}.items() if v}
        if out[4] != want:
            raise AssertionError(f"{arch} remat={remat}: a step launched "
                                 f"{out[4]}, want {want}")
        runs[remat] = out
        del params
        torch.cuda.empty_cache()
    (p0, l0, s0, m0, _), (p1, l1, s1, m1, _) = runs[False], runs[True]
    bitwise = l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    param_rel = max(float((p0[k] - p1[k]).abs().max())
                    / float(p0[k].abs().max()) for k in p0)
    if not (bitwise or (loss_rel <= REMAT_LOSS_TOL
                        and param_rel <= REMAT_PARAM_TOL)):
        raise AssertionError(f"{arch}: remat on against off, losses {l1} / "
                             f"{l0}, weights off by {param_rel:.3g}")
    out = dict(layers=cfg.n_layers, batch=[LM_BATCH, LM_SEQ],
               launches_per_step={"off": runs[False][4],
                                  "on": runs[True][4]},
               losses={"off": l0, "on": l1}, bitwise=bitwise,
               loss_rel=loss_rel, param_rel=param_rel,
               step_s={"off": statistics.median(s0[1:]),
                       "on": statistics.median(s1[1:])},
               sgd_step_s={"off": s0, "on": s1},
               peak_gb={"off": m0 / 1e9, "on": m1 / 1e9})
    print(f"{arch} ({cfg.n_layers} layers, {LM_BATCH} x {LM_SEQ}) remat off "
          f"/ on: step {out['step_s']['off']:.3f} / {out['step_s']['on']:.3f}"
          f" s, peak {out['peak_gb']['off']:.2f} / {out['peak_gb']['on']:.2f}"
          f" GB, launches a step {out['launches_per_step']}; losses "
          f"{'bit for bit' if bitwise else f'within {loss_rel:.3g}'}, "
          f"weights after {TRAIN_SGD_STEPS} steps "
          f"{'bit for bit' if bitwise else f'within {param_rel:.3g}'}",
          flush=True)
    del runs, p0, p1
    torch.cuda.empty_cache()
    return cfg, model, batch, out


def probs_bf16_step(torch, cfg, model, batch):
    """(c): yi-6b's forward and one SGD step with ``attn_probs_bf16``
    against the same without it, from the same weights: K5 and its
    backward in their probs_bf16 mode once a layer; loss and gradients
    within PB_LOSS_TOL / PB_GRAD_TOL."""
    from repro_torch.models import model as M
    pb_cfg = dataclasses.replace(cfg, attn_probs_bf16=True)
    # a model's modules keep the config they were built with: the same
    # weights drawn again under the flag
    pb_model = M.init_params(torch.Generator(device="cuda").manual_seed(0),
                             pb_cfg)
    params = {k: w.detach() for k, w in model.named_parameters()}
    if not all(torch.equal(w, params[k])
               for k, w in pb_model.named_parameters()):
        raise AssertionError("attn_probs_bf16: the redrawn weights differ")
    res = {}
    for name, c, mod in (("float32", cfg, model),
                         ("probs_bf16", pb_cfg, pb_model)):
        def loss_fn(p, b, c=c, mod=mod):
            return torch.func.functional_call(mod, p, (b, c))
        before = mode_counts()
        t = time.perf_counter()
        grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = mode_counts()
        res[name] = (grads, float(loss), secs,
                     {k: after[k] - before[k] for k in after
                      if after[k] != before[k]})
    (g0, l0, t0, _), (g1, l1, t1, modes) = res["float32"], res["probs_bf16"]
    want = {("flash_attention_bhsd", "probs_bf16"): cfg.n_layers,
            ("flash_attention_bwd", "probs_bf16"): cfg.n_layers}
    if modes != want:
        raise AssertionError(f"attn_probs_bf16: mode launches {modes}, "
                             f"want {want}")
    loss_rel = abs(l1 - l0) / abs(l0)
    grad_rel = max(float((g1[k] - g0[k]).abs().max())
                   / float(g0[k].abs().max()) for k in g0)
    if not (math.isfinite(l1) and loss_rel <= PB_LOSS_TOL
            and grad_rel <= PB_GRAD_TOL):
        raise AssertionError(f"attn_probs_bf16: loss {l1} / {l0}, "
                             f"gradients off by {grad_rel:.3g}")
    del pb_model
    print(f"yi-6b ({cfg.n_layers} layers) attn_probs_bf16: loss {l1:.7f} "
          f"against {l0:.7f} (rel {loss_rel:.3g}), gradients max |d| / max "
          f"|float32| {grad_rel:.3g}; step {t1:.3f} s against {t0:.3f}",
          flush=True)
    return dict(loss={"float32": l0, "probs_bf16": l1}, loss_rel=loss_rel,
                grad_rel=grad_rel, grad_step_s={"float32": t0,
                                                "probs_bf16": t1})


def kv_valid_call(torch, cfg, model):
    """The kv_valid mode as a model calls it: ``apply_attention`` of layer
    0's mixer on its normed input with a right-padding mask (a row with no
    live key), its gradient in x by ``torch.func.grad``, against the same
    call through the plain ``_grouped_attention`` on the first sequence."""
    from repro_torch.models import attention as attn
    mixer = model.layers[0].mixer
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), generator=g,
                    device="cuda")
    kv = kv_mask(torch, LM_BATCH, LM_SEQ, 5)

    def out_sq(x, kv):
        return attn.apply_attention(mixer, x, cfg, kv_valid=kv).square().sum()

    with torch.no_grad():
        y = attn.apply_attention(mixer, x, cfg, kv_valid=kv)
    gx = torch.func.grad(out_sq)(x, kv)
    flash = attn._flash_attention
    attn._flash_attention = attn._grouped_attention
    try:
        with torch.no_grad():
            y0 = attn.apply_attention(mixer, x[:1], cfg, kv_valid=kv[:1])
        g0 = torch.func.grad(out_sq)(x[:1], kv[:1])
    finally:
        attn._flash_attention = flash
    rel = max(float((y[:1] - y0).abs().max()) / float(y0.abs().max()),
              float((gx[:1] - g0).abs().max()) / float(g0.abs().max()))
    if not (torch.isfinite(y).all() and torch.isfinite(gx).all()
            and rel <= KV_MODEL_TOL):
        raise AssertionError(f"apply_attention with kv_valid: off the plain "
                             f"call by {rel:.3g}")
    print(f"apply_attention with kv_valid at {LM_BATCH} x {LM_SEQ} (yi-6b "
          f"layer 0): output and gradient within {rel:.3g} of the plain "
          f"grouped attention", flush=True)
    return rel


def tally_agrees():
    """The package's copy of the kernels' operation counts (the dry run's
    tally) against this script's bounds at the checked shapes."""
    from repro_torch.kernels import tally
    for _, bh, sq, sk, d, causal, group, window in FLASH_BWD_SHAPES:
        if tally.flash_flops(bh, sq, sk, d, causal, window) != flash_bound(
                bh, sq, sk, d, causal, window, 4, group)["flops"]:
            raise AssertionError("tally.flash_flops differs from flash_bound")
        if tally.flash_bwd_flops(bh, sq, sk, d, causal, window) != (
                flash_bwd_bound(bh, sq, sk, d, causal, window, 4,
                                group)["flops"]):
            raise AssertionError("tally.flash_bwd_flops differs")
    for b, s, h, p, n, chunk in SSD_BWD_SHAPES:
        s = -(-s // chunk) * chunk
        if tally.ssd_flops(b, s, h, p, n, chunk) != ssd_bound(
                b, s, h, p, n, chunk, False)["flops"]:
            raise AssertionError("tally.ssd_flops differs from ssd_bound")
        if tally.ssd_bwd_flops(b, s, h, p, n, chunk) != ssd_bwd_bound(
                b, s, h, p, n, chunk, False)["flops"]:
            raise AssertionError("tally.ssd_bwd_flops differs")


def dry_run():
    """(d): the dry run as its own process on a fake group of 8 ranks:
    exit 0 and an OK record for each debug mesh."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_DRYRUN_DEVICES="8")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *DRYRUN_ARGS], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    secs = time.perf_counter() - t
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    if out.returncode != 0 or len(recs) != 2 or any(
            r["status"] != "OK" for r in recs):
        raise AssertionError(f"dry run: exit {out.returncode}\n{out.stdout}"
                             f"\n{out.stderr[-4000:]}")
    print(f"dry run {' '.join(DRYRUN_ARGS)}: exit 0 in {secs:.1f} s, "
          + "; ".join(f"{r['mesh']} OK, {r['flops']:.4g} FLOP, "
                      f"{r['argument_size_in_bytes']} argument bytes a "
                      "device" for r in recs), flush=True)
    return dict(args=list(DRYRUN_ARGS), seconds=secs,
                records=[{k: r[k] for k in (
                    "mesh", "status", "flops", "argument_size_in_bytes",
                    "output_size_in_bytes", "n_devices")} for r in recs])


def launch_path(torch):
    """Phase 18. K5's modes checked and timed (kernel launches not
    counted); then, counts at 0, the path: remat off and on (yi-6b 4
    layers, mamba2-130m whole), attn_probs_bf16 and a kv_valid call on
    yi-6b's model, yi-6b at 8 layers with remat; the dry run. Returns the
    mode checks' errors, their timing rows, the path's launches and mode
    launches, and the summary."""
    t0 = time.perf_counter()
    tally_agrees()
    err, ratios = check_flash_modes(torch)
    rows, others, build = time_flash_modes(torch)
    torch.cuda.empty_cache()
    reset_counts()
    reset_mode_counts()
    summary = {"probs_bf16_control": ratios, "mask_build_probe": build,
               **others}
    for arch, layers in REMAT_RUNS:
        cfg, model, batch, out = remat_pair(torch, arch, layers)
        summary[arch] = out
        if arch == "yi-6b":
            summary["attn_probs_bf16"] = probs_bf16_step(torch, cfg, model,
                                                         batch)
            summary["kv_valid_call"] = dict(rel=kv_valid_call(torch, cfg,
                                                              model))
        del model, batch
        torch.cuda.empty_cache()
    arch, layers = REMAT_DEEP
    cfg, model, batch = remat_model(torch, arch, layers)
    params = {k: w.detach() for k, w in model.named_parameters()}
    _, losses, secs, peak, per = sgd_run(torch, cfg, model, batch, params,
                                         True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} {layers} layers with remat: {losses}")
    summary[f"{arch} {layers} layers remat"] = dict(
        losses=losses, sgd_step_s=secs, step_s=statistics.median(secs[1:]),
        peak_gb=peak / 1e9, launches_per_step=per)
    print(f"{arch} ({layers} layers, {LM_BATCH} x {LM_SEQ}) with remat: step "
          f"{statistics.median(secs[1:]):.3f} s, peak {peak / 1e9:.2f} GB, "
          f"losses {losses}", flush=True)
    del model, batch, params
    torch.cuda.empty_cache()
    launches, modes = read_counts(), mode_counts()
    summary["dry_run"] = dry_run()
    wall = time.perf_counter() - t0
    summary["wall_s"] = wall
    print(f"phase 18 took {wall:.1f} s", flush=True)
    return err, rows, launches, modes, summary


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
    if "--ssd-bwd-variants" in sys.argv[1:]:
        print(card_line(), flush=True)
        return ssd_bwd_variants(torch)
    if "--flash-bwd-variants" in sys.argv[1:]:
        print(card_line(), flush=True)
        return flash_bwd_variants(torch)
    if "--flash-fwd-variants" in sys.argv[1:]:
        print(card_line(), flush=True)
        return flash_fwd_variants(torch)
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
    for name in ("decision_fused", "ssd_scan", "ssd_scan_bwd",
                 "flash_attention", "flash_attention_bwd"):
        check_no_spills(name, logs.get(name, ""))

    ch, scfg = CONFIG.channel(), CONFIG.scheduler(lam=10.0)
    co = decision_coeffs(scfg, ch)
    ops = pack_decision_operands(co.solve, co.acct)
    err = check_kernels(torch, scfg, ch, ops)
    err["decision_fused_batched"] = check_batched(torch)
    # phase 7's K1-K3 timings run here, next to their checks and before
    # phase 6 runs torch.profiler in this process
    times = timings(torch, scfg, ch, ops)
    err["ssd_scan"] = check_ssd(torch)
    err["flash_attention_bhsd"] = check_flash(torch)
    launches, _, cifar_ctx = main_path(torch)
    cifar_loop = cifar_ctx["loop"]
    by_path = {"cifar10": dict(launches),
               "cifar10 loop": {k: cifar_ctx["loop_launches"][k]
                                for k in launches}}
    more, femnist, femnist_ctx = femnist_path(torch)
    by_path.update(more)
    more, scenarios = scenarios_path(torch, cifar_ctx, femnist_ctx)
    by_path.update(more)
    more, sharded = sharded_path(torch, femnist_ctx)
    by_path.update(more)
    del femnist_ctx
    torch.cuda.empty_cache()
    for name in launches:
        launches[name] = sum(p[name] for p in by_path.values())
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
    torch.cuda.empty_cache()
    err["ssd_scan_bwd"], ssd_bwd_time, ssd_train_launches, ssd_train = (
        ssd_train_path(torch))
    torch.cuda.empty_cache()
    mode_err, mode_rows, launch18, modes18, launch_summary = launch_path(
        torch)
    for path in ("transformer_lm FL", "transformer_lm FL loop"):
        by_path[path] = {k: train_launches[path][k]
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
    ssd_by_path.update({path: dict(launches=c["ssd_scan"])
                        for path, c in ssd_train_launches.items()})
    ssd_bwd_by_path = {path: c["ssd_scan_bwd"]
                       for path, c in ssd_train_launches.items()}
    # phase 18's path: remat off and on, attn_probs_bf16, a kv_valid call,
    # yi-6b at 8 layers with remat
    flash_by_path["launch planning"] = dict(
        launches=launch18["flash_attention_bhsd"])
    bwd_by_path["launch planning"] = launch18["flash_attention_bwd"]
    ssd_by_path["launch planning"] = dict(launches=launch18["ssd_scan"])
    ssd_bwd_by_path["launch planning"] = launch18["ssd_scan_bwd"]

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
    rows.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:72",
        "backward_of": "ssd_scan",
        "launches": sum(ssd_bwd_by_path.values()),
        "launches_by_path": ssd_bwd_by_path,
        "launches_per_train_step": {
            arch: ssd_train[arch]["mamba_layers"] for arch, *_ in SSD_TRAIN},
        "max_abs_err": err["ssd_scan_bwd"], **ssd_bwd_time})
    for (name, label), row in mode_rows.items():
        mode = row["mode"]
        if not modes18[(name, mode)]:
            raise AssertionError(f"{name} ({mode}) was not launched on "
                                 "phase 18's path")
        # a row of another mask or input type than the mode's first: that
        # case's error
        case = (name, mode, row.get("mask"), row.get("dtype"))
        rows.append({
            "name": f"{name} ({label})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + (
                "flash_attention.cu" if name == "flash_attention_bhsd"
                else "flash_attention_bwd.cu"),
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "mode": mode, "launches": modes18[(name, mode)],
            "max_abs_err": mode_err[case if label != mode else (name, mode)],
            "max_abs_err_kv_valid+probs_bf16": mode_err[
                (name, "kv_valid+probs_bf16")],
            **({"control_ratio": launch_summary["probs_bf16_control"][name]}
               if mode == "probs_bf16" else {}),
            "shape": list(FLASH_MODE_SHAPES[-1][1:5]),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "live_pairs")},
            **{k: row[k] for k in ("passes_ms", "kernels", "earlier",
                                   "two_pass_floor_ms", "dtype", "mask")
               if k in row}})
    print(json.dumps({"service": dict(svc_summary, profile=svc_profile)}),
          flush=True)
    print(json.dumps({"telemetry": telemetry}), flush=True)
    print(json.dumps({"cifar10": {"loop_engine": cifar_loop}}), flush=True)
    print(json.dumps({"femnist": femnist}), flush=True)
    print(json.dumps({"scenarios": scenarios}), flush=True)
    print(json.dumps({"sharded": sharded}), flush=True)
    print(json.dumps({"mamba": mamba}), flush=True)
    print(json.dumps({"yi": yi}), flush=True)
    print(json.dumps({"zoo": zoo}), flush=True)
    print(json.dumps({"moe": moe_zoo}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"mamba_train": ssd_train}), flush=True)
    print(json.dumps({"launch": dict(
        launch_summary, card=card,
        kernel_modes={f"{n} ({m})": r for (n, m), r in mode_rows.items()},
        mode_launches={f"{n} ({m})": c for (n, m), c in modes18.items()})}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
