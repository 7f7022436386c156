"""The steps K5's backward runs with a kv_valid mask, on the CPU:
``kernels/flash_attention.py::bwd_work_plan``, the twin of
``csrc/flash_attention_bwd.cu``'s ``kv_work`` and ``q_work`` (each batch
row's first and last live key from the ``kv_bounds`` pass, dead blocks,
key tiles whose packed word is 0), on seeded random masks: right and left
padding, both, holes, a batch row with no live key, all live; causal or
not, with and without a window.

* every (block, step) pair the plan leaves out is all-false in
  ``kernels/ref.py::full_mask``: no step with a live pair is skipped;
* where each batch row's live keys are contiguous (padding), a (c) block
  none of whose rows sees a live key runs no step, and a (b) block with
  no live key never runs;
* ``skip=False`` runs every step, a batch row with no live key runs none,
  and ``kv_bounds`` is each row's first and last live key.

The kernel's bits with and without the skips are held equal on the card
(``tests/test_torch_cuda.py::test_flash_attention_modes_match_plain``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (BWD_STEP, BWD_TILE,
                                                 bwd_work_plan, kv_bounds)
from repro_torch.kernels.ref import full_mask

BH, GROUP, BATCH = 8, 2, 2
# (Sq, Sk, causal, window); window 34 puts the edges mask's last row that
# sees key 127 (row 160) on a tile's first row
GEOMETRY = [(200, 200, True, None), (200, 200, True, 40),
            (200, 200, True, 34), (77, 150, False, None),
            (77, 150, False, 40)]
CONTIGUOUS = ["right", "left", "both", "dead", "live", "edges"]


def make_mask(kind, sk, seed):
    """A seeded (BATCH, Sk) mask: ``right`` / ``left`` / ``both``
    padding of up to Sk / 2 keys a row, ``holes`` (keys live with
    probability 0.7 and a dead run of 40), ``dead`` (row 0 padded on the
    right, row 1 with no live key), ``live`` (every key), ``edges``
    (first and last live keys on the first key of a 32-key tile: keys 0
    to 64 and 64 to 128)."""
    rng = np.random.default_rng(seed)
    kv = np.ones((BATCH, sk), bool)
    for b in range(BATCH):
        left, right = rng.integers(1, sk // 2, size=2)
        if kind in ("left", "both"):
            kv[b, :left] = False
        if kind in ("right", "both", "dead"):
            kv[b, sk - right:] = False
    if kind == "holes":
        kv = rng.random((BATCH, sk)) < 0.7
        kv[:, sk // 3:sk // 3 + 40] = False
    if kind == "dead":
        kv[1] = False
    if kind == "edges":
        kv[:] = False
        kv[0, :65] = True
        kv[1, 64:129] = True
    return torch.from_numpy(kv)


def skipped(plan, sq, sk):
    """Each (block, step) the plan leaves out, as index ranges of the
    (head, query row, key) mask."""
    dkdv, dq = plan
    n_q, n_k = -(-sq // BWD_STEP), -(-sk // BWD_STEP)
    for (kvh, k0), tiles in dkdv.items():
        for h in range(kvh * GROUP, (kvh + 1) * GROUP):
            for t in range(n_q):
                if t not in tiles:
                    yield (h, slice(t * BWD_STEP, (t + 1) * BWD_STEP),
                           slice(k0, k0 + BWD_TILE))
    for (h, q0), tiles in dq.items():
        for t in range(n_k):
            if t not in tiles:
                yield (h, slice(q0, q0 + BWD_TILE),
                       slice(t * BWD_STEP, (t + 1) * BWD_STEP))


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
@pytest.mark.parametrize("kind", CONTIGUOUS + ["holes"])
def test_no_live_step_is_skipped(kind, sq, sk, causal, window):
    kv = make_mask(kind, sk, seed=sq + sk)
    mask = full_mask(BH, sq, sk, causal, window, kv, "cpu")
    plan = bwd_work_plan(BH, sq, sk, GROUP, causal, window, kv)
    for h, rows, keys in skipped(plan, sq, sk):
        assert not bool(mask[h, rows, keys].any()), (h, rows, keys)
    dkdv, dq = plan
    n_q, n_k = -(-sq // BWD_STEP), -(-sk // BWD_STEP)
    assert all(0 <= r.start <= r.stop <= n_q for r in dkdv.values())
    assert all(0 <= t < n_k for tiles in dq.values() for t in tiles)


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
@pytest.mark.parametrize("kind", CONTIGUOUS)
def test_dead_blocks_run_nothing(kind, sq, sk, causal, window):
    kv = make_mask(kind, sk, seed=sq + sk)
    mask = full_mask(BH, sq, sk, causal, window, kv, "cpu")
    dkdv, dq = bwd_work_plan(BH, sq, sk, GROUP, causal, window, kv)
    hq = BH // BATCH
    for (kvh, k0), tiles in dkdv.items():
        if not bool(kv[kvh * GROUP // hq, k0:k0 + BWD_TILE].any()):
            assert len(tiles) == 0, (kvh, k0)
    for (h, q0), tiles in dq.items():
        if not bool(mask[h, q0:q0 + BWD_TILE].any()):
            assert tiles == [], (h, q0)


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
def test_skip_false_runs_every_step(sq, sk, causal, window):
    kv = make_mask("holes", sk, seed=1)
    dkdv, dq = bwd_work_plan(BH, sq, sk, GROUP, causal, window, kv,
                             skip=False)
    assert all(r == range(-(-sq // BWD_STEP)) for r in dkdv.values())
    assert all(t == list(range(-(-sk // BWD_STEP))) for t in dq.values())


def test_a_dead_batch_row_runs_nothing_and_padding_skips():
    """Batch row 1 has no live key: none of its heads' blocks runs a
    step, in (b) or (c); row 0's right padding skips steps the band
    alone would run."""
    sq = sk = 200
    kv = make_mask("dead", sk, seed=2)
    dkdv, dq = bwd_work_plan(BH, sq, sk, GROUP, True, None, kv)
    band_dkdv, band_dq = bwd_work_plan(BH, sq, sk, GROUP, True, None)
    hq = BH // BATCH
    for (kvh, _), tiles in dkdv.items():
        if kvh * GROUP // hq == 1:
            assert len(tiles) == 0
    for (h, _), tiles in dq.items():
        if h // hq == 1:
            assert tiles == []
    steps = sum(len(t) for (h, _), t in dq.items() if h // hq == 0)
    band = sum(len(t) for (h, _), t in band_dq.items() if h // hq == 0)
    assert 0 < steps < band
    steps = sum(len(t) for (kvh, _), t in dkdv.items()
                if kvh * GROUP // hq == 0)
    band = sum(len(t) for (kvh, _), t in band_dkdv.items()
               if kvh * GROUP // hq == 0)
    assert 0 < steps < band


def test_kv_bounds_are_the_first_and_last_live_key():
    kv = torch.zeros((4, 100), dtype=torch.bool)
    kv[0, 3] = True
    kv[1, 10:57] = True
    kv[2] = True
    first, last = kv_bounds(kv)
    assert first.tolist() == [3, 10, 0, 100]
    assert last.tolist() == [3, 56, 99, -1]
