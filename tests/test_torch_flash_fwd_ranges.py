"""The key tiles K5's forward runs with a kv_valid mask, on the CPU:
``kernels/flash_attention.py::fwd_work_plan``, the twin of
``csrc/flash_attention.cu``'s ``block_work``, ``live_tiles`` and
``next_tile`` (each batch row's first and last live key from the
``kv_bounds`` pass, blocks left no tile, key tiles whose packed word is
0), on the seeded masks and geometries of
``tests/test_torch_flash_bwd_ranges.py``.

* every (block, tile) pair the plan leaves out is all-false in
  ``kernels/ref.py::full_mask``: no tile with a live pair is skipped;
* under padding, a block none of whose rows sees a live key runs no
  tile, and a batch row with no live key runs none;
* ``skip=False`` runs every tile, and without a mask the plan is the
  band the unmasked kernel runs;
* the forward's scratch holds the mask's words and each batch row's
  bounds after the split K and V and the means of v.

The kernel's bits with and without the skips are held equal on the card
(``tests/test_torch_cuda.py::test_flash_attention_modes_match_plain``).
"""

import pytest
import torch
from test_torch_flash_bwd_ranges import (BATCH, BH, CONTIGUOUS, GEOMETRY,
                                         GROUP, make_mask)

from repro_torch.kernels.flash_attention import (BLOCK_ROWS, K_TILE,
                                                 fwd_work_floats,
                                                 fwd_work_plan,
                                                 mode_work_floats,
                                                 padded_keys)
from repro_torch.kernels.ref import full_mask


def n_tiles(sk):
    return -(-sk // K_TILE)


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
@pytest.mark.parametrize("kind", CONTIGUOUS + ["holes"])
def test_no_live_tile_is_skipped(kind, sq, sk, causal, window):
    kv = make_mask(kind, sk, seed=sq + sk)
    mask = full_mask(BH, sq, sk, causal, window, kv, "cpu")
    plan = fwd_work_plan(BH, sq, sk, GROUP, causal, window, kv)
    assert sorted(plan) == [(h, q0) for h in range(BH)
                            for q0 in range(0, sq, BLOCK_ROWS)]
    for (h, q0), tiles in plan.items():
        assert tiles == sorted(set(tiles))
        assert all(0 <= t < n_tiles(sk) for t in tiles)
        for t in set(range(n_tiles(sk))) - set(tiles):
            keys = slice(t * K_TILE, (t + 1) * K_TILE)
            assert not bool(mask[h, q0:q0 + BLOCK_ROWS, keys].any()), (
                h, q0, t)


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
@pytest.mark.parametrize("kind", CONTIGUOUS)
def test_dead_blocks_run_nothing(kind, sq, sk, causal, window):
    """Padding (each batch row's live keys contiguous): a block none of
    whose rows sees a live key runs no tile, and no tile the plan runs
    lies wholly outside the batch row's live span."""
    kv = make_mask(kind, sk, seed=sq + sk)
    mask = full_mask(BH, sq, sk, causal, window, kv, "cpu")
    plan = fwd_work_plan(BH, sq, sk, GROUP, causal, window, kv)
    hq = BH // BATCH
    for (h, q0), tiles in plan.items():
        if not bool(mask[h, q0:q0 + BLOCK_ROWS].any()):
            assert tiles == [], (h, q0)
        row = kv[h // hq]
        for t in tiles:
            assert bool(row[t * K_TILE:(t + 1) * K_TILE].any()), (h, q0, t)


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
def test_skip_false_runs_every_tile(sq, sk, causal, window):
    kv = make_mask("holes", sk, seed=1)
    plan = fwd_work_plan(BH, sq, sk, GROUP, causal, window, kv, skip=False)
    assert all(t == list(range(n_tiles(sk))) for t in plan.values())


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
def test_without_a_mask_the_plan_is_the_band(sq, sk, causal, window):
    """No mask: each block runs the tiles from its first row's window to
    its last row's causal edge, the unmasked kernel's tiles."""
    plan = fwd_work_plan(BH, sq, sk, GROUP, causal, window)
    for (_, q0), tiles in plan.items():
        q_last = min(q0 + BLOCK_ROWS, sq) - 1
        end = min(n_tiles(sk), q_last // K_TILE + 1) if causal else (
            n_tiles(sk))
        begin = max(0, q0 - window + 1) // K_TILE if window else 0
        assert tiles == list(range(begin, end))


@pytest.mark.parametrize("sq,sk,causal,window", GEOMETRY)
def test_a_dead_batch_row_runs_nothing_and_padding_skips(sq, sk, causal,
                                                        window):
    """Batch row 1 has no live key: none of its heads' blocks runs a
    tile; row 0's right padding of 40 keys (a whole tile or more) leaves
    out tiles the band alone would run, and left padding (rows before
    the first live key) whole blocks under causal masking."""
    hq = BH // BATCH
    kv = torch.ones((BATCH, sk), dtype=torch.bool)
    kv[0, sk - 40:] = False
    kv[1] = False
    plan = fwd_work_plan(BH, sq, sk, GROUP, causal, window, kv)
    band = fwd_work_plan(BH, sq, sk, GROUP, causal, window)
    assert all(t == [] for (h, _), t in plan.items() if h // hq == 1)
    tiles = sum(len(t) for (h, _), t in plan.items() if h // hq == 0)
    whole = sum(len(t) for (h, _), t in band.items() if h // hq == 0)
    assert 0 < tiles < whole
    kv = torch.ones((BATCH, sk), dtype=torch.bool)
    kv[0, :BLOCK_ROWS + K_TILE] = False
    plan = fwd_work_plan(BH, sq, sk, GROUP, causal, window, kv)
    if causal:
        assert all(t == [] for (h, q0), t in plan.items()
                   if h // hq == 0 and q0 == 0)
    assert all(t == band[h, q0] for (h, q0), t in plan.items()
               if h // hq == 1)


@pytest.mark.parametrize("bh,sk,d,group,batches", [
    (128, 2048, 128, 8, 0), (128, 2048, 128, 8, 4), (8, 200, 64, 2, 2),
    (6, 150, 32, 3, 2), (4, 97, 64, 2, 1)])
def test_fwd_scratch_follows_the_layout(bh, sk, d, group, batches):
    """K hi and lo and V^T hi and lo on BH / kv_group heads of Sk padded
    to the 32-key tile; with a mask of ``batches`` rows, the means of v
    (D a KV head), the packed words (one per 32 keys a batch row) and
    each batch row's first and last live key (2 ints)."""
    assert 0 <= padded_keys(sk) - sk < K_TILE
    split = 4 * (bh // group) * padded_keys(sk) * d
    want = split + (bh // group * d + batches * n_tiles(sk) + 2 * batches
                    if batches else 0)
    assert fwd_work_floats(bh, sk, d, group, batches) == want
    if batches:
        assert want - split == mode_work_floats(bh, sk, d, group,
                                                batches) + 2 * batches
