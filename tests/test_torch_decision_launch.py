"""The Python side of the fused decision kernels' launch
(``repro_torch/kernels/decision_fused.py``), on the CPU: the launch plan
covers every lane of a (B, N) bucket exactly once, in the kernel's own
mapping (one lane a thread, a block inside one row, the row loop past
CUDA's grid-y limit), with blocks the C side accepts; the output slab's
five views are contiguous, of the right shape and type, and disjoint. The
kernels themselves are held against their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import pytest
import torch

from repro_torch.kernels.decision_fused import (MAX_GRID_Y, MAX_THREADS,
                                                decision_outputs,
                                                launch_plan)

# (B, N): single lanes and ragged rows, the engine's N = 100, the
# service's buckets at full width, a cold large bucket, K2 at 2^20, and
# rows up to and past CUDA's grid-y limit
SHAPES = [(1, 1), (1, 3), (1, 5), (1, 100), (1, 1027), (1, 1 << 20),
          (3, 7), (7, 1029), (1024, 32), (512, 128), (64, 16384),
          (65535, 2), (70000, 4)]


def plan_lanes(plan, n):
    """The kernel's mapping along a row (``decision_kernel``): thread t of
    block bx takes lane bx * block + t, if below n."""
    lane = torch.arange(plan.grid_x * plan.block, dtype=torch.int64)
    return lane[lane < n]


def plan_rows(plan, rows):
    """Row block by takes rows by, by + grid_y, ... below ``rows``."""
    steps = -(-rows // plan.grid_y)
    r = (torch.arange(plan.grid_y)[:, None]
         + torch.arange(steps)[None, :] * plan.grid_y).reshape(-1)
    return r[r < rows]


@pytest.mark.parametrize("b,n", SHAPES)
def test_launch_plan_covers_every_lane_once(b, n):
    plan = launch_plan(b, n)
    # blocks the C side launches: whole warps, at least one (its first 14
    # threads load the row's operands), at most MAX_THREADS
    assert plan.block % 32 == 0 and 32 <= plan.block <= MAX_THREADS
    assert 1 <= plan.grid_y <= MAX_GRID_Y and plan.grid_x < 2 ** 31
    # each lane of a row once, and no block wholly past the row's end
    assert torch.equal(plan_lanes(plan, n), torch.arange(n))
    assert (plan.grid_x - 1) * plan.block < n
    # each row once; the row loop takes the rows past grid-y's limit
    assert torch.equal(plan_rows(plan, b).sort().values, torch.arange(b))
    assert plan.grid_y == min(b, MAX_GRID_Y)


@pytest.mark.parametrize("b,n", [(1, 5 << 29), (3, 3 << 30)])
def test_launch_plan_past_32_bit_lanes(b, n):
    """Rows longer than 2^31 lanes: the grid still covers each row, with
    no block past its end (the kernel indexes in 64 bits)."""
    plan = launch_plan(b, n)
    covered = plan.grid_x * plan.block
    assert covered >= n > covered - plan.block
    assert plan.grid_x < 2 ** 31 and plan.grid_y == b


@pytest.mark.parametrize("n,block", [(1, 32), (32, 32), (33, 64),
                                     (100, 128), (128, 128), (129, 128),
                                     (16384, 128)])
def test_launch_plan_block_follows_the_row(n, block):
    """Rows of up to 128 lanes get one block the row's length rounded up
    to a warp's power of two; longer rows get blocks of 128."""
    plan = launch_plan(1, n)
    assert plan.block == block
    assert plan.grid_x == -(-n // block)


@pytest.mark.parametrize("shape", [(1,), (100,), (1027,), (7, 1029),
                                   (1024, 32)])
def test_output_slab_views(shape):
    like = torch.zeros(shape)
    sel, out = decision_outputs(like)
    assert sel.dtype == torch.bool and sel.shape == shape
    assert sel.is_contiguous()
    outs = out.unbind(0)
    assert out.shape == (5, *shape) and len(outs) == 5
    spans = []
    for x in outs:
        assert x.dtype == torch.float32 and x.shape == shape
        assert x.is_contiguous()
        spans.append((x.data_ptr(), x.data_ptr() + 4 * x.numel()))
    spans.append((sel.data_ptr(), sel.data_ptr() + sel.numel()))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start
    # the rows are where the C side writes them: q, P, Z', tc, pq at
    # out + k * numel
    for k, x in enumerate(outs):
        assert x.data_ptr() == out.data_ptr() + 4 * k * like.numel()
    # writing one view leaves the others as they were
    out.fill_(0.0)
    outs[2].fill_(1.0)
    assert [float(x.sum()) for x in outs] == [0.0, 0.0, like.numel(),
                                             0.0, 0.0]
