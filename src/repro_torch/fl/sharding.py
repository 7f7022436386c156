"""The fixed-association accounting reduce (twin of the single-device half
of ``repro/fl/sharding.py``).

A float32 total over the client axis is always associated as
``ACCOUNT_BLOCKS`` contiguous blocks: per-block partial sums first, then an
explicit left fold of the block partials. The reference fixes this order
so that every mesh adds the same numbers in the same order; the port keeps
it so its totals are associated like the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACCOUNT_BLOCKS = 96


def padded_len(n: int, n_blocks: int = ACCOUNT_BLOCKS) -> int:
    """The client-axis length after padding to whole accounting blocks."""
    return n + (-n) % n_blocks


def block_partials(contrib: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Per-block partial sums of a (..., n_blocks * L) contribution."""
    return contrib.reshape(*contrib.shape[:-1], n_blocks, -1).sum(-1)


def _fold_partials(partials: torch.Tensor) -> torch.Tensor:
    """Left-fold the last axis of (..., n_blocks) partials with an explicit
    chain of adds: ((p0 + p1) + p2) + ..."""
    parts = partials.unbind(-1)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def blocked_total(contrib: torch.Tensor,
                  n_blocks: int = ACCOUNT_BLOCKS) -> torch.Tensor:
    """Fixed-association f32 total over the last axis: (..., N) -> (...).

    Pads with exact zeros to whole blocks (+0.0 terms change no partial).
    Leading axes are reduced independently, so stacking several
    contributions costs one fold for all of them.
    """
    contrib = F.pad(contrib, (0, (-contrib.shape[-1]) % n_blocks))
    return _fold_partials(block_partials(contrib, n_blocks))
