"""Client and participant meshes over ``torch.distributed`` ranks, and the
fixed-association accounting reduce (twin of ``repro/fl/sharding.py``).

The reference runs a ``shard_map`` over a D-device mesh; here the same
program runs as D ranks, one process per device, each on its own slice
(SPMD). Its collectives map to ``torch.distributed``: ``psum`` ->
``all_reduce(SUM)`` (:func:`psum`), ``pmax`` / ``pmin`` ->
``all_reduce(MAX / MIN)`` (:func:`pmax`, :func:`pmin`), ``all_gather`` ->
``all_gather_into_tensor`` (:func:`all_gather`). The ``'client'`` and
``'part'`` mesh axes are process groups (:func:`make_mesh2d`).

A float32 total over the client axis is always associated as
``ACCOUNT_BLOCKS`` contiguous blocks: per-block partial sums first, then
an explicit left fold of the block partials (:func:`blocked_total`). A
client shard owns ``ACCOUNT_BLOCKS / Dc`` whole blocks, computes their
partials and all-gathers them in global block order
(:func:`blocked_total_sharded`), so every mesh adds the same numbers in the
same order, and the only bytes that cross ranks are the 96 partials.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

# Fixed association width of the accounting reduce; 96 divides by 1, 2, 3,
# 4, 6, 8, 12, 16, 24, 32 and 48, so those client-shard counts split it
# into whole blocks. Part of the numeric contract, not a tuning knob.
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


# --------------------------------------------------------------------------
# Collectives over a process group (the reference's lax collectives).
# --------------------------------------------------------------------------

def _reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the elementwise sum of ``x`` over the group's ranks."""
    return _reduce(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the group's ranks."""
    return _reduce(x, dist.ReduceOp.MAX, group)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.pmin``: the elementwise minimum over the group's ranks."""
    return _reduce(x, dist.ReduceOp.MIN, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather``: (...) on each rank -> (group size, ...), in
    group rank order. One flat collective (gloo takes no stacked
    output)."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((size * x.numel(),))
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    gather(out, x.reshape(-1), group=group)
    return out.view(size, *x.shape)


def blocked_total_sharded(contrib_local: torch.Tensor, group, n_shards: int,
                          n_blocks: int = ACCOUNT_BLOCKS) -> torch.Tensor:
    """:func:`blocked_total` from one client shard: (..., n_local) ->
    (...), the same bits on every rank of ``group``.

    ``contrib_local`` is this shard's slice, ``n_blocks / n_shards`` whole
    blocks of the padded axis (a single shard may hold the unpadded axis:
    it is padded here with exact zeros, as :func:`blocked_total` pads).
    The block partials are all-gathered in global block order and folded.
    """
    if n_blocks % n_shards:
        raise ValueError(f"n_shards={n_shards} must divide n_blocks="
                         f"{n_blocks}")
    per = n_blocks // n_shards
    contrib_local = F.pad(contrib_local,
                          (0, (-contrib_local.shape[-1]) % per))
    part = block_partials(contrib_local, per)             # (..., per)
    full = all_gather(part, group).movedim(0, -2)         # (..., D, per)
    return _fold_partials(full.reshape(*part.shape[:-1], n_blocks))


def pad_client_axis(x: torch.Tensor, n_pad: int, fill, axis: int = -1):
    """Pad the client axis of ``x`` up to ``n_pad`` lanes with ``fill``."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if n == n_pad:
        return x
    shape = x.shape[:axis] + (n_pad - n,) + x.shape[axis + 1:]
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


# --------------------------------------------------------------------------
# The 2D mesh of ranks.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The ``('client', 'part')`` mesh of ranks, seen from one rank.

    Rank ``c * dp + p`` sits at client coordinate ``c`` and part
    coordinate ``p``, as the reference reshapes ``jax.devices()`` into
    ``(Dc, Dp)``. ``client_group`` holds the ``dc`` ranks of this rank's
    column (same ``p``): they split the client axis. ``part_group`` holds
    the ``dp`` ranks of its row (same ``c``): they split the packed
    participants.
    """

    dc: int
    dp: int
    c: int
    p: int
    client_group: object
    part_group: object


_MESHES: dict = {}


def require_group(what: str):
    """Raise unless ``torch.distributed`` has a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} runs one rank per device over torch.distributed, but "
            "no process group is initialised: call "
            "repro_torch.launch.distributed.initialize first (torchrun "
            "sets its environment, or pass init_method, world_size and "
            "rank)")


def make_mesh2d(client_shards: int, part_shards: int) -> Mesh2D:
    """The one ``(Dc, Dp)`` mesh both sharded stages of a composed round
    use, over every rank of the initialised process group.

    Either extent may be 1 (0 is treated as 1): the degenerate meshes are
    the 1D paths. ``Dc * Dp`` must equal the world size, and ``Dc`` must
    divide ``ACCOUNT_BLOCKS``. Every rank must call this with the same
    extents (the groups are made collectively); a mesh is made once per
    process group and extents, then reused.
    """
    dc, dp = max(1, int(client_shards)), max(1, int(part_shards))
    require_group(f"mesh ({dc}, {dp})")
    world = dist.get_world_size()
    if dc * dp != world:
        raise ValueError(
            f"mesh ({dc}, {dp}) = {dc * dp} ranks, but the process group "
            f"has world size {world} (client_shards * participant_shards "
            f"must equal it)")
    if ACCOUNT_BLOCKS % dc:
        raise ValueError(
            f"client_shards={dc} must divide ACCOUNT_BLOCKS="
            f"{ACCOUNT_BLOCKS} (the fixed association width of the exact "
            f"accounting reduce; see blocked_total)")
    world_group = dist.group.WORLD
    for old in [k for k, v in _MESHES.items() if v[0] is not world_group]:
        del _MESHES[old]   # made under a process group since destroyed
    # the stored group keeps its id from being reused by a later one
    key = (id(world_group), dc, dp)
    if key not in _MESHES:
        rank = dist.get_rank()

        def group(ranks):
            return (dist.group.WORLD if len(ranks) == world
                    else dist.new_group(ranks))

        # every rank makes every group, in one order (new_group is
        # collective over the whole world)
        columns = [group([c * dp + p for c in range(dc)]) for p in range(dp)]
        rows = [group([c * dp + p for p in range(dp)]) for c in range(dc)]
        c, p = divmod(rank, dp)
        _MESHES[key] = (world_group,
                        Mesh2D(dc, dp, c, p, columns[p], rows[c]))
    return _MESHES[key][1]
