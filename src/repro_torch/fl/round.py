"""Federated rounds, Algorithm 1 (twin of the simulation half of
``repro/fl/round.py``).

The <= ``m_cap`` selected participants each run I local SGD steps from the
global model, then the server forms the q-weighted aggregate

    x <- (1/N) sum_{i in sel} (1/q_i) y_i                 (Algorithm 1, l.7)

or its variance-reduced delta form. Participants train together under
``torch.func.vmap`` (one batched program, no per-participant loop); this is
plain PyTorch, no kernel of this repository.

The engine aggregates the packed participants (:func:`masked_aggregate`);
:func:`weighted_aggregate`, :func:`delta_aggregate` and :func:`fl_round`
are the unmasked forms over an explicit (N, ...) client axis, and
:func:`make_fl_train_step` / :func:`make_train_step` the train steps built
on them. :func:`make_sharded_round_update` splits the packed participants
over the ranks of a ``'part'`` process group, the aggregate an all-reduce
(``SimConfig(participant_shards=Dp)``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.fl.sharding import Mesh2D, make_mesh2d, psum, require_group
from repro_torch.obs.profile import trace_span

WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_wire_dtype(name: str) -> torch.dtype:
    """``SimConfig.wire_dtype`` -> torch dtype (delta-aggregation wire)."""
    if name not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {name!r} "
                         f"(want one of {sorted(WIRE_DTYPES)})")
    return WIRE_DTYPES[name]


def local_sgd(loss_fn: Callable, params: dict, batches, gamma: float,
              steps: int) -> dict:
    """I plain SGD steps (Algorithm 1, lines 4-6); ``batches`` =
    (inputs, labels) with a leading ``steps`` axis."""
    grad_fn = torch.func.grad(loss_fn)
    inputs, labels = batches
    for s in range(steps):
        g = grad_fn(params, (inputs[s], labels[s]))
        params = {k: w - gamma * g[k] for k, w in params.items()}
    return params


def train_participants(loss_fn: Callable, params: dict, inputs, labels,
                       gamma: float, steps: int) -> dict:
    """:func:`local_sgd` for every participant at once: inputs/labels carry
    a leading participant axis; returns params with that axis."""
    return torch.func.vmap(
        lambda x, y: local_sgd(loss_fn, params, (x, y), gamma, steps))(
            inputs, labels)


def _client_weights(selected: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """I_n / q_n / N, each a true IEEE division."""
    n = q.shape[0]
    return selected.to(torch.float32) / q / q.new_full((), n)


def _per_client(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return w.reshape((w.shape[0],) + (1,) * (y.ndim - 1))


def weighted_aggregate(global_params: dict, client_params: dict,
                       selected: torch.Tensor, q: torch.Tensor) -> dict:
    """Algorithm 1 line 7, x <- (1/N) sum_n (I_n / q_n) y_n, over client
    params with a leading (N,) axis; float32 accumulation."""
    w = _client_weights(selected, q)
    return {k: (y.to(torch.float32) * _per_client(w, y)).sum(0).to(y.dtype)
            for k, y in client_params.items()}


def delta_aggregate(global_params: dict, client_params: dict,
                    selected: torch.Tensor, q: torch.Tensor,
                    wire_dtype=torch.bfloat16) -> dict:
    """x <- x + (1/N) sum_n (I_n / q_n)(y_n - x): Algorithm 1's mean with a
    lower variance, each weighted delta cast to ``wire_dtype`` before the
    sum (the quantity a deployment puts on the wire)."""
    w = _client_weights(selected, q)

    def agg(x, y):
        delta = y.to(torch.float32) - x.to(torch.float32)[None]
        update = (delta * _per_client(w, y)).to(wire_dtype).sum(0)
        return (x.to(torch.float32) + update.to(torch.float32)).to(x.dtype)

    return {k: agg(x, client_params[k]) for k, x in global_params.items()}


def fl_round(loss_fn: Callable, params: dict, client_batches, selected,
             q, gamma: float, steps: int) -> dict:
    """One round over an explicit client axis: every client's local SGD
    (``client_batches`` leaves (N, steps, ...)), non-participants masked
    out by the aggregate's weight."""
    inputs, labels = client_batches
    updated = train_participants(loss_fn, params, inputs, labels, gamma,
                                 steps)
    return weighted_aggregate(params, updated, selected, q)


def make_fl_train_step(loss_fn: Callable, gamma: float, steps: int,
                       n_clients: int):
    """``train_step(params, batch, selected, q)``: :func:`fl_round` with
    batch leaves (n_clients, steps, ...) and q, selected (n_clients,)."""
    def train_step(params, batch, selected, q):
        return fl_round(loss_fn, params, batch, selected, q, gamma, steps)

    return train_step


def make_train_step(loss_fn: Callable, gamma: float):
    """Plain (non-federated) SGD step: ``train_step(params, batch) ->
    (new_params, loss)``.

    With telemetry on (``repro_torch.obs.configure(True)``) each call opens
    the profiler spans ``train_step``, and inside it ``train_step.forward``
    around the loss and ``train_step.update`` around the SGD update; the
    backward is ``train_step``'s self part (the autograd engine may launch
    it from its own device thread while this thread waits inside
    ``train_step``). Off, each span costs one flag check."""
    def forward(params, batch):
        with trace_span("train_step.forward"):
            return loss_fn(params, batch)

    grad_and_loss = torch.func.grad_and_value(forward)

    def train_step(params, batch):
        with trace_span("train_step"):
            g, loss = grad_and_loss(params, batch)
            with trace_span("train_step.update"):
                new = {k: w - gamma * g[k].to(w.dtype)
                       for k, w in params.items()}
        return new, loss

    return train_step


def pack_participants(sel: torch.Tensor, m_cap: int):
    """The first ``m_cap`` selected clients, ascending, zero-filled past the
    selection count: ``(sel_idx, sel_valid)``. A stable sort of the
    not-selected flag puts the selected indices first in order, without a
    host synchronisation (``nonzero`` would need one)."""
    order = torch.sort((~sel).to(torch.uint8), stable=True).indices
    if order.shape[0] < m_cap:
        order = torch.cat([order, order.new_zeros(m_cap - order.shape[0])])
    sel_valid = torch.arange(m_cap, device=sel.device) < sel.sum()
    return torch.where(sel_valid, order[:m_cap], 0), sel_valid


def sample_batches(idx: torch.Tensor, client_images, client_labels,
                   sel_idx):
    """The participants' local minibatches from pre-drawn (m_cap, steps,
    batch) per-client example indices ``idx``."""
    rows = sel_idx[:, None, None]
    return client_images[rows, idx], client_labels[rows, idx]


def masked_aggregate(params: dict, updated: dict, sel_valid, q_sel,
                     n_clients: int, aggregation: str = "paper",
                     wire_dtype=torch.float32, group=None) -> dict:
    """Algorithm 1 line 7 over the materialized participants (leading axis
    m_cap), masked by ``sel_valid`` and weighted by 1/(N q). ``delta``:
    x + sum (w (y - x)) with each weighted delta cast to ``wire_dtype``
    before the sum (the quantity a deployment puts on the wire).

    ``group`` turns the local sum into a partial completed by an
    ``all_reduce`` over that process group (the participant-sharded
    round's collective, the reference's ``psum`` over ``axis_name``); the
    cast before the reduce is what puts ``wire_dtype`` bytes on the
    wire."""
    w = (sel_valid.to(torch.float32) / torch.clamp_min(q_sel, 1e-9)
         / q_sel.new_full((), n_clients))

    def weight(y):
        return w.reshape((-1,) + (1,) * (y.ndim - 1))

    def reduce(x):
        return x if group is None else psum(x, group)

    if aggregation == "delta":
        return {k: x + reduce(((updated[k] - x[None]) * weight(updated[k]))
                              .to(wire_dtype).sum(0)).to(torch.float32)
                for k, x in params.items()}
    if aggregation != "paper":
        raise ValueError(f"unknown aggregation {aggregation!r} "
                         f"(want 'paper'|'delta')")
    return {k: reduce((y * weight(y)).sum(0)) for k, y in updated.items()}


def _pad_rows(x: torch.Tensor, pad: int, fill) -> torch.Tensor:
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


def make_sharded_round_update(loss_fn: Callable, gamma: float, steps: int,
                              n_clients: int, n_shards: int, *,
                              aggregation: str = "paper",
                              wire_dtype=torch.float32,
                              mesh: Optional[Mesh2D] = None) -> Callable:
    """Participant-sharded round update: the <= m_cap packed participants'
    local SGD split over the ranks of a ``'part'`` group, the q-weighted
    Algorithm-1 aggregate completed by an ``all_reduce`` over it (the
    *scheduled* collective the paper's Algorithm 2 prices).

    Returns ``update(params, inputs, labels, sel_valid, q_sel) ->
    new_params`` where ``inputs``/``labels`` carry the participant axis
    leading ((m_cap, steps, batch, ...)), the same on every rank. Each of
    the ``n_shards`` ranks trains its m_cap / n_shards rows under
    ``vmap(grad)`` (:func:`train_participants`), forms its partial weighted
    sum, and the all-reduce completes line 7. When ``n_shards`` does not
    divide m_cap the participant axis is padded with zero-weight rows
    (``sel_valid=False``, q = 1) that train on zero data and add exactly
    0.

    ``aggregation="delta"`` casts each rank's partial delta sum to
    ``wire_dtype`` before the all-reduce, so a bfloat16 wire moves
    bfloat16. At one rank the update is bit for bit the sequential
    :func:`masked_aggregate` of :func:`train_participants` (an all-reduce
    of one rank is the identity); across ranks the participant sum is
    re-associated per shard.

    ``mesh`` is the composed round's :class:`~repro_torch.fl.sharding.
    Mesh2D` (its ``part_group`` of extent ``n_shards``); None builds the 1D
    mesh ``(1, n_shards)``, which needs a world of ``n_shards`` ranks.
    """
    if mesh is None:
        require_group(f"n_shards={n_shards}")
        world = dist.get_world_size()
        if n_shards != world:
            raise ValueError(f"n_shards={n_shards} needs a process group of "
                             f"{n_shards} ranks, this one has {world}")
        mesh = make_mesh2d(1, n_shards)
    elif mesh.dp != n_shards:
        raise ValueError(f"n_shards={n_shards} != the mesh's 'part' extent "
                         f"{mesh.dp}")

    def update(params, inputs, labels, sel_valid, q_sel):
        pad = (-sel_valid.shape[0]) % n_shards
        if pad:
            inputs, labels = _pad_rows(inputs, pad, 0), _pad_rows(labels,
                                                                  pad, 0)
            sel_valid = _pad_rows(sel_valid, pad, False)
            q_sel = _pad_rows(q_sel, pad, 1.0)
        per = sel_valid.shape[0] // n_shards
        rows = slice(mesh.p * per, (mesh.p + 1) * per)
        updated = train_participants(loss_fn, params, inputs[rows],
                                     labels[rows], gamma, steps)
        return masked_aggregate(params, updated, sel_valid[rows],
                                q_sel[rows], n_clients, aggregation,
                                wire_dtype, group=mesh.part_group)

    return update
