"""Input shapes and sharding assignment for the dry run (twin of
``repro/launch/specs.py``).

``batch_specs(cfg, case)`` gives the port's ``Batch`` of ``meta`` tensors
(no memory) for a shape case, and the ``*_pspecs`` functions assign
PartitionSpecs adaptively, as the reference's do: an axis is placed on the
first listed tensor dim it divides evenly, so decode_32k shards its
128-request batch over (pod, data) while long_500k (batch 1) shards the
524,288 KV slots instead.

A mesh here is a ``DeviceMesh`` (``mesh_dim_names``, ``shape``) or any
object with a jax mesh's ``axis_names`` and ``devices.shape``.

``serve_state_pspecs`` reads shapes, and the reference's period-stacked
cache leaves have a leading (n_periods,) axis that changes what its rules
see (a 4-D cache becomes 5-D, the size order of the dims shifts). So the
plan of a period layer's cache leaf is made on the reference's stacked
shape and its leading entry dropped; a plan that puts a mesh axis on the
stacked axis raises by name.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Batch, ServeState
from repro_torch.sharding.rules import PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}

# Architectures allowed to run long_500k (sub-quadratic decode); every
# other id is SKIP(full-attn).
LONG_CONTEXT_ARCHS = {"mamba2-130m", "jamba-v0.1-52b", "mixtral-8x22b"}


def media_tokens_for(cfg: ModelConfig, kind: str) -> int:
    return cfg.n_media_tokens if cfg.cross_attn_every else 0


def encoder_len_for(cfg: ModelConfig, case: ShapeCase) -> int:
    if not cfg.is_encoder_decoder:
        return 0
    # the encoder reads stub frames, at most the configured stub length
    return min(cfg.encoder_seq or 4096, case.seq_len)


def batch_specs(cfg: ModelConfig, case: ShapeCase, *,
                client_dim: int = 0) -> Batch:
    """The ``Batch`` of ``meta`` tensors of this (arch, shape): int64
    tokens (and labels for training), float32 media and frames; with
    ``client_dim``, a leading client axis and the batch split over it."""
    b, s = case.global_batch, case.seq_len
    s_tok = 1 if case.kind == "decode" else s
    lead: Tuple[int, ...] = (client_dim,) if client_dim else ()
    if client_dim:
        b = b // client_dim

    def tok(shape):
        return torch.empty(lead + shape, dtype=torch.int64, device="meta")

    def emb(shape):
        return torch.empty(lead + shape, dtype=torch.float32, device="meta")

    media = None
    if media_tokens_for(cfg, case.kind):
        media = emb((b, cfg.n_media_tokens, cfg.d_model))
    frames = None
    if cfg.is_encoder_decoder:
        frames = emb((b, encoder_len_for(cfg, case), cfg.d_model))
    labels = tok((b, s_tok)) if case.kind == "train" else None
    return Batch(tokens=tok((b, s_tok)), labels=labels, media=media,
                 frames=frames)


# ----------------------------------------------------------------- sharding

def _assign(shape: Tuple[int, ...], wishes, mesh_axes: Dict[str, int]) -> P:
    """Greedy spec assignment: wishes = [(axis_name, [candidate dims])].

    Each axis lands on the first candidate dim that (a) is unassigned and
    (b) it divides evenly. Undivisible -> axis dropped (replicated).
    """
    spec: list = [None] * len(shape)
    for axis, dims in wishes:
        size = mesh_axes[axis] if isinstance(axis, str) else \
            functools.reduce(lambda a, b: a * mesh_axes[b], axis, 1)
        for d in dims:
            if d < len(shape) and spec[d] is None and shape[d] % size == 0 \
                    and shape[d] > 0:
                spec[d] = axis if isinstance(axis, str) else tuple(axis)
                break
    return P(*spec)


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    shape = (mesh.devices.shape if hasattr(mesh, "devices")
             else tuple(mesh.shape))
    return dict(zip(_axis_names(mesh), shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch-parallel axes: ('pod', 'data') on the multi-pod mesh, else
    ('data',)."""
    return tuple(a for a in _axis_names(mesh) if a in ("pod", "data"))


def batch_pspecs(batch: Batch, mesh, *, client_dim: bool = False) -> Batch:
    ax = mesh_axis_sizes(mesh)
    bp = list(data_axes(mesh))
    lead = ["pod"] if client_dim else []
    if client_dim and "pod" in bp:
        bp.remove("pod")

    def spec(x):
        if x is None:
            return None
        wishes = []
        if client_dim:
            wishes.append(("pod", [0]))
        # batch dim first; long-context decode (batch 1): nothing here
        wishes.append((tuple(bp) if len(bp) > 1 else bp[0], [len(lead)]))
        return _assign(tuple(x.shape), wishes, ax)

    return Batch(tokens=spec(batch.tokens), labels=spec(batch.labels),
                 media=spec(batch.media), frames=spec(batch.frames))


def _state_spec(shape, is_int: bool, ax, bp_axis) -> P:
    """The reference's heuristic for one ServeState leaf: 'model' on the
    KV-head dim, then the slot dim, then head_dim (4-D and up), else the
    trailing dims; the batch axes on the largest divisible remaining dim.
    Integer leaves (slot positions, lengths) replicated."""
    nd = len(shape)
    if nd == 0 or is_int:
        return P()
    if nd >= 4:
        model_wish = ("model", [nd - 2, 1, nd - 1])
    else:
        model_wish = ("model", list(range(nd - 1, 0, -1)))
    order = sorted(range(nd), key=lambda d: -shape[d])
    return _assign(shape, [model_wish, (bp_axis, order)], ax)


def _stacked_spec(shape, is_int, ax, bp_axis, stack: int, what: str) -> P:
    """A period layer's leaf: the plan of the reference's (stack,) +
    shape leaf, its leading entry dropped."""
    if not stack:
        return _state_spec(tuple(shape), is_int, ax, bp_axis)
    spec = _state_spec((stack,) + tuple(shape), is_int, ax, bp_axis)
    if is_int or not len(shape):
        return P()
    if spec[0] is not None:
        raise ValueError(f"serve_state_pspecs: {what}: the reference's plan "
                         f"puts {spec[0]!r} on its stacked axis of {stack} "
                         "periods, which has no per-layer twin")
    return P(*spec[1:])


def _leaf(x, ax, bp_axis, stack, what):
    """The spec of one leaf: a tensor, or a Python int (positions and
    lengths, which the reference holds as int32 scalars)."""
    if x is None:
        return None
    if isinstance(x, int):
        return P()
    is_int = not (x.dtype.is_floating_point or x.dtype.is_complex)
    return _stacked_spec(tuple(x.shape), is_int, ax, bp_axis, stack, what)


def serve_state_pspecs(state: ServeState, cfg: ModelConfig, mesh):
    """PartitionSpecs of a ``ServeState`` (of ``meta`` or real tensors),
    the same structure: each layer's cache (``KVCache`` or ``MambaState``
    of specs, None for a cross-attention mixer), ``P()`` for the position,
    and each layer's cross K / V pairs."""
    ax = mesh_axis_sizes(mesh)
    bp = data_axes(mesh)
    bp_axis = bp if len(bp) > 1 else bp[0]
    prefix, _, n_periods = cfg.period_decomposition()

    def stack(i):
        return 0 if i < len(prefix) else n_periods

    def tree(t, i, what):
        if t is None or isinstance(t, int) or torch.is_tensor(t):
            return _leaf(t, ax, bp_axis, stack(i), what)
        items = [tree(e, i, what) for e in t]
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)

    layers = tuple(tree(c, i, f"layer {i}'s cache")
                   for i, c in enumerate(state.layers))
    cross = tuple(tree(kv, i, f"layer {i}'s cross K / V")
                  for i, kv in enumerate(state.cross_kv))
    return ServeState(layers=layers, position=P(), cross_kv=cross)


def token_pspec(batch_size: int, mesh) -> P:
    ax = mesh_axis_sizes(mesh)
    bp = data_axes(mesh)
    bp_axis = bp if len(bp) > 1 else bp[0]
    return _assign((batch_size, 1), [(bp_axis, [0])], ax)
