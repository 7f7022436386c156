"""Partition rules for the model zoo on the (pod, data, model) mesh (twin
of ``repro/sharding/rules.py``).

Megatron-style tensor parallelism on the ``model`` axis plus optional
FSDP-style weight sharding on the ``data`` axis:

* column-parallel projections (wq/wk/wv, mlp wi/wg, mamba in_proj) shard
  their output dim on ``model`` and input dim on ``data`` (fsdp);
* row-parallel projections (attention wo, mlp wo, mamba out_proj) shard
  their input dim on ``model`` and output dim on ``data``;
* MoE expert banks shard the expert dim on ``model`` and the d_model dim
  on ``data``;
* embeddings / lm head shard the vocab dim on ``model``;
* per-head SSM scalars (a_log, dt_bias, d_skip) follow the head sharding.

The ``pod`` axis never shards weights: it is the FL client axis.

:class:`PartitionSpec` is the port's own: a tuple with one entry per dim,
each an axis name, a tuple of axis names (major to minor) or None.
:func:`to_placements` turns one into DTensor placements on a
``DeviceMesh``.

:func:`param_pspecs` keys the reference's rules on the same leaf names:
the port's ``LM`` names its parameters as the reference's tree does at
the leaf (``mixer.wq.w``, ``mlp.wi``, ``embed.emb``, Mamba's ``conv_w``
...). The reference stacks each period's layers (and the encoder's) on a
leading axis, and its rules and their divisibility check read that
stacked shape: a stacked leaf's spec gets a leading None, and a dropped
axis is re-homed by scanning every dim, the stacked one included. So the
plan of a period or encoder layer's leaf is computed here on the stacked
shape, (n_periods or n_encoder_layers,) + its shape, and the leading
entry dropped; a plan that puts a mesh axis on that stacked dim has no
per-layer twin and raises by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingMode:
    tensor_axis: Optional[str] = "model"
    fsdp_axis: Optional[str] = None       # 'data' to enable FSDP weight sharding
    data_axes: tuple = ("data",)          # batch axes for the train step


def _leaf_spec(names: list[str], ndim: int, mode: ShardingMode) -> P:
    """The reference's rule for the leaf at path ``names`` (its tree's
    keys) of ``ndim`` dims, stacked where the path holds 'period' or
    'encoder'."""
    tp, fsdp = mode.tensor_axis, mode.fsdp_axis
    stacked = ("period" in names or "encoder" in names)
    base_ndim = ndim - (1 if stacked else 0)
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""

    def out(*spec):
        spec = list(spec) + [None] * (base_ndim - len(spec))
        if stacked:
            spec = [None] + spec
        return P(*spec)

    # --- embeddings / head
    if name == "emb":
        return out(tp, fsdp)
    if parent == "lm_head":
        return out(fsdp, tp)
    # --- MoE
    if parent == "router":
        return out(None, None)
    if name in ("wi", "wg") and base_ndim == 3:
        return out(tp, fsdp, None)
    if name == "wo" and base_ndim == 3:
        return out(tp, None, fsdp)
    # --- attention / dense mlp
    if parent in ("wq", "wk", "wv", "wi", "wg"):
        return out(fsdp, tp)
    if parent == "wo":
        return out(tp, fsdp)
    # --- mamba
    if parent == "in_proj":
        return out(fsdp, tp)
    if parent == "out_proj":
        return out(tp, fsdp)
    if name == "conv_w":
        return out(None, tp)
    if name in ("conv_b", "norm_g"):
        return out(tp)
    if name in ("a_log", "d_skip", "dt_bias"):
        return out(tp)
    # --- norms / everything else: replicated
    return out()


def axis_size(entry, axis_sizes: dict) -> int:
    """The devices an entry spans: 1 for None, the product for a tuple."""
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for e in entry:
            n *= axis_sizes.get(e, 1)
        return n
    return axis_sizes.get(entry, 1)


def _sanitize(spec: P, shape, axis_sizes: Optional[dict]) -> P:
    """Drop axes that do not divide their dim (even shards only), then
    re-home each dropped axis on the last unassigned dim it divides: the
    reference's fallback that keeps odd vocabularies' embeddings sharded
    (minicpm 122753, seamless 256206)."""
    if axis_sizes is None:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dropped = []
    for i, e in enumerate(entries):
        if e is not None and shape[i] % axis_size(e, axis_sizes) != 0:
            dropped.append(e)
            entries[i] = None
    for e in dropped:
        for i in range(len(shape) - 1, -1, -1):
            if entries[i] is None and shape[i] % axis_size(e, axis_sizes) == 0 \
                    and shape[i] >= axis_size(e, axis_sizes):
                entries[i] = e
                break
    return P(*entries)


def reference_path(name: str, cfg) -> tuple[list[str], int]:
    """The reference's tree path of the port's parameter ``name`` (its
    keys; a prefix layer's list index as ``[j]``), and the length of the
    axis the reference stacks it on (0 where it is not stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        prefix, period, n_periods = cfg.period_decomposition()
        i = int(parts[1])
        if i < len(prefix):
            return ["prefix", f"[{i}]"] + parts[2:], 0
        k = (i - len(prefix)) % len(period)
        return ["period", f"layer{k}"] + parts[2:], n_periods
    if parts[0] == "encoder":
        return ["encoder", "layer0"] + parts[2:], cfg.n_encoder_layers
    return parts, 0


def leaf_pspec(name: str, shape, mode: ShardingMode, cfg,
               axis_sizes: Optional[dict] = None) -> P:
    """The plan of one parameter: the reference's rule and divisibility
    fix-up on the reference's (stacked) shape, the stacked entry dropped."""
    path, stack = reference_path(name, cfg)
    shape = tuple(shape)
    full = ((stack,) if stack else ()) + shape
    spec = _sanitize(_leaf_spec(path, len(full), mode), full, axis_sizes)
    if not stack:
        return spec
    if spec[0] is not None:
        raise ValueError(f"param_pspecs: {name}: the reference's plan puts "
                         f"{spec[0]!r} on its stacked axis of {stack} "
                         f"layers, which has no per-layer twin")
    return P(*spec[1:])


def _model_config(params):
    """The config an ``LM`` was built with (its mixers hold it)."""
    for module in params.modules():
        cfg = getattr(module, "cfg", None)
        if cfg is not None:
            return cfg
    raise ValueError("param_pspecs: the module holds no config; pass cfg=")


def param_pspecs(params, mode: ShardingMode,
                 axis_sizes: Optional[dict] = None, cfg=None) -> dict:
    """``{name: PartitionSpec}`` for an ``LM`` (or a ``{name: tensor}``
    dict of its parameters, with ``cfg``). ``axis_sizes`` (e.g. {'data':
    16, 'model': 16}) enables the divisibility fix-up; without it the raw
    rules are returned."""
    if hasattr(params, "named_parameters"):
        cfg = cfg if cfg is not None else _model_config(params)
        params = dict(params.named_parameters())
    if cfg is None:
        raise ValueError("param_pspecs: a dict of parameters needs cfg=")
    return {name: leaf_pspec(name, t.shape, mode, cfg, axis_sizes)
            for name, t in params.items()}


def batch_pspec(mode: ShardingMode, *, client_dim: bool = False) -> dict:
    """Spec for Batch fields: tokens/labels (B, S) — or (pods, B, S) when
    ``client_dim`` — and media/frames (B, M, d)."""
    lead = ("pod",) if client_dim else ()
    tok = P(*lead, mode.data_axes[0] if mode.data_axes else None, None)
    emb = P(*lead, mode.data_axes[0] if mode.data_axes else None, None, None)
    return {"tokens": tok, "labels": tok, "media": emb, "frames": emb}


def serve_batch_pspec(mode: ShardingMode) -> dict:
    """Decode-shape batches: the batch dim is the only parallel one at
    decode (the model axis shards the weights)."""
    return batch_pspec(mode)


def to_placements(spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``) for ``spec``: ``Shard(d)`` on each mesh dim that
    some entry d names (a tuple entry shards dim d over its axes, major to
    minor, as the mesh orders them), ``Replicate()`` on the rest. A spec
    shorter than the tensor leaves its last dims whole."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    owner = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"to_placements: {entry!r} is not in the "
                             f"mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"to_placements: axis {a!r} shards dims "
                                 f"{owner[a]} and {d} of {spec}")
            owner[a] = d
            placements[names.index(a)] = Shard(d)
    return placements
