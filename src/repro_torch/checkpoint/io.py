"""Checkpointing: flattened-key npz snapshots of trees of tensors (twin of
``repro/checkpoint/io.py``).

A tree is nested dicts, tuples, lists and NamedTuples with tensors (or
numpy arrays, or numbers) at the leaves. Keys are the reference's
'/'-joined paths: NamedTuple field names, dict keys in sorted order,
tuple and list indices. So an npz written by either package loads in the
other against a template of the same structure.

Dtype contract, as in the reference: npz cannot store bfloat16, so
``save_pytree`` widens bf16 leaves to float32 (lossless) and
``load_pytree`` casts every stored leaf back to the TEMPLATE leaf's dtype.
Templates only need shape and dtype per leaf: :func:`tree_template` gives
``meta`` tensors, which hold no memory.
"""

from __future__ import annotations

import os
from typing import Any, List, Tuple

import numpy as np
import torch

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree: PyTree) -> List[Tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in the reference's leaf order (dict keys
    sorted); ``None`` and empty containers hold no leaves."""
    out = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (k,))
        elif _is_namedtuple(x):
            for name, v in zip(x._fields, x):
                walk(v, path + (name,))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            out.append((path, x))

    walk(tree, ())
    return out


def tree_leaves(tree: PyTree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_structure(tree: PyTree):
    """A hashable description of ``tree``'s containers (leaves as '*'):
    two trees with equal structures take the same leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, tree_structure(tree[k]))
                                 for k in sorted(tree))
    if _is_namedtuple(tree):
        return (type(tree),) + tuple(tree_structure(v) for v in tree)
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(tree_structure(v)
                                              for v in tree)
    return "*"


def tree_unflatten(template: PyTree, leaves) -> PyTree:
    """A tree of ``template``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, dict):
            new = {k: build(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}
        if _is_namedtuple(x):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` applied to every leaf, structure kept."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def tree_template(tree: PyTree) -> PyTree:
    """Shape/dtype skeleton of a tree: ``meta`` tensors, no memory and no
    device transfer."""
    def spec(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")

    return tree_map(spec, tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # npz has no bf16; f32 is lossless
            x = x.to(torch.float32)
        return x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save_pytree(path: str, tree: PyTree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{_key(p): _host(leaf)
                      for p, leaf in tree_flatten_with_path(tree)})


def load_pytree(path: str, template: PyTree) -> PyTree:
    """The tree saved at ``path``, shaped like ``template``: each leaf a
    tensor of the template leaf's dtype, on its device (the CPU for a
    ``meta`` or numpy template)."""
    with np.load(path) as data:
        flat = dict(data)
    leaves = []
    for p, leaf in tree_flatten_with_path(template):
        key = _key(p)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.as_tensor(np.asarray(leaf))
        arr = flat[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for '{key}': "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        device = "cpu" if leaf.device.type == "meta" else leaf.device
        leaves.append(torch.from_numpy(arr).to(device=device,
                                               dtype=leaf.dtype))
    return tree_unflatten(template, leaves)
