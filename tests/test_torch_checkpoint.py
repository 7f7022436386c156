"""The port's ``checkpoint/io.py`` (twin of ``repro/checkpoint/io.py``):
round trips of mixed float32 / int32 / bfloat16 trees of dicts, tuples
and NamedTuples, and npz interchange with the reference in both
directions. Every comparison is exact: npz stores the values, bf16 is
widened to f32 losslessly and cast back to the template's dtype."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch.checkpoint.io import (load_pytree, save_pytree,  # noqa: E402
                                       tree_leaves, tree_template)


@pytest.fixture(scope="module")
def ref():
    return reference()


class Pair(NamedTuple):
    w: object
    step: object


def port_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "layer": Pair(w=torch.randn(3, 4, generator=g),
                      step=torch.tensor(7, dtype=torch.int32)),
        "bf": torch.randn(5, generator=g).to(torch.bfloat16),
        "a_list": (torch.arange(6, dtype=torch.int32).reshape(2, 3),
                   torch.zeros((), dtype=torch.float32)),
    }


def assert_trees_equal(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_round_trip_mixed_dtypes(tmp_path):
    tree = port_tree()
    path = str(tmp_path / "ck" / "tree.npz")
    save_pytree(path, tree)
    with np.load(path) as data:
        keys = sorted(data.files)
        assert data["bf"].dtype == np.float32
    assert keys == ["a_list/0", "a_list/1", "bf", "layer/step", "layer/w"]
    template = tree_template(tree)
    assert all(x.device.type == "meta" for x in tree_leaves(template))
    got = load_pytree(path, template)
    assert isinstance(got["layer"], Pair)
    assert_trees_equal(got, tree)


def test_load_rejects_missing_and_misshapen_leaves(tmp_path):
    path = str(tmp_path / "tree.npz")
    save_pytree(path, {"x": torch.ones(3)})
    with pytest.raises(KeyError):
        load_pytree(path, {"y": torch.ones(3)})
    with pytest.raises(ValueError):
        load_pytree(path, {"x": torch.ones(4)})


def to_jax(ref, tree):
    jnp = ref.jnp

    def conv(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.to(torch.float32).numpy()).astype(
                jnp.bfloat16)
        return jnp.asarray(x.numpy())

    return {"layer": Pair(w=conv(tree["layer"].w),
                          step=conv(tree["layer"].step)),
            "bf": conv(tree["bf"]),
            "a_list": tuple(conv(x) for x in tree["a_list"])}


def from_jax(tree):
    def conv(x):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                torch.bfloat16)
        return torch.from_numpy(arr.copy())

    return {"layer": Pair(w=conv(tree["layer"].w),
                          step=conv(tree["layer"].step)),
            "bf": conv(tree["bf"]),
            "a_list": tuple(conv(x) for x in tree["a_list"])}


def test_npz_interchange_with_reference(ref, tmp_path):
    """An npz written by the port loads through the reference's
    load_pytree, and one written by the reference loads through the
    port's, exactly, bf16 leaves included."""
    from repro.checkpoint import io as ref_io
    tree = port_tree(1)
    jtree = to_jax(ref, tree)

    path = str(tmp_path / "from_port.npz")
    save_pytree(path, tree)
    got = ref_io.load_pytree(path, ref_io.tree_template(jtree))
    assert_trees_equal(from_jax(got), tree)

    path = str(tmp_path / "from_ref.npz")
    ref_io.save_pytree(path, jtree)
    got = load_pytree(path, tree_template(tree))
    assert_trees_equal(got, tree)
