"""``repro_torch.sharding`` against the reference's ``repro.sharding``.

``param_pspecs`` of every id at full size: the port's ``LM`` built on the
``meta`` device (``init_params(..., device="meta")``, no memory) against
the reference's rules over ``jax.eval_shape(init_params)``, leaf for
leaf, without axis sizes (the raw rules) and with the sizes of the
production and debug meshes (the divisibility fix-up), FSDP on and off.
A reference leaf stacked over the periods (or the encoder's layers) is
each of the port's layers of that slot, its spec with the stacked entry
(None) dropped. Specs are compared exactly, entry for entry.
Then ``batch_pspec`` / ``serve_batch_pspec`` and ``to_placements`` on a
DeviceMesh over a fake process group.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402

# the meshes of repro/launch/mesh.py: production single and multi pod,
# debug single and multi pod
AXIS_SIZES = [None, {"data": 16, "model": 16},
              {"pod": 2, "data": 16, "model": 16},
              {"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2}]


@pytest.fixture(scope="module")
def ref():
    r = reference()
    import importlib
    r.rules = importlib.import_module("repro.sharding.rules")
    return r


def port_names(ref, path, cfg):
    """The port's parameter names of one reference leaf: a period- or
    encoder-stacked leaf is one name per layer."""
    keys = []
    for e in path:
        if isinstance(e, ref.jax.tree_util.SequenceKey):
            keys.append(str(e.idx))
        else:
            keys.append(str(e.key))
    prefix, period, n_periods = cfg.period_decomposition()
    if keys[0] == "prefix":
        return ["layers." + ".".join(keys[1:])], False
    if keys[0] == "period":
        k = int(keys[1][len("layer"):])
        return [f"layers.{len(prefix) + p * len(period) + k}."
                + ".".join(keys[2:]) for p in range(n_periods)], True
    if keys[0] == "encoder":
        return [f"encoder.{p}." + ".".join(keys[2:])
                for p in range(cfg.n_encoder_layers)], True
    return [".".join(keys)], False


def check_param_pspecs(ref, cfg, rcfg, fsdp) -> set:
    """``param_pspecs`` of ``cfg``'s LM, built on meta, against the
    reference's rules over ``jax.eval_shape`` of its ``init_params`` on
    ``rcfg``, leaf for leaf at every ``AXIS_SIZES``; returns the port's
    names seen (every parameter)."""
    lm = M.init_params(torch.Generator(), cfg, device="meta")
    assert all(p.device.type == "meta" for p in lm.parameters())
    shapes = ref.jax.eval_shape(
        lambda key: ref.model.init_params(key, rcfg),
        ref.jax.random.PRNGKey(0))
    flat, _ = ref.jax.tree_util.tree_flatten_with_path(shapes)
    own = dict(lm.named_parameters())
    seen = set()
    for sizes in AXIS_SIZES:
        mode = R.ShardingMode(tensor_axis="model",
                              fsdp_axis="data" if fsdp else None)
        rmode = ref.rules.ShardingMode(tensor_axis="model",
                                       fsdp_axis="data" if fsdp else None)
        got = R.param_pspecs(lm, mode, sizes)
        assert got == R.param_pspecs(own, mode, sizes, cfg=cfg)
        want = ref.rules.param_pspecs(shapes, rmode, sizes)
        wflat, _ = ref.jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, ref.rules.P))
        for (path, leaf), (_, spec) in zip(flat, wflat, strict=True):
            names, stacked = port_names(ref, path, cfg)
            spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
            if stacked:
                assert spec[0] is None, (path, spec)
                spec = spec[1:]
            for name in names:
                assert tuple(own[name].shape) == (
                    leaf.shape[1:] if stacked else leaf.shape), name
                assert tuple(got[name]) == spec, (name, sizes, got[name],
                                                  spec)
                seen.add(name)
    assert seen == set(own)
    return seen


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspecs_match_reference(ref, arch, fsdp):
    check_param_pspecs(ref, configs.get_config(arch),
                       ref.configs.get_config(arch), fsdp)


def test_batch_pspec_matches_reference(ref):
    for fsdp in (None, "data"):
        for axes in (("data",), (), ("pod",)):
            mode = R.ShardingMode(fsdp_axis=fsdp, data_axes=axes)
            rmode = ref.rules.ShardingMode(fsdp_axis=fsdp, data_axes=axes)
            for client_dim in (False, True):
                got = R.batch_pspec(mode, client_dim=client_dim)
                want = ref.rules.batch_pspec(rmode, client_dim=client_dim)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}
            assert {k: tuple(v) for k, v in
                    R.serve_batch_pspec(mode).items()} == {
                k: tuple(v) for k, v in
                ref.rules.serve_batch_pspec(rmode).items()}


@pytest.mark.parametrize("fsdp,want", [(None, (None, "model")),
                                       ("data", (None, "data"))])
def test_sanitize_rehomes_odd_vocab(ref, fsdp, want):
    """minicpm's 122,753-token embedding loses 'model' on the vocab dim;
    without FSDP 'model' moves to d_model, with it d_model is taken and
    'model' is dropped, as the reference's fix-up does."""
    sizes = {"data": 16, "model": 16}
    spec = R._sanitize(R.P("model", fsdp), (122753, 2304), sizes)
    assert tuple(spec) == tuple(ref.rules._sanitize(
        ref.rules.P("model", fsdp), (122753, 2304), sizes)) == want


def test_stacked_axis_plan_is_refused():
    """A plan that puts a mesh axis on the reference's stacked layer axis
    raises by name."""
    cfg = configs.get_config("yi-6b")
    # a 1-D leaf of 7 (undividable) in a 32-layer period: the dropped
    # 'model' re-homes onto the stacked axis of 32
    with pytest.raises(ValueError, match="stacked axis of 32"):
        R.leaf_pspec("layers.3.mixer.conv_b", (7,), R.ShardingMode(), cfg,
                     {"model": 16})


def test_to_placements_on_a_fake_mesh(tmp_path):
    """Placements of a spec on a (2, 4, 4) DeviceMesh over a fake process
    group (in a subprocess: a process has one default group), and
    distribute_tensor's local shape on meta."""
    import subprocess
    import sys
    code = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Shard, Replicate
from repro_torch.sharding import to_placements, PartitionSpec as P
dist.init_process_group("fake", rank=0, world_size=32, store=FakeStore())
mesh = init_device_mesh("cpu", (2, 4, 4), mesh_dim_names=("pod", "data", "model"))
pl = to_placements(P(("pod", "data"), "model"), mesh)
assert pl == [Shard(0), Shard(0), Shard(1)], pl
pl = to_placements(P(None, "model"), mesh)
assert pl == [Replicate(), Replicate(), Shard(1)], pl
t = torch.empty((64, 48), device="meta")
d = distribute_tensor(t, mesh, to_placements(P(("pod", "data"), "model"), mesh))
assert tuple(d.to_local().shape) == (8, 12), d.to_local().shape
try:
    to_placements(P("model", "model"), mesh)
except ValueError:
    pass
else:
    raise AssertionError("an axis on two dims was accepted")
print("ok")
"""
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(__import__("pathlib").Path(__file__).resolve().parents[1]
             / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
