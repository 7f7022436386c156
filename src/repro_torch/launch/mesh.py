"""Production mesh construction (twin of ``repro/launch/mesh.py``).

Functions, never module-level meshes: importing this module touches no
process group. Each returns a ``torch.distributed`` ``DeviceMesh`` over
the default process group, which must span the mesh's devices: the real
group of a ``torchrun`` job, or the fake group of ``launch/dryrun.py``
(``REPRO_DRYRUN_DEVICES`` ranks in one process).

Mesh shapes, the reference's (TPU v5e pods):
  single-pod : (data=16, model=16)            = 256 devices
  multi-pod  : (pod=2, data=16, model=16)     = 512 devices
  debug      : (data=2, model=4) and (pod=2, data=2, model=2), 8 devices

The ``pod`` axis is the paper's client axis: each pod is one federated
participant.
"""

from __future__ import annotations


def _mesh(shape, axes, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Small mesh for tests' dry runs (8 devices)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)
