"""Gloo ranks for the port's multi-device tests (holds no tests).

:func:`spawn` starts ``world`` CPU processes, joins them into one gloo
process group through a ``file://`` store under the test's ``tmp_path``
(a fixed TCP port would collide between test workers), runs one function
in each rank and returns what each rank returned. The function is named
by module and attribute, so a test file keeps its rank bodies beside its
tests; each body runs every case of its world shape in one spawn and
returns plain values or numpy arrays. Ranks run one CPU thread each and
import neither JAX nor the reference: parity inputs recorded from the
reference travel to them as numpy arrays.
"""

from __future__ import annotations

import importlib
import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240


def _rank_main(rank: int, world: int, store: str, module: str, name: str,
               args: tuple, out_dir: str):
    torch.set_num_threads(1)
    from repro_torch.launch.distributed import initialize
    import torch.distributed as dist
    initialize(f"file://{store}", world, rank, device="cpu")
    try:
        out = getattr(importlib.import_module(module), name)(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """``world`` started ranks; :meth:`results` waits for them."""

    def __init__(self, tmp_path, world: int, module: str, name: str,
                 args: tuple):
        self.world, self.what = world, f"{module}.{name}"
        self.dir = tmp_path / f"world{world}_{name}_{time.monotonic_ns()}"
        self.dir.mkdir()
        self.ctx = mp.start_processes(
            _rank_main, args=(world, str(self.dir / "store"), module, name,
                              args, str(self.dir)),
            nprocs=world, join=False, start_method="spawn")
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S

    def results(self) -> list:
        """What each rank returned, in rank order (raises if a rank
        failed or the ranks outlive ``SPAWN_TIMEOUT_S``)."""
        while not self.ctx.join(timeout=1.0):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.terminate()
                raise TimeoutError(f"{self.world} ranks of {self.what} did "
                                   f"not finish in {SPAWN_TIMEOUT_S} s")
        out = []
        for rank in range(self.world):
            with open(self.dir / f"rank{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


def start(tmp_path, world: int, module: str, name: str, *args) -> Ranks:
    """Start ``module.name(*args)`` on each of ``world`` fresh processes in
    one gloo group of ``world`` ranks; the caller works on meanwhile."""
    return Ranks(tmp_path, world, module, name, args)


def spawn(tmp_path, world: int, module: str, name: str, *args) -> list:
    """``[module.name(*args) on rank r for r in range(world)]``."""
    return start(tmp_path, world, module, name, *args).results()


def numpy_images(n: int, seed: int, per_client: int = 32, n_test: int = 128,
                 h: int = 8, w: int = 8, c: int = 3,
                 n_classes: int = 10) -> tuple:
    """A seeded CIFAR-like federated problem as host arrays
    ``(client_images, client_labels, test_images, test_labels,
    n_classes)``: noisy class templates, i.i.d. labels. Both packages
    build their dataset from it (the port's ``from_numpy``, the
    reference's ``FederatedDataset`` through :func:`reference_dataset`)."""
    rng = np.random.default_rng(seed)
    tmpl = rng.normal(size=(n_classes, h, w, c)).astype(np.float32)

    def render(labels):
        noise = rng.normal(size=labels.shape + (h, w, c)).astype(np.float32)
        return tmpl[labels] + np.float32(0.8) * noise

    labels = rng.integers(0, n_classes, (n, per_client)).astype(np.int32)
    test = rng.integers(0, n_classes, (n_test,)).astype(np.int32)
    return render(labels), labels, render(test), test, n_classes


def reference_dataset(ref, arrays: tuple):
    """The reference's ``FederatedDataset`` on :func:`numpy_images`'
    arrays."""
    jnp = ref.jnp
    imgs, labels, test_imgs, test_labels, n_classes = arrays
    return ref.synthetic.FederatedDataset(
        client_images=jnp.asarray(imgs), client_labels=jnp.asarray(labels),
        test_images=jnp.asarray(test_imgs),
        test_labels=jnp.asarray(test_labels), n_classes=n_classes)
