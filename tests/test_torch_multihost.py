"""Multi-process wiring of the port (the twin of tests/test_multihost.py).

* ``launch/distributed.py`` in one process: ``initialize`` is a no-op
  returning False with no coordinator, the rank-0 gates pass everything
  through, ``backend_for`` maps the device to its backend;
* the CLI smoke in two real processes (``python -m
  repro_torch.launch.distributed`` on a ``file://`` store): topology, one
  cross-process all_reduce and all_gather, one OK line from rank 0;
* in a 2-rank gloo group: ``is_main`` / ``main_only`` per rank; the
  service's snapshot save (``TenantStore.save``) and request-log save
  (``RequestLog.save``) write only on rank 0, the same bytes as a
  single-process save; the scenario grid's config axis split over the two
  ranks (3 seeds a cell: rank 1's block is padded) equals the one-process
  grid bit for bit, with ``n_devices`` 2.

Unlike jax 0.4's CPU backend, gloo runs the cross-process collectives
themselves, so the two-process legs run them for real.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_ranks import spawn

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl.engine import SimConfig
from repro_torch.fl.grid import GridSpec, run_grid
from repro_torch.launch import distributed
from repro_torch.models.registry import make_model
from repro_torch.service import SchedulerService

SRC = Path(__file__).resolve().parents[1] / "src"
N_SVC = 8
GRID_N = 16
GRID_SIM = dict(rounds=3, eval_every=2, m_cap=4, batch=4, local_steps=2,
                eval_size=32, model="mlp", uniform_m=4.0)
GRID_SPEC = dict(policies=("proposed", "uniform"), seeds=(0, 1, 2))


def _service_run(out_dir: Path, tag: str):
    """Serve two flushes of one tenant, then save the snapshot and the
    request log under ``tag``."""
    svc = SchedulerService(solver="stitched", device="cpu")
    svc.add_tenant("a", SchedulerConfig(n_clients=N_SVC, model_bits=1e5),
                   ChannelConfig(n_clients=N_SVC))
    rng = np.random.default_rng(0)
    for _ in range(2):
        gains = rng.uniform(0.1, 2.0, N_SVC).astype(np.float32)
        svc.submit("a", gains, raw=rng.random(N_SVC, dtype=np.float32))
        svc.flush()
    svc.save(str(out_dir / f"state_{tag}.npz"))
    svc.log.save(str(out_dir / f"log_{tag}.npz"))


def _grid():
    gen = torch.Generator().manual_seed(0)
    ds = make_cifar10_like(gen, n_clients=GRID_N, per_client=16, n_test=32,
                           h=4, w=4, device="cpu")
    params = make_model("mlp", ds).init_fn(gen)
    return run_grid(None, params, ds, SimConfig(**GRID_SIM),
                    SchedulerConfig(n_clients=GRID_N, model_bits=1e5),
                    ChannelConfig(n_clients=GRID_N), GridSpec(**GRID_SPEC))


def multihost_ranks(out_dir):
    """Rank body of the 2-rank group."""
    rank = dist.get_rank()
    _service_run(Path(out_dir), f"rank{rank}")
    return dict(is_main=distributed.is_main(),
                main_only=distributed.main_only(lambda: rank)(),
                grid=_grid())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    return out, spawn(out, 2, __name__, "multihost_ranks", str(out))


def test_single_process_gates(monkeypatch, capsys):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert distributed.initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert distributed.is_main()
    assert distributed.main_only(lambda x: x + 1)(1) == 2
    distributed.main_print("hello")
    assert capsys.readouterr().out == "hello\n"
    assert distributed.backend_for("cpu") == "gloo"
    assert distributed.backend_for("cuda:3") == "nccl"
    with pytest.raises(ValueError, match="backend"):
        distributed.backend_for("meta")


def test_two_process_cli(tmp_path):
    """``python -m repro_torch.launch.distributed`` on two processes."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.distributed",
         "--device", "cpu", "--init-method", store, "--world-size", "2",
         "--rank", str(r)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(out)
    for r, out in enumerate(outs):
        assert (f"[rank {r}/2] backend=gloo device=cpu all_reduce=2 "
                f"all_gather=[0, 1] ok") in out
    assert outs[0].count("MULTIHOST SMOKE OK") == 1
    assert "MULTIHOST SMOKE OK" not in outs[1]


def test_rank_gates(two_ranks):
    _, ranks = two_ranks
    assert [r["is_main"] for r in ranks] == [True, False]
    assert [r["main_only"] for r in ranks] == [0, None]


def test_saves_are_rank0_gated(two_ranks, tmp_path):
    """Rank 1 writes no file; rank 0 writes the single-process bytes."""
    out, _ = two_ranks
    assert not dist.is_initialized()
    _service_run(tmp_path, "single")
    for kind in ("state", "log"):
        assert not (out / f"{kind}_rank1.npz").exists(), kind
        assert (out / f"{kind}_rank0.npz").read_bytes() == (
            tmp_path / f"{kind}_single.npz").read_bytes(), kind


def test_grid_on_two_ranks_equals_one(two_ranks):
    _, ranks = two_ranks
    want = _grid()
    assert want["n_devices"] == 1
    for got in (r["grid"] for r in ranks):
        assert got["n_devices"] == 2
        assert got["comm_time"].shape == (1, 1, 2, 3, 2)
        for k in ("round", "comm_time", "test_acc", "avg_power",
                  "n_selected", "seeds"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["policies"] == want["policies"]
