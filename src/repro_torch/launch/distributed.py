"""Multi-process wiring and rank-0 IO gating (twin of
``repro/launch/distributed.py``).

* :func:`initialize` — ``torch.distributed.init_process_group`` from
  arguments or from the environment ``torchrun`` sets (``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``); with no
  coordinator anywhere it is a no-op returning False, as the reference's
  is. The backend follows the device the caller asks for: ``nccl`` with
  ``cuda:LOCAL_RANK`` on the card, ``gloo`` on the CPU. One process runs
  one device; NCCL puts no two ranks on one GPU.
* :func:`is_main` / :func:`main_print` / :func:`main_only` — the rank-0
  gate of every file write and log line (the service's snapshot and
  request-log saves, the telemetry event log, the launch entry points), so a
  multi-process job emits one copy of each artifact. In-memory telemetry
  is not gated: every rank keeps its own registry.
* :func:`main` — the multi-process smoke: run one copy per rank, it checks
  the topology, runs one ``all_reduce`` and one ``all_gather`` across the
  ranks (gloo runs cross-process collectives on the CPU, unlike jax 0.4's
  CPU backend), and rank 0 prints one OK line::

      torchrun --nproc_per_node=2 -m repro_torch.launch.distributed \
          --device cpu
      python -m repro_torch.launch.distributed --device cpu \
          --init-method file:///tmp/store --world-size 2 --rank 0   # and 1

The sharded engines (``fl/client_shard.py``, ``fl/round.py``,
``fl/grid.py``) need an initialised group; they never start one.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import tempfile

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def is_main() -> bool:
    """True on the rank-0 process, and always when ``torch.distributed``
    is not initialised (a single-process run)."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def main_print(*args, **kwargs) -> None:
    """``print`` on the rank-0 process only: the one logging gate, so a
    multi-process run logs once (the reference's)."""
    if is_main():
        print(*args, **kwargs)


def main_only(fn):
    """Run ``fn`` on rank 0 only; other ranks get ``None``. For IO side
    effects that must happen once per job, not for values other ranks
    need (nothing is broadcast)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main():
            return fn(*args, **kwargs)
        return None

    return wrapper


def backend_for(device) -> str:
    """The process-group backend of a device type: nccl for CUDA, gloo for
    the CPU."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {kind!r} "
                         f"(want one of {sorted(BACKENDS)})")
    return BACKENDS[kind]


def check_backend(device) -> None:
    """Raise unless the initialised group's backend is the one of
    ``device`` (nccl for CUDA tensors, gloo for CPU tensors): nothing runs
    a device's collectives on another backend."""
    want = backend_for(device)
    got = dist.get_backend()
    if got != want:
        raise ValueError(f"tensors on {torch.device(device)} need a {want} "
                         f"process group, this one runs {got}")


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               local_rank: int | None = None, device="cuda") -> bool:
    """Initialise ``torch.distributed`` from arguments or the environment.

    ``init_method`` (``tcp://host:port``, ``file:///path`` or ``env://``)
    falls back to ``env://`` when ``MASTER_ADDR`` is set; with neither this
    is a no-op returning False (the single-process path every entry point
    keeps). ``world_size``, ``rank`` and ``local_rank`` fall back to
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (defaults 1, 0 and the
    rank). On ``device="cuda"`` the process takes ``cuda:local_rank`` and
    an nccl group; on ``"cpu"`` a gloo group. A second call returns True
    without initialising again.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env:
            return False
        init_method = "env://"
    world_size = int(env.get("WORLD_SIZE", 1) if world_size is None
                     else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    local_rank = int(env.get("LOCAL_RANK", rank) if local_rank is None
                     else local_rank)
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device of ``device``'s type: ``cuda:LOCAL_RANK`` (the
    device :func:`initialize` set) for CUDA, the CPU otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def process_group(device="cuda"):
    """The examples' group: the environment's (``torchrun``), else a
    one-rank group on a file store in a fresh temporary directory. Yields
    the world size; a group made here is destroyed on exit."""
    if dist.is_initialized() or initialize(device=device):
        yield dist.get_world_size()
        return
    with tempfile.TemporaryDirectory() as tmp:
        initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0, 0, device)
        try:
            yield 1
        finally:
            dist.destroy_process_group()


def main(argv=None) -> int:
    """Multi-process smoke: initialise, check the topology, one
    ``all_reduce`` and one ``all_gather`` across the ranks, and rank 0
    prints the OK line."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default=None,
                    help="tcp://host:port or file:///path (default: the "
                         "torchrun environment)")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    if not initialize(args.init_method, args.world_size, args.rank,
                      device=args.device):
        raise SystemExit("no coordinator: pass --init-method, --world-size "
                         "and --rank, or run under torchrun")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if args.world_size is not None and world != args.world_size:
            raise RuntimeError(f"world size {world} != {args.world_size}")
        if args.rank is not None and rank != args.rank:
            raise RuntimeError(f"rank {rank} != {args.rank}")
        device = local_device(args.device)
        ones = torch.ones(4, device=device)
        dist.all_reduce(ones)
        ranks = torch.empty(world, dtype=torch.int64, device=device)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(ranks, torch.tensor([rank], dtype=torch.int64,
                                   device=device))
        if not (ones == world).all():
            raise RuntimeError(f"all_reduce gave {ones.tolist()}")
        if ranks.tolist() != list(range(world)):
            raise RuntimeError(f"all_gather gave {ranks.tolist()}")
        print(f"[rank {rank}/{world}] backend={dist.get_backend()} "
              f"device={device} all_reduce={ones[0].item():g} "
              f"all_gather={ranks.tolist()} ok", flush=True)
        main_print("MULTIHOST SMOKE OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
