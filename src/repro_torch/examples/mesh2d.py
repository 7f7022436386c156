"""The composed 2D mesh: client x participant sharding in one round (twin
of the reference's ``examples/mesh2d.py``).

Runs one federated simulation twice: on the sequential engine, and with
both sharded paths composed on one ``(client_shards,
participant_shards)`` mesh of ranks. The schedule splits the N-client
decision state over each column's ``'client'`` group while the packed
participants' local SGD splits over each row's ``'part'`` group; the
selection counts match exactly and the float trajectories agree to
roundoff.

    PYTHONPATH=src torchrun --nproc_per_node=4 \
        -m repro_torch.examples.mesh2d --device cpu
    PYTHONPATH=src python -m repro_torch.examples.mesh2d [--device cpu]

The mesh is the widest client axis the world size factors into; without
``torchrun`` it is one rank, mesh (1, 1). Runs on the card unless
``--device cpu`` is given (one rank a card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl.sharding import ACCOUNT_BLOCKS
from repro_torch.fl.simulation import SimConfig, run_simulation
from repro_torch.launch.distributed import (local_device, main_print,
                                            process_group)
from repro_torch.models.registry import make_model


def pick_mesh(world: int):
    """The (client_shards, participant_shards) of ``world`` ranks,
    preferring the widest client axis (client_shards must divide 96)."""
    for dc, dp in ((4, 2), (2, 2), (2, 1), (1, 1)):
        if dc * dp == world:
            return dc, dp
    return (world, 1) if ACCOUNT_BLOCKS % world == 0 else (1, world)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    n = 48
    with process_group(args.device) as world:
        device = local_device(args.device)
        gen = torch.Generator(device=device).manual_seed(0)
        ds = make_cifar10_like(gen, n_clients=n, per_client=48, n_test=256,
                               h=8, w=8, device=device)
        params = make_model("mlp", ds).init_fn(gen)
        scfg = SchedulerConfig(n_clients=n, model_bits=32 * 50_000.0)
        ch = ChannelConfig(n_clients=n)
        sig = heterogeneous_sigmas(n, device=device)
        base = dict(rounds=8, eval_every=4, m_cap=6, batch=8, local_steps=2,
                    eval_size=256, model="mlp", seed=2)
        dc, dp = pick_mesh(world)
        hist = {}
        for label, sim in (("sequential", SimConfig(**base)),
                           (f"2D mesh ({dc}, {dp})",
                            SimConfig(client_shards=dc, participant_shards=dp,
                                      **base))):
            h = run_simulation(None, params, ds, sim, scfg, ch, sig)
            hist[label] = h
            main_print(f"{label:20s} acc {h['test_acc'][0]:.3f} -> "
                       f"{h['test_acc'][-1]:.3f}, comm "
                       f"{h['comm_time'][-1]:.1f}s, selected/round "
                       f"{h['n_selected'].mean():.2f}")
        a, b = hist.values()
        np.testing.assert_array_equal(a["n_selected"], b["n_selected"])
        np.testing.assert_allclose(a["comm_time"], b["comm_time"], rtol=3e-7)
        main_print(f"parity: n_selected exact, comm_time to ~1 ulp on a "
                   f"({dc}, {dp}) mesh over {world} rank(s)")
    return hist


if __name__ == "__main__":
    main()
