"""Scenario grid: the Fig. 3-6 comparison space in one call (twin of the
reference's ``examples/scenario_grid.py``).

Runs 2 fading models x 1 sigma mix x 3 policies x 3 seeds, 18 full
simulated FL trajectories, through :func:`repro_torch.fl.grid.run_grid`
(on one card the configs run one after another).

    PYTHONPATH=src python -m repro_torch.examples.scenario_grid [--device cpu]
        [--rounds 40]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl import GridSpec, SimConfig, match_uniform_m, run_grid
from repro_torch.models.registry import make_model

N = 64          # clients (small, so the demo takes about a minute on a CPU)
CNN = dict(conv1=8, conv2=16, hidden=64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    ds = make_cifar10_like(gen, n_clients=N, per_client=64, n_test=512,
                           h=16, w=16, device=device)
    params = make_model("cnn", ds, **CNN).init_fn(gen)
    ch = ChannelConfig(n_clients=N)
    scfg = SchedulerConfig(n_clients=N, model_bits=32 * 50000.0, lam=10.0)

    # One matched M serves every cell, so the grid sweeps only the sigma
    # mix it was matched under; gauss_markov shares Rayleigh's stationary
    # gain law, so the M transfers across the channel axis.
    m = match_uniform_m(torch.Generator(device=device).manual_seed(2),
                        heterogeneous_sigmas(N, device=device), scfg, ch)
    print(f"matched M = {m:.2f}")

    spec = GridSpec(
        channels=("rayleigh", ("gauss_markov", (("rho", 0.9),))),
        sigma_dists=("heterogeneous",),
        policies=("proposed", "uniform", "update_aware"),
        seeds=(0, 1, 2),
    )
    sim = SimConfig(rounds=args.rounds, eval_every=10, m_cap=16, batch=16,
                    local_steps=5, eval_size=512, uniform_m=m,
                    model_params=tuple(CNN.items()))

    t0 = time.perf_counter()
    g = run_grid(None, params, ds, sim, scfg, ch, spec)
    wall = time.perf_counter() - t0
    print(f"{spec.size} configs x {args.rounds} rounds in {wall:.1f} s on "
          f"{g['n_devices']} device\n")

    print(f"{'channel':>13} {'sigmas':>14} {'policy':>13} "
          f"{'acc':>6} {'comm_s':>8} {'avgP':>6}")
    for ci, cname in enumerate(g["channels"]):
        for si, sname in enumerate(g["sigma_dists"]):
            for pi, pname in enumerate(g["policies"]):
                acc = g["test_acc"][ci, si, pi, :, -1].mean()
                comm = g["comm_time"][ci, si, pi, :, -1].mean()
                pw = g["avg_power"][ci, si, pi, :, -1].mean()
                print(f"{cname:>13} {sname:>14} {pname:>13} "
                      f"{acc:6.3f} {comm:8.2f} {pw:6.2f}")

    print("\nproposed/uniform comm-time ratio (lower is better):")
    for ci, cname in enumerate(g["channels"]):
        for si, sname in enumerate(g["sigma_dists"]):
            r = (g["comm_time"][ci, si, 0, :, -1].mean()
                 / g["comm_time"][ci, si, 1, :, -1].mean())
            print(f"  {cname:>13} x {sname:<14} {r:.3f}")
    return g


if __name__ == "__main__":
    main()
