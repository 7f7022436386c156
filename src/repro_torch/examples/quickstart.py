"""Quickstart: Algorithm 2 (Lyapunov scheduling) against M-matched uniform
selection on a small wireless FL problem, and the communication-time
saving (twin of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl.simulation import SimConfig, match_uniform_m, run_simulation
from repro_torch.models.registry import make_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    n = 40
    gen = torch.Generator(device=device).manual_seed(0)
    ds = make_cifar10_like(gen, n_clients=n, per_client=64, n_test=400,
                           h=16, w=16, device=device)
    # what federates is a registry choice: SimConfig(model=...) picks
    # "cnn" or "mlp"; the spec's init_fn is bound to the dataset's shapes
    model_params = dict(conv1=8, conv2=16, hidden=32)
    params = make_model("cnn", ds, **model_params).init_fn(gen)
    ch = ChannelConfig(n_clients=n)
    scfg = SchedulerConfig(n_clients=n, model_bits=32 * 50_000.0, lam=10.0,
                           V=1000.0)
    sig = heterogeneous_sigmas(n, device=device)  # 10% bad, 40%, 50% good

    rounds = 12
    base = dict(rounds=rounds, eval_every=rounds - 1, m_cap=6, batch=8,
                local_steps=3, eval_size=400, model="cnn", seed=2,
                model_params=tuple(model_params.items()))

    print("== Algorithm 2 (proposed) ==")
    hp = run_simulation(None, params, ds, SimConfig(policy="proposed", **base),
                        scfg, ch, sig)
    print(f"  final acc {hp['test_acc'][-1]:.3f}, "
          f"comm time {hp['comm_time'][-1]:.1f}s, "
          f"mean devices/round {np.mean(hp['n_selected']):.1f}")

    m = match_uniform_m(torch.Generator(device=device).manual_seed(3), sig,
                        scfg, ch, rounds=150)
    print(f"== Uniform selection (M-matched, M={m:.2f}) ==")
    hu = run_simulation(None, params, ds,
                        SimConfig(policy="uniform", uniform_m=m, **base),
                        scfg, ch, sig)
    print(f"  final acc {hu['test_acc'][-1]:.3f}, "
          f"comm time {hu['comm_time'][-1]:.1f}s")

    saving = 1.0 - hp["comm_time"][-1] / hu["comm_time"][-1]
    print(f"\ncommunication-time saving vs uniform: {saving:.1%} "
          "(paper reports up to 58% at scale)")
    return saving


if __name__ == "__main__":
    main()
