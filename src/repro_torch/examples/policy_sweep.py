"""Policy x seed scheduling sweep (the comm-time, power and participation
axes of Figs. 2-5; twin of the reference's ``examples/policy_sweep.py``).

Runs Algorithm 2 against the M-matched uniform baseline over several seeds
with :func:`repro_torch.fl.engine.run_sweep`: Rayleigh draws, the Theorem-2
solve (on the card, one solve-kernel launch per round for every seed),
Bernoulli selection, Eq. (9) queue updates, TDMA comm-time and power
accounting.

    PYTHONPATH=src python -m repro_torch.examples.policy_sweep [--device cpu]
        [--femnist]

``--femnist`` sweeps the paper's FEMNIST network (N = 3,597, the paper's
500/1,500/1,597 sigma split) instead of CIFAR-10's N = 100. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import cifar10_cnn, femnist_cnn
from repro_torch.core.channel import heterogeneous_sigmas, resolve_sigmas
from repro_torch.fl.engine import run_sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--femnist", action="store_true")
    ap.add_argument("--rounds", type=int, default=300)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rounds = args.rounds
    seeds = (0, 1, 2, 3)
    exp = femnist_cnn.CONFIG if args.femnist else cifar10_cnn.CONFIG
    n = exp.n_clients
    ch, scfg = exp.channel(), exp.scheduler(lam=10.0)
    sig = (resolve_sigmas(femnist_cnn.paper_sigmas(), n, device=device)
           if args.femnist else heterogeneous_sigmas(n, device=device))

    sw = run_sweep(None, sig, scfg, ch, rounds=rounds, seeds=seeds)
    print(f"{exp.name}: N={n}, rounds={rounds}, seeds={list(seeds)}, "
          f"matched M={float(sw['uniform_m']):.2f}\n")

    comm = sw["comm_time"][:, :, -1]          # (policy, seed) final comm time
    nsel = sw["n_selected"].mean(axis=-1)     # mean devices per round
    pwr = sw["avg_power"][:, :, -1]           # running avg of sum P q / N
    for i, pol in enumerate(sw["policies"]):
        print(f"{pol:>9}: comm {comm[i].mean():8.1f}s "
              f"(+/- {comm[i].std():.1f}), "
              f"devices/round {nsel[i].mean():5.2f}, "
              f"avg power {pwr[i].mean():.3f} (Pbar={ch.p_bar})")

    saving = 1.0 - comm[0].mean() / comm[1].mean()
    print(f"\ncommunication-time saving vs uniform: {saving:.1%} "
          "(paper reports up to 58% at scale)")
    # Fig. 5 flavor: the proposed policy's time-average power approaches Pbar
    tail = sw["avg_power"][0, :, rounds // 2:].mean()
    print(f"proposed time-average power over the last half: {tail:.3f}")
    return saving


if __name__ == "__main__":
    main()
