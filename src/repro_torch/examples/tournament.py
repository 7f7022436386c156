"""Policy tournament under adversarial wireless scenarios (twin of the
reference's ``examples/tournament.py``).

Stresses the whole policy registry where Algorithm 2's assumptions break
(device churn, correlated outage bursts, post-selection straggler
failures) and scores every policy against the per-scenario oracle
(accuracy regret) and on time-to-accuracy, through
:func:`repro_torch.fl.tournament.run_tournament`.

Reading the table: the regret is ACCURACY regret at a short horizon,
which favours the M-matched uniform baseline (its q = M/N weights make
every round a full-mass average step), while Algorithm 2 spends its
selection budget on comm time and energy, the axis the paper optimises.
The p_fail scenarios hit every policy: the server cannot see the failure
rate, so the 1/q weights under-count the delivered mass by (1 - p_fail).

    PYTHONPATH=src python -m repro_torch.examples.tournament [--device cpu]
        [--rounds 40]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl import SimConfig, match_uniform_m, run_tournament
from repro_torch.models.registry import make_model

N = 64          # clients (small, so the demo takes about a minute on a CPU)
CNN = dict(conv1=8, conv2=16, hidden=64)
SCENARIOS = dict(
    # benign fading and bursty outages (Gilbert-Elliott: ~20% of rounds in
    # a deep fade lasting ~4 rounds)
    channels=("rayleigh",
              ("outage_burst", (("outage_p", 0.2), ("burst_len", 4.0)))),
    # all-active | a churning fleet | 25% straggler failures
    populations=((),
                 (("p_leave", 0.1), ("p_join", 0.2)),
                 (("p_fail", 0.25),)),
    policies=("proposed", "uniform", "greedy_channel"),
    seeds=(0, 1, 2),
)


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
    m = match_uniform_m(torch.Generator(device=device).manual_seed(2),
                        heterogeneous_sigmas(N, device=device), scfg, ch)
    print(f"matched M = {m:.2f}")
    sim = SimConfig(rounds=args.rounds, eval_every=10, m_cap=16, batch=16,
                    local_steps=5, eval_size=512, uniform_m=m,
                    model_params=tuple(CNN.items()))

    t0 = time.perf_counter()
    t = run_tournament(None, params, ds, sim, scfg, ch, **SCENARIOS)
    wall = time.perf_counter() - t0
    print(f"{t['regret_acc'].size} configs x {args.rounds} rounds in "
          f"{wall:.1f} s on {t['n_devices']} device\n")

    pop_names = ["all-active" if not p else
                 ",".join(f"{k}={v:g}" for k, v in p.items())
                 for p in t["populations"]]
    print(f"{'channel':>13} {'population':>22} {'policy':>15} "
          f"{'acc':>6} {'regret':>7} {'tta_s':>8}")
    for ci, cname in enumerate(t["channels"]):
        for gi, gname in enumerate(pop_names):
            for pi, pname in enumerate(t["policies"]):
                acc = t["final_acc"][ci, gi, 0, pi].mean()
                reg = t["regret_acc"][ci, gi, 0, pi].mean()
                tta = t["time_to_acc"][ci, gi, 0, pi]
                tta = tta[np.isfinite(tta)]
                tta_s = f"{tta.mean():8.2f}" if tta.size else "   never"
                print(f"{cname:>13} {gname:>22} {pname:>15} "
                      f"{acc:6.3f} {reg:7.4f} {tta_s}")

    print("\nleaderboard (mean over every scenario x seed):")
    for row in t["leaderboard"]:
        print(f"  {row['policy']:>15}  regret_acc={row['mean_regret_acc']:.4f}"
              f"  oracle_wins={row['oracle_wins']}"
              f"  unreached={row['unreached']}")
    return t


if __name__ == "__main__":
    main()
