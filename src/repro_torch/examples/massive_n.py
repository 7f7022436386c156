"""Massive-N scheduling: Algorithm 2 at 100,000 clients on a client mesh
(twin of the reference's ``examples/massive_n.py``).

The scheduler needs only instantaneous CSI, so the aggregator re-solves
Theorem 2 for every client every round: the per-round (N,) pipeline is
the hot path at this scale. This runs the scheduling-only runner
(``fl/client_shard.py::make_schedule_runner``: channel -> solve ->
select -> account, no training) with the client axis split over every
rank of the process group, the decision through the fused kernel (K2)
on each shard, and compares the proposed policy with the M-matched
uniform baseline on communication time.

    PYTHONPATH=src python -m repro_torch.examples.massive_n [--device cpu]
    PYTHONPATH=src torchrun --nproc_per_node=2 \
        -m repro_torch.examples.massive_n --device cpu

Without ``torchrun`` it runs one rank. Runs on the card unless
``--device cpu`` is given (one rank a card).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fl.client_shard import make_schedule_runner
from repro_torch.fl.engine import GeneratorDraws
from repro_torch.fl.simulation import match_uniform_m
from repro_torch.launch.distributed import (local_device, main_print,
                                            process_group)

N = 100_000
ROUNDS = 60


def configs(n: int, device):
    """``(scfg, ch, sigmas)``. lam tunes participation (Eq. 17: q ~
    lam^-1/2): the paper's lam = 10 is tuned for N ~ 3,600, and at N =
    10^5 it selects so few clients that the M-matched baseline's
    P = Pbar N / M' would exceed Pmax; lam = 0.3 keeps the baseline inside
    the peak-power constraint the proposed policy respects."""
    return (SchedulerConfig(n_clients=n, model_bits=32 * 555178.0, lam=0.3),
            ChannelConfig(n_clients=n), heterogeneous_sigmas(n, device=device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--match-rounds", type=int, default=150)
    args = ap.parse_args(argv)
    with process_group(args.device) as world:
        device = local_device(args.device)
        n = args.n
        main_print(f"ranks: {world}; clients: {n}")
        scfg, ch, sig = configs(n, device)
        t0 = time.perf_counter()
        m = match_uniform_m(torch.Generator(device=device).manual_seed(1),
                            sig, scfg, ch, rounds=args.match_rounds)
        main_print(f"matched M = {m:.1f}  ({time.perf_counter() - t0:.1f}s "
                   f"Monte-Carlo)")
        draws = GeneratorDraws(0, n, (1, 1, 1), 1, device=device)
        out = {}
        for policy in ("proposed", "uniform"):
            runner = make_schedule_runner(
                sig, scfg, ch, rounds=args.rounds, policy=policy, m_avg=m,
                solver="cuda_fused", client_shards=world)
            t0 = time.perf_counter()
            [x.cpu() for x in runner(draws)]
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            t_comm, power, n_sel = (x.cpu() for x in runner(draws))
            wall = time.perf_counter() - t0
            out[policy] = dict(t_comm=t_comm, power=power, n_sel=n_sel,
                               rounds_per_s=args.rounds / wall)
            main_print(f"{policy:>9}: {args.rounds / wall:6.1f} rounds/s on "
                       f"{world} rank(s) (first run {first_s:.1f}s), mean "
                       f"participants/round "
                       f"{n_sel.to(torch.float64).mean():.1f}")
        comm = {p: float(o["t_comm"].sum()) for p, o in out.items()}
        pw = {p: float(o["power"].mean()) / n for p, o in out.items()}
        ratio = comm["proposed"] / comm["uniform"]
        main_print(f"\ncumulative comm time after {args.rounds} rounds:")
        for p in out:
            main_print(f"  {p:9s}{comm[p]:10.1f} s   (avg power/client "
                       f"{pw[p]:.3f})")
        main_print(f"  proposed/uniform ratio = {ratio:.3f} (lower is "
                   f"better; the paper's headline, at N = {n})")
    return dict(out, ratio=ratio, uniform_m=m, ranks=world)


if __name__ == "__main__":
    main()
