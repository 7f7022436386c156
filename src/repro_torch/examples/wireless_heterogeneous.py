"""Deep-dive example: the scheduler's internals under heterogeneous
channels (twin of the reference's ``examples/wireless_heterogeneous.py``).

Shows, per round: the channel draws, the virtual queues, the (q, P)
solution, who got selected, the round's TDMA uplink time, and the
Corollary-1 bound accumulator: everything the paper's Section V machinery
produces. The draws come from a ``torch.Generator`` on the device, not
the reference's PRNG key, so the numbers are the same kind, not the same
values.

    PYTHONPATH=src python -m repro_torch.examples.wireless_heterogeneous \\
        [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (BoundConstants, ChannelConfig, SchedulerConfig,
                              accumulate, corollary1_bound, draw_gains,
                              heterogeneous_sigmas, init_accumulator,
                              init_state, schedule_step, uplink_time, y0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    n = 12
    ch = ChannelConfig(n_clients=n)
    cfg = SchedulerConfig(n_clients=n, model_bits=32 * 444_062.0, lam=10.0,
                          V=1000.0)
    sig = heterogeneous_sigmas(n, device=device)
    state = init_state(cfg, device)
    acc = init_accumulator(device)
    g_ch = torch.Generator(device=device).manual_seed(0)
    g_sel = torch.Generator(device=device).manual_seed(1)

    print(f"clients: {n}, sigmas: {[f'{s:.2f}' for s in sig.tolist()]}")
    for t in range(args.rounds):
        gains = draw_gains(g_ch, sig, ch)
        sel, q, p, state = schedule_step(g_sel, gains, state, cfg, ch)
        acc = accumulate(acc, q)
        t_up = uplink_time(gains, p, sel, cfg.model_bits, ch)
        obj = y0(q, p, gains, cfg, ch)
        picked = [i for i, s in enumerate(sel.tolist()) if s]
        print(f"\nround {t}: selected {picked}")
        print(f"  |h|^2   {[f'{g:.2f}' for g in gains.tolist()]}")
        print(f"  q       {[f'{x:.3f}' for x in q.tolist()]}")
        print(f"  P       {[f'{x:.1f}' for x in p.tolist()]}")
        print(f"  Z       {[f'{x:.2f}' for x in state.z.tolist()]}")
        print(f"  uplink {float(t_up):.2f}s   y0 {float(obj):.2f}")

    c = BoundConstants(gamma=0.01, L=10.0, G2=10.0, I=10, n_clients=n)
    rhs = corollary1_bound(acc, c, 5.0)
    print(f"\nCorollary-1 RHS after {int(acc.rounds)} rounds: "
          f"{float(rhs):.3f}  (1/q running sum {float(acc.inv_q_sum):.1f})")
    return dict(rounds=int(acc.rounds), bound=float(rhs))


if __name__ == "__main__":
    main()
