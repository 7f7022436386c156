"""End-to-end training entry point (twin of ``repro/launch/train.py``):
the paper's FL experiment, or an LM of the zoo.

  PYTHONPATH=src python -m repro_torch.launch.train --dataset cifar10 \\
      --policy proposed --lam 10 --rounds 150
  PYTHONPATH=src python -m repro_torch.launch.train --dataset femnist \\
      --policy uniform --lam 100 --channel heterogeneous --rounds 150
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
      --steps 200

FL mode (the default) runs ``run_simulation`` on the synthetic CIFAR-10 or
FEMNIST stand-in. LM mode (``--arch <id>``) trains ``get_config(arch)
.reduced(n_layers=--layers, d_model=--d-model)`` with plain SGD
(``fl/round.py::make_train_step`` over ``torch.func.functional_call`` of
the :class:`~repro_torch.models.model.LM` module) on the synthetic token
stream; attention's gradient runs K5's backward kernel on the card. A
Mamba layer does not train on the card yet (``ssd_scan`` raises there,
ROADMAP §A item 13). ``--device`` picks the card (default ``cuda``, which
raises without one) or ``cpu``. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.core.channel import heterogeneous_sigmas, homogeneous_sigmas
from repro_torch.data.synthetic import (make_cifar10_like, make_femnist_like,
                                        make_token_stream)
from repro_torch.fl.simulation import (SimConfig, match_uniform_m,
                                       run_simulation, time_to_accuracy)
from repro_torch.launch.distributed import is_main, main_print
from repro_torch.models.cnn import init_cnn, param_count


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fl(args) -> dict:
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.dataset == "cifar10":
        from repro_torch.configs.cifar10_cnn import CONFIG as exp
        ds = make_cifar10_like(gen, n_clients=exp.n_clients,
                               per_client=args.per_client,
                               n_test=args.eval_size, device=device)
    else:
        from repro_torch.configs import femnist_cnn
        exp = (femnist_cnn.scaled(args.scale) if args.scale < 1.0
               else femnist_cnn.CONFIG)
        ds = make_femnist_like(gen, n_clients=exp.n_clients,
                               per_client=args.per_client,
                               n_test=args.eval_size, device=device)

    ch = exp.channel()
    scfg = exp.scheduler(args.lam)
    sig = (homogeneous_sigmas(exp.n_clients, device=device)
           if args.channel == "homogeneous"
           else heterogeneous_sigmas(exp.n_clients, device=device))
    params = init_cnn(torch.Generator(device=device).manual_seed(
        args.seed + 1), exp.cnn, device=device)

    uniform_m = args.uniform_m
    if args.policy == "uniform" and uniform_m <= 0:
        uniform_m = match_uniform_m(
            torch.Generator(device=device).manual_seed(7), sig, scfg, ch)

    sim = SimConfig(rounds=args.rounds, gamma=exp.gamma,
                    local_steps=exp.local_steps, batch=args.batch or exp.batch,
                    m_cap=args.m_cap, eval_every=args.eval_every,
                    eval_size=args.eval_size, policy=args.policy,
                    uniform_m=uniform_m, seed=args.seed + 2)
    t0 = time.time()
    hist = run_simulation(None, params, ds, sim, scfg, ch, sig)
    return {
        "dataset": exp.name, "policy": args.policy, "lam": args.lam,
        "channel": args.channel, "n_clients": exp.n_clients,
        "rounds": args.rounds, "uniform_m": uniform_m,
        "cnn_params": param_count(params),
        "final_acc": float(hist["test_acc"][-1]),
        "total_comm_time_s": float(hist["comm_time"][-1]),
        "time_to_half_final": time_to_accuracy(
            hist, 0.5 * float(hist["test_acc"][-1])),
        "avg_power_final": float(hist["avg_power"][-1]),
        "wall_s": time.time() - t0,
        "device": str(device),
        "history": {k: v.tolist() for k, v in hist.items()},
    }


def run_lm(args) -> dict:
    """Reduced-arch LM training on synthetic tokens, end to end."""
    from repro_torch.configs import get_config
    from repro_torch.fl.round import make_train_step
    from repro_torch.models import model as M
    from repro_torch.models.model import Batch

    device = torch.device(args.device)
    cfg = get_config(args.arch).reduced(n_layers=args.layers,
                                        d_model=args.d_model)
    model = M.init_params(torch.Generator(device=device).manual_seed(
        args.seed), cfg, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    n_params = sum(p.numel() for p in params.values())

    def loss_fn(p, b):
        return torch.func.functional_call(model, p, (b, cfg))

    step = make_train_step(loss_fn, args.gamma)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = args.batch or 8
    losses = []
    t0 = time.time()
    for _ in range(args.steps):
        tokens, labels = make_token_stream(gen, batch, args.seq,
                                           cfg.vocab_size, device=device)
        media = (torch.zeros((batch, cfg.n_media_tokens, cfg.d_model),
                             device=device)
                 if cfg.cross_attn_every else None)
        frames = (torch.zeros((batch, cfg.encoder_seq or 16, cfg.d_model),
                              device=device)
                  if cfg.is_encoder_decoder else None)
        params, loss = step(params, Batch(tokens=tokens, labels=labels,
                                          media=media, frames=frames))
        losses.append(float(loss))
    _sync(device)
    if args.checkpoint:
        save_pytree(args.checkpoint, params)
    return {"arch": cfg.name, "params": int(n_params), "steps": args.steps,
            "loss_first": losses[0], "loss_last": losses[-1],
            "wall_s": time.time() - t0, "device": str(device),
            "losses": losses[:: max(1, args.steps // 20)]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cifar10",
                    choices=["cifar10", "femnist"])
    ap.add_argument("--arch", default="", help="LM mode: assigned arch id")
    ap.add_argument("--policy", default="proposed",
                    choices=["proposed", "uniform"])
    ap.add_argument("--lam", type=float, default=10.0)
    ap.add_argument("--channel", default="heterogeneous",
                    choices=["homogeneous", "heterogeneous"])
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--per-client", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--m-cap", type=int, default=16)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--eval-size", type=int, default=1000)
    ap.add_argument("--uniform-m", type=float, default=0.0)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="FEMNIST client-count scale (1.0 = paper N=3597)")
    ap.add_argument("--seed", type=int, default=0)
    # LM mode extras
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    result = run_lm(args) if args.arch else run_fl(args)
    blob = json.dumps(result)
    if args.out and is_main():
        with open(args.out, "w") as f:
            f.write(blob)
    main_print(blob)
    return result


if __name__ == "__main__":
    main()
