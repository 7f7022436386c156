"""Every registry model federating (twin of the reference's
``examples/model_zoo_fl.py``).

Runs the paper's Algorithm 1/2 pipeline over each entry of the model
registry, N = 40 clients for 10 rounds: the paper CNN and an MLP on a
CIFAR-10 stand-in, and the small transformer LM over federated token
streams (its participants train under ``vmap(grad)``, attention through
K5 and its backward kernel on the card). The reference's last leg, the
MLP re-run with the participant axis sharded over every local device, is
left out: multi-device is ROADMAP §A item 8.

    PYTHONPATH=src python -m repro_torch.examples.model_zoo_fl \
        [--device cpu] [--rounds 10]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like, make_lm_federated
from repro_torch.fl.simulation import SimConfig, run_simulation
from repro_torch.models.registry import make_model

N = 40
BASE = dict(rounds=10, eval_every=9, m_cap=6, batch=8, local_steps=3,
            eval_size=400)
CONFIGS = (("cnn", (("conv1", 8), ("conv2", 16), ("hidden", 32))),
           ("mlp", ()),
           ("transformer_lm", ()))


def datasets(device):
    """The image and token datasets of the example, seeded."""
    gen = torch.Generator(device=device).manual_seed(0)
    ds_img = make_cifar10_like(gen, n_clients=N, per_client=64, n_test=400,
                               h=16, w=16, device=device)
    ds_tok = make_lm_federated(gen, n_clients=N, per_client=48, seq=16,
                               vocab=32, n_test=400, device=device)
    return ds_img, ds_tok


def configs(model, model_params, device, rounds=BASE["rounds"]):
    """One registry model's run configuration: ``(sim, scfg, ch,
    sigmas)``, the draws from seed 2."""
    sim = SimConfig(model=model, model_params=model_params, seed=2,
                    **dict(BASE, rounds=rounds,
                           eval_every=min(BASE["eval_every"], rounds - 1)))
    return (sim, SchedulerConfig(n_clients=N, model_bits=32 * 50_000.0),
            ChannelConfig(n_clients=N),
            heterogeneous_sigmas(N, device=device))


def leg(model, model_params, ds, draws=None, params=None,
        rounds=BASE["rounds"], **kw):
    """One registry model's run: its params from seed 1 (or ``params``),
    the run's draws from seed 2 (or ``draws``). Returns the history and
    the initial params."""
    device = ds.device
    if params is None:
        params = make_model(model, ds, **dict(model_params)).init_fn(
            torch.Generator(device=device).manual_seed(1))
    hist = run_simulation(draws, params, ds,
                          *configs(model, model_params, device, rounds), **kw)
    return hist, params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=BASE["rounds"])
    args = ap.parse_args(argv)
    ds_img, ds_tok = datasets(torch.device(args.device))
    out = {}
    for model, mp in CONFIGS:
        h, _ = leg(model, mp, ds_tok if model == "transformer_lm" else ds_img,
                   rounds=args.rounds)
        print(f"{model:15s} acc {h['test_acc'][0]:.3f} -> "
              f"{h['test_acc'][-1]:.3f}, comm {h['comm_time'][-1]:.1f}s, "
              f"devices/round {h['n_selected'].mean():.1f}")
        out[model] = h
    return out


if __name__ == "__main__":
    main()
