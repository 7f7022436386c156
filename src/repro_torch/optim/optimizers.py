"""Minimal functional optimizers (twin of ``repro/optim/optimizers.py``).

Each optimizer is ``(init_fn, update_fn)``: ``update_fn(grads, state,
params, lr) -> (new_params, new_state)``, over a dict of tensors (the
port's parameter trees are flat dicts, as ``fl/round.py`` takes them) and
out of place, as the reference's. SGD is the paper's local optimizer;
Adam and momentum serve the non-FL baselines and examples. The op order
is the reference's: Adam's moments and bias corrections in float32, the
step computed in float32 and cast back to the parameter's type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class OptState(NamedTuple):
    step: torch.Tensor             # () int32
    mu: Optional[dict] = None
    nu: Optional[dict] = None


def _step0(params: dict) -> torch.Tensor:
    device = next(iter(params.values())).device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd():
    def init(params):
        return OptState(step=_step0(params))

    def update(grads, state, params, lr):
        new = {k: w - lr * grads[k].to(w.dtype) for k, w in params.items()}
        return new, OptState(step=state.step + 1)

    return init, update


def momentum(beta: float = 0.9):
    def init(params):
        return OptState(step=_step0(params),
                        mu={k: torch.zeros_like(w) for k, w in
                            params.items()})

    def update(grads, state, params, lr):
        mu = {k: beta * m + grads[k].to(m.dtype)
              for k, m in state.mu.items()}
        new = {k: w - lr * mu[k] for k, w in params.items()}
        return new, OptState(step=state.step + 1, mu=mu)

    return init, update


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        def zeros32(w):
            return torch.zeros(w.shape, dtype=torch.float32, device=w.device)

        return OptState(step=_step0(params),
                        mu={k: zeros32(w) for k, w in params.items()},
                        nu={k: zeros32(w) for k, w in params.items()})

    def update(grads, state, params, lr):
        t = state.step + 1
        mu = {k: b1 * m + (1 - b1) * grads[k].to(m.dtype)
              for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].to(v.dtype))
              for k, v in state.nu.items()}
        tf = t.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=tf.device), tf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=tf.device), tf)

        def upd(w, m, v):
            step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
            return (w.to(torch.float32) - step).to(w.dtype)

        new = {k: upd(w, mu[k], nu[k]) for k, w in params.items()}
        return new, OptState(step=t, mu=mu, nu=nu)

    return init, update


def clip_by_global_norm(grads: dict, max_norm: float):
    """``grads`` scaled by min(1, max_norm / max(norm, 1e-9)), and the
    global float32 L2 norm."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm
