"""Plain MLP of the federated model registry (twin of
``repro/models/mlp.py``).

A flatten and two dense layers: the registry's cheapest entry, so the
round machinery can be exercised without paying for convolutions. The
parameters are the reference's flat dict, ``w1`` (d_in, hidden), ``b1``,
``w2`` (hidden, n_classes), ``b2``, dense weights (in, out) in both
packages; images (B, H, W, C) are flattened in the reference's (h, w, c)
order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    height: int
    width: int
    channels: int
    n_classes: int
    hidden: int = 64

    @property
    def d_in(self) -> int:
        return self.height * self.width * self.channels


def init_mlp(generator: torch.Generator, cfg: MLPConfig,
             device="cuda") -> dict:
    """Truncated-normal (+-2 sd) He-scaled weights, zero biases."""
    def weight(d_in, d_out):
        w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w * (2.0 / d_in) ** 0.5

    return {
        "w1": weight(cfg.d_in, cfg.hidden),
        "b1": torch.zeros((cfg.hidden,), dtype=torch.float32, device=device),
        "w2": weight(cfg.hidden, cfg.n_classes),
        "b2": torch.zeros((cfg.n_classes,), dtype=torch.float32,
                          device=device),
    }


class MLP(nn.Module):
    """The MLP as a module whose parameters carry the reference's names."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, n_classes)."""
        x = images.reshape(images.shape[0], -1)
        x = F.relu(x @ self.w1 + self.b1)
        return x @ self.w2 + self.b2


# a parameter-less module: calls swap their params in
_SHELL = MLP({})


def apply_mlp(params: dict, images: torch.Tensor) -> torch.Tensor:
    """The MLP with ``params`` on (B, H, W, C) images -> logits."""
    return torch.func.functional_call(_SHELL, params, (images,))


def mlp_loss(params: dict, batch) -> torch.Tensor:
    """Mean cross-entropy on ``batch`` = (images, labels)."""
    images, labels = batch
    return F.cross_entropy(apply_mlp(params, images), labels)
