"""The paper's experiment CNN (twin of ``repro/models/cnn.py``).

Two 5x5 SAME convolutions with ReLU, each followed by 2x2 max pooling, one
hidden dense layer with ReLU, then the logits. Layouts follow the
reference at the public functions: images are NHWC, and the parameters
are a flat dict with its names. Inside, the convolutions run in PyTorch's
NCHW with OIHW weights (:func:`repro_torch.convert.params_from_jax` turns
the reference's HWIO weights around), and the activations are flattened
in the reference's (h, w, c) order before ``f1w``, so dense weights keep
the reference's (in, out) layout row for row.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    height: int
    width: int
    channels: int
    n_classes: int
    conv1: int = 32
    conv2: int = 64
    hidden: int = 120
    ksize: int = 5


def init_cnn(generator: torch.Generator, cfg: CNNConfig,
             device="cuda") -> dict:
    """Truncated-normal (+-2 sd) He-scaled weights, zero biases."""
    k = cfg.ksize
    flat = (cfg.height // 4) * (cfg.width // 4) * cfg.conv2

    def weight(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w * (2.0 / fan_in) ** 0.5

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "c1w": weight((cfg.conv1, cfg.channels, k, k), k * k * cfg.channels),
        "c1b": zeros(cfg.conv1),
        "c2w": weight((cfg.conv2, cfg.conv1, k, k), k * k * cfg.conv1),
        "c2b": zeros(cfg.conv2),
        "f1w": weight((flat, cfg.hidden), flat),
        "f1b": zeros(cfg.hidden),
        "f2w": weight((cfg.hidden, cfg.n_classes), cfg.hidden),
        "f2b": zeros(cfg.n_classes),
    }


class CNN(nn.Module):
    """The CNN as a module whose parameters carry the reference's names."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, n_classes)."""
        pad = self.c1w.shape[-1] // 2
        x = images.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(F.conv2d(x, self.c1w, self.c1b,
                                         padding=pad)), 2)
        x = F.max_pool2d(F.relu(F.conv2d(x, self.c2w, self.c2b,
                                         padding=pad)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) order
        x = F.relu(x @ self.f1w + self.f1b)
        return x @ self.f2w + self.f2b


def cnn_loss(model: CNN, params: dict, batch) -> torch.Tensor:
    """Mean cross-entropy of ``model`` run with ``params`` on ``batch`` =
    (images, labels)."""
    images, labels = batch
    logits = torch.func.functional_call(model, params, (images,))
    return F.cross_entropy(logits, labels)


def apply_cnn(params: dict, images: torch.Tensor) -> torch.Tensor:
    """The CNN with ``params`` on (B, H, W, C) images -> logits."""
    return torch.func.functional_call(_SHELL, params, (images,))


def cnn_accuracy(params: dict, images: torch.Tensor, labels: torch.Tensor,
                 batch: int = 1024) -> torch.Tensor:
    """Test accuracy over ``images`` in slices of ``batch``."""
    with torch.no_grad():
        preds = torch.cat([apply_cnn(params, images[i:i + batch]).argmax(-1)
                           for i in range(0, images.shape[0], batch)])
    return (preds == labels).to(torch.float32).mean()


def param_count(params: dict) -> int:
    return sum(int(p.numel()) for p in params.values())


# a parameter-less module: calls swap their params in
_SHELL = CNN({})
