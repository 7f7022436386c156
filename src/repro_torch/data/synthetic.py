"""Synthetic federated datasets (twin of ``repro/data/synthetic.py``).

The layout is the reference's: images (N, per_client, H, W, C) float32,
labels (N, per_client) (int64 here, PyTorch's index type), and a common
test split; :func:`make_token_stream` makes an LM batch. Tensors live on
the run's device. :func:`from_numpy` carries the reference's generated
arrays across (parity tests); the makers draw their own on a
``torch.Generator`` (standalone runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FederatedDataset:
    """Client-partitioned dataset with a common test split."""

    client_images: torch.Tensor   # (N, per_client, H, W, C) float32
    client_labels: torch.Tensor   # (N, per_client) int64
    test_images: torch.Tensor     # (T, H, W, C) float32
    test_labels: torch.Tensor     # (T,) int64
    n_classes: int

    @property
    def n_clients(self) -> int:
        return self.client_images.shape[0]

    @property
    def device(self) -> torch.device:
        return self.client_images.device


def from_numpy(client_images, client_labels, test_images, test_labels,
               n_classes: int, device="cuda") -> FederatedDataset:
    """A dataset from host arrays (e.g. the reference's), on ``device``."""
    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    def idx(x):
        return torch.from_numpy(np.array(x, np.int64)).to(device)

    return FederatedDataset(client_images=f32(client_images),
                            client_labels=idx(client_labels),
                            test_images=f32(test_images),
                            test_labels=idx(test_labels),
                            n_classes=int(n_classes))


def _render(generator, templates, labels, noise=2.5):
    """Noisy class templates (the reference's SNR)."""
    imgs = templates[labels]
    return imgs + noise * torch.randn(imgs.shape, generator=generator,
                                      device=imgs.device)


def make_cifar10_like(generator: torch.Generator, n_clients: int = 100,
                      per_client: int = 500, n_test: int = 10000,
                      h: int = 32, w: int = 32, c: int = 3,
                      n_classes: int = 10,
                      device="cuda") -> FederatedDataset:
    """i.i.d. partition: every client draws labels uniformly (paper VI-A).

    ``generator`` must live on ``device``; the draws are the reference's
    recipe, not its numbers.
    """
    tmpl = torch.randn((n_classes, h, w, c), generator=generator,
                       device=device)
    labels = torch.randint(0, n_classes, (n_clients, per_client),
                           generator=generator, device=device)
    imgs = _render(generator, tmpl, labels)
    tl = torch.randint(0, n_classes, (n_test,), generator=generator,
                       device=device)
    return FederatedDataset(client_images=imgs, client_labels=labels,
                            test_images=_render(generator, tmpl, tl),
                            test_labels=tl, n_classes=n_classes)


def make_token_stream(generator: torch.Generator, batch: int, seq: int,
                      vocab: int, device="cuda"):
    """Synthetic LM batch (twin of the reference's ``make_token_stream``):
    uniform tokens (B, S) int64 and next-token labels, the tokens rolled by
    one. ``generator`` must live on ``device``."""
    tokens = torch.randint(0, vocab, (batch, seq), generator=generator,
                           device=device)
    return tokens, torch.roll(tokens, -1, dims=1)
