"""Synthetic federated datasets (twin of ``repro/data/synthetic.py``).

The layout is the reference's: images (N, per_client, H, W, C) float32,
labels (N, per_client) (int64 here, PyTorch's index type), and a common
test split; :func:`make_token_stream` makes an LM batch. Tensors live on
the run's device. :func:`make_cifar10_like` is the paper's i.i.d.
CIFAR-10 stand-in, :func:`make_femnist_like` its non-i.i.d. FEMNIST one
(one writer per client), :func:`make_lm_federated` the token streams of
``transformer_lm`` (int64 sequences in the images' place).
:func:`from_numpy` carries the reference's generated arrays across
(parity tests); the makers draw their own on a ``torch.Generator``
(standalone runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FederatedDataset:
    """Client-partitioned dataset with a common test split."""

    client_images: torch.Tensor   # (N, per_client, H, W, C) float32, or
                                  # (N, per_client, S) int64 tokens
    client_labels: torch.Tensor   # (N, per_client) int64, or (N,
                                  # per_client, S) next tokens
    test_images: torch.Tensor     # (T, H, W, C) float32, or (T, S) tokens
    test_labels: torch.Tensor     # (T,) int64, or (T, S)
    n_classes: int

    @property
    def n_clients(self) -> int:
        return self.client_images.shape[0]

    @property
    def device(self) -> torch.device:
        return self.client_images.device


def from_numpy(client_images, client_labels, test_images, test_labels,
               n_classes: int, device="cuda") -> FederatedDataset:
    """A dataset from host arrays (e.g. the reference's), on ``device``:
    float inputs as float32, integer inputs (token sequences) and the
    labels as int64."""
    def inputs(x):
        x = np.asarray(x)
        return (idx(x) if np.issubdtype(x.dtype, np.integer)
                else torch.from_numpy(np.array(x, np.float32)).to(device))

    def idx(x):
        return torch.from_numpy(np.array(x, np.int64)).to(device)

    return FederatedDataset(client_images=inputs(client_images),
                            client_labels=idx(client_labels),
                            test_images=inputs(test_images),
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


def _gamma(generator: torch.Generator, alpha: float, shape,
           device) -> torch.Tensor:
    """Gamma(alpha, 1) draws for alpha < 1 from the generator's own normals
    and uniforms: Marsaglia-Tsang on alpha + 1 (redrawing the rejected
    lanes until every lane is accepted), times U^(1/alpha). Returned as
    logarithms, so a tiny U^(1/alpha) cannot underflow to 0."""
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.empty(shape, dtype=torch.float32, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = todo & ok
        out = torch.where(take, torch.log(d * v), out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=generator, device=device)
    return out + torch.log(u) / alpha


def make_femnist_like(generator: torch.Generator, n_clients: int = 3597,
                      per_client: int = 40, n_test: int = 10000,
                      h: int = 28, w: int = 28, c: int = 1,
                      n_classes: int = 62,
                      device="cuda") -> FederatedDataset:
    """Non-i.i.d., one writer per client (paper VI-B): a writer-specific
    style (a gain (N, 1, 1, 1, 1) and an offset field (N, 1, H, W, C) on
    the rendered canvas) and a writer-biased label mix (Dirichlet 0.3,
    normalised Gamma(0.3) draws; each client's labels drawn from its mix
    with replacement). ``generator`` must live on ``device``; the draws
    are the reference's recipe, not its numbers."""
    tmpl = torch.randn((n_classes, h, w, c), generator=generator,
                       device=device)
    gain = 1.0 + 0.3 * torch.randn((n_clients, 1, 1, 1, 1),
                                   generator=generator, device=device)
    offset = 0.3 * torch.randn((n_clients, 1, h, w, c), generator=generator,
                               device=device)
    mix = torch.softmax(_gamma(generator, 0.3, (n_clients, n_classes),
                               device), dim=-1)
    labels = torch.multinomial(mix, per_client, replacement=True,
                               generator=generator)
    imgs = _render(generator, tmpl, labels) * gain + offset
    tl = torch.randint(0, n_classes, (n_test,), generator=generator,
                       device=device)
    return FederatedDataset(client_images=imgs, client_labels=labels,
                            test_images=_render(generator, tmpl, tl),
                            test_labels=tl, n_classes=n_classes)


def gather_batches(ds: FederatedDataset, generator: torch.Generator,
                   steps: int, batch: int):
    """Per-client local-step minibatches drawn on ``generator`` (on the
    dataset's device): images (N, steps, batch, H, W, C) and labels (N,
    steps, batch)."""
    n, per_client = ds.client_labels.shape[:2]
    idx = torch.randint(0, per_client, (n, steps, batch),
                        generator=generator, device=ds.device)
    rows = torch.arange(n, device=ds.device)[:, None, None]
    return ds.client_images[rows, idx], ds.client_labels[rows, idx]


def make_lm_federated(generator: torch.Generator, n_clients: int = 40,
                      per_client: int = 32, seq: int = 16, vocab: int = 32,
                      n_test: int = 512, device="cuda") -> FederatedDataset:
    """Federated token streams for ``model="transformer_lm"``: the image
    datasets' container, ``client_images`` holding the (N, per_client, seq)
    int64 token sequences and ``client_labels`` the next-token targets
    (:func:`make_token_stream`'s roll convention, along the sequence).
    Non-i.i.d. as :func:`make_femnist_like`: each client draws its tokens
    from its own Dirichlet(0.3) unigram mix (normalised Gamma(0.3) draws);
    the test split from the clients' mean mix. ``generator`` must live on
    ``device``; the draws are the reference's recipe, not its numbers."""
    mix = torch.softmax(_gamma(generator, 0.3, (n_clients, vocab), device),
                        dim=-1)
    tokens = torch.multinomial(mix, per_client * seq, replacement=True,
                               generator=generator).reshape(
                                   n_clients, per_client, seq)
    test = torch.multinomial(mix.mean(0), n_test * seq, replacement=True,
                             generator=generator).reshape(n_test, seq)
    return FederatedDataset(client_images=tokens,
                            client_labels=torch.roll(tokens, -1, dims=-1),
                            test_images=test,
                            test_labels=torch.roll(test, -1, dims=-1),
                            n_classes=vocab)


def make_token_stream(generator: torch.Generator, batch: int, seq: int,
                      vocab: int, device="cuda"):
    """Synthetic LM batch (twin of the reference's ``make_token_stream``):
    uniform tokens (B, S) int64 and next-token labels, the tokens rolled by
    one. ``generator`` must live on ``device``."""
    tokens = torch.randint(0, vocab, (batch, seq), generator=generator,
                           device=device)
    return tokens, torch.roll(tokens, -1, dims=1)
