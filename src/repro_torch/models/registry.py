"""Model registry (twin of ``repro/models/registry.py``): ``cnn`` and
``mlp``.

A :class:`ModelSpec` binds a model to a dataset's shapes: ``init_fn(
generator) -> params``, ``loss_fn(params, (inputs, labels)) -> scalar`` and
``eval_fn(params, inputs, labels) -> accuracy``. The reference's
``transformer_lm`` entry is ROADMAP §A item 10.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.cnn import CNN, CNNConfig, cnn_loss, init_cnn
from repro_torch.models.mlp import MLPConfig, apply_mlp, init_mlp, mlp_loss

NOT_PORTED = {"transformer_lm": "ROADMAP §A item 10"}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One federated model bound to a dataset's shapes."""

    name: str
    init_fn: Callable      # generator -> params
    loss_fn: Callable      # (params, (inputs, labels)) -> scalar
    eval_fn: Callable      # (params, inputs, labels) -> accuracy


def _image_dims(ds: FederatedDataset, name: str):
    if ds.client_images.ndim != 5:
        raise ValueError(
            f"model {name!r} needs image client data (N, P, H, W, C); got "
            f"shape {tuple(ds.client_images.shape)}")
    return ds.client_images.shape[2:]


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def _build_cnn(ds: FederatedDataset, *, conv1: int = 32, conv2: int = 64,
               hidden: int = 120) -> ModelSpec:
    h, w, c = _image_dims(ds, "cnn")
    cfg = CNNConfig(h, w, c, ds.n_classes, conv1=conv1, conv2=conv2,
                    hidden=hidden)
    device = ds.device
    # a parameter-less shell: every call swaps the caller's params in
    model = CNN(init_cnn(None, cfg, device="meta"))

    def eval_fn(params, inputs, labels):
        return _accuracy(
            torch.func.functional_call(model, params, (inputs,)), labels)

    return ModelSpec(name="cnn",
                     init_fn=lambda gen: init_cnn(gen, cfg, device=device),
                     loss_fn=functools.partial(cnn_loss, model),
                     eval_fn=eval_fn)


def _build_mlp(ds: FederatedDataset, *, hidden: int = 64) -> ModelSpec:
    h, w, c = _image_dims(ds, "mlp")
    cfg = MLPConfig(h, w, c, ds.n_classes, hidden=hidden)
    device = ds.device
    return ModelSpec(name="mlp",
                     init_fn=lambda gen: init_mlp(gen, cfg, device=device),
                     loss_fn=mlp_loss,
                     eval_fn=lambda params, inputs, labels: _accuracy(
                         apply_mlp(params, inputs), labels))


MODELS = {"cnn": _build_cnn, "mlp": _build_mlp}


def make_model(name: str, ds: FederatedDataset, **params) -> ModelSpec:
    """Resolve a model against a dataset's shapes (``params``: conv1,
    conv2, hidden for cnn; hidden for mlp)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"({NOT_PORTED[name]})")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} "
                         f"(registered: {sorted(MODELS)})")
    return MODELS[name](ds, **params)
