"""Model registry (twin of ``repro/models/registry.py``): ``cnn``,
``mlp`` and ``transformer_lm``.

A :class:`ModelSpec` binds a model to a dataset's shapes: ``init_fn(
generator) -> params``, ``loss_fn(params, (inputs, labels)) -> scalar`` and
``eval_fn(params, inputs, labels) -> accuracy``. ``cnn`` and ``mlp`` need
image client data (N, P, H, W, C); ``transformer_lm`` token client data
(N, P, S) int (``data/synthetic.py::make_lm_federated``). The build
functions raise early, with the reference's messages.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.cnn import CNN, CNNConfig, cnn_loss, init_cnn
from repro_torch.models.mlp import MLPConfig, apply_mlp, init_mlp, mlp_loss
from repro_torch.models.transformer_lm import (LMConfig, init_lm,
                                               lm_accuracy, lm_loss)


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
            f"model {name!r} needs image client data (N, P, H, W, C); "
            f"got shape {tuple(ds.client_images.shape)} — token datasets "
            f"federate via model='transformer_lm'")
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


def _build_transformer_lm(ds: FederatedDataset, *, d_model: int = 32,
                          n_heads: int = 2, n_layers: int = 2,
                          d_ff: int = 64) -> ModelSpec:
    tokens = ds.client_images
    if tokens.ndim != 3 or tokens.dtype.is_floating_point:
        raise ValueError(
            "model 'transformer_lm' needs token client data (N, P, S) int "
            f"(see data/synthetic.py::make_lm_federated); got shape "
            f"{tuple(tokens.shape)} dtype {tokens.dtype}")
    cfg = LMConfig(vocab=ds.n_classes, d_model=d_model, n_heads=n_heads,
                   n_layers=n_layers, d_ff=d_ff)
    device = ds.device
    return ModelSpec(name="transformer_lm",
                     init_fn=lambda gen: init_lm(gen, cfg, device=device),
                     loss_fn=functools.partial(lm_loss, cfg=cfg),
                     eval_fn=lambda params, toks, tgts: lm_accuracy(
                         params, toks, tgts, cfg))


MODELS = {"cnn": _build_cnn, "mlp": _build_mlp,
          "transformer_lm": _build_transformer_lm}


def make_model(name: str, ds: FederatedDataset, **params) -> ModelSpec:
    """Resolve a model against a dataset's shapes (``params``: conv1,
    conv2, hidden for cnn; hidden for mlp; d_model, n_heads, n_layers,
    d_ff for transformer_lm)."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} "
                         f"(registered: {sorted(MODELS)})")
    return MODELS[name](ds, **params)
