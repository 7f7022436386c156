"""Carry the reference's parameters across to the port.

``params_from_jax`` (the CNN) takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference side) and returns
the port's float32 tensors:

* conv weights: HWIO (kh, kw, in, out) in the reference, OIHW in PyTorch;
* dense weights: (in, out) in both. The reference flattens its NHWC
  activations in (h, w, c) order before ``f1w``; the port's CNN flattens
  in that same order (``models/cnn.py``), so ``f1w``'s rows carry over
  unchanged;
* biases: unchanged.

``mlp_params_from_jax`` (the MLP: ``w1``, ``b1``, ``w2``, ``b2``) carries
every leaf unchanged: dense weights are (in, out) in both packages, and
both flatten NHWC images in (h, w, c) order.

``lm_params_from_jax`` (the model zoo's stacks) takes the reference's
``init_params`` tree, numpy leaves, and returns the port's
:class:`~repro_torch.models.model.LM`: the ``params["prefix"]`` list
(Kimi's leading dense layer; one unstacked tree per layer) comes first in
the layer list, then the period-stacked ``params["period"]["layer<i>"]``
leaves, whose leading axis counts periods (``models/model.py`` in the
reference), unstacked layer by layer. Each layer carries ``norm1`` and
its mixer (a Mamba mixer's leaves, or ``mixer.w{q,k,v,o}`` of an
attention or cross-attention mixer), in an encoder-decoder's decoder
``norm_x`` and ``cross.w{q,k,v,o}``, and where it has an mlp ``norm2``
and either ``mlp.w{i,g,o}.w`` (dense) or the MoE's ``mlp.router.w``,
``mlp.wi``, ``mlp.wg`` and ``mlp.wo`` (stacked over experts); an
encoder-decoder's ``params["encoder"]["layer0"]``, stacked over its
encoder layers, goes into ``encoder`` (its mixers bidirectional) with
``enc_norm``; ``embed.emb``, ``final_norm.g`` and an untied
``lm_head.w`` (a tied head has none) carry over unchanged. Dense weights
are (in, out) in both packages.

``transformer_lm_params_from_jax`` (the registry's small LM) takes the
reference's ``init_lm`` tree (``emb``, the ``layers`` list of ``ln1`` /
``attn`` / ``ln2`` / ``mlp`` dicts, ``lnf``), numpy leaves, and returns
the port's flat dict (``models/transformer_lm.py``): ``emb.emb``,
``layers.<i>.attn.wq.w`` and so on, every leaf unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.attention import Attention, CrossAttention
from repro_torch.models.layers import Dense, Embedding, RMSNorm, SwiGLU
from repro_torch.models.mamba import Mamba2Block
from repro_torch.models.moe import MoE

_CONV = ("c1w", "c2w")


def params_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's CNN parameter dict (numpy leaves) -> the port's."""
    out = {}
    for name, value in tree.items():
        value = np.array(value, dtype=np.float32)
        if name in _CONV:
            value = value.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return out


def mlp_params_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's MLP parameter dict (numpy leaves) -> the port's."""
    return {name: torch.from_numpy(np.array(tree[name], dtype=np.float32))
            .to(device) for name in ("w1", "b1", "w2", "b2")}


def _tensor(value, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def _layer(p: dict, k: int | None, spec, cfg, device,
           causal: bool = True) -> M.Layer:
    """Layer ``k`` of one period-stacked reference layer ``p``, or the
    unstacked layer ``p`` with ``k=None`` (a prefix layer);
    ``causal=False``: an encoder layer."""
    def leaf(v):
        return _tensor(v if k is None else v[k], device)

    def norm(name):
        return RMSNorm(leaf(p[name]["g"]), cfg.rmsnorm_eps)

    def weights(m):
        return (leaf(m[n]["w"]) for n in ("wq", "wk", "wv", "wo"))

    m = p["mixer"]
    if spec.mixer == "mamba":
        mixer = Mamba2Block({name: ({"w": leaf(v["w"])} if isinstance(v, dict)
                                    else leaf(v)) for name, v in m.items()},
                            cfg)
    elif spec.mixer == "cross_attn":
        mixer = CrossAttention(*weights(m), cfg)
    else:
        mixer = Attention(*weights(m), cfg, causal=causal)
    rest = {}
    if "cross" in p:
        rest = dict(norm_x=norm("norm_x"),
                    cross=CrossAttention(*weights(p["cross"]), cfg))
    if spec.mlp == "moe":
        mlp = p["mlp"]
        rest.update(norm2=norm("norm2"), mlp=MoE(
            leaf(mlp["router"]["w"]), leaf(mlp["wi"]), leaf(mlp["wg"]),
            leaf(mlp["wo"]), cfg))
    elif spec.mlp == "dense":
        rest.update(norm2=norm("norm2"), mlp=SwiGLU(
            *(leaf(p["mlp"][n]["w"]) for n in ("wi", "wg", "wo"))))
    return M.Layer(norm("norm1"), mixer, **rest)


def lm_params_from_jax(tree: dict, cfg, device="cuda") -> M.LM:
    """The reference's LM parameter tree (numpy leaves) -> the port's
    :class:`~repro_torch.models.model.LM` on ``device``."""
    prefix, period, n_periods = cfg.period_decomposition()
    layers = [_layer(p, None, spec, cfg, device)
              for p, spec in zip(tree["prefix"], prefix, strict=True)]
    layers += [_layer(tree["period"][f"layer{i}"], k, spec, cfg, device)
               for k in range(n_periods) for i, spec in enumerate(period)]
    final_norm = RMSNorm(_tensor(tree["final_norm"]["g"], device),
                         cfg.rmsnorm_eps)
    head = (None if cfg.tie_embeddings else
            Dense(_tensor(tree["lm_head"]["w"], device)))
    encoder = enc_norm = None
    if cfg.is_encoder_decoder:
        (enc_spec,), n_enc = cfg.encoder_period()
        encoder = [_layer(tree["encoder"]["layer0"], k, enc_spec, cfg,
                          device, causal=False) for k in range(n_enc)]
        enc_norm = RMSNorm(_tensor(tree["enc_norm"]["g"], device),
                           cfg.rmsnorm_eps)
    return M.LM(Embedding(_tensor(tree["embed"]["emb"], device)), layers,
                final_norm, head, encoder, enc_norm)


def transformer_lm_params_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's ``init_lm`` tree (numpy leaves) -> the port's flat
    parameter dict, named as ``models/transformer_lm.py`` names it."""
    out = {"emb.emb": tree["emb"]["emb"]}
    for i, layer in enumerate(tree["layers"]):
        out[f"layers.{i}.ln1.g"] = layer["ln1"]["g"]
        for n in ("wq", "wk", "wv", "wo"):
            out[f"layers.{i}.attn.{n}.w"] = layer["attn"][n]["w"]
        out[f"layers.{i}.ln2.g"] = layer["ln2"]["g"]
        for n in ("wi", "wg", "wo"):
            out[f"layers.{i}.mlp.{n}.w"] = layer["mlp"][n]["w"]
    out["lnf.g"] = tree["lnf"]["g"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in out.items()}
