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
:class:`~repro_torch.models.model.LM`: the period-stacked
``params["period"]["layer<i>"]`` leaves, whose leading axis counts
periods (``models/model.py`` in the reference), are unstacked into the
layer list (Mamba layers: ``norm1`` and the mixer's leaves; attention
and cross-attention layers: ``norm1``, ``mixer.w{q,k,v,o}``, ``norm2``,
``mlp.w{i,g,o}``, and in an encoder-decoder's decoder ``norm_x`` and
``cross.w{q,k,v,o}``); an encoder-decoder's ``params["encoder"]
["layer0"]``, stacked over its encoder layers, into ``encoder`` (its
mixers bidirectional) with ``enc_norm``; ``embed.emb``, ``final_norm.g``
and an untied ``lm_head.w`` (a tied head has none) carry over unchanged.
Dense weights are (in, out) in both packages. Prefix layers (MoE models'
leading dense layers) raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.attention import Attention, CrossAttention
from repro_torch.models.layers import Dense, Embedding, RMSNorm, SwiGLU
from repro_torch.models.mamba import Mamba2Block

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


def _layer(p: dict, k: int, spec, cfg, device,
           causal: bool = True) -> M.Layer:
    """Layer ``k`` of one period-stacked reference layer ``p``
    (``causal=False``: an encoder layer)."""
    def leaf(v):
        return _tensor(v[k], device)

    def norm(name):
        return RMSNorm(leaf(p[name]["g"]), cfg.rmsnorm_eps)

    def weights(m):
        return (leaf(m[n]["w"]) for n in ("wq", "wk", "wv", "wo"))

    m = p["mixer"]
    if spec.mixer == "mamba":
        mixer = {name: ({"w": leaf(v["w"])} if isinstance(v, dict)
                        else leaf(v)) for name, v in m.items()}
        return M.Layer(norm("norm1"), Mamba2Block(mixer, cfg))
    if spec.mixer == "cross_attn":
        mixer = CrossAttention(*weights(m), cfg)
    else:
        mixer = Attention(*weights(m), cfg, causal=causal)
    cross = {}
    if "cross" in p:
        cross = dict(norm_x=norm("norm_x"),
                     cross=CrossAttention(*weights(p["cross"]), cfg))
    mlp = SwiGLU(*(leaf(p["mlp"][n]["w"]) for n in ("wi", "wg", "wo")))
    return M.Layer(norm("norm1"), mixer, norm("norm2"), mlp, **cross)


def lm_params_from_jax(tree: dict, cfg, device="cuda") -> M.LM:
    """The reference's LM parameter tree (numpy leaves) -> the port's
    :class:`~repro_torch.models.model.LM` on ``device``."""
    M.check_config(cfg)
    prefix, period, n_periods = cfg.period_decomposition()
    if prefix or tree.get("prefix"):
        raise NotImplementedError("prefix layers are not ported yet "
                                  "(ROADMAP §A item 10)")
    layers = [_layer(tree["period"][f"layer{i}"], k, spec, cfg, device)
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
