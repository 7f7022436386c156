"""Model assembly for an SSM stack (twin of the parts of
``repro/models/model.py`` that ``mamba2-130m`` runs).

The parameters are one ``nn.Module``, :class:`MambaLM`: ``embed.emb``,
``final_norm.g`` and an ``nn.ModuleList`` of layers, each ``norm1.g`` and
a :class:`~repro_torch.models.mamba.Mamba2Block` ``mixer``. The reference
stacks the period's layers and runs them with ``lax.scan``; the port runs
them as a Python loop. :func:`repro_torch.convert.lm_params_from_jax`
carries the reference's parameters across.

Entry points, as the reference's, with the module in place of the
parameter tree: ``forward`` and ``loss_fn`` (full sequence), ``prefill``
and ``decode_step`` (serving). They run under ``torch.inference_mode()``;
training and gradients wait for a later slice. A layer whose mixer is not
``mamba`` or whose mlp is not ``none`` raises ``NotImplementedError``
(ROADMAP §A item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import mamba as mam
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import _dtype, Embedding, RMSNorm


class Batch(NamedTuple):
    """One scoring / serving micro-batch (the reference's VLM and audio
    fields wait for those models)."""

    tokens: torch.Tensor                     # (B, S) int64
    labels: Optional[torch.Tensor] = None    # (B, S) next-token targets


def _check_spec(spec: LayerSpec):
    if spec.mixer != "mamba" or spec.mlp != "none":
        raise NotImplementedError(
            f"layer {spec} is not ported yet: the port runs mamba mixers "
            "without an mlp (ROADMAP §A item 10)")


def check_config(cfg: ModelConfig):
    """Raise for a configuration the port cannot run yet."""
    if (cfg.is_encoder_decoder or cfg.cross_attn_every
            or not cfg.tie_embeddings):
        raise NotImplementedError(f"{cfg.name}: encoder-decoder, "
                                  "cross-attention and untied-head models "
                                  "are not ported yet (ROADMAP §A item 10)")
    for spec in cfg.layer_specs():
        _check_spec(spec)


class MambaLayer(nn.Module):
    """Pre-norm residual layer around one Mamba-2 mixer."""

    def __init__(self, norm1: RMSNorm, mixer: mam.Mamba2Block):
        super().__init__()
        self.norm1 = norm1
        self.mixer = mixer


class MambaLM(nn.Module):
    """Embedding, the layer stack and the final norm; the logits use the
    embedding (tied)."""

    def __init__(self, embed: Embedding, layers, final_norm: RMSNorm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> MambaLM:
    """Random weights drawn on ``generator`` (which lives on ``device``)
    with the reference's initializers."""
    check_config(cfg)
    dtype = _dtype(cfg.param_dtype)
    eps = cfg.rmsnorm_eps
    embed = Embedding.init(generator, cfg.vocab_size, cfg.d_model, dtype,
                           device)
    layers = [MambaLayer(RMSNorm.init(cfg.d_model, dtype, device, eps),
                         mam.init_mamba(generator, cfg, dtype, device))
              for _ in range(cfg.n_layers)]
    return MambaLM(embed, layers, RMSNorm.init(cfg.d_model, dtype, device,
                                               eps))


def logits_from_hidden(params: MambaLM, x, cfg: ModelConfig):
    return params.final_norm(x) @ params.embed.emb.T


@torch.inference_mode()
def forward(params: MambaLM, batch: Batch, cfg: ModelConfig):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    x = params.embed(batch.tokens)
    for layer in params.layers:
        h = layer.mixer(layer.norm1(x))
        x = x + h.to(x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_from_hidden(params, x, cfg), aux


@torch.inference_mode()
def loss_fn(params: MambaLM, batch: Batch, cfg: ModelConfig):
    """Mean next-token cross-entropy (+ aux, zero without MoE). fp32
    softmax."""
    logits, aux = forward(params, batch, cfg)
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, batch.labels[..., None])[..., 0]
    return -torch.mean(ll) + aux


# ======================================================================
# Serving: prefill + decode
# ======================================================================

class ServeState(NamedTuple):
    layers: Tuple[mam.MambaState, ...]   # one cache per layer, in order
    position: int


def _layer_cache_init(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      cache_len: int, dtype, device="cuda"):
    _check_spec(spec)
    return mam.init_mamba_state(cfg, batch, dtype, device)


@torch.inference_mode()
def prefill(params: MambaLM, batch: Batch, cfg: ModelConfig, cache_len: int):
    """Process the prompt; returns (last-token logits (B, 1, V),
    ServeState). A Mamba layer's cache is its (conv, ssm) state, whose size
    does not grow with ``cache_len``."""
    x = params.embed(batch.tokens)
    caches = []
    for layer in params.layers:
        h, cache = layer.mixer(layer.norm1(x), return_state=True)
        x = x + h.to(x.dtype)
        caches.append(cache)
    logits = logits_from_hidden(params, x[:, -1:, :], cfg)
    return logits, ServeState(layers=tuple(caches),
                              position=batch.tokens.shape[1])


@torch.inference_mode()
def decode_step(params: MambaLM, token, state: ServeState, cfg: ModelConfig):
    """Logits for ONE new token. token (B, 1) int64."""
    x = params.embed(token)
    caches = []
    for layer, cache in zip(params.layers, state.layers):
        h, cache = layer.mixer.decode(layer.norm1(x), cache)
        x = x + h.to(x.dtype)
        caches.append(cache)
    logits = logits_from_hidden(params, x, cfg)
    return logits, ServeState(layers=tuple(caches),
                              position=state.position + 1)
