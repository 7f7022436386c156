"""Model assembly for decoder-only stacks (twin of the parts of
``repro/models/model.py`` that ``mamba2-130m`` and ``yi-6b`` run).

The parameters are one ``nn.Module``, :class:`LM`: ``embed.emb``,
``final_norm.g``, ``lm_head.w`` for an untied head, and an
``nn.ModuleList`` of :class:`Layer`: ``norm1.g`` and a ``mixer`` (a
:class:`~repro_torch.models.mamba.Mamba2Block` or an
:class:`~repro_torch.models.attention.Attention`), and for dense layers
``norm2.g`` and a :class:`~repro_torch.models.layers.SwiGLU` ``mlp``.
The reference stacks the period's layers and runs them with ``lax.scan``;
the port runs them as a Python loop.
:func:`repro_torch.convert.lm_params_from_jax` carries the reference's
parameters across.

Entry points, as the reference's, with the module in place of the
parameter tree: ``forward`` and ``loss_fn`` (full sequence), ``prefill``
and ``decode_step`` (serving, one cache per layer: the Mamba state, or a
KV cache of ``cache_len`` slots, ``min(cache_len, sliding_window)`` with
a window). They run under ``torch.inference_mode()``; training and
gradients wait for a later slice. Layers other than a Mamba mixer without
an mlp or attention with a dense mlp, and encoder-decoder or
cross-attention models, raise ``NotImplementedError`` (ROADMAP §A item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (_dtype, Dense, Embedding, RMSNorm,
                                       SwiGLU)

PORTED_LAYERS = (LayerSpec(mixer="mamba", mlp="none"),
                 LayerSpec(mixer="attn", mlp="dense"))


class Batch(NamedTuple):
    """One scoring / serving micro-batch (the reference's VLM and audio
    fields wait for those models)."""

    tokens: torch.Tensor                     # (B, S) int64
    labels: Optional[torch.Tensor] = None    # (B, S) next-token targets


def _check_spec(spec: LayerSpec):
    if spec not in PORTED_LAYERS:
        raise NotImplementedError(
            f"layer {spec} is not ported yet: the port runs mamba mixers "
            "without an mlp and attention with a dense mlp (ROADMAP §A "
            "item 10)")


def check_config(cfg: ModelConfig):
    """Raise for a configuration the port cannot run yet."""
    if cfg.is_encoder_decoder or cfg.cross_attn_every:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and "
                                  "cross-attention models are not ported "
                                  "yet (ROADMAP §A item 10)")
    for spec in cfg.layer_specs():
        _check_spec(spec)


class Layer(nn.Module):
    """Pre-norm residual layer: ``norm1`` and the mixer, then ``norm2`` and
    the mlp where the layer has one. The mixer's ``forward``, ``prefill``
    and ``decode`` carry its own cache kind."""

    def __init__(self, norm1: RMSNorm, mixer: nn.Module,
                 norm2: RMSNorm | None = None, mlp: SwiGLU | None = None):
        super().__init__()
        self.norm1, self.mixer = norm1, mixer
        self.norm2, self.mlp = norm2, mlp

    def _mlp(self, x):
        if self.mlp is None:
            return x
        return x + self.mlp(self.norm2(x)).to(x.dtype)

    def forward(self, x):
        return self._mlp(x + self.mixer(self.norm1(x)).to(x.dtype))

    def prefill(self, x, cache_len: int):
        h, cache = self.mixer.prefill(self.norm1(x), cache_len)
        return self._mlp(x + h.to(x.dtype)), cache

    def decode(self, x, cache):
        h, cache = self.mixer.decode(self.norm1(x), cache)
        return self._mlp(x + h.to(x.dtype)), cache


class LM(nn.Module):
    """Embedding, the layer stack, the final norm and, untied, the head."""

    def __init__(self, embed: Embedding, layers, final_norm: RMSNorm,
                 lm_head: Dense | None = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head


# the names of the Mamba-only classes these replaced
MambaLM, MambaLayer = LM, Layer


def _init_layer(generator, spec: LayerSpec, cfg: ModelConfig, dtype,
                device) -> Layer:
    d, eps = cfg.d_model, cfg.rmsnorm_eps
    norm1 = RMSNorm.init(d, dtype, device, eps)
    if spec.mixer == "mamba":
        return Layer(norm1, mam.init_mamba(generator, cfg, dtype, device))
    mixer = attn.Attention.init(generator, cfg, dtype, device)
    return Layer(norm1, mixer, RMSNorm.init(d, dtype, device, eps),
                 SwiGLU.init(generator, d, cfg.d_ff, dtype, device))


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights drawn on ``generator`` (which lives on ``device``)
    with the reference's initializers, in its order: embedding, head,
    layers."""
    check_config(cfg)
    dtype = _dtype(cfg.param_dtype)
    embed = Embedding.init(generator, cfg.vocab_size, cfg.d_model, dtype,
                           device)
    head = (None if cfg.tie_embeddings else
            Dense.init(generator, cfg.d_model, cfg.vocab_size, dtype,
                       device))
    layers = [_init_layer(generator, spec, cfg, dtype, device)
              for spec in cfg.layer_specs()]
    return LM(embed, layers, RMSNorm.init(cfg.d_model, dtype, device,
                                          cfg.rmsnorm_eps), head)


def logits_from_hidden(params: LM, x, cfg: ModelConfig):
    x = params.final_norm(x)
    if cfg.tie_embeddings:
        return x @ params.embed.emb.T
    return params.lm_head(x)


@torch.inference_mode()
def forward(params: LM, batch: Batch, cfg: ModelConfig):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    x = params.embed(batch.tokens)
    for layer in params.layers:
        x = layer(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_from_hidden(params, x, cfg), aux


@torch.inference_mode()
def loss_fn(params: LM, batch: Batch, cfg: ModelConfig):
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
    layers: Tuple   # one cache per layer, in order: MambaState or KVCache
    position: int


def _layer_cache_init(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      cache_len: int, dtype, device="cuda"):
    _check_spec(spec)
    if spec.mixer == "attn":
        return attn.init_cache(cfg, batch, attn.cache_slots(cfg, cache_len),
                               dtype, device)
    return mam.init_mamba_state(cfg, batch, dtype, device)


@torch.inference_mode()
def prefill(params: LM, batch: Batch, cfg: ModelConfig, cache_len: int):
    """Process the prompt; returns (last-token logits (B, 1, V),
    ServeState). A Mamba layer's cache is its (conv, ssm) state, whose size
    does not grow with ``cache_len``; an attention layer's holds the last
    ``cache_len`` keys and values."""
    x = params.embed(batch.tokens)
    caches = []
    for layer in params.layers:
        x, cache = layer.prefill(x, cache_len)
        caches.append(cache)
    logits = logits_from_hidden(params, x[:, -1:, :], cfg)
    return logits, ServeState(layers=tuple(caches),
                              position=batch.tokens.shape[1])


@torch.inference_mode()
def decode_step(params: LM, token, state: ServeState, cfg: ModelConfig):
    """Logits for ONE new token. token (B, 1) int64. KV caches are updated
    in place (``models/attention.py``)."""
    x = params.embed(token)
    caches = []
    for layer, cache in zip(params.layers, state.layers):
        x, cache = layer.decode(x, cache)
        caches.append(cache)
    logits = logits_from_hidden(params, x, cfg)
    return logits, ServeState(layers=tuple(caches),
                              position=state.position + 1)
