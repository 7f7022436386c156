"""Model assembly: decoder-only stacks, the VLM's cross-attention layers
and the encoder-decoder (twin of ``repro/models/model.py``, for the
seven ids the port runs: ``mamba2-130m``, ``yi-6b``, ``chatglm3-6b``,
``minicpm-2b``, ``granite-20b``, ``llama-3.2-vision-11b`` and
``seamless-m4t-large-v2``).

The parameters are one ``nn.Module``, :class:`LM`: ``embed.emb``,
``final_norm.g``, ``lm_head.w`` for an untied head (a tied head reads
``embed.emb``), an ``nn.ModuleList`` of :class:`Layer`: ``norm1`` and a
``mixer`` (a :class:`~repro_torch.models.mamba.Mamba2Block`, an
:class:`~repro_torch.models.attention.Attention` or a
:class:`~repro_torch.models.attention.CrossAttention` over the batch's
media), in an encoder-decoder's decoder ``norm_x`` and a ``cross``
block over the encoder's output, and for dense layers ``norm2`` and a
:class:`~repro_torch.models.layers.SwiGLU` ``mlp``; an encoder-decoder
adds ``encoder`` (bidirectional attention layers with RoPE over the
batch's frames) and ``enc_norm``. The reference stacks the period's
layers and runs them with ``lax.scan``; the port runs them as a Python
loop. :func:`repro_torch.convert.lm_params_from_jax` carries the
reference's parameters across.

Entry points, as the reference's, with the module in place of the
parameter tree: ``forward`` and ``loss_fn`` (full sequence), ``prefill``
and ``decode_step`` (serving, one cache per layer: the Mamba state, a KV
cache of ``cache_len`` slots, ``min(cache_len, sliding_window)`` with a
window, or none for a cross-attention mixer; each request's cross
K / V, of the media and of the encoder's output, computed once at
prefill and carried in ``ServeState.cross_kv``). They run under
``torch.inference_mode()``; training and gradients wait for a later
slice. MoE layers and Mamba layers with an mlp (``mixtral-8x22b``,
``jamba-v0.1-52b``, ``kimi-k2-1t-a32b``) raise ``NotImplementedError``
(ROADMAP §A item 10).
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
                 LayerSpec(mixer="attn", mlp="dense"),
                 LayerSpec(mixer="cross_attn", mlp="dense"))


class Batch(NamedTuple):
    """One scoring / serving micro-batch. Unused fields are None."""

    tokens: torch.Tensor                     # (B, S) int64
    labels: Optional[torch.Tensor] = None    # (B, S) next-token targets
    media: Optional[torch.Tensor] = None     # (B, M, d) VLM patch embeddings
    frames: Optional[torch.Tensor] = None    # (B, Se, d) audio frames


def _check_spec(spec: LayerSpec):
    if spec not in PORTED_LAYERS:
        raise NotImplementedError(
            f"layer {spec} is not ported yet: the port runs mamba mixers "
            "without an mlp and self- or cross-attention with a dense mlp "
            "(ROADMAP §A item 10)")


def check_config(cfg: ModelConfig):
    """Raise for a configuration the port cannot run yet."""
    for spec in cfg.layer_specs():
        _check_spec(spec)


class Layer(nn.Module):
    """Pre-norm residual layer: ``norm1`` and the mixer; in an
    encoder-decoder's decoder, ``norm_x`` and the ``cross`` block over the
    encoder's output; then ``norm2`` and the mlp where the layer has one.
    The mixer's ``forward``, ``prefill`` and ``decode`` carry its own cache
    kind; a cross-attention mixer reads the media (``forward``) or their
    precomputed K / V (``prefill``, ``decode``), the ``cross`` block the
    encoder's output or its K / V."""

    def __init__(self, norm1: RMSNorm, mixer: nn.Module,
                 norm2: RMSNorm | None = None, mlp: SwiGLU | None = None,
                 norm_x: RMSNorm | None = None,
                 cross: attn.CrossAttention | None = None):
        super().__init__()
        self.norm1, self.mixer = norm1, mixer
        self.norm2, self.mlp = norm2, mlp
        self.norm_x, self.cross = norm_x, cross

    @property
    def cross_mixer(self) -> bool:
        return isinstance(self.mixer, attn.CrossAttention)

    def _rest(self, x, h, cross):
        """The mixer's residual ``h``, then the cross block's (``cross`` of
        its normed input) and the mlp's."""
        x = x + h.to(x.dtype)
        if self.cross is not None:
            x = x + cross(self.norm_x(x)).to(x.dtype)
        if self.mlp is None:
            return x
        return x + self.mlp(self.norm2(x)).to(x.dtype)

    def forward(self, x, media=None, enc_out=None):
        h = self.norm1(x)
        h = self.mixer(h, media) if self.cross_mixer else self.mixer(h)
        return self._rest(x, h, lambda y: self.cross(y, enc_out))

    def prefill(self, x, cache_len: int, media_kv=None, enc_kv=None):
        h = self.norm1(x)
        if self.cross_mixer:
            h, cache = self.mixer.prefill(h, media_kv), None
        else:
            h, cache = self.mixer.prefill(h, cache_len)
        x = self._rest(x, h, lambda y: self.cross.prefill(y, enc_kv))
        return x, cache

    def decode(self, x, cache, media_kv=None, enc_kv=None):
        h = self.norm1(x)
        if self.cross_mixer:
            h = self.mixer.decode(h, media_kv)
        else:
            h, cache = self.mixer.decode(h, cache)
        x = self._rest(x, h, lambda y: self.cross.decode(y, enc_kv))
        return x, cache


class LM(nn.Module):
    """Embedding, the layer stack, the final norm and, untied, the head; an
    encoder-decoder's encoder layers and ``enc_norm``."""

    def __init__(self, embed: Embedding, layers, final_norm: RMSNorm,
                 lm_head: Dense | None = None, encoder=None,
                 enc_norm: RMSNorm | None = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.encoder = None if encoder is None else nn.ModuleList(encoder)
        self.enc_norm = enc_norm


# the names of the Mamba-only classes these replaced
MambaLM, MambaLayer = LM, Layer


def _init_layer(generator, spec: LayerSpec, cfg: ModelConfig, dtype,
                device, with_cross: bool = False,
                causal: bool = True) -> Layer:
    """Drawn in the reference's order: the mixer, the cross block, the
    mlp. ``causal=False`` makes an encoder layer."""
    d, eps = cfg.d_model, cfg.rmsnorm_eps
    norm1 = RMSNorm.init(d, dtype, device, eps)
    if spec.mixer == "mamba":
        return Layer(norm1, mam.init_mamba(generator, cfg, dtype, device))
    if causal:
        mixer = attn.init_attention(generator, cfg, dtype, device,
                                    cross=spec.mixer == "cross_attn")
    else:
        mixer = attn.Attention.init(generator, cfg, dtype, device,
                                    causal=False)
    cross = {}
    if with_cross:
        cross = dict(norm_x=RMSNorm.init(d, dtype, device, eps),
                     cross=attn.init_attention(generator, cfg, dtype,
                                               device, cross=True))
    return Layer(norm1, mixer, RMSNorm.init(d, dtype, device, eps),
                 SwiGLU.init(generator, d, cfg.d_ff, dtype, device), **cross)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights drawn on ``generator`` (which lives on ``device``)
    with the reference's initializers, in its order: embedding, head,
    layers, encoder."""
    check_config(cfg)
    dtype = _dtype(cfg.param_dtype)
    d, eps = cfg.d_model, cfg.rmsnorm_eps
    embed = Embedding.init(generator, cfg.vocab_size, d, dtype, device)
    head = (None if cfg.tie_embeddings else
            Dense.init(generator, d, cfg.vocab_size, dtype, device))
    layers = [_init_layer(generator, spec, cfg, dtype, device,
                          with_cross=cfg.is_encoder_decoder)
              for spec in cfg.layer_specs()]
    encoder = enc_norm = None
    if cfg.is_encoder_decoder:
        (enc_spec,), n_enc = cfg.encoder_period()
        encoder = [_init_layer(generator, enc_spec, cfg, dtype, device,
                               causal=False) for _ in range(n_enc)]
        enc_norm = RMSNorm.init(d, dtype, device, eps)
    return LM(embed, layers, RMSNorm.init(d, dtype, device, eps), head,
              encoder, enc_norm)


def _encode(params: LM, frames, cfg: ModelConfig):
    """The bidirectional encoder over the stub frame embeddings (B, Se,
    d), then ``enc_norm``."""
    if frames is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                         "batch.frames")
    x = frames
    for layer in params.encoder:
        x = layer(x)
    return params.enc_norm(x)


def _media(batch: Batch, cfg: ModelConfig):
    if cfg.cross_attn_every and batch.media is None:
        raise ValueError(f"{cfg.name}: cross-attention layers need "
                         "batch.media")
    return batch.media


def logits_from_hidden(params: LM, x, cfg: ModelConfig):
    x = params.final_norm(x)
    if cfg.tie_embeddings:
        return x @ params.embed.emb.T
    return params.lm_head(x)


@torch.inference_mode()
def forward(params: LM, batch: Batch, cfg: ModelConfig):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    x = params.embed(batch.tokens)
    enc_out = (_encode(params, batch.frames, cfg) if cfg.is_encoder_decoder
               else None)
    media = _media(batch, cfg)
    for layer in params.layers:
        x = layer(x, media, enc_out)
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
    layers: Tuple     # one cache per layer: MambaState, KVCache or None
    position: int
    # one (media K / V, encoder K / V) pair per layer, each None where the
    # layer has no such block: the K / V of a cross-attention mixer and of
    # a decoder layer's cross block, computed once at prefill
    cross_kv: Tuple


def _layer_cache_init(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      cache_len: int, dtype, device="cuda"):
    _check_spec(spec)
    if spec.mixer == "attn":
        return attn.init_cache(cfg, batch, attn.cache_slots(cfg, cache_len),
                               dtype, device)
    if spec.mixer == "mamba":
        return mam.init_mamba_state(cfg, batch, dtype, device)
    return None  # cross_attn: precomputed K / V, no per-token state


def _cross_sources(params: LM, batch: Batch, cfg: ModelConfig) -> Tuple:
    """Each layer's cross-attention K / V, computed once per request: a
    cross-attention mixer's over the media, a decoder layer's cross
    block's over the encoder's output."""
    media = _media(batch, cfg)
    enc_out = (_encode(params, batch.frames, cfg) if cfg.is_encoder_decoder
               else None)
    return tuple(
        (attn.precompute_cross_kv(layer.mixer, media, cfg)
         if layer.cross_mixer else None,
         attn.precompute_cross_kv(layer.cross, enc_out, cfg)
         if layer.cross is not None else None)
        for layer in params.layers)


@torch.inference_mode()
def prefill(params: LM, batch: Batch, cfg: ModelConfig, cache_len: int):
    """Process the prompt; returns (last-token logits (B, 1, V),
    ServeState). A Mamba layer's cache is its (conv, ssm) state, whose size
    does not grow with ``cache_len``; an attention layer's holds the last
    ``cache_len`` keys and values; a cross-attention mixer's is None (its
    K / V are in ``cross_kv``)."""
    x = params.embed(batch.tokens)
    cross_kv = _cross_sources(params, batch, cfg)
    caches = []
    for layer, kv in zip(params.layers, cross_kv):
        x, cache = layer.prefill(x, cache_len, *kv)
        caches.append(cache)
    logits = logits_from_hidden(params, x[:, -1:, :], cfg)
    return logits, ServeState(layers=tuple(caches),
                              position=batch.tokens.shape[1],
                              cross_kv=cross_kv)


@torch.inference_mode()
def decode_step(params: LM, token, state: ServeState, cfg: ModelConfig):
    """Logits for ONE new token. token (B, 1) int64. KV caches are updated
    in place (``models/attention.py``); the cross K / V are the
    prefill's, read and never recomputed."""
    x = params.embed(token)
    caches = []
    for layer, cache, kv in zip(params.layers, state.layers,
                                state.cross_kv):
        x, cache = layer.decode(x, cache, *kv)
        caches.append(cache)
    logits = logits_from_hidden(params, x, cfg)
    return logits, state._replace(layers=tuple(caches),
                                  position=state.position + 1)
