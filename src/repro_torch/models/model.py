"""Model assembly: decoder-only, hybrid and MoE stacks, the VLM's
cross-attention layers and the encoder-decoder (twin of
``repro/models/model.py``, for all ten ids of ``configs.ARCH_IDS``).

The parameters are one ``nn.Module``, :class:`LM`: ``embed.emb``,
``final_norm.g``, ``lm_head.w`` for an untied head (a tied head reads
``embed.emb``), an ``nn.ModuleList`` of :class:`Layer`: ``norm1`` and a
``mixer`` (a :class:`~repro_torch.models.mamba.Mamba2Block`, an
:class:`~repro_torch.models.attention.Attention` or a
:class:`~repro_torch.models.attention.CrossAttention` over the batch's
media), in an encoder-decoder's decoder ``norm_x`` and a ``cross``
block over the encoder's output, and where the layer has an mlp
``norm2`` and the ``mlp``: a :class:`~repro_torch.models.layers.SwiGLU`
or a :class:`~repro_torch.models.moe.MoE`, after any mixer (Jamba's
Mamba layers carry either, Mixtral's and Kimi's attention layers the
MoE); an encoder-decoder adds ``encoder`` (bidirectional attention layers
with RoPE over the batch's frames) and ``enc_norm``. The layers run in
``cfg.layer_specs()`` order: the dense prefix
(``cfg.period_decomposition()``'s first part, Kimi's first layer) first,
then the periods. The reference stacks the period's layers and runs them
with ``lax.scan``; the port runs them as a Python loop.
:func:`repro_torch.convert.lm_params_from_jax` carries the reference's
parameters across.

Entry points, as the reference's, with the module in place of the
parameter tree: ``forward`` and ``loss_fn`` (full sequence), ``prefill``
and ``decode_step`` (serving, one cache per layer: the Mamba state, a KV
cache of ``cache_len`` slots, ``min(cache_len, sliding_window)`` with a
window, or none for a cross-attention mixer; each request's cross
K / V, of the media and of the encoder's output, computed once at
prefill and carried in ``ServeState.cross_kv``). ``forward`` and
``loss_fn`` follow the caller's grad mode: they train, attention's
gradient going through K5's backward kernel on the card
(``kernels/flash_attention.py::FlashAttention``) and a Mamba layer's
through K4's (``kernels/ssd_scan.py::SsdScan``). ``LM.forward`` is
``loss_fn``, so
``torch.func.functional_call(lm, params, (batch, cfg))`` is the loss over
a dict of parameters (``fl/round.py::make_train_step`` takes it).
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.
``forward`` returns the MoE layers' load-balance losses summed,
and ``loss_fn`` adds them, as the reference's ``_apply_layer`` does;
``prefill`` and ``decode_step`` drop them. Any mixer (attn, mamba,
cross_attn) takes any mlp (dense, moe, none), as the reference's four
layer functions do: every ``LayerSpec`` that ``cfg.layer_specs()``
yields builds, scores, serves and trains, also those no id of the zoo
has (a cross-attention mixer with an MoE mlp, an attention mixer without
an mlp).

``cfg.remat_layers`` recomputes each decoder layer in the backward, as
the reference's ``jax.checkpoint`` of ``_apply_layer`` does (the encoder's
layers, which the reference does not wrap, keep their activations):
:class:`RematLayer`, an ``autograd.Function`` whose inputs are the
layer's input, the media or encoder output it reads and its parameters
as explicit tensors, and which saves only those. Its backward runs the
layer again under ``torch.func.vjp``, so K5 and K4 launch twice a layer
in a training step (forward, recompute) and their backwards once; it
composes with ``torch.func.grad`` and ``vmap(grad)``, where
``torch.utils.checkpoint`` raises in both of its modes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (_dtype, Dense, Embedding, RMSNorm,
                                       SwiGLU)

class Batch(NamedTuple):
    """One scoring / serving micro-batch. Unused fields are None."""

    tokens: torch.Tensor                     # (B, S) int64
    labels: Optional[torch.Tensor] = None    # (B, S) next-token targets
    media: Optional[torch.Tensor] = None     # (B, M, d) VLM patch embeddings
    frames: Optional[torch.Tensor] = None    # (B, Se, d) audio frames


class Layer(nn.Module):
    """Pre-norm residual layer: ``norm1`` and the mixer; in an
    encoder-decoder's decoder, ``norm_x`` and the ``cross`` block over the
    encoder's output; then ``norm2`` and the mlp (dense or MoE) where the
    layer has one. The mixer's ``forward``, ``prefill`` and ``decode``
    carry its own cache kind; a cross-attention mixer reads the media
    (``forward``) or their precomputed K / V (``prefill``, ``decode``), the
    ``cross`` block the encoder's output or its K / V. ``forward`` returns
    (x, the MoE's aux loss or None), ``prefill`` and ``decode`` (x,
    cache)."""

    def __init__(self, norm1: RMSNorm, mixer: nn.Module,
                 norm2: RMSNorm | None = None,
                 mlp: SwiGLU | moe_mod.MoE | None = None,
                 norm_x: RMSNorm | None = None,
                 cross: attn.CrossAttention | None = None):
        super().__init__()
        self.norm1, self.mixer = norm1, mixer
        self.norm2, self.mlp = norm2, mlp
        self.norm_x, self.cross = norm_x, cross

    @property
    def cross_mixer(self) -> bool:
        return isinstance(self.mixer, attn.CrossAttention)

    def _rest(self, x, h, cross, aux=True):
        """The mixer's residual ``h``, then the cross block's (``cross`` of
        its normed input) and the mlp's. Returns (x, the MoE's aux loss, or
        None where there is none or ``aux`` is False)."""
        x = x + h.to(x.dtype)
        if self.cross is not None:
            x = x + cross(self.norm_x(x)).to(x.dtype)
        if self.mlp is None:
            return x, None
        if isinstance(self.mlp, moe_mod.MoE):
            h, aux = self.mlp(self.norm2(x), aux)
        else:
            h, aux = self.mlp(self.norm2(x)), None
        return x + h.to(x.dtype), aux

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
        x, _ = self._rest(x, h, lambda y: self.cross.prefill(y, enc_kv),
                          aux=False)
        return x, cache

    def decode(self, x, cache, media_kv=None, enc_kv=None):
        h = self.norm1(x)
        if self.cross_mixer:
            h = self.mixer.decode(h, media_kv)
        else:
            h, cache = self.mixer.decode(h, cache)
        x, _ = self._rest(x, h, lambda y: self.cross.decode(y, enc_kv),
                          aux=False)
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

    def forward(self, batch: Batch, cfg: ModelConfig):
        """:func:`loss_fn` of this module, the call that
        ``torch.func.functional_call(lm, params, (batch, cfg))`` runs."""
        return loss_fn(self, batch, cfg)


# the names of the Mamba-only classes these replaced
MambaLM, MambaLayer = LM, Layer


def _run_layer(layer: Layer, names, has_media, has_enc, tensors):
    """``layer`` on its explicit tensors (the input, the media and the
    encoder output where present, then its parameters under ``names``):
    (x, aux), aux a zero where the layer has no MoE."""
    x, rest = tensors[0], list(tensors[1:])
    media = rest.pop(0) if has_media else None
    enc_out = rest.pop(0) if has_enc else None
    x, aux = torch.func.functional_call(layer, dict(zip(names, rest)),
                                        (x, media, enc_out))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


class RematLayer(torch.autograd.Function):
    """One decoder layer without its activations: ``apply(layer, names,
    has_media, has_enc, x, [media], [enc_out], *params)`` returns (x,
    aux) as ``layer`` does (aux zero without an MoE) and saves only its
    tensor inputs; the backward runs the layer again under
    ``torch.func.vjp`` and returns every tensor input's gradient.
    ``generate_vmap_rule``: under ``vmap`` the forward and backward run
    batched, the kernels inside through their own ``vmap`` rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(layer, names, has_media, has_enc, *tensors):
        return _run_layer(layer, names, has_media, has_enc, tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        layer, names, has_media, has_enc, *tensors = inputs
        ctx.call = (layer, names, has_media, has_enc)
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, dx, daux):
        layer, names, has_media, has_enc = ctx.call

        def run(*tensors):
            return _run_layer(layer, names, has_media, has_enc, tensors)

        # detached: torch.func.grad takes its gradient with create_graph,
        # which would otherwise record the recompute into the outer graph
        # and keep every layer's activations to the end (the kernels'
        # backwards have no second derivative, so nothing is lost)
        with torch.enable_grad():
            _, pullback = torch.func.vjp(
                run, *(t.detach() for t in ctx.saved_tensors))
        return (None, None, None, None) + tuple(
            pullback((dx.detach(), daux.detach())))


def remat_layer(layer: Layer, x, media=None, enc_out=None):
    """``layer(x, media, enc_out)`` through :class:`RematLayer`; returns
    (x, aux), aux a zero where the layer has no MoE."""
    named = list(layer.named_parameters())
    media = media if layer.cross_mixer else None
    enc_out = enc_out if layer.cross is not None else None
    extra = [t for t in (media, enc_out) if t is not None]
    return RematLayer.apply(layer, tuple(n for n, _ in named),
                            media is not None, enc_out is not None, x,
                            *extra, *(t for _, t in named))


def _init_layer(generator, spec: LayerSpec, cfg: ModelConfig, dtype,
                device, with_cross: bool = False,
                causal: bool = True) -> Layer:
    """Drawn in the reference's order: the mixer, the cross block, the
    mlp. ``causal=False`` makes an encoder layer."""
    d, eps = cfg.d_model, cfg.rmsnorm_eps
    norm1 = RMSNorm.init(d, dtype, device, eps)
    if spec.mixer == "mamba":
        mixer = mam.init_mamba(generator, cfg, dtype, device)
    elif causal:
        mixer = attn.init_attention(generator, cfg, dtype, device,
                                    cross=spec.mixer == "cross_attn")
    else:
        mixer = attn.Attention.init(generator, cfg, dtype, device,
                                    causal=False)
    rest = {}
    if with_cross:
        rest = dict(norm_x=RMSNorm.init(d, dtype, device, eps),
                    cross=attn.init_attention(generator, cfg, dtype,
                                              device, cross=True))
    if spec.mlp == "moe":
        rest["mlp"] = moe_mod.init_moe(generator, cfg, dtype, device)
    elif spec.mlp == "dense":
        rest["mlp"] = SwiGLU.init(generator, d, cfg.d_ff, dtype, device)
    if spec.mlp != "none":
        rest["norm2"] = RMSNorm.init(d, dtype, device, eps)
    return Layer(norm1, mixer, **rest)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> LM:
    """Random weights drawn on ``generator`` (which lives on ``device``)
    with the reference's initializers, in its order: embedding, head,
    layers (the dense prefix first), encoder."""
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
        x, _ = layer(x)
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


def forward(params: LM, batch: Batch, cfg: ModelConfig):
    """Full-sequence forward. Returns (logits, aux_loss): the MoE layers'
    load-balance losses summed in layer order, zero without MoE."""
    x = params.embed(batch.tokens)
    enc_out = (_encode(params, batch.frames, cfg) if cfg.is_encoder_decoder
               else None)
    media = _media(batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        if cfg.remat_layers:
            x, a = remat_layer(layer, x, media, enc_out)
        else:
            x, a = layer(x, media, enc_out)
        if a is not None:
            aux = aux + a
    return logits_from_hidden(params, x, cfg), aux


def loss_fn(params: LM, batch: Batch, cfg: ModelConfig):
    """Mean next-token cross-entropy (+ the router's aux loss, zero
    without MoE). fp32 softmax."""
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
