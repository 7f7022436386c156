"""Grouped-query attention with RoPE, sliding windows, KV caches and
cross-attention (twin of ``repro/models/attention.py``).

Full-sequence attention (``apply_attention``, self- or cross-), prefill
attention (``prefill_attention``) and prefill cross-attention
(``cross_attention_cached`` over a prompt) run through the flash kernel:
``ops.flash_attention`` runs on q (B Hq, S, hd) and the unexpanded k / v
(B KV, S, hd) with ``kv_group = Hq / KV``, in the reference's grouping
(KV head j serves query heads j g .. j g + g - 1, as
``q.reshape(b, s, kv, g, hd)`` groups them there: ``repeat_interleave``,
not ``repeat``), the CUDA kernel for CUDA tensors and its plain version
for CPU tensors. The reference computes these with its jnp
``_grouped_attention`` (its module docstring says the TPU prefill routes
through the Pallas kernel; its code does not); on the prompt, causal with
Sq == Sk, and unmasked (bidirectional encoder layers and cross-attention,
any Sq and Sk), the two compute the same function. ``_grouped_attention`` is
here too, the plain model-level twin the kernel path is held against.
Decode (``decode_attention``, and ``cross_attention_cached`` with
``decode=True``) is plain PyTorch over the cache, as it is jnp in the
reference.

Cross-attention (:class:`CrossAttention`, ``kv_x``) takes q from x and k /
v from the media or encoder embeddings, with no RoPE on either side and
no mask; serving computes each request's k / v once
(``precompute_cross_kv``) and reads them at every step.

Caches are the reference's: a cache of C slots, each slot holding the
absolute position of its key (``slot_pos``, -1 empty), filled at
``position % C`` so a window cache rolls and RoPE stays exact.
``length`` is a Python int. Prefill fills the cache it is given, and
decode writes its slot, in place (the returned cache shares the tensors
of the one passed in); the reference returns new arrays, but copying two
(B, C, KV, hd) tensors per layer per token would cost more than the step.
Decode masks the slots of positions after its own, so decoding twice from
one state is exact as long as the first run did not roll the cache; once
it has, the keys it overwrote are gone.

``kv_valid`` masks live keys as the reference's do: a (B, Sk) or (Sk,)
bool mask taken by ``apply_attention`` (self- and cross-attention), a
dead key scoring -1e30 like a causally masked one, so that a query row
with no live key averages v over all Sk keys. ``cfg.attn_probs_bf16``
rounds the float32 softmax's probabilities and v to bfloat16 and sums
their product in float32, in ``apply_attention`` and
``prefill_attention`` (not in decode or the cached cross-attention, as in
the reference). Both go to K5 as its two modes and to the plain
``_grouped_attention``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_dtype, Dense, apply_rope,
                                       rope_frequencies, truncated_normal)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, KV, hd)
    v: torch.Tensor          # (B, C, KV, hd)
    slot_pos: torch.Tensor   # (C,) int32 absolute position per slot, -1 empty
    length: int              # tokens seen so far


class Attention(nn.Module):
    """One attention mixer: ``wq`` (d, Hq hd), ``wk`` / ``wv`` (d, KV hd),
    ``wo`` (Hq hd, d), named as the reference's dict keys. Called as a
    layer's mixer it is causal self-attention with the config's window
    (``forward`` full-sequence, ``prefill`` and ``decode`` with a cache),
    or, with ``causal=False``, an encoder layer's bidirectional
    self-attention (``forward`` only)."""

    def __init__(self, wq, wk, wv, wo, cfg: ModelConfig, causal=True):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        self.wq, self.wk, self.wv, self.wo = (Dense(w) for w in
                                              (wq, wk, wv, wo))
        inv, self.rot_dim = rope_frequencies(
            cfg.resolved_head_dim, cfg.partial_rotary, cfg.rope_theta)
        self.register_buffer("inv_freq", inv.to(wq.device), persistent=False)

    @classmethod
    def init(cls, generator, cfg: ModelConfig, dtype, device="cuda",
             **kw) -> "Attention":
        """Drawn in the reference's order: wq, wk, wv, wo."""
        d, hd = cfg.d_model, cfg.resolved_head_dim
        shapes = ((d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                  (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d))
        return cls(*(truncated_normal(generator, s, 0.02, dtype, device)
                     for s in shapes), cfg, **kw)

    def forward(self, x):
        return apply_attention(self, x, self.cfg, causal=self.causal,
                               window=self.cfg.sliding_window)

    def prefill(self, x, cache_len: int):
        """The prompt into a new cache of ``cache_slots(cfg, cache_len)``
        slots; returns (out, cache)."""
        cache = init_cache(self.cfg, x.shape[0],
                           cache_slots(self.cfg, cache_len),
                           _dtype(self.cfg.param_dtype), x.device)
        return prefill_attention(self, x, self.cfg, cache,
                                 window=self.cfg.sliding_window)

    def decode(self, x, cache: KVCache):
        return decode_attention(self, x, self.cfg, cache,
                                window=self.cfg.sliding_window)


class CrossAttention(Attention):
    """A cross-attention mixer (the same four weights): q from the layer's
    input, k / v from the media or encoder embeddings, no RoPE, no mask.
    ``forward`` takes those embeddings (``kv_x``); ``prefill`` and
    ``decode`` take their k / v, precomputed once per request by
    :func:`precompute_cross_kv`, and keep no per-token cache."""

    def forward(self, x, kv_x):
        return apply_attention(self, x, self.cfg, kv_x=kv_x)

    def prefill(self, x, kv):
        return cross_attention_cached(self, x, kv, self.cfg)

    def decode(self, x, kv):
        return cross_attention_cached(self, x, kv, self.cfg, decode=True)


def init_attention(generator, cfg: ModelConfig, dtype, device="cuda",
                   cross: bool = False) -> Attention:
    """The reference's ``init_attention``: the same four weights, as a
    :class:`CrossAttention` with ``cross``."""
    return (CrossAttention if cross else Attention).init(generator, cfg,
                                                         dtype, device)


def _heads(t, n: int, cfg: ModelConfig):
    """(B, S, n hd) -> (B, S, n, hd)."""
    return t.reshape(t.shape[0], t.shape[1], n, cfg.resolved_head_dim)


def _qkv(p: Attention, x, cfg: ModelConfig, kv_x=None):
    """Projections split into heads: q (B, S, Hq, hd) from x, k / v (B, Sk,
    KV, hd) from ``kv_x`` (x by default)."""
    src = x if kv_x is None else kv_x
    return (_heads(p.wq(x), cfg.n_heads, cfg),
            _heads(p.wk(src), cfg.n_kv_heads, cfg),
            _heads(p.wv(src), cfg.n_kv_heads, cfg))


def _rope(p: Attention, t, positions):
    return apply_rope(t, positions, p.inv_freq, p.rot_dim)


def _kv_rows(kv_valid, b: int):
    """A (B, Sk) or (Sk,) key mask as (B, Sk) bool."""
    kv_valid = kv_valid.bool()
    return kv_valid if kv_valid.ndim == 2 else kv_valid[None].expand(b, -1)


def _flash_attention(q, k, v, *, causal, window, kv_valid=None,
                     probs_bf16=False):
    """q (B, Sq, Hq, hd), k / v (B, Sk, KV, hd) -> (B, Sq, Hq, hd) through
    ``ops.flash_attention`` on q (B Hq, S, hd) and the unexpanded k / v
    (B KV, S, hd) with ``kv_group = Hq / KV``: row-block b Hq + h reads
    KV head b KV + h // kv_group, the reference's grouping, and row b of
    ``kv_valid``."""
    b, sq, hq, hd = q.shape
    dtype = q.dtype
    if not q.dtype == k.dtype == v.dtype:
        # cross-attention on float32 media under bfloat16 weights: the
        # reference computes in float32 and returns q's type
        common = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                     v.dtype)
        q, k, v = q.to(common), k.to(common), v.to(common)

    def heads_first(t):
        return t.transpose(1, 2).reshape(-1, t.shape[1], hd)

    out = kops.flash_attention(
        heads_first(q), heads_first(k), heads_first(v), causal=causal,
        window=window, kv_group=hq // k.shape[2],
        kv_valid=None if kv_valid is None else _kv_rows(kv_valid, b),
        probs_bf16=probs_bf16)
    return out.reshape(b, hq, sq, hd).transpose(1, 2).to(dtype)


def _grouped_attention(q, k, v, *, causal, window, q_offset=0,
                       kv_valid=None, probs_bf16=False):
    """The reference's dense grouped attention: q (B, Sq, Hq, hd), k / v
    (B, Sk, KV, hd) -> (B, Sq, Hq, hd); ``q_offset`` is the absolute
    position of q[0] minus that of k[0]. Scores scaled after the product,
    float32 softmax, a window only with ``causal``; ``kv_valid`` (B, Sk)
    or (Sk,) masks keys to -1e30 too; ``probs_bf16`` sums bfloat16 p
    times bfloat16 v in float32."""
    b, sq, hq, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, hq // kv, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                     k.float()) * float(hd) ** -0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    if kv_valid is not None:
        kvm = kv_valid.bool()
        kvm = kvm if kvm.ndim == 2 else kvm[None]
        s = torch.where(kvm[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if probs_bf16:
        out = torch.einsum("bkgst,btkd->bskgd",
                           p.to(torch.bfloat16).float(),
                           v.to(torch.bfloat16).float())
    else:
        out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def apply_attention(p: Attention, x, cfg: ModelConfig, *, positions=None,
                    causal=True, window=None, kv_x=None, kv_valid=None):
    """Full (non-cached) attention over x (B, S, d): training, scoring.
    ``positions`` (1 or B, S) default to 0 .. S - 1. ``kv_x`` (B, Sk, d)
    switches to cross-attention: no RoPE on either side, no causal mask.
    ``kv_valid`` (B, Sk) or (Sk,) masks dead keys in either."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, kv_x)
    if kv_x is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None]
        q, k = _rope(p, q, positions), _rope(p, k, positions)
    else:
        causal = False
    # the reference applies a window only with causal masking
    out = _flash_attention(q, k, v, causal=causal,
                           window=window if causal else None,
                           kv_valid=kv_valid, probs_bf16=cfg.attn_probs_bf16)
    return p.wo(out.reshape(b, s, -1))


def cache_slots(cfg: ModelConfig, cache_len: int) -> int:
    """A layer's cache size: ``cache_len``, or the window where shorter."""
    return (min(cache_len, cfg.sliding_window) if cfg.sliding_window
            else cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device="cuda") -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((cache_len,), -1, dtype=torch.int32,
                            device=device),
        length=0)


def prefill_attention(p: Attention, x, cfg: ModelConfig, cache: KVCache, *,
                      window=None):
    """Causal attention over the prompt x (B, S, d), filling ``cache``.

    Rolling semantics: if the prompt is longer than the cache, only the
    last ``cache_len`` keys survive, each at slot ``position % cache_len``
    (window caches are sized to the window). Returns (out, cache).
    """
    b, s, _ = x.shape
    cache_len = cache.k.shape[1]
    q, k, v = _qkv(p, x, cfg)
    positions = torch.arange(s, device=x.device)[None]
    q, k = _rope(p, q, positions), _rope(p, k, positions)
    out = _flash_attention(q, k, v, causal=True, window=window,
                           probs_bf16=cfg.attn_probs_bf16)

    first = max(0, s - cache_len)       # only the most recent fit
    pos = positions[0, first:]
    slots = pos % cache_len
    cache.k.zero_()
    cache.v.zero_()
    cache.slot_pos.fill_(-1)
    cache.k[:, slots] = k[:, first:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, first:].to(cache.v.dtype)
    cache.slot_pos[slots] = pos.to(cache.slot_pos.dtype)
    return p.wo(out.reshape(b, s, -1)), cache._replace(length=s)


def decode_attention(p: Attention, x, cfg: ModelConfig, cache: KVCache, *,
                     window=None):
    """One-token decode, x (B, 1, d): write the slot, attend over the live
    slots (positions already rotated). Returns (out, cache)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache.length                   # absolute position of this token
    q, k, v = _qkv(p, x, cfg)
    positions = torch.full((1, 1), pos, device=x.device)
    q, k = _rope(p, q, positions), _rope(p, k, positions)

    slot = pos % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.slot_pos[slot] = pos
    # slots of later positions are left from an earlier decode of this state
    valid = (cache.slot_pos >= 0) & (cache.slot_pos <= pos)
    if window is not None:
        valid &= cache.slot_pos > pos - window
    qg = q.reshape(b, 1, cfg.n_kv_heads, -1, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                     cache.k.float()) * float(hd) ** -0.5
    s = torch.where(valid, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", prob, cache.v.float())
    out = out.reshape(b, 1, -1).to(x.dtype)
    return p.wo(out), cache._replace(length=pos + 1)


def precompute_cross_kv(p: Attention, media, cfg: ModelConfig):
    """Cross-attention k / v (B, Sk, KV, hd) from the media or encoder
    embeddings (B, Sk, d), computed once per request."""
    return (_heads(p.wk(media), cfg.n_kv_heads, cfg),
            _heads(p.wv(media), cfg.n_kv_heads, cfg))


def cross_attention_cached(p: Attention, x, kv, cfg: ModelConfig, *,
                           decode=False):
    """Cross-attention of x (B, S, d) against precomputed ``kv``: the
    prompt through the flash kernel, a decode step (``decode``, S = 1)
    plain, as decode self-attention is; in float32 probabilities either
    way (the reference's cached path takes no ``attn_probs_bf16``)."""
    b, s, _ = x.shape
    q = _heads(p.wq(x), cfg.n_heads, cfg)
    k, v = kv
    attend = _grouped_attention if decode else _flash_attention
    out = attend(q, k, v, causal=False, window=None)
    return p.wo(out.reshape(b, s, -1))
