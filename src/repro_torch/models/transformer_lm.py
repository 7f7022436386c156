"""Small decoder-only transformer LM for the federated model registry
(twin of ``repro/models/transformer_lm.py``).

Built from the zoo's blocks (``models/attention.py`` grouped-query
attention with RoPE, ``models/layers.py`` RMSNorm and SwiGLU) at
federated-client scale: a few layers, tied embeddings, float32. Batches
are ``(tokens, next_tokens)`` pairs, each (B, S) int64, from
``data/synthetic.py::make_lm_federated``, so ``lm_loss`` slots into
``fl/round.py::local_sgd`` as the image models' losses do.

The parameters are a flat dict named after the reference's tree:
``emb.emb``, ``layers.<i>.ln1.g``, ``layers.<i>.attn.w{q,k,v,o}.w``,
``layers.<i>.ln2.g``, ``layers.<i>.mlp.w{i,g,o}.w``, ``lnf.g``
(``convert.transformer_lm_params_from_jax`` carries the reference's
across). :func:`apply_lm` runs them through a parameter-less module
(:class:`TransformerLM`, weights on the meta device, the RoPE frequencies
on the tokens' device) with ``torch.func.functional_call``, so the loss is
a function of the dict, as ``torch.func.grad`` and ``vmap`` over
participants want. Attention is causal through ``ops.flash_attention``:
K5 and its backward kernel on the card (head dim 16 at the registry's
defaults, padded to 32), the plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Embedding, RMSNorm, SwiGLU,
                                       rope_frequencies, truncated_normal)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int
    d_model: int = 32
    n_heads: int = 2
    n_layers: int = 2
    d_ff: int = 64

    def model_config(self) -> ModelConfig:
        """The attention blocks consume the zoo's ModelConfig."""
        return ModelConfig(
            name="fed_lm", arch_type="dense", n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, d_ff=self.d_ff, vocab_size=self.vocab)


class Block(nn.Module):
    """``ln1``, causal ``attn``, ``ln2``, the SwiGLU ``mlp``."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm,
                 mlp: SwiGLU):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """``emb``, the blocks, ``lnf``; logits through the tied embedding."""

    def __init__(self, emb: Embedding, layers, lnf: RMSNorm):
        super().__init__()
        self.emb, self.layers, self.lnf = emb, nn.ModuleList(layers), lnf

    def forward(self, tokens):
        x = self.emb(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.lnf(x) @ self.emb.emb.T


def _module(cfg: LMConfig, weight, ones) -> TransformerLM:
    """The module of ``cfg``, each weight ``weight(shape)`` in the
    reference's draw order (the embedding, then per layer the attention's
    wq, wk, wv, wo and the mlp's wi, wg, wo), each norm gain ``ones(d)``."""
    mcfg, d, ff = cfg.model_config(), cfg.d_model, cfg.d_ff
    h = cfg.n_heads * mcfg.resolved_head_dim
    emb = Embedding(weight((cfg.vocab, d)))
    layers = []
    for _ in range(cfg.n_layers):
        attn = Attention(*(weight(s) for s in ((d, h), (d, h), (d, h),
                                               (h, d))), mcfg)
        mlp = SwiGLU(*(weight(s) for s in ((d, ff), (d, ff), (ff, d))))
        layers.append(Block(RMSNorm(ones(d)), attn, RMSNorm(ones(d)), mlp))
    return TransformerLM(emb, layers, RMSNorm(ones(d)))


def init_lm(generator: torch.Generator, cfg: LMConfig,
            device="cuda") -> dict:
    """Random parameters drawn on ``generator`` (which lives on
    ``device``): the reference's initializers (truncated normals of scale
    0.02, norm gains of one), in its order."""
    def weight(shape):
        return truncated_normal(generator, shape, 0.02, torch.float32,
                                device)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    return {k: v.detach() for k, v in
            _module(cfg, weight, ones).named_parameters()}


@functools.cache
def _shell(cfg: LMConfig, device: torch.device) -> TransformerLM:
    """The parameter-less module of ``cfg`` (weights on the meta device,
    no random draw, so it can be built inside ``vmap``), its RoPE
    frequencies (a buffer) on ``device``."""
    def meta(shape):
        return torch.empty(shape, device="meta")

    shell = _module(cfg, meta, meta)
    mcfg = cfg.model_config()
    inv, _ = rope_frequencies(mcfg.resolved_head_dim, mcfg.partial_rotary,
                              mcfg.rope_theta)
    for layer in shell.layers:
        layer.attn.inv_freq = inv.to(device)
    return shell


def apply_lm(params: dict, tokens: torch.Tensor, cfg: LMConfig):
    """tokens (B, S) int -> next-token logits (B, S, vocab). Causal
    attention, tied input / output embeddings."""
    return torch.func.functional_call(_shell(cfg, tokens.device), params,
                                      (tokens,))


def lm_loss(params: dict, batch, cfg: LMConfig):
    """batch = (tokens, next_tokens), each (B, S). Mean next-token CE."""
    tokens, targets = batch
    logp = F.log_softmax(apply_lm(params, tokens, cfg), dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets[..., None]))


def lm_accuracy(params: dict, tokens, targets, cfg: LMConfig):
    """Mean next-token top-1 accuracy over (T, S) token / target arrays."""
    with torch.no_grad():
        preds = apply_lm(params, tokens, cfg).argmax(-1)
    return (preds == targets).to(torch.float32).mean()
