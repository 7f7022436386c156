"""Inputs and weights made from the run's seed, on the run's device: the
LM's weights and its token batches. The program and the plain reference
receive the same tensors.
"""

from __future__ import annotations

import torch

MASK63 = (1 << 63) - 1


def mix(seed: int, *salt: int) -> int:
    """``seed`` and ``salt`` folded into 63 bits: any whole number is a
    seed."""
    h = int(seed) & MASK63
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + int(s)) & MASK63
    return h


def seeded(device, seed: int, *salt: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``salt``."""
    return torch.Generator(device=device).manual_seed(mix(seed, *salt))


# ------------------------------------------------------------------- LM

def lm_weight_shapes(cfg: dict, n_layers: int) -> dict:
    """The LM's weights by the benchmark's names: embedding, untied head,
    final norm, and per layer the attention's q, k, v, o, the SwiGLU's
    wi, wg, wo and the two RMSNorm gains."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hd = d // cfg["num_attention_heads"]
    hq, hkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    shapes = {"embed": (v, d), "head": (d, v)}
    for i in range(n_layers):
        shapes.update({f"{i}.wq": (d, hq), f"{i}.wk": (d, hkv),
                       f"{i}.wv": (d, hkv), f"{i}.wo": (hq, d),
                       f"{i}.wi": (d, f), f"{i}.wg": (d, f),
                       f"{i}.wo_mlp": (f, d)})
    return shapes


def lm_weights(gen, cfg: dict, n_layers: int, device, scale=0.02) -> dict:
    """Every weight matrix as a view of one buffer drawn in one call:
    ``scale`` N(0, 1) truncated at 2 sd; the RMSNorm gains ones."""
    shapes = lm_weight_shapes(cfg, n_layers)
    total = sum(torch.Size(s).numel() for s in shapes.values())
    buf = torch.randn((total,), generator=gen, device=device)
    buf.clamp_(-2.0, 2.0).mul_(scale)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = torch.Size(shape).numel()
        out[name] = buf[at:at + n].view(shape)
        at += n
    d = cfg["hidden_size"]
    ones = torch.ones((2 * n_layers + 1, d), device=device)
    for i in range(n_layers):
        out[f"{i}.norm1"], out[f"{i}.norm2"] = ones[2 * i], ones[2 * i + 1]
    out["final_norm"] = ones[-1]
    return out


def token_batches(gen, n, batch, seq, vocab, device):
    """``n`` distinct (tokens, next-token labels) batches, each (batch,
    seq) int64 drawn uniformly, labels the tokens rolled by one."""
    tokens = torch.randint(0, vocab, (n, batch, seq), generator=gen,
                           device=device)
    return tokens, torch.roll(tokens, -1, dims=-1)
