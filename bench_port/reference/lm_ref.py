"""Plain reference of one SGD step of a dense GQA decoder (Yi's layer,
arXiv:2403.04652, llama's architecture): token embedding; per layer an
RMSNorm, grouped-query causal attention with rotary positions, the
residual, an RMSNorm, a SwiGLU mlp and the residual; the final RMSNorm,
the untied head and the mean next-token cross-entropy.

Float32 with plain PyTorch operations; the caller decides whether the
card may round products to TF32 (the configuration states float32: it
may not). Memory is bounded the plain way: the forward keeps only each
layer's input, and the backward runs one layer at a time again under
autograd; attention runs one batch row at a time. Rotary positions
rotate adjacent pairs (x[2i], x[2i+1]), the port's convention; the
published model rotates the two halves of a head, the same function
under a fixed permutation of the q and k weights' columns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, g, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * g


def rope_tables(seq, head_dim, theta, device):
    """cos and sin (S, head_dim / 2) of position p times 1 / theta ^
    (2 i / head_dim), the frequencies rounded once from float64, the
    angles a float32 product (the configuration's precision)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim
    inv = (1.0 / theta ** exps).float().to(device)
    ang = torch.arange(seq, device=device).float()[:, None] * inv[None]
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin):
    """x (B, S, H, D): each adjacent pair rotated by its angle."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       dim=-1).flatten(-2)


def causal_attention(q, k, v):
    """q (B, S, Hq, D), k / v (B, S, KV, D): query head h reads KV head
    h // (Hq / KV); scaled scores, the causal mask, a float32 softmax;
    one batch row at a time."""
    b, s, hq, d = q.shape
    group = hq // k.shape[2]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    rows = []
    for i in range(b):
        qi = q[i].transpose(0, 1)                               # (Hq, S, D)
        ki = k[i].transpose(0, 1).repeat_interleave(group, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(group, 0)
        scores = (qi @ ki.transpose(1, 2)) * d ** -0.5
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        rows.append((p @ vi).transpose(0, 1))                   # (S, Hq, D)
    return torch.stack(rows)


def layer(w: dict, i: int, x, cfg: dict, tables):
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    eps = cfg["rms_norm_eps"]
    b, s, _ = x.shape
    h = rmsnorm(x, w[f"{i}.norm1"], eps)
    q = (h @ w[f"{i}.wq"]).view(b, s, -1, hd)
    k = (h @ w[f"{i}.wk"]).view(b, s, -1, hd)
    v = (h @ w[f"{i}.wv"]).view(b, s, -1, hd)
    q, k = rope(q, *tables), rope(k, *tables)
    x = x + causal_attention(q, k, v).reshape(b, s, -1) @ w[f"{i}.wo"]
    h = rmsnorm(x, w[f"{i}.norm2"], eps)
    return x + (F.silu(h @ w[f"{i}.wg"]) * (h @ w[f"{i}.wi"])) \
        @ w[f"{i}.wo_mlp"]


def head_loss(w: dict, x, labels, cfg: dict):
    logits = rmsnorm(x, w["final_norm"], cfg["rms_norm_eps"]) @ w["head"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def loss_and_grads(w: dict, tokens, labels, cfg: dict, n_layers: int,
                   rows=None):
    """The mean loss over the batch (or over its first ``rows`` rows) and
    every weight's gradient, layer by layer."""
    if rows is not None:
        tokens, labels = tokens[:rows], labels[:rows]
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    tables = rope_tables(tokens.shape[1], hd, cfg["rope_theta"],
                         tokens.device)
    xs = [w["embed"][tokens]]
    with torch.no_grad():
        for i in range(n_layers):
            xs.append(layer(w, i, xs[-1], cfg, tables))
    grads = {}
    with torch.enable_grad():
        x = xs[-1].detach().requires_grad_(True)
        names = ["final_norm", "head"]
        leaves = [w[n].detach().requires_grad_(True) for n in names]
        loss = head_loss(dict(zip(names, leaves)), x, labels, cfg)
        dx, *gs = torch.autograd.grad(loss, [x] + leaves)
        grads.update(zip(names, gs))
        del xs[-1]
        for i in reversed(range(n_layers)):
            x = xs.pop().detach().requires_grad_(True)
            names = [n for n in w if n.startswith(f"{i}.")]
            leaves = [w[n].detach().requires_grad_(True) for n in names]
            out = layer(dict(zip(names, leaves)), i, x, cfg, tables)
            dx, *gs = torch.autograd.grad(out, [x] + leaves, dx)
            grads.update(zip(names, gs))
    grads["embed"] = torch.zeros_like(w["embed"]).index_add_(
        0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
    return float(loss.detach()), grads


def sgd_step(w: dict, tokens, labels, cfg: dict, n_layers: int,
             gamma: float, rows=None):
    """One plain SGD step in float32: (new weights, loss)."""
    loss, grads = loss_and_grads(w, tokens, labels, cfg, n_layers, rows)
    return {k: v - gamma * grads[k] for k, v in w.items()}, loss
