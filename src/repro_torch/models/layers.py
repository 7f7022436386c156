"""Primitive layers (twin of ``repro/models/layers.py``: dense, embedding,
RMSNorm, RoPE, SwiGLU).

Each layer is an ``nn.Module`` whose parameter carries the reference's
dict key (``w``, ``emb``, ``g``), so ``in_proj.w`` here is
``["in_proj"]["w"]`` there and ``mlp.wi.w`` is ``["mlp"]["wi"]["w"]``.
Initializers draw truncated normals (+-2 sd) on a ``torch.Generator``:
the reference's recipe, not its numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def truncated_normal(generator, shape, scale, dtype, device):
    """scale * N(0, 1) truncated to +-2, drawn in float32 on ``device``.
    A float32 draw is scaled in place (the bits of ``w * scale``), so the
    only full-size tensor is the result: a 22.5 GB expert stack needs no
    second one."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    if dtype == torch.float32:
        return w.mul_(scale)
    return (w * scale).to(dtype)


def _param(value: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(value, requires_grad=False)


class Dense(nn.Module):
    """``x @ w`` with ``w`` (d_in, d_out), the reference's layout; x and w
    of two types are both promoted first, as jnp's product promotes them
    (a float32 activation times bfloat16 weights is a float32 product)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)

    @classmethod
    def init(cls, generator, d_in: int, d_out: int, dtype,
             device) -> "Dense":
        return cls(truncated_normal(generator, (d_in, d_out), 0.02, dtype,
                                    device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        if x.dtype != w.dtype:
            common = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(common), w.to(common)
        return x @ w


class Embedding(nn.Module):
    """Row lookup in ``emb`` (vocab, d)."""

    def __init__(self, emb: torch.Tensor):
        super().__init__()
        self.emb = _param(emb)

    @classmethod
    def init(cls, generator, vocab: int, d: int, dtype,
             device) -> "Embedding":
        return cls(truncated_normal(generator, (vocab, d), 0.02, dtype,
                                    device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.emb[tokens]


class RMSNorm(nn.Module):
    def __init__(self, g: torch.Tensor, eps: float = 1e-5):
        super().__init__()
        self.g = _param(g)
        self.eps = eps

    @classmethod
    def init(cls, d: int, dtype, device, eps: float = 1e-5) -> "RMSNorm":
        return cls(torch.ones((d,), dtype=dtype, device=device), eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``apply_rmsnorm``: float32 mean of squares,
        rsqrt, back to x's type, times g."""
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.g


# ------------------------------------------------------------------ RoPE

def rope_frequencies(head_dim: int, rotary_frac: float, theta: float):
    """Inverse frequencies of the rotary (possibly partial) subspace, as a
    float32 CPU tensor, and the rotated width: ``1 / theta ** (2i /
    rot_dim)``, the reference's op order, with the power rounded once to
    float32 from float64 (PyTorch's vectorised float32 ``pow`` is off by
    one ulp in some lanes, e.g. i = 19 at theta 5e6, D 128, where the
    reference's is not; the angles at position 2,000 would differ by 2e-6).
    Callers move it to their device once, so the card and the CPU rotate by
    the same frequencies."""
    rot_dim = int(head_dim * rotary_frac)
    rot_dim -= rot_dim % 2
    exponents = torch.arange(0, rot_dim, 2, dtype=torch.float32) / rot_dim
    return 1.0 / (theta ** exponents.double()).float(), rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, rot_dim: int) -> torch.Tensor:
    """Rotate the first ``rot_dim`` dims of x (..., seq, heads, head_dim),
    adjacent pairs (x[2i], x[2i+1]) by ``positions * inv_freq[i]``.

    ``positions`` (..., seq) broadcasts over heads; the angles are float32
    ``positions * inv_freq``, as the reference computes them. Partial
    rotary (rot_dim < head_dim) passes the other dims through.
    """
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv_freq         # (..., s, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), xp], dim=-1)


# ------------------------------------------------------------------ MLP

class SwiGLU(nn.Module):
    """``wo(silu(wg x) * wi x)``; parameters ``wi``, ``wg`` (d, d_ff) and
    ``wo`` (d_ff, d)."""

    def __init__(self, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wi, self.wg, self.wo = Dense(wi), Dense(wg), Dense(wo)

    @classmethod
    def init(cls, generator, d: int, d_ff: int, dtype, device) -> "SwiGLU":
        """Drawn in the reference's order: wi, wg, wo."""
        return cls(*(truncated_normal(generator, shape, 0.02, dtype, device)
                     for shape in ((d, d_ff), (d, d_ff), (d_ff, d))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(F.silu(self.wg(x)) * self.wi(x))
