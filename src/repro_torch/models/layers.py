"""Primitive layers (twin of ``repro/models/layers.py``: dense, embedding,
RMSNorm). RoPE and SwiGLU wait for the attention slice (ROADMAP §A item
10).

Each layer is an ``nn.Module`` whose parameter carries the reference's
dict key (``w``, ``emb``, ``g``), so ``in_proj.w`` here is
``["in_proj"]["w"]`` there. Initializers draw truncated normals (+-2 sd)
on a ``torch.Generator``: the reference's recipe, not its numbers.
"""

from __future__ import annotations

import torch
from torch import nn


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def truncated_normal(generator, shape, scale, dtype, device):
    """scale * N(0, 1) truncated to +-2, drawn in float32 on ``device``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def _param(value: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(value, requires_grad=False)


class Dense(nn.Module):
    """``x @ w`` with ``w`` (d_in, d_out), the reference's layout."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w


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
