"""Mamba-2 block, SSD form (twin of ``repro/models/mamba.py``).

Fused input projection to (z, x, B, C, dt), causal depthwise conv over
(x, B, C), softplus dt with a learned bias, SSD mixing with per-head A and
skip D, gated RMSNorm, output projection. The full-sequence and prefill
paths run the chunked scan through ``ops.ssd`` (the CUDA kernel for CUDA
tensors, its plain version on the CPU), asking for the final state only in
prefill; decode carries (conv, ssm) state and costs O(1) per token.

Layouts are the reference's at every function: x (B, S, H, P), dt
(B, S, H), B and C (B, S, N), the state (B, H, N, P). The plain modules
mirror the reference's op order: the conv sums ``full[:, j:j+s] * w[j]``
for j in order (``F.conv1d`` sums in another order), softplus is
``logaddexp(x, 0)`` as ``jax.nn.softplus`` is (PyTorch's ``softplus``
switches to x above a threshold), and the gated norm is ``y silu(z)``,
the mean of squares, then ``rsqrt``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, _param, truncated_normal


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, ksize-1, conv_dim) recent conv inputs
    ssm: torch.Tensor    # (B, n_heads, d_state, head_p) SSD state (fp32)


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nh, conv_dim


class Mamba2Block(nn.Module):
    """One Mamba-2 mixer; parameters named as the reference's dict keys."""

    def __init__(self, params: dict, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.in_proj = Dense(params["in_proj"]["w"])
        self.out_proj = Dense(params["out_proj"]["w"])
        for name in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
                     "norm_g"):
            self.register_parameter(name, _param(params[name]))

    def forward(self, x, state: MambaState | None = None,
                return_state: bool = False):
        return apply_mamba(self, x, self.cfg, state, return_state)

    def prefill(self, x, cache_len: int):
        """The prompt from a zero state; returns (out, final state), whose
        size does not grow with ``cache_len``."""
        return apply_mamba(self, x, self.cfg, return_state=True)

    def decode(self, x, state: MambaState):
        return decode_mamba(self, x, self.cfg, state)


def init_mamba(generator, cfg: ModelConfig, dtype,
               device="cuda") -> Mamba2Block:
    """The reference's initializers, drawn on ``generator``."""
    d_in, nh, conv_dim = _dims(cfg)
    n = cfg.ssm_state
    proj_out = 2 * d_in + 2 * n + nh

    def f32(x):
        return x.to(device=device, dtype=torch.float32)

    params = {
        "in_proj": {"w": truncated_normal(generator, (cfg.d_model, proj_out),
                                          0.02, dtype, device)},
        "conv_w": truncated_normal(generator, (cfg.ssm_conv, conv_dim), 0.1,
                                   dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": f32(torch.log(torch.linspace(1.0, 16.0, nh))),
        "d_skip": f32(torch.ones((nh,))),
        "dt_bias": f32(torch.full((nh,), -2.0)),  # softplus(-2) ~ 0.13
        "norm_g": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": {"w": truncated_normal(generator, (d_in, cfg.d_model),
                                           0.02, dtype, device)},
    }
    return Mamba2Block(params, cfg)


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_in, nh, _ = _dims(cfg)
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in, n, n, nh], dim=-1)


def _causal_conv(xbc, conv_w, conv_b, history=None):
    """Depthwise causal conv1d. xbc (B, S, C); history (B, k-1, C) or
    None."""
    ksize = conv_w.shape[0]
    if history is None:
        history = xbc.new_zeros((xbc.shape[0], ksize - 1, xbc.shape[-1]))
    full = torch.cat([history, xbc], dim=1)              # (B, S+k-1, C)
    # windowed sum: out[t] = sum_j w[j] * full[t+j]
    s = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for j in range(ksize):
        out = out + full[:, j:j + s, :] * conv_w[j]
    out = out + conv_b
    new_hist = full[:, full.shape[1] - (ksize - 1):, :]
    return F.silu(out), new_hist


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gated_norm(y, z, g, eps):
    h = y * F.silu(z)
    hf = h.float()
    var = torch.mean(hf * hf, dim=-1, keepdim=True)
    return (hf * torch.rsqrt(var + eps)).to(y.dtype) * g


def apply_mamba(p: Mamba2Block, x, cfg: ModelConfig,
                state: MambaState | None = None, return_state: bool = False):
    """Full-sequence / prefill path over x (B, S, d_model)."""
    d_in, nh, _ = _dims(cfg)
    b, s, _ = x.shape
    z, xs, bm, cm, dt = _split_proj(p.in_proj(x), cfg)
    xbc = torch.cat([xs, bm, cm], dim=-1)
    hist = state.conv if state is not None else None
    xbc, new_hist = _causal_conv(xbc, p.conv_w, p.conv_b, hist)
    xs, bm, cm = torch.split(xbc, [d_in, cfg.ssm_state, cfg.ssm_state],
                             dim=-1)

    dtf = _softplus(dt.float() + p.dt_bias)                   # (B,S,nh)
    a = -torch.exp(p.a_log)                                   # (nh,)
    xh = xs.reshape(b, s, nh, cfg.ssm_headdim)
    h0 = state.ssm if state is not None else None
    out = kops.ssd(xh, dtf, a, bm, cm, chunk=cfg.ssm_chunk, h0=h0,
                   return_state=return_state)
    y, h_final = out if return_state else (out, None)
    y = y + p.d_skip[None, None, :, None] * xh
    y = y.reshape(b, s, d_in)
    y = _gated_norm(y, z, p.norm_g, cfg.rmsnorm_eps)
    out = p.out_proj(y)
    if return_state:
        return out, MambaState(conv=new_hist, ssm=h_final)
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> MambaState:
    d_in, nh, conv_dim = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, nh, cfg.ssm_state, cfg.ssm_headdim),
                        dtype=torch.float32, device=device),
    )


def decode_mamba(p: Mamba2Block, x, cfg: ModelConfig, state: MambaState
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrent step. x (B, 1, d_model)."""
    d_in, nh, _ = _dims(cfg)
    b = x.shape[0]
    z, xs, bm, cm, dt = _split_proj(p.in_proj(x), cfg)
    xbc = torch.cat([xs, bm, cm], dim=-1)                # (B, 1, conv_dim)
    xbc, new_hist = _causal_conv(xbc, p.conv_w, p.conv_b, state.conv)
    xs, bm, cm = torch.split(xbc, [d_in, cfg.ssm_state, cfg.ssm_state],
                             dim=-1)

    dtf = _softplus(dt[:, 0].float() + p.dt_bias)             # (B, nh)
    a = -torch.exp(p.a_log)
    xh = xs[:, 0].reshape(b, nh, cfg.ssm_headdim)
    y, new_ssm = kops.ssd_decode_step(state.ssm, xh, dtf, a, bm[:, 0],
                                      cm[:, 0])
    y = y + p.d_skip[None, :, None] * xh
    y = y.reshape(b, 1, d_in)
    y = _gated_norm(y, z, p.norm_g, cfg.rmsnorm_eps)
    return p.out_proj(y), MambaState(conv=new_hist, ssm=new_ssm)
