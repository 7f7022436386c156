"""Mixture-of-Experts with sort-based capacity dispatch (twin of
``repro/models/moe.py``).

The router runs in float32: softmax over the experts, the top k, the k
weights renormalised to sum to one. Ties in the top k go to the lower
expert index, as ``jax.lax.top_k`` gives them: a stable descending sort,
where ``torch.topk`` promises no order. The (token, k) pairs are sorted by
expert id with a stable sort over their flat order, so an expert's
``capacity`` slots go to its first pairs in token order and the rest are
dropped. The kept pairs fill an (E, C) buffer (one overflow row takes the
dropped ones and is cut off), the experts run as grouped SwiGLU products
(``ecd,edf->ecf``, ``torch.bmm``), and each token gathers its k weighted
slot outputs back, summed in ascending expert order: the order in which
the reference's scatter-add meets them, and a fixed one, so the combine is
the same from run to run on the card (an ``index_add_`` of the k terms is
not). The aux loss is the Switch load-balance loss. MoE has no TPU kernel
in the reference, and none here.

Parameters are the reference's: ``router.w`` (d, E) float32, ``wi`` /
``wg`` (E, d, ff) and ``wo`` (E, ff, d) in the parameter type.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, _param, truncated_normal


class MoE(nn.Module):
    """One MoE mlp: ``router`` (a :class:`Dense`, float32) and the stacked
    expert weights ``wi``, ``wg``, ``wo``."""

    def __init__(self, router_w, wi, wg, wo, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.router = Dense(router_w)
        self.wi, self.wg, self.wo = _param(wi), _param(wg), _param(wo)

    def forward(self, x, aux: bool = True):
        return apply_moe(self, x, self.cfg, aux)


def init_moe(generator, cfg: ModelConfig, dtype, device="cuda") -> MoE:
    """Drawn in the reference's order: router, wi, wg, wo; each expert
    stack straight into its final tensor."""
    d, ff, e = cfg.d_model, cfg.resolved_moe_ff, cfg.n_experts
    router = truncated_normal(generator, (d, e), 0.02, torch.float32, device)
    return MoE(router, *(truncated_normal(generator, shape, 0.02, dtype,
                                          device)
                         for shape in ((e, d, ff), (e, d, ff), (e, ff, d))),
               cfg)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ceil(T k cf / E), 8-aligned, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, c + (-c) % 8)


class Routing(NamedTuple):
    probs: torch.Tensor     # (T, E) float32 softmax of the router
    weights: torch.Tensor   # (T, K) renormalised top-k probabilities
    ids: torch.Tensor       # (T, K) int64 expert ids, best first


class Dispatch(NamedTuple):
    dest: torch.Tensor      # (T K,) buffer slot of each flat (token, k)
                            # pair in flat order, E C where dropped
    buf_tok: torch.Tensor   # (E C,) token of each slot, T where empty
    buf_w: torch.Tensor     # (E C,) float32 weight of each slot, 0 empty


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The float32 router over tokens ``xt`` (T, d)."""
    logits = xt.float() @ p.router.w
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[:, :cfg.top_k], top_ids[:, :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return Routing(probs, top_w, top_ids)


def dispatch(r: Routing, cap: int, cfg: ModelConfig) -> Dispatch:
    """The sort-based dispatch: a stable sort of the flat (token, k) pairs
    on their expert id, each pair's rank within its expert, the first
    ``cap`` of each expert kept."""
    t, k = r.ids.shape
    e = cfg.n_experts
    expert_flat = r.ids.reshape(-1)
    order = torch.argsort(expert_flat, stable=True)
    se = expert_flat[order]
    counts = torch.bincount(expert_flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=se.device) - starts[se]
    keep = pos_in_e < cap
    dest_sorted = torch.where(keep, se * cap + pos_in_e, e * cap)
    # out-of-place scatters, so that a gradient reaches the router's
    # weights through buf_w under torch.func.grad as under autograd
    dest = torch.empty_like(dest_sorted).index_put((order,), dest_sorted)
    # every dropped pair lands on the overflow row, which is cut off
    buf_tok = torch.full((e * cap + 1,), t, dtype=torch.int64,
                         device=se.device).index_put((dest_sorted,),
                                                     order // k)
    buf_w = torch.zeros((e * cap + 1,), dtype=torch.float32,
                        device=se.device).index_put(
        (dest_sorted,), r.weights.reshape(-1)[order])
    return Dispatch(dest, buf_tok[:-1], buf_w[:-1])


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """x (..., d) -> (y, aux_loss), the loss None where ``aux`` is False
    (prefill and decode drop it). Router in float32; experts in the
    parameters' type."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t, e = xt.shape[0], cfg.n_experts
    cap = capacity(t, cfg)
    r = route(p, xt, cfg)
    if aux:
        # Switch-style load balance: E sum(mean prob x share of first
        # choices)
        me = torch.mean(r.probs, dim=0)
        ce = torch.bincount(r.ids[:, 0], minlength=e).float() / t
        aux = e * torch.sum(me * ce) * cfg.router_aux_coef
    else:
        aux = None
    disp = dispatch(r, cap, cfg)

    xp = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    gathered = xp[disp.buf_tok].reshape(e, cap, d)
    # the grouped expert SwiGLU, ecd,edf->ecf
    act = F.silu(torch.bmm(gathered, p.wg)) * torch.bmm(gathered, p.wi)
    out = torch.bmm(act, p.wo)
    out = out.reshape(e * cap, d) * disp.buf_w[:, None].to(out.dtype)
    # each token's k slot outputs (the overflow row's zeros where
    # dropped), added in ascending expert order
    out = torch.cat([out, out.new_zeros((1, d))], dim=0)
    _, perm = torch.sort(r.ids, dim=-1)
    dest = torch.gather(disp.dest.reshape(t, -1), 1, perm)
    y = out[dest[:, 0]]
    for j in range(1, dest.shape[1]):
        y = y + out[dest[:, j]]
    return y.reshape(shape).to(x.dtype), aux
