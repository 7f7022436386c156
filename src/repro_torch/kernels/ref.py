"""Plain PyTorch versions of the attention and SSD kernels (twin of
``repro/kernels/ref.py``).

``flash_attention_ref`` is the function ``csrc/flash_attention.cu``
computes, as the reference's Pallas kernel
(``repro/kernels/flash_attention.py::_attn_kernel``) defines it: query
and key positions both start at 0, the window is one-sided; the wrapper
(``kernels/flash_attention.py``) runs it for CPU tensors and
``chip_smoke.py`` holds the kernel against it on the card.
``attention_ref`` is the reference's dense oracle, which places the
queries at the end of the keys and makes a non-causal window two-sided:
the two agree where Sq == Sk and a window comes with ``causal``.
``flash_attention_bwd_ref`` is the gradient of ``flash_attention_ref``
by the recomputation ``csrc/flash_attention_bwd.cu`` runs (P from each
row's lse, delta, dP, dS), the function that kernel computes;
``flash_lse_ref`` is the per-row log-sum-exp K5 writes for it.

``ssd_chunked_ref`` is the function ``csrc/ssd_scan.cu`` computes, op for
op in the order of the reference's Pallas kernel
(``repro/kernels/ssd_scan.py::_ssd_kernel``); the wrapper
(``kernels/ssd_scan.py``) runs it for CPU tensors and ``chip_smoke.py``
holds the kernel against it on the card. ``ssd_ref`` is the sequential
recurrence, the ground truth both are tested against.

SSD shapes: x (b, S, H, P), dt (b, S, H), a (H,), bm / cm (b, S, N),
state (b, H, N, P); both return ``(y, h_final)``.

``scheduler_solve_ref`` is the solve kernel's oracle, the paper core's
stitched Theorem-2 solve; the kernel's own plain version, which follows
its op order, is ``kernels/scheduler_solve.py::scheduler_solve_plain``.
"""

from __future__ import annotations

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.scheduler import SchedulerConfig, solve_round

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  scale=None, kv_group: int = 1):
    """Dense softmax attention over q (BH, Sq, D), k / v (BH / kv_group,
    Sk, D) (KV head j serves query rows j kv_group .. j kv_group +
    kv_group - 1, expanded with ``repeat_interleave``), float32 softmax,
    output in q's type. With ``causal`` the queries sit at the end of the
    keys (offset Sk - Sq) and a window keeps ``k > q - window``; without
    it a window keeps ``|k - q| < window``."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    if scale is None:
        scale = float(d) ** -0.5
    if kv_group > 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        offset = sk - sq
        mask &= k_pos <= q_pos + offset
        if window is not None:
            mask &= k_pos > q_pos + offset - window
    elif window is not None:
        mask &= (k_pos - q_pos).abs() < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_mask(sq: int, sk: int, causal: bool, window, device):
    """The flash kernel's (Sq, Sk) mask: positions from 0 on both sides,
    ``k <= q`` with ``causal``, ``k > q - window`` with a window (with or
    without ``causal``)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None, kv_group: int = 1):
    """The flash kernel's function over q (BH, Sq, D), k / v (BH /
    kv_group, Sk, D), dense: KV head j serves query rows j kv_group ..
    j kv_group + kv_group - 1 (expanded here with ``repeat_interleave``),
    q scaled in float32 before the product, masked scores set to -1e30
    (never -inf), ``exp(s - max)``, ``(p @ v) / max(l, 1e-30)``, output in
    q's type."""
    d = q.shape[2]
    if scale is None:
        scale = float(d) ** -0.5
    if kv_group > 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    s = torch.bmm(q.float() * scale, k.float().transpose(1, 2))
    mask = flash_mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return (torch.bmm(p, v.float()) / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _flash_scores(q, k, causal, window, scale, kv_group):
    """q scale, the expanded k, and s = (q scale) k^T with masked scores
    -1e30, all float32."""
    kf = k.float()
    if kv_group > 1:
        kf = kf.repeat_interleave(kv_group, dim=0)
    qs = q.float() * scale
    s = torch.bmm(qs, kf.transpose(1, 2))
    mask = flash_mask(q.shape[1], k.shape[1], causal, window, q.device)[None]
    return qs, kf, torch.where(mask, s, NEG_INF), mask


def _row_lse(s):
    m = s.amax(dim=-1, keepdim=True)
    return m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))


def flash_lse_ref(q, k, *, causal: bool = True, window=None, scale=None,
                  kv_group: int = 1):
    """Each query row's log-sum-exp over its visible keys, (BH, Sq)
    float32: max + log(sum exp(s - max)) of s = (q scale) k^T, what K5
    writes beside o for the backward (``flash_attention_bhsd(...,
    return_lse=True)``), computed as :func:`flash_attention_bwd_ref`
    computes it."""
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    _, _, s, _ = _flash_scores(q, k, causal, window, scale, kv_group)
    return _row_lse(s)[..., 0]


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window=None, scale=None, kv_group: int = 1,
                            lse=None):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at
    (q, k, v), given its output ``o`` and the output's gradient ``do``,
    float32 throughout: each row's lse (the forward's, ``lse`` (BH, Sq),
    where given, else max + log(sum exp(s - max)) recomputed from s =
    (q scale) k^T on the visible keys, as :func:`flash_lse_ref`), delta =
    rowsum(do o), P = exp(s - lse) (0 where masked), dV = P^T dO, dP =
    dO V^T, dS = P (dP - delta), dQ = scale (dS K), dK = dS^T (q scale);
    dk and dv of KV head j are the sums over its query heads j kv_group ..
    j kv_group + kv_group - 1. Returned in the inputs' types."""
    bh, sq, d = q.shape
    if scale is None:
        scale = float(d) ** -0.5
    qs, kf, s, mask = _flash_scores(q, k, causal, window, scale, kv_group)
    vf = v.float()
    if kv_group > 1:
        vf = vf.repeat_interleave(kv_group, dim=0)
    lse = _row_lse(s) if lse is None else lse.float()[..., None]
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dv = torch.bmm(p.transpose(1, 2), dof)
    dp = torch.bmm(dof, vf.transpose(1, 2))
    ds = p * (dp - delta)
    dq = scale * torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), qs)
    if kv_group > 1:
        dk = dk.unflatten(0, (-1, kv_group)).sum(1)
        dv = dv.unflatten(0, (-1, kv_group)).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_ref(x, dt, a, bm, cm, h0=None):
    """Sequential SSD recurrence.

    h[t] = exp(dt[t] a) h[t-1] + dt[t] B[t] (x) x[t];  y[t] = C[t] . h[t]
    """
    b, s, h, p = x.shape
    n = bm.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bmf, cmf = bm.float(), cm.float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * af[None, :])                 # (b,h)
        upd = torch.einsum("bn,bh,bhp->bhnp", bmf[:, t], dtf[:, t], xf[:, t])
        state = decay[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cmf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked_ref(x, dt, a, bm, cm, *, chunk: int = 128, h0=None):
    """Chunked SSD (the dual form of arXiv 2405.21060), one chunk at a time
    over all (batch, head) pairs. S must be a multiple of ``chunk``.

    Per chunk, as the Pallas kernel orders it: ``g = dt a``, its inclusive
    cumsum ``lc``; ``w = where(causal, exp(min(lc_t - lc_s, 0)), 0)``;
    ``m = (C.B^T) w dt_s``; ``y = m @ x + (C exp(lc)) @ state``;
    ``state = exp(lc_last) state + (B exp(lc_last - lc) dt)^T @ x``.
    """
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked_ref: S={s} is not a multiple of the "
                         f"chunk {chunk} (ops.ssd pads)")
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    af = a.float()
    bmf = bm.float().reshape(b, nc, chunk, n)
    cmf = cm.float().reshape(b, nc, chunk, n)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    t_idx = torch.arange(chunk, device=x.device)
    causal = (t_idx[:, None] >= t_idx[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xf[:, c], dtf[:, c], bmf[:, c], cmf[:, c]
        lc = torch.cumsum(dtc * af, dim=1)                       # (b,L,h)
        decay = lc[:, :, None, :] - lc[:, None, :, :]            # (b,L,L,h)
        w = torch.where(causal, torch.exp(torch.clamp_max(decay, 0.0)), 0.0)
        scores = torch.einsum("bln,bmn->blm", cc, bc)            # (b,L,L)
        m = scores[..., None] * w * dtc[:, None, :, :]           # (b,L,L,h)
        y = torch.einsum("blmh,bmhp->blhp", m, xc)
        c_decayed = cc[:, :, None, :] * torch.exp(lc)[..., None]  # (b,L,h,n)
        y = y + torch.einsum("blhn,bhnp->blhp", c_decayed, state)
        carry = torch.exp(lc[:, -1, :])                          # (b,h)
        bw = torch.exp(lc[:, -1:, :] - lc) * dtc                 # (b,L,h)
        b_weighted = bc[:, :, None, :] * bw[..., None]           # (b,L,h,n)
        state = carry[:, :, None, None] * state + torch.einsum(
            "blhn,blhp->bhnp", b_weighted, xc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p).to(x.dtype)
    return y, state


def scheduler_solve_ref(gains, z, *, n, v, lam, ell, bandwidth, noise,
                        p_max, p_bar, q_floor=1e-5):
    """Oracle of the solve kernel: the paper core's Theorem-2 solve."""
    ch = ChannelConfig(n_clients=n, bandwidth_hz=bandwidth,
                       noise_power=noise, p_max=p_max, p_bar=p_bar)
    cfg = SchedulerConfig(n_clients=n, model_bits=ell, lam=lam, V=v,
                          q_floor=q_floor)
    return solve_round(gains, z, cfg, ch)
