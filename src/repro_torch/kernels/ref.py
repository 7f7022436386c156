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
``flash_attention_bwd_folded_ref`` the same gradient with probs_bf16's dq
in the kernel's order of sums (its delta made in the dQ pass);
``flash_lse_ref`` is the per-row log-sum-exp K5 writes for it.

``ssd_chunked_ref`` is the function ``csrc/ssd_scan.cu`` computes, op for
op in the order of the reference's Pallas kernel
(``repro/kernels/ssd_scan.py::_ssd_kernel``); the wrapper
(``kernels/ssd_scan.py``) runs it for CPU tensors and ``chip_smoke.py``
holds the kernel against it on the card. ``ssd_ref`` is the sequential
recurrence, the ground truth both are tested against.
``ssd_scan_bwd_ref`` is the gradient of ``ssd_chunked_ref`` by the
formulas ``csrc/ssd_scan_bwd.cu`` computes (a reverse pass over the chunk
states, then each chunk's gradients), not by autograd;
``ssd_scan_bwd_gemm_ref`` the same gradient with its sums in the kernel's
order (the heads' state terms inside one product per chunk, dCB summed
by head groups).

SSD shapes: x (b, S, H, P), dt (b, S, H), a (H,), bm / cm (b, S, N),
state (b, H, N, P); both return ``(y, h_final)``. The chunked version
and its gradient also take a as (R, H) with R dividing b: batch element
i reads row i // (b / R) (a vmapped ``ops.ssd`` folds its samples into
the batch, each with its own a).

``scheduler_solve_ref`` is the solve kernel's oracle, the paper core's
stitched Theorem-2 solve; the kernel's own plain version, which follows
its op order, is ``kernels/scheduler_solve.py::scheduler_solve_plain``.
"""

from __future__ import annotations

from types import SimpleNamespace

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


def kv_rows(kv_valid, bh: int):
    """A (B, Sk) key mask (bool or uint8) as each row-block's (BH, 1, Sk)
    bool mask: row-block ``bh`` reads batch ``bh // (BH / B)``, the
    query heads of one batch element being consecutive."""
    b = kv_valid.shape[0]
    if kv_valid.ndim != 2 or bh % b:
        raise ValueError(f"kv_valid must be (B, Sk) with B dividing BH "
                         f"{bh}, got {tuple(kv_valid.shape)}")
    return kv_valid.bool().repeat_interleave(bh // b, dim=0)[:, None, :]


def full_mask(bh: int, sq: int, sk: int, causal: bool, window, kv_valid,
              device):
    """(BH or 1, Sq, Sk): :func:`flash_mask`, and with ``kv_valid`` each
    row-block's live keys."""
    mask = flash_mask(sq, sk, causal, window, device)[None]
    return mask if kv_valid is None else mask & kv_rows(kv_valid, bh)


def bf16_round(x):
    """x rounded to the nearest bfloat16 (ties to even), kept float32."""
    return x.to(torch.bfloat16).float()


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None, kv_group: int = 1, kv_valid=None,
                        probs_bf16: bool = False):
    """The flash kernel's function over q (BH, Sq, D), k / v (BH /
    kv_group, Sk, D), dense: KV head j serves query rows j kv_group ..
    j kv_group + kv_group - 1 (expanded here with ``repeat_interleave``),
    q scaled in float32 before the product, masked scores set to -1e30
    (never -inf), ``exp(s - max)``, ``(p @ v) / max(l, 1e-30)``, output in
    q's type.

    ``kv_valid`` (B, Sk), B dividing BH, masks each batch element's dead
    keys as the reference's ``_grouped_attention`` does: their scores are
    -1e30 too, so a row with no live key at all averages v over all Sk
    keys. ``probs_bf16`` is the reference's ``attn_probs_bf16``: the
    normalised p rounded to bfloat16 times v rounded to bfloat16, summed
    in float32."""
    d = q.shape[2]
    if scale is None:
        scale = float(d) ** -0.5
    if kv_group > 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    s = torch.bmm(q.float() * scale, k.float().transpose(1, 2))
    mask = full_mask(q.shape[0], q.shape[1], k.shape[1], causal, window,
                     kv_valid, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if probs_bf16:
        return torch.bmm(bf16_round(p / l),
                         bf16_round(v.float())).to(q.dtype)
    return (torch.bmm(p, v.float()) / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _flash_scores(q, k, causal, window, scale, kv_group, kv_valid=None):
    """q scale, the expanded k, and s = (q scale) k^T with masked scores
    -1e30, all float32, and the mask."""
    kf = k.float()
    if kv_group > 1:
        kf = kf.repeat_interleave(kv_group, dim=0)
    qs = q.float() * scale
    s = torch.bmm(qs, kf.transpose(1, 2))
    mask = full_mask(q.shape[0], q.shape[1], k.shape[1], causal, window,
                     kv_valid, q.device)
    return qs, kf, torch.where(mask, s, NEG_INF), mask


def _row_lse(s, mask):
    """max + log(sum exp(s - max)) of each row; +inf for a row with no
    live key, so that exp(s - lse) is 0 on all of its keys."""
    m = s.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    return torch.where(mask.any(dim=-1, keepdim=True), lse, float("inf"))


def flash_lse_ref(q, k, *, causal: bool = True, window=None, scale=None,
                  kv_group: int = 1, kv_valid=None):
    """Each query row's log-sum-exp over its visible keys, (BH, Sq)
    float32: max + log(sum exp(s - max)) of s = (q scale) k^T, what K5
    writes beside o for the backward (``flash_attention_bhsd(...,
    return_lse=True)``), computed as :func:`flash_attention_bwd_ref`
    computes it; +inf for a row that ``kv_valid`` leaves no live key."""
    if scale is None:
        scale = float(q.shape[2]) ** -0.5
    _, _, s, mask = _flash_scores(q, k, causal, window, scale, kv_group,
                                  kv_valid)
    return _row_lse(s, mask)[..., 0]


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window=None, scale=None, kv_group: int = 1,
                            lse=None, kv_valid=None,
                            probs_bf16: bool = False):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` at
    (q, k, v), given its output ``o`` and the output's gradient ``do``,
    float32 throughout: each row's lse (the forward's, ``lse`` (BH, Sq),
    where given, else max + log(sum exp(s - max)) recomputed from s =
    (q scale) k^T on the visible keys, as :func:`flash_lse_ref`), delta =
    rowsum(do o) (with ``probs_bf16`` sum(P dP), below), P = exp(s - lse)
    (0 where masked), dV = P^T dO, dP = dO V^T, dS = P (dP - delta), dQ =
    scale (dS K), dK = dS^T (q scale);
    dk and dv of KV head j are the sums over its query heads j kv_group ..
    j kv_group + kv_group - 1. Returned in the inputs' types.

    A row that ``kv_valid`` leaves no live key has P = 1 / Sk on every
    key in the forward and no path to q or k: it adds do / Sk to dV at
    every key and nothing else. ``probs_bf16`` takes the gradient with the
    reference's rounding points, as ``jax.vjp`` does: dV from P rounded
    to bfloat16 and itself rounded to bfloat16 once summed, dP from V
    rounded to bfloat16 and itself rounded to bfloat16 (the casts of p
    and v transpose to casts of their cotangents), dS from the float32 P,
    and delta the reference's sum(P dP) of the rounded dP (rowsum(do o)
    is that sum only while P and dP are not rounded)."""
    return _flash_bwd(q, k, v, o, do, causal, window, scale, kv_group, lse,
                      kv_valid, probs_bf16, False)


def flash_attention_bwd_folded_ref(q, k, v, o, do, *, causal: bool = True,
                                   window=None, scale=None,
                                   kv_group: int = 1, lse=None,
                                   kv_valid=None, probs_bf16: bool = False):
    """:func:`flash_attention_bwd_ref` with probs_bf16's dq in the order of
    sums of ``csrc/flash_attention_bwd.cu``, whose dQ pass makes the delta
    itself: dq = scale (A - delta B) with A = (P bf16(dP)) K, B = P K and
    delta = sum_j P_j bf16(dP_j) a row, the same function as scale (dS K)
    reassociated. dk and dv, and every gradient without probs_bf16, are
    :func:`flash_attention_bwd_ref`'s."""
    return _flash_bwd(q, k, v, o, do, causal, window, scale, kv_group, lse,
                      kv_valid, probs_bf16, True)


def _flash_bwd(q, k, v, o, do, causal, window, scale, kv_group, lse,
               kv_valid, probs_bf16, folded):
    bh, sq, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = float(d) ** -0.5
    qs, kf, s, mask = _flash_scores(q, k, causal, window, scale, kv_group,
                                    kv_valid)
    vf = v.float()
    if kv_group > 1:
        vf = vf.repeat_interleave(kv_group, dim=0)
    lse = _row_lse(s, mask) if lse is None else lse.float()[..., None]
    dof = do.float()
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    if probs_bf16:
        vf = bf16_round(vf)
    dv = torch.bmm((bf16_round(p) if probs_bf16 else p).transpose(1, 2),
                   dof)
    dead = ~mask.any(dim=-1, keepdim=True)
    if kv_valid is not None and bool(dead.any()):
        w = torch.tensor(1.0 / sk, dtype=torch.float32)
        w = bf16_round(w) if probs_bf16 else w
        dv = dv + w * (dof * dead).sum(dim=1, keepdim=True)
    dp = torch.bmm(dof, vf.transpose(1, 2))
    if probs_bf16:
        dp = bf16_round(dp)
        delta = (p * dp).sum(dim=-1, keepdim=True)
    else:
        delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if folded and probs_bf16:
        dq = scale * (torch.bmm(p * dp, kf) - delta * torch.bmm(p, kf))
    else:
        dq = scale * torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), qs)
    if kv_group > 1:
        dk = dk.unflatten(0, (-1, kv_group)).sum(1)
        dv = dv.unflatten(0, (-1, kv_group)).sum(1)
    if probs_bf16:
        dv = bf16_round(dv)
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


def a_rows(a, b: int):
    """a as float32, broadcastable against (b, L, H): (H,) as it is, (R,
    H) repeated to (b, 1, H), batch element i on row i // (b / R)."""
    af = a.float()
    if af.ndim == 1:
        return af
    return af.repeat_interleave(b // af.shape[0], dim=0)[:, None, :]


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
    af = a_rows(a, b)
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


def ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, *, chunk: int = 128, h0=None,
                     dh=None):
    """The gradients (dx, ddt, da, dbm, dcm, dh0) of
    :func:`ssd_chunked_ref`'s (y, h_final) at (x, dt, a, bm, cm, h0), given
    dy (b, S, H, P) and dh (b, H, N, P) or None for 0; da has a's shape,
    dh0 is (b, H, N, P) (the gradient of a zero ``h0`` when it is None).
    float32.

    Per chunk, with lc the cumsum of dt a, w_ts = exp(min(lc_t - lc_s, 0))
    (s <= t), M = (C B^T) w dt_s, bw = exp(lc_L - lc) dt, S the state
    entering the chunk and dS the gradient of the one leaving it:

    * dS of the chunk before: exp(lc_L) dS + sum_t exp(lc_t) C_t dy_t^T;
    * G = dy x^T (per head); dx = M^T dy + bw (B dS);
    * dCB = sum_h G w dt_s; dC = dCB B + sum_h exp(lc) (dy S^T);
      dB = dCB^T C + sum_h bw (x dS^T);
    * dlc: the row sums less the column sums of G M below the diagonal,
      plus dy . y_inter, plus the state update's terms (exp(lc_L) <S, dS>
      and sum_s bw_s <B_s x_s^T, dS> on the last row, minus bw_s <B_s
      x_s^T, dS> on row s);
    * dg, the reverse cumsum of dlc in the chunk; ddt = a dg + sum_t G C.B
      w + exp(lc_L - lc) <B x^T, dS>; da = sum over (b, S) of dt dg.

    Only exponentials of differences that are <= 0 are formed (and
    exp(lc), lc <= 0 for a < 0), as the forward forms them."""
    def terms(t):
        b_ds = torch.einsum("bmn,bhnp->bmhp", t.bc, t.ds)        # (b,L,h,p)
        dx = torch.einsum("blmh,blhp->bmhp", t.m, t.dyc) + \
            t.bw[..., None] * b_ds
        dcb = (t.g * t.w * t.dtc[:, None, :, :]).sum(-1)         # (b,L,L)
        dc_state = t.elc[..., None] * torch.einsum("bhnp,blhp->blhn",
                                                   t.s_prev, t.dyc)
        db_state = t.bw[..., None] * torch.einsum("bhnp,bmhp->bmhn", t.ds,
                                                  t.xc)
        dcm = torch.einsum("blm,bmn->bln", dcb, t.bc) + dc_state.sum(2)
        dbm = torch.einsum("blm,bln->bmn", dcb, t.cc) + db_state.sum(2)
        r = (t.xc * b_ds).sum(-1)                                # (b,L,h)
        yint = (dc_state * t.cc[:, :, None, :]).sum(-1)
        return dx, dbm, dcm, r, yint
    return _ssd_scan_bwd("ssd_scan_bwd_ref", x, dt, a, bm, cm, dy, chunk,
                         h0, dh, terms)


def ssd_scan_bwd_gemm_ref(x, dt, a, bm, cm, dy, *, chunk: int = 128,
                          h0=None, dh=None, head_group: int = 1):
    """:func:`ssd_scan_bwd_ref`'s gradients with their sums in the order
    ``csrc/ssd_scan_bwd.cu`` takes them. float32.

    Per (batch, chunk), for every head at once: U = B dS^T and Y = C S^T;
    dx = M^T dy + bw U, r = x . U and dy . y_inter = exp(lc) (dy . Y) per
    head; dCB = sum_h G w dt_s over each group of ``head_group`` heads in
    head order, then over the groups in order; dC = [dCB | exp(lc) dy] [B ;
    S] and dB = [dCB^T | bw x] [C ; dS], each one product of depth L + H P,
    so the heads' state terms are summed inside the product, not head by
    head. The carry, dlc, dg, ddt and da as :func:`ssd_scan_bwd_ref`."""
    h = x.shape[2]
    if h % head_group:
        raise ValueError(f"ssd_scan_bwd_gemm_ref: H={h} is not a multiple "
                         f"of the head group {head_group}")

    def rows(st):  # (b, h, n, p) -> (b, h p, n), K = (h, p) as dy's rows
        return st.permute(0, 1, 3, 2).reshape(st.shape[0], -1, st.shape[2])

    def terms(t):
        b, chunk = t.xc.shape[:2]
        u = torch.einsum("bmn,bhnp->bmhp", t.bc, t.ds)           # B dS^T
        y_st = torch.einsum("bln,bhnp->blhp", t.cc, t.s_prev)    # C S^T
        dx = torch.einsum("blmh,blhp->bmhp", t.m, t.dyc) + \
            t.bw[..., None] * u
        dcb_h = t.g * t.w * t.dtc[:, None, :, :]
        dcb = torch.zeros_like(dcb_h[..., 0])
        for g0 in range(0, h, head_group):
            group = torch.zeros_like(dcb)
            for hh in range(g0, g0 + head_group):
                group = group + dcb_h[..., hh]
            dcb = dcb + group
        dcm = torch.cat([dcb, (t.elc[..., None] * t.dyc).reshape(
            b, chunk, -1)], -1) @ torch.cat([t.bc, rows(t.s_prev)], 1)
        dbm = torch.cat([dcb.transpose(1, 2), (t.bw[..., None] * t.xc).reshape(
            b, chunk, -1)], -1) @ torch.cat([t.cc, rows(t.ds)], 1)
        r = (t.xc * u).sum(-1)
        yint = t.elc * (t.dyc * y_st).sum(-1)
        return dx, dbm, dcm, r, yint
    return _ssd_scan_bwd("ssd_scan_bwd_gemm_ref", x, dt, a, bm, cm, dy,
                         chunk, h0, dh, terms)


def _ssd_scan_bwd(name, x, dt, a, bm, cm, dy, chunk, h0, dh, terms):
    """The two plain gradients' common part: the forward's per-chunk
    quantities and entering states, then the chunks from the last, where
    ``terms(t)`` gives (dx, dB, dC, r, dy . y_inter) of chunk t (a
    namespace of its tensors) and the rest (dlc, dg, ddt, da, the carry)
    is shared."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    if s % chunk:
        raise ValueError(f"{name}: S={s} is not a multiple of the chunk "
                         f"{chunk} (ops.ssd pads)")
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dyf = dy.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    af = a_rows(a, b)
    bmf = bm.float().reshape(b, nc, chunk, n)
    cmf = cm.float().reshape(b, nc, chunk, n)
    t_idx = torch.arange(chunk, device=x.device)
    causal = (t_idx[:, None] >= t_idx[None, :])[None, :, :, None]
    below = (t_idx[:, None] > t_idx[None, :])[None, :, :, None]

    # the forward's per-chunk quantities and the states entering each chunk
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    per_chunk = []
    for c in range(nc):
        xc, dtc, bc = xf[:, c], dtf[:, c], bmf[:, c]
        lc = torch.cumsum(dtc * af, dim=1)                       # (b,L,h)
        bw = torch.exp(lc[:, -1:, :] - lc) * dtc                 # (b,L,h)
        per_chunk.append((lc, bw, state))
        state = torch.exp(lc[:, -1, :])[:, :, None, None] * state + \
            torch.einsum("bln,blh,blhp->bhnp", bc, bw, xc)

    ds = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
          if dh is None else dh.float())
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dbm = torch.empty_like(bmf)
    dcm = torch.empty_like(cmf)
    da_b = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    for c in reversed(range(nc)):
        xc, dyc, dtc = xf[:, c], dyf[:, c], dtf[:, c]
        bc, cc = bmf[:, c], cmf[:, c]
        lc, bw, s_prev = per_chunk[c]
        elc = torch.exp(lc)                                      # (b,L,h)
        decay = lc[:, :, None, :] - lc[:, None, :, :]            # (b,L,L,h)
        w = torch.where(causal, torch.exp(torch.clamp_max(decay, 0.0)), 0.0)
        live = below & (decay <= 0.0)
        cb = torch.einsum("bln,bmn->blm", cc, bc)                # (b,L,L)
        m = cb[..., None] * w * dtc[:, None, :, :]               # (b,L,L,h)
        g = torch.einsum("blhp,bmhp->blmh", dyc, xc)             # (b,L,L,h)
        dx[:, c], dbm[:, c], dcm[:, c], r, yint = terms(SimpleNamespace(
            xc=xc, dyc=dyc, dtc=dtc, bc=bc, cc=cc, elc=elc, bw=bw, w=w, m=m,
            g=g, s_prev=s_prev, ds=ds))
        q = torch.where(live, g * m, 0.0)
        term = bw * r
        dlc = q.sum(2) - q.sum(1) + yint
        dlc = dlc - term
        dlc[:, -1] += elc[:, -1] * (s_prev * ds).sum((-1, -2)) + term.sum(1)
        dg = torch.flip(torch.cumsum(torch.flip(dlc, (1,)), dim=1), (1,))
        ddt[:, c] = af * dg + (g * cb[..., None] * w).sum(1) + \
            torch.exp(lc[:, -1:, :] - lc) * r
        da_b += (dtc * dg).sum(1)
        ds = torch.exp(lc[:, -1, :])[:, :, None, None] * ds + \
            torch.einsum("bln,blh,blhp->bhnp", cc, elc, dyc)
    da = (da_b.sum(0) if a.ndim == 1
          else da_b.reshape(a.shape[0], -1, h).sum(1))
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.reshape(b, s, h),
            da.to(a.dtype), dbm.reshape(b, s, n), dcm.reshape(b, s, n), ds)


def scheduler_solve_ref(gains, z, *, n, v, lam, ell, bandwidth, noise,
                        p_max, p_bar, q_floor=1e-5):
    """Oracle of the solve kernel: the paper core's Theorem-2 solve."""
    ch = ChannelConfig(n_clients=n, bandwidth_hz=bandwidth,
                       noise_power=noise, p_max=p_max, p_bar=p_bar)
    cfg = SchedulerConfig(n_clients=n, model_bits=ell, lam=lam, V=v,
                          q_floor=q_floor)
    return solve_round(gains, z, cfg, ch)
