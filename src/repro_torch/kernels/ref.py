"""Plain PyTorch versions of the SSD scan (twin of the SSD part of
``repro/kernels/ref.py``).

``ssd_chunked_ref`` is the function ``csrc/ssd_scan.cu`` computes, op for
op in the order of the reference's Pallas kernel
(``repro/kernels/ssd_scan.py::_ssd_kernel``); the wrapper
(``kernels/ssd_scan.py``) runs it for CPU tensors and ``chip_smoke.py``
holds the kernel against it on the card. ``ssd_ref`` is the sequential
recurrence, the ground truth both are tested against.

Shapes: x (b, S, H, P), dt (b, S, H), a (H,), bm / cm (b, S, N), state
(b, H, N, P); both return ``(y, h_final)``.
"""

from __future__ import annotations

import torch


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
