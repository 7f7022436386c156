"""Attention and SSD entry points of the model zoo (twin of
``repro/kernels/ops.py``).

``flash_attention`` runs :func:`flash_attention_bhsd` on (BH, S, D)
tensors through :class:`FlashAttention`: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors, differentiable (K5's backward
kernel on the card), with a head dim between K5's padded up.
``attention_auto`` runs the dense oracle on CPU tensors and the kernel on
CUDA tensors, as the reference's runs the oracle off a TPU. ``ssd`` pads
S to a multiple of the chunk and runs :func:`ssd_scan` the same way (on
the card it refuses to run under grad: K4 has no backward yet). Unlike
the reference's ``ssd``, it takes an initial state and returns the final
one on request, so the full-sequence forward and the serving prefill
both go through it. ``ssd_auto`` runs the sequential
oracle on CPU tensors and ``ssd`` on CUDA tensors, as the reference's
runs its oracle off a TPU. ``ssd_decode_step`` is
plain PyTorch, as it is jnp in the reference. ``scheduler_solve`` is
re-exported, as the reference's module does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, FlashAttention
from repro_torch.kernels.scheduler_solve import scheduler_solve
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["flash_attention", "ssd", "ssd_decode_step", "scheduler_solve",
           "attention_auto", "ssd_auto", "on_tpu"]


def on_tpu() -> bool:
    """False: the port dispatches on each tensor's device (CUDA kernels
    for CUDA tensors, plain versions for CPU tensors) and runs on no
    TPU."""
    return False


def padded_head_dim(d: int) -> int:
    """The smallest of K5's head dims that holds ``d``; ``d`` itself past
    the largest (the kernel then refuses it)."""
    return next((h for h in HEAD_DIMS if h >= d), d)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    kv_group=1):
    """(BH, Sq, D) flash attention over k / v (BH / kv_group, Sk, D):
    query row-block ``bh`` reads KV head ``bh // kv_group``. Differentiable
    (:class:`FlashAttention`: K5 and its backward kernel on the card).

    A head dim between K5's (16 for the registry's ``transformer_lm``) is
    padded with zero columns up to the next one, with the scale of the
    unpadded D passed explicitly, and the output cut back: exact, since
    zero columns add nothing to q . k and the padded output columns are
    P . 0."""
    d = q.shape[-1]
    if scale is None:
        scale = float(d) ** -0.5
    pad = padded_head_dim(d) - d
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    out = FlashAttention.apply(q, k, v, causal, window, float(scale),
                               kv_group)
    return out[..., :d] if pad else out


def attention_auto(q, k, v, *, causal=True, window=None, scale=None,
                   kv_group=1):
    """Model-zoo entry point, the twin of the reference's: on CPU tensors
    the dense oracle :func:`ref.attention_ref` (queries at the end of the
    keys, a non-causal window two-sided), as the reference computes it off
    a TPU; on CUDA tensors K5 through :func:`flash_attention` (0-based
    positions, a one-sided window), the twin of its TPU branch. The two
    agree where Sq == Sk and a window comes with ``causal``."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_group=kv_group)
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, kv_group=kv_group)


def pad_to_chunk(chunk: int, x, dt, bm, cm):
    """x, dt, B, C padded with zeros along S to a multiple of ``chunk``.
    Padded steps have dt = 0, so they leave the state unchanged."""
    pad = (-x.shape[1]) % chunk
    if not pad:
        return x, dt, bm, cm
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad)))


def ssd(x, dt, a, bm, cm, *, chunk: int = 128, h0=None,
        return_state: bool = False):
    """Chunked SSD over x (b, S, H, P) for any S: pads to a chunk multiple
    and cuts y back to S. Returns y, or (y, h_final) with
    ``return_state``. On the card K4 has no backward yet: with grad mode
    on and an input requiring a gradient :func:`ssd_scan` raises
    ``NotImplementedError`` (ROADMAP §A item 13) instead of cutting the
    gradient; on the CPU the plain version differentiates."""
    s = x.shape[1]
    x, dt, bm, cm = pad_to_chunk(chunk, x, dt, bm, cm)
    out = ssd_scan(x, dt, a, bm, cm, chunk=chunk, h0=h0,
                   return_state=return_state)
    if return_state:
        return out[0][:, :s], out[1]
    return out[:, :s]


def ssd_auto(x, dt, a, bm, cm, *, chunk: int = 128):
    """Model-zoo entry point, the twin of the reference's: on CPU tensors
    the sequential oracle :func:`ref.ssd_ref`, on CUDA tensors K4 through
    :func:`ssd`. Returns y."""
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, a, bm, cm)[0]
    return ssd(x, dt, a, bm, cm, chunk=chunk)


def ssd_decode_step(h, xt, dtt, a, bt, ct):
    """Single-token SSD recurrence for serving.

    h (b, H, N, P) carried state; xt (b, H, P); dtt (b, H); a (H,); bt / ct
    (b, N). Returns (y_t (b, H, P), new h).
    """
    decay = torch.exp(dtt.float() * a.float()[None, :])
    upd = torch.einsum("bn,bh,bhp->bhnp", bt.float(), dtt.float(),
                       xt.float())
    h = decay[..., None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", ct.float(), h)
    return y.to(xt.dtype), h
