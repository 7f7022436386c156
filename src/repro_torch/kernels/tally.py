"""The operation counts of K4 and K5 (and their backwards), for shapes
that run on the ``meta`` device.

On ``meta`` the wrappers launch nothing and run no plain version: they
return empty outputs of the kernel's shapes and types and add the
kernel's own operation count here (an explicit tally, not
``torch.utils.flop_counter.register_flop_formula``: the kernels are
ctypes calls inside ``autograd.Function``s, not torch operators, so a
``FlopCounterMode`` never sees them). ``launch/dryrun.py`` resets the
tally, runs a step on ``meta`` under ``FlopCounterMode`` and adds the two.

The counts are the ones ``chip_smoke.py`` reckons for each kernel's bound
(``flash_bound``, ``flash_bwd_bound``, ``ssd_bound``, ``ssd_bwd_bound``,
their ``flops``): products and the elementwise work, masked attention
pairs left out. The script cannot be imported by the package, so this is
the package's own copy; the smoke checks that the two agree.
"""

from __future__ import annotations

import torch

KERNELS = ("flash_attention_bhsd", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd")
_FLOPS = dict.fromkeys(KERNELS, 0)


def reset():
    for name in KERNELS:
        _FLOPS[name] = 0


def read() -> dict:
    """The operations added since :func:`reset`, by kernel."""
    return dict(_FLOPS)


def add(name: str, flops: int):
    _FLOPS[name] += int(flops)


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (q, k) pairs that ``ref.flash_mask`` keeps (positions from 0,
    ``k <= q`` with ``causal``, ``k > q - window`` with a window), counted
    row by row without building the (Sq, Sk) mask."""
    q = torch.arange(sq, dtype=torch.int64)
    hi = q.clamp_max(sk - 1) if causal else torch.full_like(q, sk - 1)
    lo = ((q - window + 1).clamp_min(0) if window is not None
          else torch.zeros_like(q))
    return int((hi - lo + 1).clamp_min(0).sum())


def flash_flops(bh, sq, sk, d, causal, window) -> int:
    """K5: q . k and p v, 2 D each a live pair; its max, exp and sum a
    pair and the scale and division an output element."""
    live = live_pairs(sq, sk, causal, window)
    return bh * live * 4 * d + bh * (live * 3 + 2 * sq * d)


def flash_bwd_flops(bh, sq, sk, d, causal, window) -> int:
    """K5's backward: the five products (q k^T, dO V^T, P^T dO, dS K,
    dS^T q), 2 D each a live pair, and its exp, subtract and two
    products."""
    live = live_pairs(sq, sk, causal, window)
    return bh * live * 5 * 2 * d + bh * live * 4


def ssd_flops(b, s, h, p, n, chunk) -> int:
    """K4 over (b, S, H, P) with state N, S a multiple of the chunk."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    products = (b * nc * 2 * tri * n
                + b * h * nc * (2 * tri * p + 4 * chunk * n * p))
    other = b * h * nc * (6 * chunk + 1 + 6 * tri + 2 * chunk * n
                          + chunk * p + 2 * n * p)
    return products + other


def ssd_bwd_flops(b, s, h, p, n, chunk) -> int:
    """K4's backward at the same shape."""
    nc = s // chunk
    tri = chunk * (chunk + 1) // 2
    products = b * nc * (h * (4 * 2 * chunk * n * p + 2 * 2 * tri * p)
                         + 2 * 2 * tri * n)
    other = (b * h * nc * (10 * tri + 4 * chunk * p + 4 * chunk * n
                           + 20 * chunk + 2 * n * p)
             + 2 * b * s * h * n)
    return products + other
