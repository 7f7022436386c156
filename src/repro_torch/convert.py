"""Carry the reference's CNN parameters across to the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference side) and returns
the port's float32 tensors:

* conv weights: HWIO (kh, kw, in, out) in the reference, OIHW in PyTorch;
* dense weights: (in, out) in both. The reference flattens its NHWC
  activations in (h, w, c) order before ``f1w``; the port's CNN flattens
  in that same order (``models/cnn.py``), so ``f1w``'s rows carry over
  unchanged;
* biases: unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

_CONV = ("c1w", "c2w")


def params_from_jax(tree: dict, device="cuda") -> dict:
    """The reference's CNN parameter dict (numpy leaves) -> the port's."""
    out = {}
    for name, value in tree.items():
        value = np.array(value, dtype=np.float32)
        if name in _CONV:
            value = value.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return out
