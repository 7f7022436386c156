"""Carry the reference's parameters across to the port.

``params_from_jax`` (the CNN) takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the reference side) and returns
the port's float32 tensors:

* conv weights: HWIO (kh, kw, in, out) in the reference, OIHW in PyTorch;
* dense weights: (in, out) in both. The reference flattens its NHWC
  activations in (h, w, c) order before ``f1w``; the port's CNN flattens
  in that same order (``models/cnn.py``), so ``f1w``'s rows carry over
  unchanged;
* biases: unchanged.

``lm_params_from_jax`` (the model zoo's SSM stack) takes the reference's
``init_params`` tree, numpy leaves, and returns the port's
:class:`~repro_torch.models.model.MambaLM`: the period-stacked
``params["period"]["layer<i>"]`` leaves, whose leading axis counts
periods (``models/model.py`` in the reference), are unstacked into the
layer list; ``embed.emb`` and ``final_norm.g`` carry over unchanged.
Dense weights are (in, out) in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.layers import Embedding, RMSNorm
from repro_torch.models.mamba import Mamba2Block

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


def _tensor(value, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def _mamba_layer(p: dict, k: int, cfg, device) -> M.MambaLayer:
    """Layer ``k`` of one period-stacked reference layer ``p``."""
    def leaf(v):
        return _tensor(v[k], device)

    m = p["mixer"]
    mixer = {name: ({"w": leaf(v["w"])} if isinstance(v, dict) else leaf(v))
             for name, v in m.items()}
    return M.MambaLayer(RMSNorm(leaf(p["norm1"]["g"]), cfg.rmsnorm_eps),
                        Mamba2Block(mixer, cfg))


def lm_params_from_jax(tree: dict, cfg, device="cuda") -> M.MambaLM:
    """The reference's LM parameter tree (numpy leaves) -> the port's
    :class:`~repro_torch.models.model.MambaLM` on ``device``."""
    M.check_config(cfg)
    prefix, period, n_periods = cfg.period_decomposition()
    if prefix or tree.get("prefix"):
        raise NotImplementedError("prefix layers are not ported yet "
                                  "(ROADMAP §A item 10)")
    layers = [_mamba_layer(tree["period"][f"layer{i}"], k, cfg, device)
              for k in range(n_periods) for i in range(len(period))]
    final_norm = RMSNorm(_tensor(tree["final_norm"]["g"], device),
                         cfg.rmsnorm_eps)
    return M.MambaLM(Embedding(_tensor(tree["embed"]["emb"], device)),
                     layers, final_norm)
