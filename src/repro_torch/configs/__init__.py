"""Configurations: the paper's experiment (``cifar10_cnn.py``) and the
architecture registry (twin of ``repro/configs/__init__.py``).

``ARCH_IDS`` lists the reference's 10 assigned architectures, and the
port runs all ten (``PORTED_IDS``): the dense, VLM and encoder-decoder
ids, ``mamba2-130m``, and the MoE ids ``mixtral-8x22b`` (sliding-window
attention), ``jamba-v0.1-52b`` (Mamba, attention and MoE in one stack)
and ``kimi-k2-1t-a32b`` (a dense prefix layer, 384 experts).
``get_config(name)`` returns an id's full-size ``ModelConfig``;
``all_configs()`` maps each id to its config. Every config has
``reduced()`` for CPU tests. The paper's two FL experiments are
``cifar10_cnn.py`` and ``femnist_cnn.py``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# the ids whose config the port has, and their modules
_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "chatglm3-6b": "chatglm3_6b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "yi-6b": "yi_6b",
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-20b": "granite_20b",
    "minicpm-2b": "minicpm_2b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
}
PORTED_IDS = tuple(_MODULES)

ARCH_IDS = [
    "mamba2-130m",
    "jamba-v0.1-52b",
    "chatglm3-6b",
    "llama-3.2-vision-11b",
    "kimi-k2-1t-a32b",
    "yi-6b",
    "mixtral-8x22b",
    "granite-20b",
    "minicpm-2b",
    "seamless-m4t-large-v2",
]


def get_config(name: str) -> ModelConfig:
    if name in _MODULES:
        return importlib.import_module(
            f"repro_torch.configs.{_MODULES[name]}").CONFIG
    raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCH_IDS)}")


def all_configs() -> dict:
    """``{arch id: ModelConfig}`` of every architecture, in ``ARCH_IDS``
    order, as the reference's."""
    return {name: get_config(name) for name in ARCH_IDS}
