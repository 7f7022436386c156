"""Configurations: the paper's experiment (``cifar10_cnn.py``) and the
architecture registry (twin of ``repro/configs/__init__.py``).

``ARCH_IDS`` lists the reference's 10 assigned architectures.
``get_config(name)`` returns the full-size ``ModelConfig`` of the seven
the port runs so far (``PORTED_IDS``): ``mamba2-130m``, ``yi-6b``,
``chatglm3-6b``, ``minicpm-2b``, ``granite-20b``,
``llama-3.2-vision-11b`` and ``seamless-m4t-large-v2``; the three others,
``mixtral-8x22b``, ``jamba-v0.1-52b`` and ``kimi-k2-1t-a32b``, need MoE
layers and raise ``NotImplementedError`` (ROADMAP §A item 10);
``all_configs()`` maps each ported id to its config. Every config has
``reduced()`` for CPU tests. The paper's two FL experiments are
``cifar10_cnn.py`` and ``femnist_cnn.py``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# the ids whose config the port has, and their modules
_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "chatglm3-6b": "chatglm3_6b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "yi-6b": "yi_6b",
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
    if name in ARCH_IDS:
        raise NotImplementedError(f"arch {name!r} is not ported yet "
                                  "(ROADMAP §A item 10)")
    raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCH_IDS)}")


def all_configs() -> dict:
    """``{arch id: ModelConfig}`` of every ported architecture, in
    ``ARCH_IDS`` order (the reference's maps all ten)."""
    return {name: get_config(name) for name in ARCH_IDS
            if name in PORTED_IDS}
