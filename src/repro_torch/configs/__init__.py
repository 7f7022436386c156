"""Configurations: the paper's experiment (``cifar10_cnn.py``) and the
architecture registry (twin of ``repro/configs/__init__.py``).

``ARCH_IDS`` lists the reference's 10 assigned architectures.
``get_config(name)`` returns the full-size ``ModelConfig`` of the two the
port runs so far, ``mamba2-130m`` and ``yi-6b``; the eight others raise
``NotImplementedError`` (ROADMAP §A item 10); ``all_configs()`` maps
each ported id to its config. Every config has ``reduced()`` for CPU
tests. The paper's two FL experiments are ``cifar10_cnn.py`` and
``femnist_cnn.py``.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

# the ids whose config the port has
PORTED_IDS = ("mamba2-130m", "yi-6b")

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
    if name == "mamba2-130m":
        from repro_torch.configs.mamba2_130m import CONFIG
        return CONFIG
    if name == "yi-6b":
        from repro_torch.configs.yi_6b import CONFIG
        return CONFIG
    if name in ARCH_IDS:
        raise NotImplementedError(f"arch {name!r} is not ported yet "
                                  "(ROADMAP §A item 10)")
    raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCH_IDS)}")


def all_configs() -> dict:
    """``{arch id: ModelConfig}`` of every ported architecture, in
    ``ARCH_IDS`` order (the reference's maps all ten)."""
    return {name: get_config(name) for name in ARCH_IDS
            if name in PORTED_IDS}
