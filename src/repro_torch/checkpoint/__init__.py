"""Checkpointing: flattened-key npz snapshots of trees of tensors."""

from repro_torch.checkpoint.io import load_pytree, save_pytree, tree_template

__all__ = ["load_pytree", "save_pytree", "tree_template"]
