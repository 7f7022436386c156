"""Partition rules for the model zoo on the (pod, data, model) mesh (twin
of ``repro/sharding``)."""

from repro_torch.sharding.rules import (PartitionSpec, ShardingMode,
                                        batch_pspec, param_pspecs,
                                        serve_batch_pspec, to_placements)

__all__ = ["batch_pspec", "param_pspecs", "ShardingMode",
           "serve_batch_pspec", "PartitionSpec", "to_placements"]
