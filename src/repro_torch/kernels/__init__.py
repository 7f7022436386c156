"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (used for CPU tensors and as the on-card reference):
``scheduler_solve``, ``decision_fused`` (single-vector and bucket-batched),
``ssd_scan`` (Mamba-2's chunked SSD, reached through ``ops.ssd``) and
``flash_attention_bhsd`` (attention, reached through
``ops.flash_attention``). The package surface is the reference's
``repro.kernels``; the kernels build at their first launch, so importing
it needs no CUDA toolkit."""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decision_fused import (N_DECISION_OPS,
                                                decision_fused,
                                                decision_fused_batched,
                                                pack_decision_operands)
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.scheduler_solve import scheduler_solve
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["ops", "ref", "flash_attention_bhsd", "scheduler_solve",
           "ssd_scan", "decision_fused", "decision_fused_batched",
           "pack_decision_operands", "N_DECISION_OPS"]
