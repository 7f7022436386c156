"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (used for CPU tensors and as the on-card reference):
``scheduler_solve``, ``decision_fused`` (single-vector and bucket-batched),
``ssd_scan`` (Mamba-2's chunked SSD, reached through ``ops.ssd``) and
``flash_attention_bhsd`` (attention, reached through
``ops.flash_attention``)."""
