"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version (used for CPU tensors and as the on-card reference)."""
