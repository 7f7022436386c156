"""PyTorch/CUDA port of the wireless-FL scheduling system in ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its module
layout so each module here has an obvious twin there. It imports ``torch``
only: no JAX, and nothing of ``repro`` (jax-free pieces such as the
coefficient layouts are kept as local copies). The Pallas TPU kernels on the
ported paths (the simulation engine and the scheduler service) are
hand-written CUDA C++ for Hopper (``kernels/csrc``), each with a plain
PyTorch version beside it. Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""
