"""PyTorch/CUDA port of the wireless-FL scheduling system in ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its module
layout so each module here has an obvious twin there. It imports ``torch``
only: no JAX, and nothing of ``repro`` (jax-free pieces such as the
coefficient layouts and the model configs are kept as local copies). The
Pallas TPU kernels on the ported paths (the simulation engine, the
scheduler service, and Mamba-2 scoring and serving) are hand-written CUDA
C++ for Hopper (``kernels/csrc``), each with a plain PyTorch version
beside it. Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``. ``repro_torch.obs`` is the
reference's telemetry layer (off by default; ``obs.configure(True)`` or
``SchedulerService(telemetry=True)``), recording on the host only.
"""
