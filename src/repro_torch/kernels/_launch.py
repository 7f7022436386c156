"""Argument checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import contextlib
import ctypes

import torch


def check_lanes(kernel: str, dtype: torch.dtype, like: torch.Tensor,
                ndim: int = 1, **lanes):
    """Each named lane is a contiguous ``dtype`` tensor with ``like``'s
    shape and device; ``like`` itself must be ``ndim``-D and non-empty."""
    if like.ndim != ndim or like.numel() < 1:
        raise ValueError(f"{kernel}: lanes must be {ndim}-D and non-empty, "
                         f"got shape {tuple(like.shape)}")
    for name, x in lanes.items():
        if x.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got "
                            f"{x.dtype}")
        if x.shape != like.shape or x.device != like.device:
            raise ValueError(f"{kernel}: {name} is {tuple(x.shape)} on "
                             f"{x.device}, want {tuple(like.shape)} on "
                             f"{like.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def host_f32(kernel: str, values, n: int) -> ctypes.Array:
    """``n`` scalars as a host float32 array for the C interface."""
    values = [float(v) for v in values]
    if len(values) != n:
        raise ValueError(f"{kernel}: want {n} scalars, got {len(values)}")
    return (ctypes.c_float * n)(*values)


def ptr(x) -> ctypes.c_void_p:
    """A tensor's device pointer, or NULL for None."""
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the integer value of its
    ``cudaStream_t``. ``torch._C._cuda_getCurrentRawStream`` is what
    PyTorch's own generated kernel launchers call; it skips building a
    ``torch.cuda.Stream`` object (~2.5 us a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` where it is not the current device: a
    wrapper enters a device context only off the current device."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raise_on_error(kernel: str, code: int):
    """Raise when the C side reported a failed launch."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{code}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its data on a 16-byte boundary (a kernel's
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def no_grad_input(kernel: str, entry: str, *tensors):
    """Raise where grad mode is on and an input requires a gradient: the
    bare kernel's output would carry none, and the gradient upstream would
    be cut without a word. ``entry`` names the differentiable route."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel}: an input requires a gradient, which "
                           f"the bare kernel would cut; differentiate "
                           f"through {entry}")


def unsupported_device(kernel: str, device: torch.device):
    raise ValueError(f"{kernel}: tensors on {device}; the kernel runs on "
                     f"CUDA and its plain version on the CPU")
