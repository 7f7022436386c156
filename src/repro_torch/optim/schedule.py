"""Learning-rate schedules (twin of ``repro/optim/schedule.py``), incl.
MiniCPM's WSD (warmup-stable-decay) [arXiv:2404.06395 §4], the schedule
the minicpm-2b config requests. Each maps a step (int or tensor) to a
float32 scalar tensor, in the reference's op order."""

from __future__ import annotations

import torch


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def wsd_schedule(lr: float, total_steps: int, warmup_frac: float = 0.1,
                 decay_frac: float = 0.1, floor: float = 0.1):
    """Warmup -> stable plateau -> exponential-style decay to floor*lr."""
    warm = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1.0 - decay_frac))
    decay_len = max(total_steps - decay_start, 1)

    def f(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm_lr = lr * step / warm
        dec_t = torch.clamp((step - decay_start) / decay_len, 0.0, 1.0)
        dec_lr = lr * torch.pow(torch.tensor(floor, dtype=torch.float32),
                                dec_t)
        return torch.where(step < warm, warm_lr,
                           torch.where(step < decay_start,
                                       torch.tensor(lr, dtype=torch.float32),
                                       dec_lr))

    return f


def get_schedule(name: str, lr: float, total_steps: int):
    if name == "wsd":
        return wsd_schedule(lr, total_steps)
    return constant_schedule(lr)
