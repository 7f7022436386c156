"""Functional optimizers and learning-rate schedules (twin of
``repro.optim``)."""

from repro_torch.optim.optimizers import (OptState, adam,
                                          clip_by_global_norm, momentum, sgd)
from repro_torch.optim.schedule import (constant_schedule, get_schedule,
                                        wsd_schedule)

__all__ = ["adam", "momentum", "sgd", "clip_by_global_norm", "OptState",
           "constant_schedule", "wsd_schedule", "get_schedule"]
