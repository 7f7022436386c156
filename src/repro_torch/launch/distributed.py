"""Process-rank helpers (twin of ``repro/launch/distributed.py``; only the
IO gate so far).

The repo-wide rule: in a multi-process job only rank 0 writes files and
logs, so a job emits one stream. The reference reads the rank from
``jax.process_index()``; here it is ``torch.distributed``'s rank.
"""

from __future__ import annotations

import torch.distributed as dist


def is_main() -> bool:
    """True on the rank-0 process, and always when ``torch.distributed``
    is not initialised (a single-process run)."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0
