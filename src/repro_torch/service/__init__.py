"""Multi-tenant online scheduler service: bucket-batched Theorem-2 serving
(twin of ``repro/service``).

Each *tenant* is one FL deployment (its own N, power budget, lam/V,
policy and persistent queues); requests carry the tenant's measured gains
and selection draws, and serving is the engines' decision step
(``fl/decision.py``) batched over power-of-two buckets, with the
``proposed`` buckets through the bucket-batched fused CUDA kernel by
default. Replaying a logged session from a snapshot is bit-exact.
"""

from repro_torch.service.batching import SOLVERS, Decision, SchedulerService
from repro_torch.service.replay import LoggedRequest, RequestLog
from repro_torch.service.state import BucketKey, TenantSpec, TenantStore
from repro_torch.service.step import (SERVICE_POLICIES, make_bucket_step,
                                      policy_coeffs, step_signature)

__all__ = [
    "SOLVERS", "Decision", "SchedulerService",
    "LoggedRequest", "RequestLog",
    "BucketKey", "TenantSpec", "TenantStore",
    "SERVICE_POLICIES", "make_bucket_step", "policy_coeffs",
    "step_signature",
]
