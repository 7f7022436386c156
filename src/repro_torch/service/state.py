"""Tenant registry + bucketed tensor state store for the scheduler service
(twin of ``repro/service/state.py``).

Each *tenant* is one FL deployment: its own client count N, scheduler
hyper-parameters, wireless configuration, selection policy, and — the only
cross-round state the paper's scheduler needs — its Eq. 9 virtual power
queues Z (plus the registry's ``PolicyState`` scratch).

Tenants are grouped into *buckets* keyed by
``(policy, n_bucket, acct_len, guarantee_one)``: the power-of-two
client-axis width the tenant's (N,) lanes pad to, the accounting length
``padded_len(N)`` that keeps the blocked association the engines', and
the static guarantee-one branch. Per bucket the store holds stacked
tensors on the service's device: the ``PolicyState`` leaves
((T, n_bucket) queues and scratch, (T,) round counters), the (T, k)
float32 coefficient table (``service/step.py::coeff_row``; for
``proposed`` the fused kernel's (T, 14) operand table) and the (T,) real
client counts. The serving step updates the state leaves in place.

Tenant lifecycle: ``evict(name)`` copies a tenant's padded state row to
the host and compacts the bucket (siblings' rows shift; their queues are
preserved BY NAME across every re-materialization); ``readmit(spec,
row)`` installs the spilled row verbatim, bitwise-identical to never
having left. Every host row and snapshot is a copy: a CPU tensor's
``.numpy()`` is a view that the next in-place update would change.

Snapshot/restore rides ``checkpoint/io.py``: a snapshot is the
``{bucket-key-string: PolicyState}`` tree of numpy copies, and
``save``/``load`` round-trip it through the reference's npz layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import load_pytree, save_pytree, tree_template
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.policies import POLICIES, PolicyState, policy_aux_init
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fl.sharding import padded_len
from repro_torch.launch.distributed import is_main
from repro_torch.obs.instrument import noop_instruments
from repro_torch.service.step import SERVICE_POLICIES, coeff_row


def bucket_width(n: int) -> int:
    """The power-of-two client-axis width a tenant of N clients pads to."""
    return max(8, 1 << (int(n) - 1).bit_length())


class BucketKey(NamedTuple):
    policy: str
    n_bucket: int
    acct_len: int
    guarantee_one: bool

    def as_string(self) -> str:
        """Stable string form (npz snapshot keys, logs)."""
        return (f"{self.policy}|b{self.n_bucket}|a{self.acct_len}"
                f"|g{int(self.guarantee_one)}")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One deployment's full scheduling configuration."""

    name: str
    scfg: SchedulerConfig
    ch: ChannelConfig
    policy: str = "proposed"
    m_avg: float = 0.0       # matched M — required (> 0) by the baselines

    @property
    def n(self) -> int:
        return self.scfg.n_clients

    @property
    def bucket(self) -> BucketKey:
        return BucketKey(self.policy, bucket_width(self.n),
                         padded_len(self.n), self.scfg.guarantee_one)


def _host(x: torch.Tensor) -> np.ndarray:
    """A host numpy COPY of a tensor (never a view of live state)."""
    return x.detach().cpu().numpy().copy()


def _host_row(state: PolicyState, i: int) -> PolicyState:
    """One tenant's padded state row as host copies (bitwise)."""
    return PolicyState(z=_host(state.z[i]), aux=_host(state.aux[i]),
                       t=_host(state.t[i]))


class _Bucket:
    """Stacked device tensors for one bucket's tenants."""

    def __init__(self, key: BucketKey, device: torch.device):
        self.key = key
        self.device = device
        self.tenants: list = []          # TenantSpec, row order
        self.row_of: Dict[str, int] = {}
        self.pending: Dict[str, PolicyState] = {}  # rows to install (readmit)
        self.state: Optional[PolicyState] = None
        self.table: Optional[torch.Tensor] = None  # (T, k) float32
        self.n_real: Optional[torch.Tensor] = None  # (T,) int64

    @property
    def size(self) -> int:
        return len(self.tenants)

    def row_state(self, spec: TenantSpec) -> PolicyState:
        """A fresh padded state row for one tenant (zeros beyond N)."""
        nb = self.key.n_bucket
        aux = np.zeros((nb,), np.float32)
        aux[: spec.n] = policy_aux_init(spec.policy, spec.n, "cpu").numpy()
        return PolicyState(z=np.zeros((nb,), np.float32), aux=aux,
                           t=np.zeros((), np.int32))

    def materialize(self, preserve: Optional[Dict[str, PolicyState]] = None):
        """(Re)build the stacked device tensors from the tenant list.

        ``preserve`` maps tenant name -> the host state row to install
        (served queues of registered tenants, or a readmitted tenant's
        spilled row); everyone else gets a fresh zero-queue row.
        """
        preserve = preserve or {}
        rows = [preserve[s.name] if s.name in preserve
                else self.row_state(s) for s in self.tenants]

        def stack(leaves, dtype):
            arr = np.stack([np.asarray(x, dtype) for x in leaves])
            return torch.from_numpy(arr).to(self.device)

        self.state = PolicyState(z=stack([r.z for r in rows], np.float32),
                                 aux=stack([r.aux for r in rows], np.float32),
                                 t=stack([r.t for r in rows], np.int32))
        self.table = stack([coeff_row(s.policy, s.scfg, s.ch, s.m_avg)
                            for s in self.tenants], np.float32)
        self.n_real = stack([s.n for s in self.tenants], np.int64)
        self.row_of = {s.name: i for i, s in enumerate(self.tenants)}


class TenantStore:
    """Registry of tenants + their bucketed queue state on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._tenants: Dict[str, TenantSpec] = {}
        self._buckets: Dict[BucketKey, _Bucket] = {}
        self._dirty: set = set()
        # telemetry hook: admit/evict counters + resident gauge. A disabled
        # bundle (every metric a shared no-op) keeps the store usable
        # standalone; the owning SchedulerService installs its own here
        self.obs = noop_instruments()

    # ------------------------------------------------------------ registry
    def add(self, spec: TenantSpec) -> TenantSpec:
        if spec.name in self._tenants:
            raise ValueError(f"tenant {spec.name!r} already registered")
        if spec.policy not in SERVICE_POLICIES:
            raise ValueError(
                f"policy {spec.policy!r} is not servable (servable: "
                f"{SERVICE_POLICIES}; the others need global state an "
                "instantaneous-CSI request cannot carry)")
        if POLICIES[spec.policy][2] and not spec.m_avg > 0.0:
            raise ValueError(f"policy {spec.policy!r} needs m_avg > 0 "
                             f"(matched participation), got {spec.m_avg!r}")
        if spec.n < 1:
            raise ValueError(f"tenant {spec.name!r} needs n_clients >= 1")
        if (spec.policy == "greedy_channel"
                and round(spec.m_avg) > spec.n):
            # with m > N the threshold would tie into the pad lanes
            raise ValueError(
                f"tenant {spec.name!r}: greedy_channel needs "
                f"round(m_avg) <= n_clients, got {spec.m_avg!r} > {spec.n}")
        bucket = self._buckets.setdefault(
            spec.bucket, _Bucket(spec.bucket, self.device))
        self._tenants[spec.name] = spec
        bucket.tenants.append(spec)
        self._dirty.add(spec.bucket)
        self.obs.admits.inc()
        self.obs.resident.set(len(self._tenants))
        return spec

    def evict(self, name: str) -> PolicyState:
        """Copy ``name``'s live padded state row to the host, drop the
        tenant, and compact its bucket. Returns the spilled row —
        ``readmit`` with it restores the tenant bitwise."""
        spec = self.spec(name)
        b = self.bucket_of(name)         # resolves dirty buckets first
        row = _host_row(b.state, b.row_of[name])
        del self._tenants[name]
        b.tenants = [s for s in b.tenants if s.name != name]
        if not b.tenants:
            del self._buckets[spec.bucket]
            self._dirty.discard(spec.bucket)
        else:
            self._dirty.add(spec.bucket)
        self.obs.evicts.inc()
        self.obs.resident.set(len(self._tenants))
        return row

    def readmit(self, spec: TenantSpec, row: PolicyState) -> TenantSpec:
        """Re-admit an evicted tenant with its spilled padded state row
        installed verbatim."""
        nb = spec.bucket.n_bucket
        row = PolicyState(*(np.array(x.cpu() if isinstance(x, torch.Tensor)
                                     else x) for x in row))
        if row.z.shape != (nb,) or row.aux.shape != (nb,):
            raise ValueError(
                f"readmit row for {spec.name!r} has shapes "
                f"z{row.z.shape}/aux{row.aux.shape}, bucket wants ({nb},)")
        out = self.add(spec)
        self._buckets[spec.bucket].pending[spec.name] = row
        return out

    def spec(self, name: str) -> TenantSpec:
        if name not in self._tenants:
            raise KeyError(f"unknown tenant {name!r}")
        return self._tenants[name]

    def row(self, name: str) -> int:
        return self.bucket_of(name).row_of[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    @property
    def tenants(self) -> Dict[str, TenantSpec]:
        return dict(self._tenants)

    def buckets(self) -> Dict[BucketKey, _Bucket]:
        """Materialized buckets. Registering or evicting a tenant
        re-materializes only its own bucket; every tenant with a live (or
        pending readmitted) state row keeps it, by name."""
        for key in list(self._dirty):
            b = self._buckets[key]
            preserve = dict(b.pending)
            b.pending = {}
            if b.state is not None:
                current = {s.name for s in b.tenants}
                for name, i in b.row_of.items():
                    if name in current and name not in preserve:
                        preserve[name] = _host_row(b.state, i)
            b.materialize(preserve)
            self._dirty.discard(key)
        return self._buckets

    def bucket_of(self, name: str) -> _Bucket:
        return self.buckets()[self.spec(name).bucket]

    # ------------------------------------------------------- state access
    def tenant_state(self, name: str) -> PolicyState:
        """One tenant's live (unpadded) PolicyState, as host copies."""
        spec = self.spec(name)
        b = self.bucket_of(name)
        r = b.row_of[name]
        return PolicyState(z=_host(b.state.z[r, : spec.n]),
                           aux=_host(b.state.aux[r, : spec.n]),
                           t=_host(b.state.t[r]))

    # --------------------------------------------------- snapshot/restore
    def snapshot(self) -> Dict[str, PolicyState]:
        """Host copy of every bucket's state."""
        return {k.as_string(): PolicyState(*(_host(x) for x in b.state))
                for k, b in self.buckets().items()}

    def restore(self, snap: Dict[str, PolicyState]) -> None:
        """Install a snapshot taken from an identically-registered store
        (leaves are copied, so the snapshot stays the caller's)."""
        by_string = {k.as_string(): k for k in self.buckets()}
        if set(snap) != set(by_string):
            raise ValueError(
                f"snapshot buckets {sorted(snap)} do not match the "
                f"registered tenants' buckets {sorted(by_string)}")
        for s, st in snap.items():
            b = self._buckets[by_string[s]]
            st = PolicyState(*st)
            for field, got, want in zip(PolicyState._fields, st, b.state):
                if tuple(np.shape(got)) != tuple(want.shape):
                    raise ValueError(
                        f"snapshot bucket {s!r} leaf {field!r} has shape "
                        f"{tuple(np.shape(got))}, store has "
                        f"{tuple(want.shape)}")
            b.state = PolicyState(*(
                torch.as_tensor(got, dtype=want.dtype).to(self.device,
                                                          copy=True)
                for got, want in zip(st, b.state)))

    def save(self, path: str) -> None:
        """Persist the snapshot through ``checkpoint/io.py``.

        Rank-0 gated: one snapshot per job (every rank holds the same
        replicated store; ``launch/distributed.py``)."""
        if not is_main():
            return
        save_pytree(path, self.snapshot())

    def load(self, path: str) -> None:
        """Restore from :meth:`save`'s npz (tenants must be registered)."""
        template = {k.as_string(): tree_template(b.state)
                    for k, b in self.buckets().items()}
        self.restore(load_pytree(path, template))
