"""Continuous batching + the multi-tenant ``SchedulerService`` facade (twin
of ``repro/service/batching.py``).

Requests carry instantaneous gains (the paper's only per-round input) and
the policy's raw selection draws. ``submit()`` writes each request straight
into its bucket's pre-allocated host staging arena (slot writes, no
per-request allocation) and assigns it to a *wave*: a wave touches each
tenant at most once, so state updates never race, and a tenant submitted
k times spans k waves. ``flush()`` then serves one *group* per (wave,
bucket): the group's padded batch goes to the device in ONE host-to-device
copy (rows, gains and raws packed into one transfer buffer, pinned on a
CUDA device, fresh per group so no in-flight copy can see it refilled),
and one bucket step (``service/step.py``) decides the whole batch and
writes the real rows' state back in place. Groups are enqueued back to
back on one stream, so a later wave reads the earlier wave's queue
update; the results of every group come back after ONE synchronisation.

The batch row axis pads to a power of two with sentinel rows (row index
T): the step clamps their gather and skips their write-back, so pad rows
never alter a real tenant's bits.

Replay-log failure atomicity: each group is appended to the
:class:`~repro_torch.service.replay.RequestLog` right after its step was
issued. A ``flush()`` that raises partway leaves the log holding exactly
the groups whose queue updates happened, so replay from the last snapshot
reproduces the live state bit for bit (the unserved requests are
dropped).

Tenant lifecycle: ``evict(name)`` spills a tenant's padded state row
(through ``checkpoint/io.py`` into ``spill_dir``; on the host heap
otherwise) and compacts its bucket; ``reload(name)`` — or a ``submit`` to
a spilled tenant — re-admits it with bitwise-identical queues.
``evict_lru()`` picks the least-recently-used resident. ``compact_log()``
snapshots state and drops the served log entries.

Not in this port yet: the reference's telemetry (``telemetry`` /
``event_log``, ``metrics_snapshot``), its legacy ``staging=False`` batch
builder (the reference's internal parity reference) and the rank-0
gating of ``save`` (ROADMAP §A 9 and §A 8).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (load_pytree, save_pytree, tree_leaves,
                                       tree_map, tree_structure,
                                       tree_unflatten)
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.policies import (POLICY_DRAWS, POLICY_RAW_PAD,
                                       PolicyState)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.service.replay import LoggedRequest, RequestLog
from repro_torch.service.state import (BucketKey, TenantSpec, TenantStore,
                                       bucket_width)
from repro_torch.service.step import make_bucket_step

GAINS_PAD = 0.0  # below every clipped channel gain (gain_bounds lo > 0)
SOLVERS = ("stitched", "cuda", "cuda_fused")


class Decision(NamedTuple):
    """One served scheduling decision (host arrays, tenant's real N)."""

    sel: np.ndarray      # (N,) bool participation indicators
    q: np.ndarray        # (N,) f32 selection probabilities
    p: np.ndarray        # (N,) f32 transmit powers
    t_comm: np.float32   # TDMA round communication time (Eq. 8 sum)
    power: np.float32    # sum_n P_n q_n this round
    n_sel: np.int64      # participants this round


class _Pending(NamedTuple):
    tenant: str
    gains: np.ndarray
    raw: object


class _RawProto(NamedTuple):
    """One policy's raw-draw layout: an example tree + per-leaf kind,
    dtype and pad fill."""

    example: object
    structure: object
    scalar: tuple      # per leaf: True if a per-request scalar (no lanes)
    dtypes: tuple
    fills: tuple       # per-lane pad fill per leaf (POLICY_RAW_PAD)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _numpy(x) -> np.ndarray:
    """A host numpy copy of a request leaf (tensor, array or number)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


class _Stage:
    """Pre-allocated host staging arenas for one bucket within one wave.

    Admission writes each request into arena slot ``count``; dispatch
    packs the active ``[:b_pad]`` slice into one transfer buffer and
    copies it to the device in one go. Arenas grow by doubling and are
    pooled per bucket across flushes.
    """

    def __init__(self, bkey: BucketKey, proto: _RawProto, cap: int = 8):
        self.bkey = bkey
        self.proto = proto
        self.cap = 0
        self.count = 0
        self.gains: Optional[np.ndarray] = None
        self.raw: List[np.ndarray] = []
        self._grow(cap)

    def _grow(self, cap: int) -> None:
        nb = self.bkey.n_bucket

        def bigger(old, shape, dtype):
            new = np.zeros(shape, dtype)
            if old is not None:
                new[: old.shape[0]] = old
            return new

        self.gains = bigger(self.gains, (cap, nb), np.float32)
        old = self.raw or [None] * len(self.proto.scalar)
        self.raw = [bigger(a, (cap,) if s else (cap, nb), d)
                    for a, s, d in zip(old, self.proto.scalar,
                                       self.proto.dtypes)]
        self.cap = cap

    def put(self, n: int, gains: np.ndarray, raw_leaves) -> None:
        """Admit one request: slot writes only, no allocation."""
        if self.count == self.cap:
            self._grow(self.cap * 2)
        i = self.count
        g = self.gains[i]
        g[:n] = gains
        g[n:] = GAINS_PAD
        for arena, leaf, scalar, fill in zip(self.raw, raw_leaves,
                                             self.proto.scalar,
                                             self.proto.fills):
            if scalar:
                arena[i] = leaf
            else:
                a = arena[i]
                a[:n] = leaf
                a[n:] = fill
        self.count += 1

    def batch(self, rows: List[int], sentinel: int, b_pad: int,
              device: torch.device):
        """The padded ``(rows, gains, raw)`` batch on ``device``: the
        first ``count`` rows real, the rest sentinel rows with zero
        payloads. One host-to-device copy of one transfer buffer."""
        c, nb = self.count, self.bkey.n_bucket
        parts = [(np.dtype(np.int64), (b_pad,)),
                 (np.dtype(np.float32), (b_pad, nb))]
        parts += [(np.dtype(d), (b_pad,) if s else (b_pad, nb))
                  for s, d in zip(self.proto.scalar, self.proto.dtypes)]
        spans, total = [], 0
        for dtype, shape in parts:
            nbytes = int(np.prod(shape)) * dtype.itemsize
            spans.append((total, nbytes))
            total += -(-nbytes // 8) * 8
        buf = torch.empty(total, dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
        host = buf.numpy()
        views = [host[o:o + n].view(dtype).reshape(shape)
                 for (o, n), (dtype, shape) in zip(spans, parts)]
        views[0][:c] = rows
        views[0][c:] = sentinel
        for view, arena in zip(views[1:], [self.gains] + self.raw):
            view[:c] = arena[:c]
            view[c:] = 0
        dev = buf.to(device, non_blocking=True)
        out = [dev[o:o + n].view(torch.from_numpy(v).dtype).view(v.shape)
               for (o, n), v in zip(spans, views)]
        return out[0], out[1], tree_unflatten(self.proto.example, out[2:])

    def reset(self) -> None:
        self.count = 0


class _Wave:
    """One serving wave: each tenant at most once, grouped per bucket."""

    __slots__ = ("seen", "groups", "stages")

    def __init__(self):
        self.seen: set = set()
        self.groups: Dict[BucketKey, List[_Pending]] = {}
        self.stages: Dict[BucketKey, _Stage] = {}


class SchedulerService:
    """Online multi-tenant Theorem-2 scheduling service.

    >>> svc = SchedulerService()                          # on the GPU
    >>> svc.add_tenant("cityA", scfg, ch)                 # Algorithm 2
    >>> svc.submit("cityA", gains, raw=u)                 # one round's CSI
    >>> decision = svc.flush()["cityA"]                   # (sel, q, p) + accounting

    Solvers, twins of the reference's ``jnp | pallas | pallas_fused``:

    * ``"cuda_fused"`` (default) serves ``proposed`` buckets through the
      bucket-batched fused kernel (``decision_fused_batched``), one launch
      per group; every scalar is a runtime operand row, so heterogeneous
      tenants batch together. ``uniform`` and ``greedy_channel`` buckets
      run the stitched rows: those policies have no kernel, in the
      reference as here;
    * ``"cuda"`` routes ``proposed``'s Theorem-2 solve through the solve
      kernel, one launch over the whole group; its bucket must be
      configuration-homogeneous (the kernel takes the configuration's
      scalars), which the first flush of a mixed bucket rejects;
    * ``"stitched"`` runs plain PyTorch ops.

    ``device`` is where the buckets' state lives and the steps run: the
    GPU unless the caller passes ``device="cpu"`` (the kernels' wrappers
    then run their plain versions). Without a CUDA device,
    ``device="cuda"`` raises.
    """

    def __init__(self, solver: str = "cuda_fused", log_requests: bool = True,
                 spill_dir: Optional[str] = None, device="cuda"):
        """``log_requests=False`` disables the replay log; deployments
        that keep it call :meth:`compact_log` on their checkpoint cadence.
        ``spill_dir`` routes :meth:`evict` state spills to disk; by
        default spilled rows stay on the host heap."""
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r} (want one of "
                             f"{SOLVERS})")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SchedulerService runs on a CUDA device, and "
                               "PyTorch sees none; pass device='cpu' for "
                               "the plain versions on the CPU")
        self.solver = solver
        self.log_requests = log_requests
        self.spill_dir = spill_dir
        self.store = TenantStore(self.device)
        self.log = RequestLog()
        self._waves: List[_Wave] = []
        self._steps: Dict[BucketKey, object] = {}
        self._pool: Dict[BucketKey, List[_Stage]] = {}
        self._protos: Dict[str, _RawProto] = {}
        self._spilled: Dict[str, tuple] = {}   # name -> (spec, row | path)
        self._spill_seq = 0
        self._tick = 0
        self._last_used: Dict[str, int] = {}

    # ------------------------------------------------------------ tenants
    def add_tenant(self, name: str, scfg: SchedulerConfig,
                   ch: ChannelConfig, policy: str = "proposed",
                   m_avg: float = 0.0) -> TenantSpec:
        if name in self._spilled:
            raise ValueError(f"tenant {name!r} is evicted (spilled); "
                             "reload() it instead of re-registering")
        spec = self.store.add(TenantSpec(name=name, scfg=scfg, ch=ch,
                                         policy=policy, m_avg=m_avg))
        self._invalidate_step(spec.bucket)
        self._touch(name)
        return spec

    def _invalidate_step(self, bkey: BucketKey) -> None:
        """Drop a bucket's cached step if tenant-set changes can affect it:
        only ``solver='cuda'`` binds the bucket's configuration into its
        solve."""
        if self.solver == "cuda":
            self._steps.pop(bkey, None)

    def raw_structure(self, name: str):
        """An example raw-draw tree for this tenant (log loading)."""
        spec = self.store.spec(name)
        return POLICY_DRAWS[spec.policy](torch.Generator().manual_seed(0),
                                         spec.n, "cpu")

    def _proto(self, policy: str) -> _RawProto:
        if policy not in self._protos:
            example = tree_map(
                _numpy, POLICY_DRAWS[policy](torch.Generator().manual_seed(0),
                                             4, "cpu"))
            leaves = tree_leaves(example)
            self._protos[policy] = _RawProto(
                example=example, structure=tree_structure(example),
                scalar=tuple(np.ndim(x) == 0 for x in leaves),
                dtypes=tuple(x.dtype for x in leaves),
                fills=tuple(tree_leaves(POLICY_RAW_PAD[policy])))
        return self._protos[policy]

    def _touch(self, name: str) -> None:
        self._last_used[name] = self._tick
        self._tick += 1

    # ------------------------------------------------------------ serving
    def submit(self, name: str, gains, raw=None,
               generator: Optional[torch.Generator] = None) -> None:
        """Queue one round's scheduling request for a tenant.

        ``gains`` are the tenant's instantaneous channel gains (finite and
        positive, shape (N,)). Exactly one of ``raw`` (the policy's
        pre-drawn raw selection draws, ``POLICY_DRAWS`` layout) or
        ``generator`` (a ``torch.Generator`` the service draws them from)
        must be given. Submitting to an evicted tenant reloads it first.
        """
        if name in self._spilled:
            self.reload(name)
        spec = self.store.spec(name)
        gains = _numpy(gains).astype(np.float32, copy=False)
        if gains.shape != (spec.n,):
            raise ValueError(f"tenant {name!r} expects gains of shape "
                             f"({spec.n},), got {gains.shape}")
        if not np.all(np.isfinite(gains)) or not np.all(gains > 0.0):
            # non-positive gains would tie greedy's threshold with the 0.0
            # pad fill and divide by zero in the solve; +inf poisons the
            # solve's log2 SNR
            raise ValueError(f"tenant {name!r} gains must be finite and "
                             "positive (channel gains are clipped into a "
                             "finite band above 0)")
        if (raw is None) == (generator is None):
            raise ValueError("pass exactly one of raw= or generator=")
        if raw is None:
            raw = POLICY_DRAWS[spec.policy](generator, spec.n,
                                            generator.device)
        raw = tree_map(_numpy, raw)
        proto = self._proto(spec.policy)
        leaves = tree_leaves(raw)
        if (tree_structure(raw) != proto.structure
                or any(x.shape != (() if s else (spec.n,))
                       for x, s in zip(leaves, proto.scalar))):
            raise ValueError(
                f"tenant {name!r} raw draws do not match the "
                f"{spec.policy!r} POLICY_DRAWS layout for N = {spec.n}")
        bkey = spec.bucket
        wave = next((w for w in self._waves if name not in w.seen), None)
        if wave is None:
            wave = _Wave()
            self._waves.append(wave)
        wave.seen.add(name)
        wave.groups.setdefault(bkey, []).append(_Pending(name, gains, raw))
        stage = wave.stages.get(bkey)
        if stage is None:
            pool = self._pool.get(bkey)
            stage = pool.pop() if pool else _Stage(bkey, proto)
            wave.stages[bkey] = stage
        stage.put(spec.n, gains, leaves)
        self._touch(name)

    @property
    def n_queued(self) -> int:
        return sum(len(g) for w in self._waves for g in w.groups.values())

    def flush(self, log: bool = True) -> Dict[str, Decision]:
        """Serve every queued request; return ``{tenant: Decision}``.

        A tenant submitted k times is served k times, in order (k waves);
        the returned dict carries its LAST decision. Every group is
        enqueued before any result is read, and the results come back
        after one synchronisation. Each group is appended to the replay log
        right after it was issued, which makes the log failure-atomic.
        """
        waves, self._waves = self._waves, []
        pending = []
        try:
            for w in waves:
                for bkey, reqs in w.groups.items():
                    outs = self._dispatch_group(bkey, reqs,
                                                w.stages[bkey])
                    if log and self.log_requests:
                        self.log.append_entry(
                            [LoggedRequest(*r) for r in reqs])
                    pending.append((reqs, outs))
        finally:
            for w in waves:
                for bkey, stage in w.stages.items():
                    stage.reset()
                    self._pool.setdefault(bkey, []).append(stage)
        pulled = [(reqs, [x.to("cpu", non_blocking=True) for x in outs])
                  for reqs, outs in pending]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        responses: Dict[str, Decision] = {}
        for reqs, outs in pulled:
            sel, q, p, t_comm, power, n_sel = (x.numpy() for x in outs)
            for i, r in enumerate(reqs):
                n = r.gains.shape[0]
                responses[r.tenant] = Decision(
                    sel=sel[i, :n], q=q[i, :n], p=p[i, :n],
                    t_comm=t_comm[i], power=power[i],
                    n_sel=np.int64(n_sel[i]))
        return responses

    def warmup(self, max_batch: int = 8) -> None:
        """Serve all-sentinel batches of every power-of-two size up to
        ``max_batch`` through every bucket's step (no row is written back,
        so tenant state is bitwise untouched): loads the kernels and warms
        the device allocator off the serving path."""
        for bkey, bucket in self.store.buckets().items():
            step = self._bucket_step(bkey, bucket)
            stage = _Stage(bkey, self._proto(bkey.policy))
            b = 1
            while b <= _next_pow2(max_batch):
                rows, gains, raw = stage.batch([], bucket.size, b,
                                               self.device)
                step(bucket.state, bucket.table, bucket.n_real, rows, 0,
                     gains, raw)
                b *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_step(self, bkey: BucketKey, bucket):
        if bkey not in self._steps:
            proposed = bkey.policy == "proposed"
            solve_fn = (self._cuda_solve(bkey, bucket)
                        if self.solver == "cuda" and proposed else None)
            self._steps[bkey] = make_bucket_step(
                bkey.policy, bkey.n_bucket, bkey.acct_len,
                bkey.guarantee_one, solve_fn=solve_fn,
                fused=self.solver == "cuda_fused" and proposed)
        return self._steps[bkey]

    def _cuda_solve(self, bkey: BucketKey, bucket):
        """The solve kernel over a whole (B, n_bucket) group in one launch,
        with the bucket's one configuration."""
        from repro_torch.fl.engine import make_solve_fn

        configs = {(s.scfg, s.ch) for s in bucket.tenants}
        if len(configs) > 1:
            raise ValueError(
                f"solver='cuda' needs bucket {bkey.as_string()!r} to be "
                "configuration-homogeneous (the solve kernel takes the "
                f"configuration's scalars); it mixes {len(configs)} "
                "configs")
        flat = make_solve_fn(*next(iter(configs)))

        def solve(gains, z):
            q, p = flat(gains.reshape(-1), z.reshape(-1))
            return q.view(gains.shape), p.view(gains.shape)

        return solve

    def _dispatch_group(self, bkey: BucketKey, reqs: List[_Pending],
                        stage: _Stage):
        """Issue one (wave, bucket) group; returns its device outputs
        without reading them."""
        bucket = self.store.buckets()[bkey]
        step = self._bucket_step(bkey, bucket)
        rows, gains, raw = stage.batch(
            [bucket.row_of[r.tenant] for r in reqs], bucket.size,
            _next_pow2(len(reqs)), self.device)
        return step(bucket.state, bucket.table, bucket.n_real, rows,
                    len(reqs), gains, raw)

    # --------------------------------------------------- tenant lifecycle
    def evict(self, name: str):
        """Spill ``name``'s state row and compact its bucket. The tenant
        stays known to the service (``reload`` or a ``submit`` re-admits
        it, bitwise)."""
        for w in self._waves:
            if name in w.seen:
                raise ValueError(f"tenant {name!r} has queued requests; "
                                 "flush() before evicting")
        spec = self.store.spec(name)
        row = self.store.evict(name)
        self._invalidate_step(spec.bucket)
        self._last_used.pop(name, None)
        if self.spill_dir is not None:
            fname = re.sub(r"[^\w.-]", "_", name)
            path = os.path.join(self.spill_dir,
                                f"spill-{self._spill_seq}-{fname}.npz")
            self._spill_seq += 1
            save_pytree(path, row)
            self._spilled[name] = (spec, path)
        else:
            self._spilled[name] = (spec, row)
        return row

    def reload(self, name: str) -> TenantSpec:
        """Re-admit an evicted tenant with bitwise-identical queues."""
        if name not in self._spilled:
            raise KeyError(f"tenant {name!r} is not spilled")
        spec, ref = self._spilled.pop(name)
        if isinstance(ref, str):
            nb = bucket_width(spec.n)
            meta = dict(dtype=torch.float32, device="meta")
            template = PolicyState(
                z=torch.empty((nb,), **meta), aux=torch.empty((nb,), **meta),
                t=torch.empty((), dtype=torch.int32, device="meta"))
            row = PolicyState(*(x.numpy() for x in load_pytree(ref,
                                                                template)))
            os.remove(ref)
        else:
            row = ref
        out = self.store.readmit(spec, row)
        self._invalidate_step(spec.bucket)
        self._touch(name)
        return out

    def evict_lru(self) -> str:
        """Evict the least-recently-used resident tenant; returns its
        name. Tenants with queued requests are never candidates."""
        staged: set = set()
        for w in self._waves:
            staged |= w.seen
        cands = [n for n in self.store.tenants if n not in staged]
        if not cands:
            raise ValueError("no evictable tenant (none resident, or all "
                             "have queued requests)")
        name = min(cands, key=lambda n: self._last_used.get(n, -1))
        self.evict(name)
        return name

    @property
    def spilled(self) -> tuple:
        """Names of currently-evicted (spilled) tenants."""
        return tuple(self._spilled)

    # --------------------------------------------------- state management
    def tenant_state(self, name: str) -> PolicyState:
        return self.store.tenant_state(name)

    def snapshot(self):
        return self.store.snapshot()

    def restore(self, snap) -> None:
        self.store.restore(snap)

    def save(self, path: str) -> None:
        self.store.save(path)

    def load(self, path: str) -> None:
        self.store.load(path)

    def compact_log(self):
        """Snapshot the current state and compact the replay log against
        it: served entries are dropped, the snapshot rides in the log, and
        replaying the compacted log reproduces what replaying the full log
        would have, bit for bit. Returns the snapshot."""
        if self._waves:
            raise ValueError("flush() before compacting the log "
                             "(queued requests are not yet in it)")
        snap = self.snapshot()
        self.log.compact(snap)
        return snap
