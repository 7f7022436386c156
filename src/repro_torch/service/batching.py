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

``staging=False`` builds each group's batch the legacy way, padding
every request into fresh host arrays; it is the staged arenas' bitwise
parity reference, and both paths send the batch in the same one copy.

Telemetry (``repro_torch.obs``, off by default): the service records flush
latency split into its host segments (staging / dispatch / pull), per-bucket
group occupancy and pad waste, queue depth, per-decision comm time, tenant
lifecycle counters, replay-log growth, and — keyed by ``step_signature`` —
every first dispatch of a batch shape on the serving path (``warmup()``
seeds the tracker, so warm hits are counted too). All recording is on the
host, on values already there: the Eq. 8 comm times are read from the
host arrays the flush pulled after its one synchronisation, so
telemetry-on serving and replay are bitwise-identical to telemetry-off
and add no synchronisation (tests/test_torch_obs.py).
``metrics_snapshot()`` exports dict / JSON / Prometheus text.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.io import (load_pytree, save_pytree, tree_leaves,
                                       tree_map, tree_structure,
                                       tree_unflatten)
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.policies import (POLICY_DRAWS, POLICY_RAW_PAD,
                                       PolicyState)
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.export import EventLog, json_snapshot, prometheus_text
from repro_torch.obs.instrument import ServiceInstruments, perf
from repro_torch.obs.profile import trace_span
from repro_torch.service.replay import LoggedRequest, RequestLog
from repro_torch.service.state import (BucketKey, TenantSpec, TenantStore,
                                       bucket_width)
from repro_torch.service.step import make_bucket_step, step_signature

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


def _transfer_buffer(parts, device: torch.device):
    """One host buffer holding a batch's arrays back to back (8-byte
    aligned; pinned on a CUDA device, fresh per group so no in-flight copy
    can see it refilled). ``parts`` are (dtype, shape) pairs; returns the
    buffer, each array's (offset, bytes) span and numpy views to fill."""
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
    return buf, spans, views


def _send(buf, spans, views, example, device: torch.device):
    """Copy a filled transfer buffer to ``device`` (one copy, not awaited)
    and view it as the ``(rows, gains, raw)`` batch."""
    dev = buf.to(device, non_blocking=True)
    out = [dev[o:o + n].view(torch.from_numpy(v).dtype).view(v.shape)
           for (o, n), v in zip(spans, views)]
    return out[0], out[1], tree_unflatten(example, out[2:])


def _upload(batch, example, device: torch.device):
    """A host ``(rows, gains, raw)`` batch on ``device``, in the staged
    path's one copy of one transfer buffer."""
    arrays = [batch[0], batch[1], *tree_leaves(batch[2])]
    buf, spans, views = _transfer_buffer([(a.dtype, a.shape)
                                          for a in arrays], device)
    for view, a in zip(views, arrays):
        view[...] = a
    return _send(buf, spans, views, example, device)


def _pad_lane(x: np.ndarray, width: int, fill) -> np.ndarray:
    out = np.full((width,), fill, x.dtype)
    out[: x.shape[0]] = x
    return out


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
        buf, spans, views = _transfer_buffer(parts, device)
        views[0][:c] = rows
        views[0][c:] = sentinel
        for view, arena in zip(views[1:], [self.gains] + self.raw):
            view[:c] = arena[:c]
            view[c:] = 0
        return _send(buf, spans, views, self.proto.example, device)

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
                 staging: bool = True, spill_dir: Optional[str] = None,
                 telemetry: Optional[bool] = None,
                 event_log: Union[None, str, EventLog] = None,
                 log_warn_bytes: float = float(1 << 28), device="cuda"):
        """``log_requests=False`` disables the replay log; deployments
        that keep it call :meth:`compact_log` on their checkpoint cadence.

        ``staging=False`` builds each group's batch the legacy way (fresh
        padded arrays per request, stacked per group): the staged arenas'
        bitwise parity reference, not for production use.

        ``spill_dir`` routes :meth:`evict` state spills to disk; by
        default spilled rows stay on the host heap.

        ``telemetry`` turns this service's metrics registry on or off
        (``None`` follows the process-wide ``repro_torch.obs.configure``
        switch, which starts off). All recording is on the host: served
        decisions, queue updates and replay are bitwise-identical with
        telemetry on or off; off, the hot path pays one attribute load and
        an empty call per site. Read metrics via :meth:`metrics_snapshot`.

        ``event_log`` is an optional JSONL path (or a shared
        :class:`~repro_torch.obs.export.EventLog`) for lifecycle events
        (admit / evict / reload / compact / warmup / log-growth warnings);
        the in-memory tail is always kept, file writes are rank-0 gated.

        ``log_warn_bytes`` is the estimated retained replay-log size above
        which the service warns, once, that the log (unbounded by design)
        wants a :meth:`compact_log` cadence. Default 256 MiB."""
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
        self.staging = staging
        self.spill_dir = spill_dir
        self.obs = ServiceInstruments(obs_metrics.new_registry(telemetry))
        self.events = (event_log if isinstance(event_log, EventLog)
                       else EventLog(event_log))
        self.log_warn_bytes = float(log_warn_bytes)
        self.store = TenantStore(self.device)
        self.store.obs = self.obs
        self.log = RequestLog()
        self._waves: List[_Wave] = []
        self._steps: Dict[BucketKey, object] = {}
        self._pool: Dict[BucketKey, List[_Stage]] = {}
        self._protos: Dict[str, _RawProto] = {}
        self._spilled: Dict[str, tuple] = {}   # name -> (spec, row | path)
        self._spill_seq = 0
        self._tick = 0
        self._last_used: Dict[str, int] = {}
        self._bstrs: Dict[BucketKey, str] = {}   # cached as_string() forms

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
        self.events.emit("admit", tenant=name,
                         bucket=self._bucket_str(spec.bucket))
        return spec

    def _bucket_str(self, bkey: BucketKey) -> str:
        """Cached ``bkey.as_string()`` (metric labels, events): the flush
        path does a dict lookup instead of formatting per group."""
        s = self._bstrs.get(bkey)
        if s is None:
            s = self._bstrs[bkey] = bkey.as_string()
        return s

    def _invalidate_step(self, bkey: BucketKey) -> None:
        """Drop a bucket's cached step if tenant-set changes can affect it:
        only ``solver='cuda'`` binds the bucket's configuration into its
        solve. The first-dispatch tracker forgets the bucket with it, as
        the reference's forgets a dropped jit cache."""
        if self.solver == "cuda":
            self._steps.pop(bkey, None)
            self.obs.compiles.forget(bkey)

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
        if self.staging:
            stage = wave.stages.get(bkey)
            if stage is None:
                pool = self._pool.get(bkey)
                stage = pool.pop() if pool else _Stage(bkey, proto)
                wave.stages[bkey] = stage
            stage.put(spec.n, gains, leaves)
        self._touch(name)
        self.obs.submits.inc()

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
        obs = self.obs
        t_start = perf()
        if obs.enabled:
            obs.queue_depth.set(self.n_queued)
        annotate = obs_metrics.enabled()   # profiler spans: global switch
        waves, self._waves = self._waves, []
        pending = []
        try:
            for wi, w in enumerate(waves):
                for bkey, reqs in w.groups.items():
                    if annotate:
                        with trace_span("service.flush/wave"
                                        f"{wi}/{self._bucket_str(bkey)}"):
                            outs = self._dispatch_group(
                                bkey, reqs, w.stages.get(bkey))
                    else:
                        outs = self._dispatch_group(bkey, reqs,
                                                    w.stages.get(bkey))
                    if log and self.log_requests:
                        self.log.append_entry(
                            [LoggedRequest(*r) for r in reqs])
                    pending.append((reqs, outs))
        finally:
            for w in waves:
                for bkey, stage in w.stages.items():
                    stage.reset()
                    self._pool.setdefault(bkey, []).append(stage)
        t_pull = perf()
        pulled = [(reqs, [x.to("cpu", non_blocking=True) for x in outs])
                  for reqs, outs in pending]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        responses: Dict[str, Decision] = {}
        rec_t_comm = obs.t_comm.record if obs.enabled else None
        for reqs, outs in pulled:
            sel, q, p, t_comm, power, n_sel = (x.numpy() for x in outs)
            for i, r in enumerate(reqs):
                n = r.gains.shape[0]
                responses[r.tenant] = Decision(
                    sel=sel[i, :n], q=q[i, :n], p=p[i, :n],
                    t_comm=t_comm[i], power=power[i],
                    n_sel=np.int64(n_sel[i]))
                if rec_t_comm is not None:
                    rec_t_comm(float(t_comm[i]))
        t_end = perf()
        obs.pull_s.record(t_end - t_pull)
        obs.flush_s.record(t_end - t_start)
        obs.flushes.inc()
        if log and self.log_requests:
            self._log_health()
        return responses

    def _log_health(self) -> None:
        """Replay-log growth gauges + the one-time threshold warning: the
        log is unbounded by design (it is the replay trajectory), so when
        the estimated retained bytes cross ``log_warn_bytes`` the service
        emits one ``log_growth_warning`` event and one Python warning
        nudging the :meth:`compact_log` cadence."""
        est = self.log.bytes_est
        self.obs.log_entries.set(len(self.log))
        self.obs.log_bytes.set(est)
        if est > self.log_warn_bytes:
            rec = self.events.once(
                "log_growth", "log_growth_warning",
                entries=len(self.log), bytes_est=est,
                threshold=self.log_warn_bytes)
            if rec is not None:
                warnings.warn(
                    f"replay log holds ~{est / 2**20:.0f} MiB across "
                    f"{len(self.log)} entries (threshold "
                    f"{self.log_warn_bytes / 2**20:.0f} MiB); it grows "
                    "unbounded by design — call compact_log() on your "
                    "checkpoint cadence to bound host memory",
                    RuntimeWarning, stacklevel=3)

    def warmup(self, max_batch: int = 8) -> None:
        """Serve all-sentinel batches of every power-of-two size up to
        ``max_batch`` through every bucket's step (no row is written back,
        so tenant state is bitwise untouched): loads the kernels and warms
        the device allocator off the serving path, and seeds the
        first-dispatch tracker so later dispatches of these shapes count
        as warm hits."""
        obs = self.obs
        n_warmed = 0
        for bkey, bucket in self.store.buckets().items():
            step = self._bucket_step(bkey, bucket)
            stage = _Stage(bkey, self._proto(bkey.policy))
            bstr = self._bucket_str(bkey)
            b = 1
            while b <= _next_pow2(max_batch):
                fresh = obs.compiles.warm(
                    step_signature(bkey, bucket.size, b, self.solver),
                    bucket=bstr, batch=b, solver=self.solver)
                rows, gains, raw = stage.batch([], bucket.size, b,
                                               self.device)
                t0 = perf()
                step(bucket.state, bucket.table, bucket.n_real, rows, 0,
                     gains, raw)
                if fresh:
                    obs.compiles.compile_s.inc(perf() - t0)
                    n_warmed += 1
                b *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.events.emit("warmup", shapes_compiled=n_warmed,
                         max_batch=max_batch)

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
                        stage: Optional[_Stage]):
        """Issue one (wave, bucket) group; returns its device outputs
        without reading them."""
        obs = self.obs
        bucket = self.store.buckets()[bkey]
        step = self._bucket_step(bkey, bucket)
        b_pad = _next_pow2(len(reqs))
        row_ids = [bucket.row_of[r.tenant] for r in reqs]
        t0 = perf()
        if stage is not None:
            rows, gains, raw = stage.batch(row_ids, bucket.size, b_pad,
                                           self.device)
        else:
            rows, gains, raw = _upload(
                self._legacy_batch(bkey, bucket, reqs, row_ids, b_pad),
                self._proto(bkey.policy).example, self.device)
        t1 = perf()
        fresh = obs.compiles.miss(
            step_signature(bkey, bucket.size, b_pad, self.solver),
            bucket=self._bucket_str(bkey), batch=b_pad, solver=self.solver)
        outs = step(bucket.state, bucket.table, bucket.n_real, rows,
                    len(reqs), gains, raw)
        t2 = perf()
        obs.stage_s.record(t1 - t0)
        obs.dispatch_s.record(t2 - t1)
        if fresh:
            # the first dispatch of a shape: its host wall is the cost the
            # serving path just paid (module docstring of obs/instrument.py)
            obs.compiles.compile_s.inc(t2 - t1)
        if obs.enabled:
            occ, waste = obs.bucket(self._bucket_str(bkey))
            occ.record(len(reqs))
            waste.record((b_pad - len(reqs)) / b_pad)
            obs.groups.inc()
            obs.requests.inc(len(reqs))
        return outs

    def _legacy_batch(self, bkey: BucketKey, bucket, reqs, row_ids,
                      b_pad: int):
        """The pad-per-request host batch ``(rows, gains, raw)``: one
        ``np.full`` per request lane, stacked per group — the staged
        arenas' bitwise parity reference, built as the reference's
        ``_legacy_batch`` builds it (rows int64 here, the step's index
        type)."""
        nb = bkey.n_bucket
        rows = np.full((b_pad,), bucket.size, np.int64)  # pad: dropped
        gains = np.zeros((b_pad, nb), np.float32)
        raw_rows = []
        fills = POLICY_RAW_PAD[bkey.policy]
        for i, r in enumerate(reqs):
            rows[i] = row_ids[i]
            gains[i] = _pad_lane(r.gains, nb, GAINS_PAD)
            raw_rows.append(tree_unflatten(r.raw, [
                x if np.ndim(x) == 0 else _pad_lane(np.asarray(x), nb, f)
                for x, f in zip(tree_leaves(r.raw), tree_leaves(fills))]))
        for _ in range(b_pad - len(reqs)):   # sentinel-row payloads
            raw_rows.append(tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                     raw_rows[0]))
        raw = tree_unflatten(raw_rows[0], [
            np.stack(xs) for xs in zip(*map(tree_leaves, raw_rows))])
        return rows, gains, raw

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
        self.obs.spills.inc()
        self.obs.spilled.set(len(self._spilled))
        self.events.emit("evict", tenant=name,
                         spill="disk" if self.spill_dir else "heap")
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
        self.obs.reloads.inc()
        self.obs.spilled.set(len(self._spilled))
        self.events.emit("reload", tenant=name)
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
        dropped = self.log.compact(snap)
        self.obs.log_compactions.inc()
        self.obs.log_entries.set(0)
        self.obs.log_bytes.set(0)
        self.events.emit("compact", entries_dropped=dropped)
        return snap

    # --------------------------------------------------------- telemetry
    def metrics_snapshot(self, fmt: str = "dict"):
        """This service's metrics, in one of three formats.

        ``fmt="dict"`` (default): a JSON-serializable dict, the metric list
        plus on-demand extras (tenant counts, per-bucket Z-queue summaries
        — the paper's Eq. 9 virtual power queues, copied to the host HERE,
        off the serving path, and only when telemetry is on). ``"json"``:
        the same, serialized. ``"prometheus"``: the Prometheus text
        exposition format. With telemetry off the registry is empty and
        nothing is read from the device.
        """
        obs = self.obs
        if obs.enabled:
            obs.queue_depth.set(self.n_queued)
            for bkey, b in self.store.buckets().items():
                bstr = self._bucket_str(bkey)
                z = b.state.z.detach().cpu().numpy()   # snapshot time only
                g = obs.registry.gauge
                g("service_z_mean", bucket=bstr).set(float(z.mean()))
                g("service_z_max", bucket=bstr).set(float(z.max()))
                g("service_bucket_tenants", bucket=bstr).set(b.size)
        if fmt == "prometheus":
            return prometheus_text(obs.registry)
        snap = json_snapshot(
            obs.registry,
            tenants={"resident": len(self.store),
                     "spilled": len(self._spilled)},
            queued=self.n_queued,
            log={"entries": len(self.log), "bytes_est": self.log.bytes_est,
                 "n_compacted": self.log.n_compacted},
            compile_misses=obs.compiles.misses_total())
        if fmt == "json":
            return json.dumps(snap)
        if fmt != "dict":
            raise ValueError(f"unknown fmt {fmt!r} "
                             "(want 'dict'|'json'|'prometheus')")
        return snap
