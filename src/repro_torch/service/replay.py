"""Append-only request log with bit-exact re-execution and compaction
(twin of ``repro/service/replay.py``).

The service is deterministic: every source of randomness (the tenant's
measured gains and the policy's raw selection draws) arrives with the
request, so a logged session replayed through the same registered
tenants, from the same state snapshot, reproduces every decision and
every queue update bit for bit.

The log records one entry per *serve group* — one bucket's batch within
one flush wave — appended right after that group's state write-back was
issued. That makes it FAILURE-ATOMIC: if ``flush()`` raises partway, every
group whose queue update happened is logged and nothing else is. Replay
re-submits each entry's requests in order and flushes: a group's tenants
are unique, so the batcher re-forms the identical batch.

``compact(snapshot)`` drops the entries a state snapshot covers and keeps
the snapshot in the log, so ``replay`` restores it first.

``save``/``load`` use the reference's npz layout (``n_entries``,
``n_compacted``, ``snap/…``, ``f{i}/n``, ``f{i}/r{j}/{tenant,gains,raw{k}}``
with the raws in the reference's leaf order, dict keys sorted), so a log
saved by either package loads in the other.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.checkpoint.io import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.policies import PolicyState
from repro_torch.launch.distributed import is_main


class LoggedRequest(NamedTuple):
    tenant: str
    gains: np.ndarray   # (N,) float32 instantaneous gains
    raw: object         # the policy's raw draws (POLICY_DRAWS layout)


class RequestLog:
    """Serve-group-granular append-only request log with compaction."""

    def __init__(self):
        self.entries: List[List[LoggedRequest]] = []
        self.snapshot: Optional[Dict[str, PolicyState]] = None
        self.n_compacted: int = 0    # entries dropped by compact()
        self.bytes_est: int = 0      # retained payload estimate, kept up
        #                              to date on append (O(1) to read: the
        #                              service's gauge and growth warning)

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def n_requests(self) -> int:
        return sum(len(e) for e in self.entries)

    def append_entry(self, requests: List[LoggedRequest]) -> None:
        est = 0
        for r in requests:
            est += r.gains.nbytes + len(r.tenant) + 64  # + container slop
            for leaf in tree_leaves(r.raw):
                est += np.asarray(leaf).nbytes
        self.bytes_est += est
        self.entries.append(list(requests))

    # --------------------------------------------------------- compaction
    def compact(self, snapshot: Dict[str, PolicyState]) -> int:
        """Drop every retained entry; record ``snapshot`` (the service's
        state after those entries were served) as the new replay base.
        Returns the number of entries dropped."""
        dropped = len(self.entries)
        self.snapshot = tree_map(np.array, snapshot)
        self.n_compacted += dropped
        self.entries = []
        self.bytes_est = 0
        return dropped

    # ------------------------------------------------------------- replay
    def replay(self, service, restore: bool = True
               ) -> List[Dict[str, object]]:
        """Re-execute the log through ``service`` (same tenants required).

        A compacted log first restores its recorded snapshot into
        ``service`` (``restore=False`` skips that). Returns the per-entry
        response dicts.
        """
        if restore and self.snapshot is not None:
            service.restore(self.snapshot)
        out = []
        for requests in self.entries:
            for r in requests:
                service.submit(r.tenant, r.gains, raw=r.raw)
            out.append(service.flush(log=False))
        return out

    # ------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Write the log to an npz. Rank-0 gated: every rank appends the
        same entries, so rank 0's copy is the job's one log."""
        if not is_main():
            return
        flat = {"n_entries": np.int64(len(self.entries)),
                "n_compacted": np.int64(self.n_compacted)}
        if self.snapshot is not None:
            flat["snap/n"] = np.int64(len(self.snapshot))
            for i, (bstr, st) in enumerate(sorted(self.snapshot.items())):
                st = PolicyState(*st)
                flat[f"snap/{i}/key"] = np.asarray(bstr)
                flat[f"snap/{i}/z"] = np.asarray(st.z, np.float32)
                flat[f"snap/{i}/aux"] = np.asarray(st.aux, np.float32)
                flat[f"snap/{i}/t"] = np.asarray(st.t, np.int32)
        for i, requests in enumerate(self.entries):
            flat[f"f{i}/n"] = np.int64(len(requests))
            for j, r in enumerate(requests):
                pre = f"f{i}/r{j}"
                flat[f"{pre}/tenant"] = np.asarray(r.tenant)
                flat[f"{pre}/gains"] = np.asarray(r.gains, np.float32)
                for k, leaf in enumerate(tree_leaves(r.raw)):
                    flat[f"{pre}/raw{k}"] = np.asarray(leaf)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, **flat)

    @classmethod
    def load(cls, path: str, raw_structures: Dict[str, object]
             ) -> "RequestLog":
        """Load a saved log. ``raw_structures`` maps tenant name -> an
        example raw tree (``SchedulerService.raw_structure``) whose
        structure rebuilds the flattened leaves."""
        with np.load(path) as data:
            flat = dict(data)
        log = cls()
        log.n_compacted = int(flat.get("n_compacted", 0))
        if "snap/n" in flat:
            log.snapshot = {
                str(flat[f"snap/{i}/key"]): PolicyState(
                    z=flat[f"snap/{i}/z"], aux=flat[f"snap/{i}/aux"],
                    t=flat[f"snap/{i}/t"])
                for i in range(int(flat["snap/n"]))}
        for i in range(int(flat["n_entries"])):
            requests = []
            for j in range(int(flat[f"f{i}/n"])):
                pre = f"f{i}/r{j}"
                tenant = str(flat[f"{pre}/tenant"])
                if tenant not in raw_structures:
                    raise KeyError(f"no raw structure for tenant "
                                   f"{tenant!r}")
                example = raw_structures[tenant]
                leaves = [flat[f"{pre}/raw{k}"]
                          for k in range(len(tree_leaves(example)))]
                requests.append(LoggedRequest(
                    tenant=tenant, gains=flat[f"{pre}/gains"],
                    raw=tree_unflatten(example, leaves)))
            log.append_entry(requests)
        return log
