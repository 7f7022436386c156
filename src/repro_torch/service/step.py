"""Per-bucket serving step over a padded tenant batch (twin of
``repro/service/step.py``).

The serving pipeline per request is the engines' decision layer
(``fl/decision.py``): Theorem-2 solve -> Bernoulli selection -> Eq. 9
queue update (``proposed``) -> TDMA comm-time / power accounting. What this
module adds is the multi-tenant batched form:

* every tenant's scalar configuration is a row of its bucket's stacked
  float32 coefficient table: the policy's coefficient fields, then the
  accounting's ell, bw, n0. For ``proposed`` that row is exactly the fused
  kernel's 14-operand vector (``pack_decision_operands`` order), so one set
  of ops serves heterogeneous tenants;
* the client axis is padded to the bucket's power-of-two width with fills
  that cannot influence a real lane (pad selection uniforms 2.0 > any q;
  pad scores -1.0 below any real score; pad gains 0.0 below any clipped
  channel gain);
* the accounting reduce is cut or zero-padded to the tenant's real
  ``padded_len(n)`` (``acct_len``) so its fixed-block association is the
  engine's own;
* the bucket's stacked queue state is updated IN PLACE: the step gathers
  the batch's rows, decides, and writes the real rows back with
  ``index_copy_``.

PyTorch runs eagerly, so a step is a plain function of tensors; the
reference's jit/donation and compile-cache concerns have no counterpart
(``step_signature`` stays, as the key of a batch shape).

``solver="cuda"`` routes the Theorem-2 solve through the solve kernel
(``kernels/scheduler_solve``) with the bucket's one configuration: the
bucket must be configuration-homogeneous, and ONE launch over the
flattened (B * n_bucket,) lanes computes what the reference's ``lax.map``
of per-row calls computes. ``fused=True`` (``proposed`` only) serves the
batch through the bucket-batched fused kernel
(``kernels/decision_fused.py::decision_fused_batched``), with the
guarantee-one argmax and the accounting folds over the kernel's own
tc/pq summands outside it, as the reference's ``fused_rows``.
"""

from __future__ import annotations

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.policies import PolicyState
from repro_torch.core.scheduler import (GreedyCoeffs, SchedulerConfig,
                                        SolveCoeffs, UniformCoeffs,
                                        force_one, greedy_coeffs,
                                        greedy_decide, selection_from_uniform,
                                        solve_coeffs, solve_round_coeffs,
                                        uniform_coeffs, uniform_decide,
                                        update_queues_z)
from repro_torch.fl.decision import (AccountCoeffs, account_coeffs,
                                     account_totals, decision_step)
from repro_torch.kernels.decision_fused import decision_fused_batched

# Policies the service can serve: those whose randomness is split out of
# the step (POLICY_DRAWS), so requests carry the raw draws and replay is
# deterministic.
SERVICE_POLICIES = ("proposed", "uniform", "greedy_channel")

_COEFFS = {"proposed": SolveCoeffs, "uniform": UniformCoeffs,
           "greedy_channel": GreedyCoeffs}


def policy_coeffs(policy: str, scfg: SchedulerConfig, ch: ChannelConfig,
                  m_avg: float = 0.0):
    """One tenant's policy-coefficient bundle (host floats, f32-exact)."""
    if policy == "proposed":
        return solve_coeffs(scfg, ch)
    if policy == "uniform":
        return uniform_coeffs(scfg.n_clients, m_avg, ch)
    if policy == "greedy_channel":
        return greedy_coeffs(scfg.n_clients, m_avg, ch)
    raise ValueError(f"policy {policy!r} is not servable "
                     f"(servable: {SERVICE_POLICIES})")


def coeff_row(policy: str, scfg: SchedulerConfig, ch: ChannelConfig,
              m_avg: float = 0.0) -> list:
    """One tenant's row of its bucket's coefficient table: the policy's
    coefficient fields, then AccountCoeffs' ell, bw, n0 (integer fields
    as exact floats). For ``proposed`` it is the fused kernel's operand
    vector."""
    return [float(x) for x in policy_coeffs(policy, scfg, ch, m_avg)] + [
        float(x) for x in account_coeffs(scfg, ch)]


def _row_coeffs(policy: str, tab: torch.Tensor):
    """Split (B, k) table rows into the policy bundle and AccountCoeffs.
    The solve's and the accounting's fields become (B, 1) columns that
    broadcast over the lanes; the baselines' stay (B,), one per row."""
    k = len(_COEFFS[policy]._fields)
    cols = tab.unbind(1)
    acct = AccountCoeffs(*(c.unsqueeze(1) for c in cols[k:]))
    if policy == "proposed":
        return SolveCoeffs(*(c.unsqueeze(1) for c in cols[:k])), acct
    return _COEFFS[policy](*cols[:k]), acct


# --------------------------------------------------------------------------
# Per-row policy cores over coefficient rows; the raws arrive with the
# request. Each mirrors the registry step (core/policies.py) op for op.
# --------------------------------------------------------------------------

def _proposed_core(guarantee_one: bool, solve_fn=None):
    def core(u, gains, st: PolicyState, c: SolveCoeffs):
        if solve_fn is None:
            q, p = solve_round_coeffs(gains, st.z, c)
        else:
            q, p = solve_fn(gains, st.z)
        sel = selection_from_uniform(u, q, guarantee_one)
        z = update_queues_z(st.z, q, p, c)
        return sel, q, p, PolicyState(z, st.aux, st.t + 1)

    return core


def _uniform_core(guarantee_one: bool, solve_fn=None):
    def core(raw, gains, st: PolicyState, c: UniformCoeffs):
        sel, q, p = uniform_decide(raw, c)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return core


def _greedy_core(guarantee_one: bool, solve_fn=None):
    def core(raw, gains, st: PolicyState, c: GreedyCoeffs):
        sel, q, p = greedy_decide(gains, c)
        return sel, q, p, PolicyState(st.z, st.aux, st.t + 1)

    return core


_POLICY_CORES = {
    "proposed": _proposed_core,
    "uniform": _uniform_core,
    "greedy_channel": _greedy_core,
}


def step_signature(bkey, n_tenants: int, batch: int, solver: str) -> tuple:
    """The key of one bucket-step batch shape: (bucket, tenant count T,
    padded batch size B, solver), as the reference keys its compile
    cache."""
    return (bkey, int(n_tenants), int(batch), solver)


def make_bucket_step(policy: str, n_bucket: int, acct_len: int,
                     guarantee_one: bool, solve_fn=None,
                     fused: bool = False):
    """Build the batched serving step for one bucket shape.

    Returns ``bucket_step(state, table, n_real, rows, n_rows, gains, raw)
    -> (sel, q, p, t_comm, power, n_sel)`` where

    * ``state`` — the bucket's stacked :class:`PolicyState` (leaves
      (T, n_bucket) / (T,)), updated IN PLACE: the ``n_rows`` real rows of
      the batch are written back, nothing else;
    * ``table`` / ``n_real`` — the stacked (T, k) coefficient table and
      the (T,) real client counts, gathered by row;
    * ``rows`` — (B,) int64 tenant rows on the device; the first
      ``n_rows`` are real, the rest are sentinels (T) that pad the batch
      to a power of two. The gather clamps them onto the last tenant
      (their results are discarded) and the write-back skips them: an
      index past the end would fault the device, and sentinel rows never
      alter a real tenant's bits;
    * ``gains`` (B, n_bucket) and ``raw`` (the policy's raws, batched) —
      padded request payloads.

    ``fused=True`` (``proposed`` only) serves the batch through the
    bucket-batched fused kernel; unlike ``solve_fn`` it needs no bucket
    homogeneity, since every scalar rides the operand rows.
    """
    core = _POLICY_CORES[policy](guarantee_one, solve_fn)
    if fused and policy != "proposed":
        raise ValueError("fused=True needs policy='proposed' (the only "
                         "policy with a fused decision kernel)")

    def fused_rows(u, gains, st: PolicyState, ops, valid):
        sel, q, p, z_new, tc, pq = decision_fused_batched(
            gains, st.z, u, ops, valid=valid)
        if guarantee_one:
            sel = force_one(sel, q)
        t_comm, power = account_totals(torch.where(sel, tc, 0.0), pq,
                                       acct_len)
        return (sel, q, p, t_comm, power, sel.sum(-1),
                PolicyState(z_new, st.aux, st.t + 1))

    def bucket_step(state: PolicyState, table, n_real, rows, n_rows: int,
                    gains, raw):
        idx = rows.clamp_max(state.z.shape[0] - 1)
        st = PolicyState(*(leaf.index_select(0, idx) for leaf in state))
        tab = table.index_select(0, idx)
        lanes = torch.arange(n_bucket, device=gains.device)
        valid = lanes < n_real.index_select(0, idx).unsqueeze(1)
        if fused:
            out = fused_rows(raw, gains, st, tab, valid)
        else:
            c, acct = _row_coeffs(policy, tab)
            out = decision_step(lambda r, g, s: core(r, g, s, c), acct, raw,
                                gains, st, valid=valid, acct_len=acct_len)
        real = rows[:n_rows]
        for buf, upd in zip(state, out[-1]):
            buf.index_copy_(0, real, upd[:n_rows])
        return out[:-1]

    return bucket_step
