"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same device tensors, the engine's cuda / cuda_fused paths
launching them, and the scheduler service's cuda_fused path against its
stitched one. Marked ``cuda``; every test skips when PyTorch sees no CUDA
device (decided in a fixture, never at import). Run on a GPU with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \
        tests/test_torch_cuda.py

Solve tolerances as on the CPU: q rtol 1e-5 / atol 1e-6, power-like
outputs rtol 1e-5 / atol 1e-3. The fused kernels, single-vector and
bucket-batched, are held to their plain versions bit for bit (the same
IEEE ops in the same order, no contraction; the single-vector one also at
the solve's tolerances), at short and ragged sizes, rows past CUDA's
grid-y limit and lanes at storage offset 1, and the service's
cuda_fused and stitched paths select the same clients; telemetry on
(``repro_torch.obs``) equals telemetry off bit for bit in the service
(both batch builders; no synchronisation in a group's dispatch) and in the
engine and the chunk runner (deterministic cuDNN). The SSD scan
(through ``ops.ssd``, which pads) against its plain chunked version at the
smoke's shapes: y rtol 1e-4 / atol 2e-4, the final state rtol 1e-4 /
atol 2e-5, as on the CPU (float32
sums in other orders; both sides full float32, TF32 off); mamba2-130m's
forward and prefill launch it once per layer (24), decode never. The
flash attention kernel against its plain version at the reference tests'
shapes, yi-6b's (128, 2048, 128), Sq != Sk, non-causal with a ragged key
count (llama-3.2-vision-11b's cross-attention over 1,601 media
embeddings) and seamless-m4t-large-v2's encoder and cross shapes: 2e-5
in float32 and 2e-2 in bfloat16, the reference tests' own; skipping the
masked key tiles changes no bit; on unexpanded KV heads (``kv_group`` 2,
4, 8, 16 and 48) it equals itself on the ``repeat_interleave``-expanded
heads bit for bit; reduced yi-6b at its full head_dim (128) launches it
once per layer in forward and prefill, never in decode, and expands no
KV head; so do reduced llama-3.2-vision-11b's cross-attention layer and
seamless-m4t-large-v2's encoder layers and cross blocks. The solve kernel on
the sweep's flattened seeds equals itself per seed bit for bit, returns q
and P as the two rows of one allocation, and the sweep launches it once a
round for every seed. The population engine launches K2 with its
activity mask under cuda_fused and K1 under cuda, keeps inactive lanes
out, and with ``population=()`` takes the population-free decisions bit
for bit. The MoE (``models/moe.py``, plain PyTorch) on the card agrees
with the CPU and gives the same bits run to run; K5 with mixtral's window
of 4,096 over 8,192 tokens and K4 at jamba's N = 16 agree with their
plain versions; the reduced MoE ids launch K5 (and jamba K4) per
attention (Mamba) layer in forward and prefill, never in decode, and
decode past mixtral's window reproduces the forward. K5's backward
kernel against its plain version at phase 15's shapes (reduced BH), 1e-4
of each gradient's largest |plain| in float32 (2e-2 in bfloat16), the
same bits with the masked tiles run and from run to run, and on the
expanded KV heads (dq bit-equal; dk and dv summed back per group within
3e-5 of their largest entry: the group's sum in another order); gradients through ``ops.flash_attention``
(D = 16 padded) equal the CPU's; bare K5 and ``ops.ssd`` raise under grad
instead of cutting it; a reduced train step of each attention and MoE id
on the card equals the CPU's (loss rtol 1e-5, gradients 1e-4 of each
leaf's largest |CPU|), launching K5's forward and backward once per
attention call.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl.decision import decision_coeffs
from repro_torch.fl.simulation import SimConfig, run_simulation
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.decision_fused import (decision_fused,
                                                decision_fused_batched,
                                                decision_fused_batched_plain,
                                                decision_fused_plain,
                                                pack_decision_operands)
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.ref import flash_attention_ref, ssd_chunked_ref
from repro_torch.kernels.scheduler_solve import (scheduler_solve,
                                                 scheduler_solve_plain,
                                                 solve_scalars)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import model as M
from repro_torch.models.registry import make_model
from repro_torch.service import SchedulerService
from repro_torch.service.demo import demo_request, register_demo_tenants

pytestmark = pytest.mark.cuda

SIZES = [1, 100, 1023, 1024, 1025, 3597]
OUTPUTS = ("sel", "q", "p", "z_new", "tc", "pq")
KW = dict(n=100, v=1000.0, lam=10.0, ell=32 * 555178.0, bandwidth=22e6,
          noise=1.0, p_max=100.0, p_bar=1.0, q_floor=1e-5)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # full float32 products in the plain versions, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def lanes(n, device):
    g = torch.Generator(device=device).manual_seed(n)
    gains = torch.exp(torch.randn(n, generator=g, device=device) * 2.0)
    z = torch.randn(n, generator=g, device=device).abs() * 50.0
    z[::4] = 0.0  # the Z-floor / boundary branch
    u = torch.rand(n, generator=g, device=device)
    mask = torch.rand(n, generator=g, device=device) < 0.8
    return gains, z, u, mask


def ops():
    co = decision_coeffs(SchedulerConfig(n_clients=100,
                                         model_bits=32 * 555178.0),
                         ChannelConfig(n_clients=100))
    return pack_decision_operands(co.solve, co.acct)


@pytest.mark.parametrize("n", SIZES)
def test_scheduler_solve_kernel_matches_plain(cuda, n):
    gains, z, _, _ = lanes(n, cuda)
    before = scheduler_solve.launches
    q, p = scheduler_solve(gains, z, **KW)
    assert scheduler_solve.launches == before + 1
    q0, p0 = scheduler_solve_plain(gains, z, solve_scalars(**KW))
    torch.testing.assert_close(q, q0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p, p0, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_decision_fused_kernel_matches_plain(cuda, n, masked):
    gains, z, u, mask = lanes(n, cuda)
    m = mask if masked else None
    before = decision_fused.launches
    got = decision_fused(gains, z, u, ops(), active=m, valid=m)
    assert decision_fused.launches == before + 1
    want = decision_fused_plain(gains, z, u, ops(), m, m)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    for i in (2, 3, 5):
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0.0)
    far = (u - want[1]).abs() > 1e-6
    assert torch.equal(got[0][far], want[0][far])
    for name, x, y in zip(OUTPUTS, got, want):
        assert torch.equal(x, y), name


def offset_view(x):
    """A copy of ``x`` as a contiguous view at storage offset 1."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 3, 5, 1027])
def test_decision_fused_kernel_edges_bitwise(cuda, n, masked, offset):
    """Short and ragged vectors, masks on and off, lanes and masks at
    storage offset 1: bit for bit the plain version."""
    gains, z, u, mask = lanes(n, cuda)
    m = mask if masked else None
    want = decision_fused_plain(gains, z, u, ops(), m, m)
    if offset:
        gains, z, u = (offset_view(x) for x in (gains, z, u))
        m = None if m is None else offset_view(m)
    got = decision_fused(gains, z, u, ops(), active=m, valid=m)
    for name, x, y in zip(OUTPUTS, got, want):
        assert torch.equal(x, y), name


def test_wrappers_reject_mixed_devices(cuda):
    g = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        scheduler_solve(g, g.cpu(), **KW)
    with pytest.raises(ValueError):
        decision_fused(g, g, g, ops().to(cuda))


def test_engine_paths_launch_their_kernels(cuda):
    """A tiny run per solver: cuda_fused launches only the fused kernel and
    cuda only the solve kernel, once per round, and all three solvers
    select the same clients on the same draws."""
    n, rounds = 20, 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    ds = make_cifar10_like(gen, n_clients=n, per_client=16, n_test=32, h=8,
                           w=8, device=cuda)
    mp = dict(conv1=4, conv2=8, hidden=16)
    params = make_model("cnn", ds, **mp).init_fn(gen)
    scfg = SchedulerConfig(n_clients=n, model_bits=32 * 50_000.0)
    ch = ChannelConfig(n_clients=n)
    sig = heterogeneous_sigmas(n, device=cuda)
    hist = {}
    for solver, want in (("cuda_fused", (0, rounds)), ("cuda", (rounds, 0)),
                         ("stitched", (0, 0))):
        scheduler_solve.launches = decision_fused.launches = 0
        hist[solver] = run_simulation(
            None, params, ds,
            SimConfig(rounds=rounds, eval_every=2, m_cap=4, batch=4,
                      local_steps=2, eval_size=32, solver=solver,
                      model_params=tuple(mp.items())),
            scfg, ch, sig, keep_selection=True)
        assert (scheduler_solve.launches, decision_fused.launches) == want
    for solver in ("cuda", "stitched"):
        assert (hist[solver]["selected"]
                == hist["cuda_fused"]["selected"]).all()


def test_population_engine_launches_masked_kernels(cuda):
    """The population engine on the card: cuda_fused launches only K2 (its
    activity mask as ``active`` and ``valid``), cuda only K1, once a
    round; no inactive lane is selected or has q != 0; the solvers select
    the same clients; ``population=()`` equals the population-free fused
    run's decisions bit for bit."""
    n, rounds = 40, 4
    gen = torch.Generator(device=cuda).manual_seed(1)
    ds = make_cifar10_like(gen, n_clients=n, per_client=16, n_test=32, h=8,
                           w=8, device=cuda)
    mp = dict(conv1=4, conv2=8, hidden=16)
    params = make_model("cnn", ds, **mp).init_fn(gen)
    scfg = SchedulerConfig(n_clients=n, model_bits=32 * 50_000.0)
    ch = ChannelConfig(n_clients=n)
    sig = heterogeneous_sigmas(n, device=cuda)
    base = dict(rounds=rounds, eval_every=2, m_cap=4, batch=4, local_steps=2,
                eval_size=32, model_params=tuple(mp.items()),
                channel="outage_burst")
    pop = (("p_leave", 0.2), ("p_join", 0.3), ("p_fail", 0.25),
           ("init_active", 0.6))

    def run(solver, population):
        scheduler_solve.launches = decision_fused.launches = 0
        hist = run_simulation(None, params, ds,
                              SimConfig(solver=solver, population=population,
                                        **base), scfg, ch, sig,
                              keep_selection=True)
        return hist, (scheduler_solve.launches, decision_fused.launches)

    hist = {}
    for solver, want in (("cuda_fused", (0, rounds)), ("cuda", (rounds, 0)),
                         ("stitched", (0, 0))):
        hist[solver], launched = run(solver, pop)
        assert launched == want, solver
        active = hist[solver]["active"]
        assert not active.all()
        assert not hist[solver]["selected"][~active].any()
        assert not hist[solver]["q"][~active].any()
    for solver in ("cuda", "stitched"):
        assert (hist[solver]["selected"]
                == hist["cuda_fused"]["selected"]).all()
    free, _ = run("cuda_fused", None)
    degenerate, launched = run("cuda_fused", ())
    assert launched == (0, rounds)
    for key in ("comm_time", "avg_power", "n_selected", "selected", "q"):
        np.testing.assert_array_equal(degenerate[key], free[key])


@pytest.mark.parametrize("n,seeds", [(100, 3), (3597, 4)])
def test_scheduler_solve_flattened_seeds(cuda, n, seeds):
    """S seeds' lanes flattened in one launch equal S launches of N lanes
    bit for bit (``n`` the configuration's N), and equal the plain version
    bit for bit; q and P are the rows of one (2, S N) tensor."""
    gains, z, _, _ = lanes(n * seeds, cuda)
    kw = dict(KW, n=n)
    before = scheduler_solve.launches
    q, p = scheduler_solve(gains, z, **kw)
    assert scheduler_solve.launches == before + 1
    assert q.data_ptr() + 4 * n * seeds == p.data_ptr()
    q0, p0 = scheduler_solve_plain(gains, z, solve_scalars(**kw))
    assert torch.equal(q, q0) and torch.equal(p, p0)
    for s in range(seeds):
        rows = slice(s * n, (s + 1) * n)
        qs, ps_ = scheduler_solve(gains[rows], z[rows], **kw)
        assert torch.equal(qs, q[rows]) and torch.equal(ps_, p[rows])


def test_sweep_launches_solve_once_a_round(cuda):
    """run_sweep under "cuda" and "cuda_fused": the solve kernel once a
    round for all seeds, the same trajectories as "stitched" (n_selected
    exact, comm time at rtol 1e-5); uniform launches nothing."""
    from repro_torch.fl.engine import run_sweep

    n, rounds = 64, 12
    sig = heterogeneous_sigmas(n, device=cuda)
    scfg = SchedulerConfig(n_clients=n, model_bits=32 * 555178.0)
    ch = ChannelConfig(n_clients=n)
    out = {}
    for solver, policy, want in (("cuda", "proposed", rounds),
                                 ("cuda_fused", "proposed", rounds),
                                 ("stitched", "proposed", 0),
                                 ("cuda", "uniform", 0)):
        scheduler_solve.launches = decision_fused.launches = 0
        out[solver, policy] = run_sweep(None, sig, scfg, ch, rounds=rounds,
                                        policies=(policy,),
                                        seeds=(0, 1, 2), solver=solver)
        assert (scheduler_solve.launches, decision_fused.launches) == (
            want, 0)
    for solver in ("cuda", "cuda_fused"):
        got, want = out[solver, "proposed"], out["stitched", "proposed"]
        np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
        np.testing.assert_allclose(got["comm_time"], want["comm_time"],
                                   rtol=1e-5)


BATCHED_SHAPES = [(1, 8), (7, 1029), (1024, 32), (512, 128), (64, 16384)]


def bucket(b, n, device):
    """(B, N) lanes, a ragged ``valid`` and B heterogeneous operand rows
    (each its own ell, lam, V and Pmax)."""
    gains, z, u, _ = lanes(b * n, device)
    gains, z, u = gains.view(b, n), z.view(b, n), u.view(b, n)
    g = torch.Generator(device=device).manual_seed(b)
    valid = (torch.arange(n, device=device)
             < torch.randint(1, n + 1, (b, 1), generator=g, device=device))
    return gains, z, u, valid, operand_rows(b, n).to(device)


@functools.cache
def operand_rows(b, n):
    return torch.stack([pack_decision_operands(*decision_coeffs(
        SchedulerConfig(n_clients=n, model_bits=1e5 * (1 + r % 97),
                        lam=0.5 + r % 30, V=10.0 + 37.0 * r),
        ChannelConfig(n_clients=n, p_max=20.0 + r % 130)))
        for r in range(b)])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n", BATCHED_SHAPES)
def test_decision_fused_batched_kernel_equals_plain(cuda, b, n, masked):
    gains, z, u, valid, bops = bucket(b, n, cuda)
    v = valid if masked else None
    before = decision_fused_batched.launches
    got = decision_fused_batched(gains, z, u, bops, valid=v)
    assert decision_fused_batched.launches == before + 1
    want = decision_fused_batched_plain(gains, z, u, bops, v)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n", [(1, 3), (7, 1029), (70000, 4)])
def test_decision_fused_batched_kernel_edges_bitwise(cuda, b, n, masked,
                                                     offset):
    """A single ragged row, ragged rows, and rows past CUDA's grid-y limit
    (the kernel's row loop), ``valid`` on and off, lanes at storage offset
    1: bit for bit the plain version."""
    gains, z, u, valid, bops = bucket(b, n, cuda)
    v = valid if masked else None
    want = decision_fused_batched_plain(gains, z, u, bops, v)
    if offset:
        gains, z, u = (offset_view(x) for x in (gains, z, u))
        v = None if v is None else offset_view(v)
    got = decision_fused_batched(gains, z, u, bops, valid=v)
    for name, x, y in zip(OUTPUTS, got, want):
        assert torch.equal(x, y), name


def test_service_fused_flush_matches_stitched(cuda):
    """One flush of a demo-mix slice: cuda_fused launches the batched
    kernel once per proposed group and selects what stitched selects."""
    decisions, launches = {}, {}
    for solver in ("cuda_fused", "stitched"):
        svc = SchedulerService(solver=solver, device=cuda)
        rng = np.random.default_rng(0)
        tenants = register_demo_tenants(svc, rng, scale=0.05)
        before = decision_fused_batched.launches
        for name, n, policy in tenants:
            _, gains, raw = demo_request(rng, name, n, policy)
            svc.submit(name, gains, raw=raw)
        decisions[solver] = svc.flush()
        launches[solver] = decision_fused_batched.launches - before
    assert launches == {"cuda_fused": 2, "stitched": 0}
    for name, d in decisions["stitched"].items():
        f = decisions["cuda_fused"][name]
        assert np.array_equal(d.sel, f.sel)
        np.testing.assert_allclose(f.q, d.q, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("staging", [True, False])
def test_service_telemetry_is_neutral_on_the_card(cuda, staging):
    """A demo-mix slice under cuda_fused, telemetry on (profiler spans too)
    and off: the same decisions and queues bit for bit, the same K3
    launches, the counters what was served, and no synchronisation inside
    any group's dispatch (``set_sync_debug_mode("error")``)."""
    from repro_torch import obs
    runs = {}
    for on in (False, True):
        obs.configure(on)
        try:
            svc = SchedulerService(solver="cuda_fused", device=cuda,
                                   telemetry=on, staging=staging)
            rng = np.random.default_rng(0)
            tenants = register_demo_tenants(svc, rng, scale=0.05)
            svc.warmup(16)
            dispatch = svc._dispatch_group

            def checked(*args):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return dispatch(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")

            svc._dispatch_group = checked
            before = decision_fused_batched.launches
            out = []
            for _ in range(3):
                for name, n, policy in tenants:
                    _, gains, raw = demo_request(rng, name, n, policy)
                    svc.submit(name, gains, raw=raw)
                out.append(svc.flush())
            runs[on] = (svc, out, decision_fused_batched.launches - before)
        finally:
            obs.configure(False)
    (off, r_off, k_off), (on, r_on, k_on) = runs[False], runs[True]
    assert k_on == k_off == 6
    for a, b in zip(r_on, r_off):
        for name in b:
            for x, y in zip(a[name], b[name]):
                assert np.array_equal(x, y), name
    for x, y in zip(on.snapshot().values(), off.snapshot().values()):
        for lx, ly in zip(x, y):
            assert np.array_equal(lx, ly)
    reg = on.obs.registry
    assert reg.value("service_flushes_total") == 3
    assert reg.value("service_requests_served_total") == 3 * len(tenants)
    assert off.metrics_snapshot()["metrics"] == []


def test_engine_telemetry_is_neutral_on_the_card(cuda):
    """run_simulation under cuda_fused with telemetry on and off (cuDNN's
    deterministic algorithms: the card's training is otherwise not
    bitwise reproducible), and the chunk runner's 2 + 1 rounds against 3:
    equal bit for bit, K2 / K1 once a round each."""
    from repro_torch import obs
    from repro_torch.fl.engine import (default_draws, init_carry,
                                       make_chunk_runner)
    n, rounds = 20, 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    ds = make_cifar10_like(gen, n_clients=n, per_client=16, n_test=32, h=8,
                           w=8, device=cuda)
    mp = dict(conv1=4, conv2=8, hidden=16)
    params = make_model("cnn", ds, **mp).init_fn(gen)
    scfg = SchedulerConfig(n_clients=n, model_bits=32 * 50_000.0)
    ch = ChannelConfig(n_clients=n)
    sig = heterogeneous_sigmas(n, device=cuda)
    sim = SimConfig(rounds=rounds, eval_every=2, m_cap=4, batch=4,
                    local_steps=2, eval_size=32,
                    model_params=tuple(mp.items()))
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    hist, chunks = {}, {}
    try:
        for on in (False, True):
            obs.configure(on)
            decision_fused.launches = scheduler_solve.launches = 0
            hist[on] = run_simulation(None, params, ds, sim, scfg, ch, sig,
                                      keep_selection=True)
            assert (decision_fused.launches, scheduler_solve.launches) == (
                rounds, 0)
            csim = dataclasses.replace(sim, solver="cuda")
            draws = default_draws(csim, ds)
            run_chunk = make_chunk_runner(ds, csim, scfg, ch, sig, draws)
            carry = init_carry(draws, params, scfg, csim, sig, ch)
            for length in ((rounds,) if on else (2, rounds - 2)):
                carry, acc, _ = run_chunk(carry, length)
            assert scheduler_solve.launches == rounds
            chunks[on] = (carry, acc)
        assert obs.default_registry().value("engine_runs_total") == 1.0
    finally:
        obs.configure(False)
        torch.backends.cudnn.deterministic = flag
    for key in hist[False]:
        assert np.array_equal(hist[False][key], hist[True][key]), key
    (a, acc_a), (b, acc_b) = chunks[False], chunks[True]
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert torch.equal(a[1].z, b[1].z) and torch.equal(a[4], b[4])
    assert torch.equal(acc_a, acc_b)


# (b, S, H, P, N, chunk): the padded reference-test shape, a mid shape,
# mamba2-130m's prefill in generate (4 x 2000, padded to 2048 by ops.ssd:
# 48 steps with dt = 0) and its forward shape at batch 4 x 2048
SSD_SHAPES = [(1, 128, 2, 32, 16, 32), (2, 384, 24, 64, 128, 128),
              (4, 2000, 24, 64, 128, 128), (4, 2048, 24, 64, 128, 128)]


def ssd_lanes(b, s, h, p, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    dt = torch.nn.functional.softplus(randn(b, s, h)) * 0.2
    return (randn(b, s, h, p), dt, -torch.exp(randn(h)), randn(b, s, n),
            randn(b, s, n))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk, with_h0):
    x, dt, a, bm, cm = ssd_lanes(b, s, h, p, n, cuda)
    h0 = torch.randn((b, h, n, p), device=cuda) if with_h0 else None
    before = ssd_scan.launches
    y, h_final = kernel_ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0,
                                return_state=True)
    y_only = kernel_ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0)
    assert ssd_scan.launches == before + 2
    xp, dtp, bmp, cmp = kernel_ops.pad_to_chunk(chunk, x, dt, bm, cm)
    y0, h0_final = ssd_chunked_ref(xp, dtp, a, bmp, cmp, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert y.shape == x.shape
    torch.testing.assert_close(y, y0[:, :s], rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(h_final, h0_final, rtol=1e-4, atol=2e-5)
    assert torch.equal(y_only, y)


def test_ssd_scan_rejects_other_dtypes(cuda):
    x, dt, a, bm, cm = ssd_lanes(1, 32, 2, 32, 16, cuda)
    with pytest.raises(TypeError):
        ssd_scan(x.double(), dt, a, bm, cm, chunk=32)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm.cpu(), cm, chunk=32)


def test_mamba_launches_ssd_scan_per_layer(cuda):
    """mamba2-130m at full width (24 layers), batch 1 x 256: one launch
    per layer in the forward and in the prefill, none in decode."""
    cfg = get_config("mamba2-130m")
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    ssd_scan.launches = 0
    logits, _ = M.forward(params, M.Batch(tokens=tok), cfg)
    assert ssd_scan.launches == cfg.n_layers == 24
    _, st = M.prefill(params, M.Batch(tokens=tok[:, :200]), cfg, 256)
    assert ssd_scan.launches == 48
    for t in range(200, 204):
        lg, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
        assert float((lg[:, 0] - logits[:, t]).abs().max()) < 2e-4
    assert ssd_scan.launches == 48


# (bh, Sq, Sk, D, causal, window): the reference tests' shapes, Sq != Sk,
# a non-causal window and yi-6b's shapes at batch 4: generate's prefill of
# 2000 and the forward's 2048; non-causal Sq > Sk with a ragged key tile
# and Sq < Sk; llama-3.2-vision-11b's cross-attention over 1,601 media
# embeddings, seamless-m4t-large-v2's encoder (4,096 frames) and its
# cross-attention over them, at batch 4
FLASH_SHAPES = [(2, 256, 256, 64, True, None), (1, 200, 200, 64, True, None),
                (2, 384, 384, 64, True, 128), (3, 64, 64, 128, False, None),
                (1, 128, 128, 32, True, 32), (2, 100, 300, 64, True, None),
                (2, 150, 130, 128, True, 40), (2, 256, 256, 64, False, 48),
                (128, 2000, 2000, 128, True, None),
                (128, 2048, 2048, 128, True, None),
                (2, 48, 37, 64, False, None), (2, 70, 150, 64, False, None),
                (128, 2048, 1601, 128, False, None),
                (64, 4096, 4096, 64, False, None),
                (64, 2048, 4096, 64, False, None)]


def flash_lanes(bh, sq, sk, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((bh, s, d), generator=g, device=device).to(dtype)
            for s in (sq, sk, sk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,window", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, bh, sq, sk, d, causal,
                                              window, dtype):
    q, k, v = flash_lanes(bh, sq, sk, d, dtype, cuda)
    before = flash_attention_bhsd.launches
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window)
    every = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                 skip_tiles=False)
    assert flash_attention_bhsd.launches == before + 2
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(out, every)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal,window,kv_group", [
    (128, 2048, 2048, 128, True, None, 8),   # yi-6b's forward
    (128, 2000, 2000, 128, True, None, 8),   # yi-6b's prefill
    (4, 150, 130, 128, True, 40, 2), (8, 100, 300, 64, True, None, 2),
    (4, 256, 256, 32, False, 48, 2),
    (128, 2048, 2048, 128, True, None, 16),  # chatglm3-6b's forward
    (192, 2048, 2048, 128, True, None, 48),  # granite-20b's forward
    (128, 2048, 1601, 128, False, None, 4),  # llama-vision's cross layer
    (96, 48, 37, 64, False, None, 48)])
def test_flash_attention_kv_group_equals_expanded(cuda, bh, sq, sk, d,
                                                  causal, window, kv_group,
                                                  dtype):
    """Row-block bh reads KV head bh // kv_group: the kernel on the
    unexpanded heads equals it on the expanded ones bit for bit, and its
    plain version (which expands) within the tolerance."""
    g = torch.Generator(device=cuda).manual_seed(kv_group)
    q, k, v = (torch.randn((n, s, d), generator=g, device=cuda).to(dtype)
               for n, s in ((bh, sq), (bh // kv_group, sk),
                            (bh // kv_group, sk)))
    out = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                               kv_group=kv_group)
    expanded = flash_attention_bhsd(
        q, k.repeat_interleave(kv_group, 0), v.repeat_interleave(kv_group, 0),
        causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               kv_group=kv_group)
    torch.cuda.synchronize()
    assert torch.equal(out, expanded)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_rejects_bad_kv_groups(cuda):
    q, k, v = flash_lanes(8, 64, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="kv_group"):
        flash_attention_bhsd(q, k, v, kv_group=4)    # k has BH heads
    with pytest.raises(ValueError, match="kv_group"):
        flash_attention_bhsd(q, k[:2], v[:4], kv_group=4)
    with pytest.raises(ValueError, match="multiple of kv_group"):
        flash_attention_bhsd(q, k[:2], v[:2], kv_group=3)
    assert flash_attention_bhsd(q, k[:2], v[:2], kv_group=4).shape == q.shape


def test_yi_forward_and_prefill_expand_no_kv_head(cuda, monkeypatch):
    """No ``repeat_interleave`` runs in reduced yi-6b's forward or prefill
    on the card: K5 reads the shared KV heads itself."""
    cfg = get_config("yi-6b").reduced(d_model=512)
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    calls = []
    interleave = torch.Tensor.repeat_interleave

    def counting(self, *args, **kw):
        calls.append(tuple(self.shape))
        return interleave(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", counting)
    M.forward(params, M.Batch(tokens=tok), cfg)
    M.prefill(params, M.Batch(tokens=tok[:, :80]), cfg, 96)
    assert calls == [] and cfg.n_heads > cfg.n_kv_heads


def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = flash_lanes(2, 64, 64, 96, torch.float32, cuda)
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, k, v)
    q, k, v = flash_lanes(2, 64, 64, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention_bhsd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, k.cpu(), v)


def test_yi_launches_flash_attention_per_layer(cuda):
    """yi-6b reduced to 2 layers of d_model 512 (4 query heads of 128
    sharing one KV head), batch 2 x 256: one launch per layer in the
    forward and in the prefill, none in decode, and decode reproduces the
    forward's logits."""
    cfg = get_config("yi-6b").reduced(d_model=512)
    assert cfg.resolved_head_dim == 128
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    flash_attention_bhsd.launches = 0
    logits, _ = M.forward(params, M.Batch(tokens=tok), cfg)
    assert flash_attention_bhsd.launches == cfg.n_layers
    _, st = M.prefill(params, M.Batch(tokens=tok[:, :200]), cfg, 256)
    assert flash_attention_bhsd.launches == 2 * cfg.n_layers
    for t in range(200, 204):
        lg, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
        assert float((lg[:, 0] - logits[:, t]).abs().max()) < 2e-4
    assert flash_attention_bhsd.launches == 2 * cfg.n_layers


def no_kv_expansion(monkeypatch):
    """A list that records the shape of every ``repeat_interleave``."""
    calls = []
    interleave = torch.Tensor.repeat_interleave

    def counting(self, *args, **kw):
        calls.append(tuple(self.shape))
        return interleave(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", counting)
    return calls


@pytest.mark.parametrize("arch,per_call", [
    ("llama-3.2-vision-11b", 2),      # a self- and a cross-attention layer
    ("seamless-m4t-large-v2", 6)])    # 2 encoder layers, 2 x (self, cross)
def test_cross_and_encoder_layers_launch_flash_attention(cuda, monkeypatch,
                                                         arch, per_call):
    """Reduced llama-3.2-vision-11b (a cross-attention layer over 100
    media embeddings) and seamless-m4t-large-v2 (bidirectional encoder
    layers over 200 frames, a cross block in each decoder layer), d_model
    512 (head dim 128), batch 2 x 256: K5 launches once per self-, cross-
    and encoder attention call in the forward and the prefill, never in
    decode; no KV head is expanded, and decode reproduces the forward's
    logits."""
    cfg = get_config(arch).reduced(d_model=512)
    assert cfg.resolved_head_dim == 128
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    g = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                        generator=g)
    media = (torch.randn((2, 100, cfg.d_model), device=cuda, generator=g)
             if cfg.cross_attn_every else None)
    frames = (torch.randn((2, 200, cfg.d_model), device=cuda, generator=g)
              if cfg.is_encoder_decoder else None)
    calls = no_kv_expansion(monkeypatch)
    flash_attention_bhsd.launches = 0
    logits, _ = M.forward(params, M.Batch(tok, media=media, frames=frames),
                          cfg)
    assert flash_attention_bhsd.launches == per_call
    _, st = M.prefill(params, M.Batch(tok[:, :200], media=media,
                                      frames=frames), cfg, 256)
    assert flash_attention_bhsd.launches == 2 * per_call
    for t in range(200, 204):
        lg, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
        assert float((lg[:, 0] - logits[:, t]).abs().max()) < 2e-4
    assert flash_attention_bhsd.launches == 2 * per_call
    assert calls == []


def test_apply_moe_on_the_card_matches_the_cpu(cuda):
    """The MoE at a kimi-like 64 experts top-8 (d 512, ff 256) and at
    mixtral's 8 top-2 on 2 x 300 tokens. At the configs' capacity factor
    1.25 (the 64-expert case drops pairs) the card's output is the same
    bits run to run (the combine gathers each token's k slots in a fixed
    order; no atomics). At a factor of E / k, where nothing drops and a
    token's output depends on its own choices only: the card's experts
    are the CPU's on every token whose k-th / (k+1)-th router margin
    exceeds 1e-5, and on every token whose choices agree the output is
    the CPU's (rtol 1e-4 / atol 1e-5: float32 products in cuBLAS's
    order)."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    for e, k in ((64, 8), (8, 2)):
        cfg = ModelConfig(name="t", arch_type="moe", n_layers=1, d_model=512,
                          n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=64,
                          n_experts=e, top_k=k, moe_d_ff=256)
        p = moe.init_moe(torch.Generator(device=cuda).manual_seed(e), cfg,
                         torch.float32, cuda)
        x = torch.randn((2, 300, 512), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
        y, _ = moe.apply_moe(p, x, cfg)
        again, _ = moe.apply_moe(p, x, cfg)
        assert torch.equal(y, again)

        wide = dataclasses.replace(cfg, capacity_factor=e / k)
        p_cpu = moe.MoE(*(t.cpu() for t in (p.router.w, p.wi, p.wg, p.wo)),
                        wide)
        y, _ = moe.apply_moe(p, x, wide)
        y_cpu, _ = moe.apply_moe(p_cpu, x.cpu(), wide)
        xt = x.reshape(-1, 512)
        r, r_cpu = moe.route(p, xt, wide), moe.route(p_cpu, xt.cpu(), wide)
        top = torch.sort(r_cpu.probs, dim=-1, descending=True).values
        trusted = (top[:, k - 1] - top[:, k]) > 1e-5
        assert trusted.float().mean() > 0.5
        assert torch.equal(r.ids.cpu()[trusted], r_cpu.ids[trusted])
        same = (r.ids.cpu() == r_cpu.ids).all(dim=1)
        torch.testing.assert_close(y.reshape(-1, 512).cpu()[same],
                                   y_cpu.reshape(-1, 512)[same], rtol=1e-4,
                                   atol=1e-5)


def test_flash_attention_mixtral_window_matches_plain(cuda):
    """K5 with mixtral's window of 4,096 over its forward's 8,192 tokens
    and its prefill's 8,000 (a ragged last tile), on 12 query heads
    sharing 2 KV heads (``kv_group`` 6): within 2e-5 of its plain version,
    the same bits with the masked key tiles run, and the same bits as on
    the expanded heads."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for s in (8192, 8000):
        q = torch.randn((12, s, 128), generator=g, device=cuda)
        k, v = (torch.randn((2, s, 128), generator=g, device=cuda)
                for _ in range(2))
        out = flash_attention_bhsd(q, k, v, causal=True, window=4096,
                                   kv_group=6)
        every = flash_attention_bhsd(q, k, v, causal=True, window=4096,
                                     kv_group=6, skip_tiles=False)
        expanded = flash_attention_bhsd(q, k.repeat_interleave(6, 0),
                                        v.repeat_interleave(6, 0),
                                        causal=True, window=4096)
        want = flash_attention_ref(q, k, v, causal=True, window=4096,
                                   kv_group=6)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
        assert torch.equal(out, every) and torch.equal(out, expanded)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_jamba_state_width_matches_plain(cuda, with_h0):
    """K4 at jamba-v0.1-52b's Mamba width (128 heads of 64, N = 16, padded
    to 32 state columns in the kernel, chunk 128) over its prefill, batch
    4 x 2,000 tokens (padded to 2,048): y rtol 1e-4 / atol 2e-4, the final
    state rtol 1e-4 / atol 2e-5."""
    b, s, h, p, n, chunk = 4, 2000, 128, 64, 16, 128
    x, dt, a, bm, cm = ssd_lanes(b, s, h, p, n, cuda, seed=16)
    h0 = torch.randn((b, h, n, p), device=cuda) if with_h0 else None
    y, h_final = kernel_ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0,
                                return_state=True)
    xp, dtp, bmp, cmp = kernel_ops.pad_to_chunk(chunk, x, dt, bm, cm)
    y0, h0_final = ssd_chunked_ref(xp, dtp, a, bmp, cmp, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0[:, :s], rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(h_final, h0_final, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("arch,flash,ssd", [("mixtral-8x22b", 2, 0),
                                            ("jamba-v0.1-52b", 1, 7),
                                            ("kimi-k2-1t-a32b", 2, 0)])
def test_moe_ids_decode_past_the_window(cuda, monkeypatch, arch, flash,
                                        ssd):
    """The reduced MoE ids at d_model 512 (head dim 128), capacity factor
    E / k (nothing drops, so decode can match the forward), batch 2 x 200:
    K5 (with mixtral's window, 64) and K4 launch their counts in the
    forward and the prefill, never in decode, no KV head is expanded, and
    prefill of 100 plus decode to 199 (mixtral's 64-slot cache wraps)
    reproduces the forward's logits within 2e-4."""
    cfg = get_config(arch).reduced(d_model=512)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                              / cfg.top_k)
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    calls = no_kv_expansion(monkeypatch)
    flash_attention_bhsd.launches = ssd_scan.launches = 0
    logits, aux = M.forward(params, M.Batch(tokens=tok), cfg)
    assert (flash_attention_bhsd.launches, ssd_scan.launches) == (flash, ssd)
    assert float(aux) > 0.0
    lg, st = M.prefill(params, M.Batch(tokens=tok[:, :100]), cfg, 200)
    assert (flash_attention_bhsd.launches, ssd_scan.launches) == (
        2 * flash, 2 * ssd)
    errs = [float((lg[:, 0] - logits[:, 99]).abs().max())]
    for t in range(100, 199):
        lg, st = M.decode_step(params, tok[:, t:t + 1], st, cfg)
        errs.append(float((lg[:, 0] - logits[:, t]).abs().max()))
    assert (flash_attention_bhsd.launches, ssd_scan.launches) == (
        2 * flash, 2 * ssd)
    assert max(errs) < 2e-4 and calls == []
    if cfg.sliding_window:
        slots = [c for c in st.layers if c is not None and hasattr(c, "k")]
        assert all(int(c.slot_pos.max()) == 198 and c.k.shape[1] == 64
                   for c in slots)


# ---------------------------------------------------------------- training

# (BH, Sq, Sk, D, causal, window, kv_group): chip_smoke.py phase 15's
# K5-backward shapes at a reduced BH: yi-6b's causal GQA, minicpm-2b's D =
# 64, mixtral-8x22b's window of 4,096 over 8,192 tokens, llama-3.2-vision-
# 11b's non-causal ragged cross-attention; plus short and ragged ones; and
# the edges of the kernel's tiling (64 resident rows a block, 32 streamed
# a step, heads padded to 64 rows): Sq 1 (non-causal, so the row sees 37
# keys), 16 (the FL leg's), 65 and 2,000; Sk ragged against both tiles;
# window rows whose first key tiles are all masked; D 32 with a window;
# granite-20b's kv_group 48
BWD_SHAPES = [(16, 2048, 2048, 128, True, None, 8),
              (16, 2048, 2048, 64, True, None, 1),
              (6, 8192, 8192, 128, True, 4096, 6),
              (8, 2048, 1601, 128, False, None, 4),
              (4, 100, 100, 32, True, None, 2),
              (6, 100, 70, 64, False, 48, 3),
              (3, 70, 150, 128, True, 40, 1),
              (4, 1, 37, 64, False, None, 2),
              (96, 16, 16, 32, True, None, 1),
              (4, 65, 65, 128, True, None, 2),
              (8, 2000, 2000, 128, True, None, 4),
              (4, 130, 97, 64, False, None, 1),
              (2, 600, 600, 64, True, 100, 1),
              (4, 200, 200, 32, True, 50, 2),
              (48, 300, 300, 128, True, None, 48)]
BWD_TOL = 1e-4      # of max |plain| per gradient, float32


def bwd_lanes(bh, sq, sk, d, group, device, dtype=torch.float32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((bh, sq, d), (bh // group, sk, d), (bh // group, sk, d),
                      (bh, sq, d))]


@pytest.mark.parametrize("bh,sq,sk,d,causal,window,group", BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, bh, sq, sk, d,
                                                  causal, window, group):
    """K5's backward kernel (on the forward's lse, as the main path runs
    it) against its plain version, the same bits with the masked tiles run
    (and lse from its own K5 run), from run to run, and on the expanded KV
    heads summed back per group."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    q, k, v, do = bwd_lanes(bh, sq, sk, d, group, cuda, seed=sq + d)
    kw = dict(causal=causal, window=window, kv_group=group)
    o, lse = flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= BWD_TOL * float(w.abs().max())
    for g, w in zip(flash_attention_bwd(q, k, v, o, do, skip_tiles=False,
                                        **kw), got):
        assert torch.equal(g, w)
    for g, w in zip(flash_attention_bwd(q, k, v, o, do, **kw), got):
        assert torch.equal(g, w)
    if group > 1:
        ke, ve = (t.repeat_interleave(group, 0) for t in (k, v))
        dq, dk, dv = flash_attention_bwd(q, ke, ve, o, do, causal=causal,
                                         window=window)
        assert torch.equal(dq, got[0])
        for e, g in ((dk, got[1]), (dv, got[2])):
            e = e.unflatten(0, (-1, group)).sum(1)
            assert float((e - g).abs().max()) <= 3e-5 * float(
                e.abs().max())


@pytest.mark.parametrize("bh,sq,sk,d,causal,window", FLASH_SHAPES[:8])
def test_flash_attention_lse_matches_plain(cuda, bh, sq, sk, d, causal,
                                           window):
    """The lse K5 writes for the backward (``return_lse=True``) against the
    plain log-sum-exp within 2e-5 (scores of a few units; ex2.approx and
    3xTF32), and o the same bits with and without it."""
    from repro_torch.kernels.ref import flash_lse_ref
    q, k, v = flash_lanes(bh, sq, sk, d, torch.float32, cuda)
    o, lse = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    assert lse.shape == (bh, sq) and lse.dtype == torch.float32
    assert torch.equal(o, flash_attention_bhsd(q, k, v, causal=causal,
                                               window=window))
    want = flash_lse_ref(q, k, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bwd_bfloat16(cuda, d):
    """bfloat16 inputs and gradients (the kernel widens them exactly into
    its hi parts): against the plain version within a bfloat16 rounding,
    the same bits with the masked tiles run and from run to run, and dq
    bit-equal on the expanded KV."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    q, k, v, do = bwd_lanes(4, 256, 256, d, 2, cuda, torch.bfloat16)
    o, lse = flash_attention_bhsd(q, k, v, kv_group=2, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, do, kv_group=2, lse=lse)
    want = flash_attention_bwd_ref(q, k, v, o, do, kv_group=2)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w.float()).abs().max()) <= (
            2e-2 * float(w.float().abs().max()))
    for again in (flash_attention_bwd(q, k, v, o, do, kv_group=2,
                                      skip_tiles=False),
                  flash_attention_bwd(q, k, v, o, do, kv_group=2, lse=lse)):
        for g, w in zip(again, got):
            assert torch.equal(g, w)
    dq, _, _ = flash_attention_bwd(q, k.repeat_interleave(2, 0),
                                   v.repeat_interleave(2, 0), o, do)
    assert torch.equal(dq, got[0])


@pytest.mark.parametrize("d,group", [(16, 2), (64, 1), (128, 4)])
def test_ops_flash_attention_gradients_equal_the_cpus(cuda, d, group):
    """Autograd through ``ops.flash_attention`` (K5 and its backward; D =
    16 padded to 32) on the card against the same on the CPU."""
    arrays = bwd_lanes(8, 96, 96, d, group, "cpu", seed=d)
    grads = []
    for device in ("cpu", cuda):
        q, k, v = (t.to(device).requires_grad_() for t in arrays[:3])
        o = kernel_ops.flash_attention(q, k, v, kv_group=group)
        grads.append(torch.autograd.grad(o, (q, k, v),
                                         arrays[3].to(device)))
    for c, g in zip(*grads):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * float(
            c.abs().max())


@pytest.mark.parametrize("d,group,kv_batched", [(16, 2, True),
                                                 (64, 4, False)])
def test_flash_attention_vmap_grad_equals_the_cpus(cuda, d, group,
                                                   kv_batched):
    """``vmap(grad(...))`` through ``ops.flash_attention`` over 6 rows: the
    vmap rules fold the rows into BH (row-block m BH + bh reads KV head m
    BH / g + bh // g; unbatched K and V expanded first), one forward and
    one backward launch for all rows; the card's gradients against the
    CPU's within 1e-4 of each one's largest |CPU| entry."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    rows = 6
    q, k, v, do = bwd_lanes(rows * 8, 80, 80, d, group, "cpu", seed=d)
    q, do = (t.unflatten(0, (rows, 8)) for t in (q, do))
    if kv_batched:
        k, v = (t.unflatten(0, (rows, 8 // group)) for t in (k, v))
    else:
        k, v = (t[:8 // group] for t in (k, v))

    def loss(q, k, v, do):
        return (kernel_ops.flash_attention(q, k, v, kv_group=group)
                * do).sum()

    grad = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                           in_dims=(0, 0 if kv_batched else None,
                                    0 if kv_batched else None, 0))
    out = []
    for device in ("cpu", cuda):
        flash_attention_bhsd.launches = flash_attention_bwd.launches = 0
        out.append(grad(*(t.to(device) for t in (q, k, v, do))))
        if device is cuda:
            assert (flash_attention_bhsd.launches,
                    flash_attention_bwd.launches) == (1, 1)
    for c, g in zip(*out):
        assert g.shape == c.shape
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * float(
            c.abs().max())


def test_lm_participant_gradients_on_the_card_equal_the_cpus(cuda):
    """The FL engine's participant gradient, ``vmap(grad(lm_loss))`` of
    the registry's ``transformer_lm`` over 6 participants: K5 and its
    backward once per layer for all of them, and each leaf of the card's
    gradients within 1e-4 of its largest |CPU| entry."""
    from repro_torch.data.synthetic import make_lm_federated
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    host = make_lm_federated(torch.Generator().manual_seed(0), n_clients=6,
                             per_client=8, seq=16, vocab=32, n_test=8,
                             device="cpu")
    spec = make_model("transformer_lm", host)
    start = spec.init_fn(torch.Generator().manual_seed(1))
    grad = torch.func.vmap(torch.func.grad(spec.loss_fn), in_dims=(None, 0))
    out = []
    for device in ("cpu", cuda):
        flash_attention_bhsd.launches = flash_attention_bwd.launches = 0
        out.append(grad({k: w.to(device) for k, w in start.items()},
                        (host.client_images.to(device),
                         host.client_labels.to(device))))
        if device is cuda:
            assert (flash_attention_bhsd.launches,
                    flash_attention_bwd.launches) == (2, 2)
    for name, c in out[0].items():
        scale = float(c.abs().max())
        assert scale > 0, name
        assert float((out[1][name].cpu() - c).abs().max()) <= 1e-4 * scale, \
            name


def test_bare_kernels_refuse_to_cut_a_gradient(cuda):
    """With grad mode on, a bare K5 call on an input that requires a
    gradient raises, and so does ops.ssd (K4 has no backward yet, ROADMAP
    §A item 13); under no_grad both run."""
    q, k, v, _ = bwd_lanes(2, 64, 64, 64, 1, cuda)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="cut"):
        flash_attention_bhsd(q, k, v)
    with torch.no_grad():
        flash_attention_bhsd(q, k, v)
    x, dt, a, bm, cm = ssd_lanes(1, 128, 2, 32, 16, cuda)
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="item 13"):
        kernel_ops.ssd(x, dt, a, bm, cm, chunk=32)
    with torch.no_grad():
        kernel_ops.ssd(x, dt, a, bm, cm, chunk=32)


TRAIN_IDS = ["yi-6b", "chatglm3-6b", "minicpm-2b", "granite-20b",
             "llama-3.2-vision-11b", "seamless-m4t-large-v2",
             "mixtral-8x22b", "kimi-k2-1t-a32b"]


def step_batch(cfg, device, b=2, s=16):
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    media = (torch.randn((b, cfg.n_media_tokens, cfg.d_model), generator=g)
             if cfg.cross_attn_every else None)
    frames = (torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g)
              if cfg.is_encoder_decoder else None)
    return M.Batch(tokens=tok.to(device), labels=tok.roll(-1, 1).to(device),
                   media=None if media is None else media.to(device),
                   frames=None if frames is None else frames.to(device))


@pytest.mark.parametrize("arch", TRAIN_IDS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced train step (``functional_call`` of the LM module,
    ``make_train_step``): the card's loss and gradients against the CPU's
    on the same weights; K5 and its backward launch once per attention
    call. Loss rtol 1e-5; gradients 1e-4 of each leaf's largest |CPU|."""
    import copy

    from repro_torch.fl.round import make_train_step
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    cfg = get_config(arch).reduced()
    host = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    out = []
    for model, device in ((host, "cpu"), (card, cuda)):
        params = {k: p.detach() for k, p in model.named_parameters()}

        def loss_fn(p, b, model=model):
            return torch.func.functional_call(model, p, (b, cfg))

        flash_attention_bhsd.launches = flash_attention_bwd.launches = 0
        grads, loss = torch.func.grad_and_value(loss_fn)(
            params, step_batch(cfg, device))
        out.append((grads, loss, flash_attention_bhsd.launches,
                    flash_attention_bwd.launches))
        new, _ = make_train_step(loss_fn, 0.01)(params,
                                                step_batch(cfg, device))
        assert all(bool(torch.isfinite(w).all()) for w in new.values())
    (cg, closs, _, _), (gg, gloss, fwd, bwd) = out
    np.testing.assert_allclose(float(gloss), float(closs), rtol=1e-5)
    assert fwd == bwd > 0
    for name, c in cg.items():
        scale = float(c.abs().max())
        assert scale > 0, name
        assert float((gg[name].cpu() - c).abs().max()) <= 1e-4 * scale, name


def test_mamba_layers_do_not_train_on_the_card(cuda):
    """jamba's Mamba layers reach ops.ssd, which raises under grad on the
    card (ROADMAP §A item 13)."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    model = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    params = {k: p.detach() for k, p in model.named_parameters()}
    with pytest.raises(NotImplementedError, match="item 13"):
        torch.func.grad(lambda p: torch.func.functional_call(
            model, p, (step_batch(cfg, cuda), cfg)))(params)
