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
for bit.
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
