"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same device tensors, and the engine's cuda / cuda_fused
paths launching them. Marked ``cuda``; every test skips when PyTorch sees
no CUDA device (decided in a fixture, never at import). Run on a GPU with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as on the CPU: q rtol 1e-5 / atol 1e-6, power-like outputs
rtol 1e-5 / atol 1e-3, tc rtol 1e-5, ``sel`` exact where |u - q| > 1e-6.
"""

import pytest
import torch

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import make_cifar10_like
from repro_torch.fl.decision import decision_coeffs
from repro_torch.fl.simulation import SimConfig, run_simulation
from repro_torch.kernels.decision_fused import (decision_fused,
                                                decision_fused_plain,
                                                pack_decision_operands)
from repro_torch.kernels.scheduler_solve import (scheduler_solve,
                                                 scheduler_solve_plain,
                                                 solve_scalars)
from repro_torch.models.registry import make_model

pytestmark = pytest.mark.cuda

SIZES = [1, 100, 1023, 1024, 1025, 3597]
KW = dict(n=100, v=1000.0, lam=10.0, ell=32 * 555178.0, bandwidth=22e6,
          noise=1.0, p_max=100.0, p_bar=1.0, q_floor=1e-5)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
