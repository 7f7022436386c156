"""The policy x seed sweep (``fl/engine.py::run_sweep``) against the
reference's, and the solve kernel's flattened-seed call.

* ``run_sweep`` at N = 40, 3 seeds, 30 rounds, ``proposed`` and
  ``uniform`` (and ``greedy_channel``), on the reference's own draws:
  n_selected exact; comm_time, power and avg_power at rtol 1e-5; the
  matched M at rtol 1e-6;
* the sweep launches the solve once per round for all seeds: K1's plain
  version on the (S N,) lanes flattened equals S per-seed calls bit for
  bit, with ``n`` the configuration's N (passing S N would change Eq. 17
  and the objective);
* the default draws are paired: a seed's numbers do not depend on which
  other seeds the sweep holds;
* unknown names, parameters and solvers raise; every registered channel
  and policy runs.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import (ReplaySweepDraws,  # noqa: E402
                                  record_sweep_draws, reference)

from repro_torch.core.channel import (ChannelConfig,  # noqa: E402
                                      heterogeneous_sigmas)
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.fl.engine import (GeneratorSweepDraws,  # noqa: E402
                                   make_sweep_runner, make_sweep_solve_fn,
                                   run_sweep)
from repro_torch.kernels.scheduler_solve import scheduler_solve  # noqa: E402

N, SEEDS, ROUNDS, MATCH = 40, (0, 1, 2), 30, 100
BITS = 32 * 555178.0


@pytest.fixture(scope="module")
def ref():
    return reference()


def port_configs(n=N):
    return (SchedulerConfig(n_clients=n, model_bits=BITS),
            ChannelConfig(n_clients=n))


def check_history(got, want, keys=("comm_time", "power", "avg_power")):
    assert got["policies"] == list(want["policies"])
    np.testing.assert_array_equal(got["seeds"], want["seeds"])
    np.testing.assert_array_equal(got["n_selected"], want["n_selected"])
    for k in keys:
        assert got[k].shape == np.asarray(want[k]).shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


@pytest.mark.parametrize("solver,ref_solver", [
    ("stitched", "jnp"), ("cuda", "pallas"), ("cuda_fused", "pallas_fused")])
def test_sweep_matches_reference(ref, solver, ref_solver):
    """Both policies, the matched M estimated inside: n_selected exact,
    comm_time, power and avg_power at rtol 1e-5, uniform_m at rtol 1e-6.
    (``"cuda_fused"`` runs the solve kernel's plain version here, the
    reference's ``"pallas_fused"`` its stitched solve: a few ulp apart.)"""
    key = ref.jax.random.PRNGKey(4)
    cfg = ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=N)
    want = ref.engine.run_sweep(key, ref.channel.heterogeneous_sigmas(N), cfg,
                                ch, rounds=ROUNDS, seeds=SEEDS,
                                solver=ref_solver, match_rounds=MATCH)
    draws = ReplaySweepDraws(record_sweep_draws(ref, key, ROUNDS, N, SEEDS,
                                                MATCH))
    got = run_sweep(draws, heterogeneous_sigmas(N, device="cpu"),
                    *port_configs(), rounds=ROUNDS, seeds=SEEDS,
                    solver=solver, match_rounds=MATCH)
    np.testing.assert_allclose(got["uniform_m"], want["uniform_m"],
                               rtol=1e-6)
    assert got["uniform_m"].dtype == np.float32
    check_history(got, want)
    assert got["comm_time"].shape == (2, len(SEEDS), ROUNDS)


def test_sweep_greedy_and_given_m(ref):
    """greedy_channel and uniform at a given M (no estimate): the same
    holds, and nothing reads the match draws."""
    key = ref.jax.random.PRNGKey(5)
    cfg = ref.scheduler.SchedulerConfig(n_clients=N, model_bits=BITS)
    ch = ref.channel.ChannelConfig(n_clients=N)
    policies = ("greedy_channel", "uniform")
    want = ref.engine.run_sweep(key, ref.channel.heterogeneous_sigmas(N), cfg,
                                ch, rounds=ROUNDS, seeds=SEEDS,
                                policies=policies, uniform_m=4.6)
    arrays = record_sweep_draws(ref, key, ROUNDS, N, SEEDS, 1)
    del arrays["match"]
    got = run_sweep(ReplaySweepDraws(arrays),
                    heterogeneous_sigmas(N, device="cpu"), *port_configs(),
                    rounds=ROUNDS, seeds=SEEDS, policies=policies,
                    uniform_m=4.6)
    assert got["uniform_m"] == np.float32(4.6)
    check_history(got, want)


@pytest.mark.parametrize("n,seeds", [(40, 3), (100, 4), (1027, 2)])
def test_flattened_seeds_equal_per_seed_solves(n, seeds):
    """K1 (its plain version on the CPU) on the (S N,) lanes of S seeds
    equals S calls of N lanes bit for bit, with ``n`` = N; the sweep's
    solve closure does exactly that. Passing S N as ``n`` would be another
    solve."""
    rng = np.random.default_rng(n)
    gains = torch.from_numpy(
        np.exp(rng.standard_normal((seeds, n)) * 2).astype(np.float32))
    z = torch.from_numpy(
        (np.abs(rng.standard_normal((seeds, n))) * 50).astype(np.float32))
    cfg, ch = port_configs(n)
    kw = dict(v=cfg.V, lam=cfg.lam, ell=cfg.model_bits,
              bandwidth=ch.bandwidth_hz, noise=ch.noise_power,
              p_max=ch.p_max, p_bar=ch.p_bar, q_floor=cfg.q_floor)
    q, p = scheduler_solve(gains.reshape(-1), z.reshape(-1), n=n, **kw)
    for s in range(seeds):
        qs, ps_ = scheduler_solve(gains[s], z[s], n=n, **kw)
        assert torch.equal(q.view(seeds, n)[s], qs)
        assert torch.equal(p.view(seeds, n)[s], ps_)
    fq, fp = make_sweep_solve_fn(cfg, ch, "cuda")(gains, z)
    assert fq.shape == (seeds, n)
    assert torch.equal(fq, q.view(seeds, n)) and torch.equal(fp,
                                                             p.view(seeds, n))
    wrong, _ = scheduler_solve(gains.reshape(-1), z.reshape(-1),
                               n=n * seeds, **kw)
    assert not torch.equal(wrong, q)


def test_generator_draws_are_paired():
    """A seed's channel, uniforms and raws do not depend on the other
    seeds of the sweep; the shapes are (S, N), (S,) and (rounds, N)."""
    both = GeneratorSweepDraws(7, (0, 3), N, "cpu")
    one = GeneratorSweepDraws(7, (3,), N, "cpu")
    for r in (0, 5):
        assert both.channel_raw(r).shape == (2, N)
        assert torch.equal(both.channel_raw(r)[1], one.channel_raw(r)[0])
        assert torch.equal(both.selection_u(r)[1], one.selection_u(r)[0])
        raw, raw1 = both.uniform_raw(r), one.uniform_raw(r)
        assert raw["take"].shape == (2,)
        assert torch.equal(raw["scores"][1], raw1["scores"][0])
    m = both.match_raws(20)
    assert m.shape == (20, N) and torch.equal(m, one.match_raws(20))
    assert float(m.min()) >= 1e-12 and float(m.max()) < 1.0
    assert not torch.equal(both.channel_raw(0)[0], both.channel_raw(0)[1])


def test_sweep_on_its_own_draws():
    """run_sweep with no draws: finite trajectories of the right shapes,
    cumulative comm time non-decreasing, at least one client a round;
    ``keep_selection`` returns each round's selections and q, which
    account for n_selected; proposed saves comm time over uniform."""
    sig = heterogeneous_sigmas(N, device="cpu")
    out = run_sweep(None, sig, *port_configs(), rounds=40, seeds=(0, 1),
                    keep_selection=True, solver="stitched")
    assert out["comm_time"].shape == (2, 2, 40)
    assert out["selected"].shape == (2, 2, 40, N)
    assert out["q"].shape == (2, 2, 40, N)
    np.testing.assert_array_equal(out["selected"].sum(-1), out["n_selected"])
    assert (np.diff(out["comm_time"], axis=-1) >= 0).all()
    assert (out["n_selected"] >= 1).all()
    for k in ("comm_time", "power", "avg_power"):
        assert np.isfinite(out[k]).all()
    assert out["comm_time"][0, :, -1].mean() < out["comm_time"][1, :, -1].mean()


def test_sweep_rejects_what_it_does_not_run():
    """Unknown names, extra params and solvers are errors; the channels
    and policies that once raised (rician, aoi_capped) now run, with
    their params."""
    sig = heterogeneous_sigmas(N, device="cpu")
    cfg, ch = port_configs()
    out = run_sweep(None, sig, cfg, ch, rounds=2, channel="rician",
                    channel_params=(("k_factor", 2.0),),
                    policies=("aoi_capped", "proposed"), uniform_m=4.0,
                    policy_params={"aoi_capped": {"max_age": 3}},
                    solver="stitched")
    assert out["comm_time"].shape == (2, 1, 2)
    assert np.isfinite(out["comm_time"]).all()
    with pytest.raises(ValueError, match="unknown policy"):
        run_sweep(None, sig, cfg, ch, rounds=2, policies=("best",))
    with pytest.raises(ValueError, match="unknown channel"):
        run_sweep(None, sig, cfg, ch, rounds=2, channel="awgn")
    with pytest.raises(ValueError, match="channel_params"):
        run_sweep(None, sig, cfg, ch, rounds=2,
                  channel_params=(("rho", 0.9),))
    with pytest.raises(ValueError, match="policy_params"):
        make_sweep_runner(sig, cfg, ch, rounds=2,
                          policy_params={"q_floor": 0.1})
    with pytest.raises(ValueError, match="unknown solver"):
        make_sweep_runner(sig, cfg, ch, rounds=2, solver="pallas")
