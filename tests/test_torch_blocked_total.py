"""The fixed-association accounting reduce across ranks (the twin of
tests/test_blocked_total.py), the collective helpers, and the
scheduling-only runner whose totals it folds.

* an emulated split: the padded contribution cut into D contiguous shards
  on the host, each shard's block partials concatenated in global block
  order and folded, equals ``blocked_total`` bit for bit for every divisor
  D of ACCOUNT_BLOCKS (no ranks needed);
* real splits: ``blocked_total_sharded`` on 2, 3 and 4 gloo ranks (and 1),
  each rank holding its ``ClientLayout`` slice, equals ``blocked_total``
  of the whole vector bit for bit, on every rank, through ragged final
  blocks, all-zero lanes, subnormals, a huge magnitude spread and
  negative values, and over a leading axis;
* ``psum`` / ``pmax`` / ``pmin`` / ``all_gather`` over the world group;
* ``make_schedule_runner`` sharded against sequential (bit for bit at one
  shard; n_sel exact and rtol 3e-7 on 2-4 ranks) and the sequential one
  against the reference's runner on its draws (n_sel exact, rtol 1e-5).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_ranks import start
from test_torch_reference import ReplayDraws, record_draws, reference

from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fl.client_shard import ClientLayout, make_schedule_runner
from repro_torch.fl.sharding import (ACCOUNT_BLOCKS, _fold_partials,
                                     all_gather, block_partials,
                                     blocked_total, blocked_total_sharded,
                                     pad_client_axis, padded_len, pmax, pmin,
                                     psum)

DIVISORS = [d for d in range(1, ACCOUNT_BLOCKS + 1)
            if ACCOUNT_BLOCKS % d == 0]
# ragged final blocks, exact multiples, a single partial, the suites' N
LENGTHS = (1, 5, 21, 48, 96, 100, 191, 192, 1000)
WORLDS = (1, 2, 3, 4)

RUNNER_N = 2400
RUNNER_BITS = 32 * 555_178.0
RUNNER_ROUNDS = 8
# (policy, m_avg, solver)
RUNNERS = (("proposed", 0.0, "stitched"), ("proposed", 0.0, "cuda_fused"),
           ("uniform", 32.0, "stitched"))


def _vector(n: int, mix: str) -> np.ndarray:
    rng = np.random.default_rng(n * 7 + len(mix))
    if mix == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if mix == "zeros":
        return np.zeros(n, np.float32)
    if mix == "subnormal":
        return (rng.uniform(0, 1, n) * 1e-39).astype(np.float32)
    if mix == "spread":   # catastrophic-cancellation bait
        x = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
        return x.astype(np.float32)
    raise ValueError(mix)


MIXES = ("normal", "zeros", "subnormal", "spread")


def _emulated(contrib: torch.Tensor, n_shards: int) -> torch.Tensor:
    """blocked_total_sharded's association computed shard by shard."""
    padded = pad_client_axis(contrib, padded_len(contrib.shape[-1]), 0.0)
    per = padded.shape[-1] // n_shards
    parts = [block_partials(padded[..., i * per:(i + 1) * per],
                            ACCOUNT_BLOCKS // n_shards)
             for i in range(n_shards)]
    return _fold_partials(torch.cat(parts, -1))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("n", LENGTHS)
def test_every_divisor_split_is_bitwise(n, mix):
    x = torch.from_numpy(_vector(n, mix))
    want = blocked_total(x)
    for d in DIVISORS:
        assert torch.equal(_emulated(x, d), want), (n, mix, d)


def test_pad_client_axis():
    x = torch.arange(6.0).reshape(2, 3)
    assert pad_client_axis(x, 3, -1.0) is x
    got = pad_client_axis(x, 5, -1.0)
    assert torch.equal(got, torch.tensor([[0., 1, 2, -1, -1],
                                          [3, 4, 5, -1, -1]]))
    got = pad_client_axis(x, 4, 9.0, axis=0)
    assert got.shape == (4, 3) and (got[2:] == 9.0).all()
    assert pad_client_axis(torch.ones(2, dtype=torch.bool), 3,
                           False).tolist() == [True, True, False]


def blocked_ranks(payload):
    """Rank body: the sharded totals of every vector, the collectives,
    and the runners (numpy out)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    totals = {}
    for key, x in payload["vectors"].items():
        x = torch.from_numpy(x)
        lay = ClientLayout(x.shape[-1], world, rank, group)
        totals[key] = blocked_total_sharded(lay.local(x, 0.0), group,
                                            world).numpy()
    me = torch.tensor([rank + 0.5, -rank], dtype=torch.float32)
    coll = {"psum": psum(me, group).numpy(), "pmax": pmax(me, group).numpy(),
            "pmin": pmin(me, group).numpy(),
            "all_gather": all_gather(me.reshape(1, 2), group).numpy(),
            "bf16": psum(me.to(torch.bfloat16), group).float().numpy()}
    runners = {}
    scfg = SchedulerConfig(n_clients=RUNNER_N, model_bits=RUNNER_BITS)
    ch = ChannelConfig(n_clients=RUNNER_N)
    sig = heterogeneous_sigmas(RUNNER_N, device="cpu")
    draws = ReplayDraws(payload["runner_draws"])
    for policy, m_avg, solver in RUNNERS:
        runners[(policy, solver)] = {
            dc: [x.numpy() for x in make_schedule_runner(
                sig, scfg, ch, rounds=RUNNER_ROUNDS, policy=policy,
                m_avg=m_avg, solver=solver, client_shards=dc)(draws)]
            for dc in ((0, 1) if world == 1 else (world,))}
    return totals, coll, runners


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Worlds 1-4 started at once; meanwhile the reference's runner on the
    recorded draws."""
    vectors = {(n, mix): _vector(n, mix) for n in LENGTHS for mix in MIXES}
    vectors[("rows", 191)] = np.stack([_vector(191, "normal"),
                                       _vector(191, "spread")])
    key = ref.jax.random.PRNGKey(5)
    payload = dict(vectors=vectors, runner_draws=record_draws(
        ref, key, RUNNER_ROUNDS, RUNNER_N, (1, 1, 1), 1))
    tmp = tmp_path_factory.mktemp("blocked_total")
    started = {w: start(tmp, w, __name__, "blocked_ranks", payload)
               for w in WORLDS}
    from repro.fl.client_shard import make_schedule_runner as ref_runner
    want = {policy: [np.asarray(x) for x in ref_runner(
        ref.channel.heterogeneous_sigmas(RUNNER_N),
        ref.scheduler.SchedulerConfig(n_clients=RUNNER_N,
                                      model_bits=RUNNER_BITS),
        ref.channel.ChannelConfig(n_clients=RUNNER_N),
        rounds=RUNNER_ROUNDS, policy=policy, m_avg=m_avg,
        client_shards=0)(key)] for policy, m_avg, _ in RUNNERS}
    return vectors, {w: r.results() for w, r in started.items()}, want


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_total_is_bitwise_on_every_rank(ranks, world):
    vectors, out, _ = ranks
    for key, x in vectors.items():
        want = blocked_total(torch.from_numpy(x)).numpy()
        for rank, (totals, _, _) in enumerate(out[world]):
            np.testing.assert_array_equal(totals[key], want,
                                          err_msg=f"{key} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_collectives(ranks, world):
    ranks_f = np.arange(world, dtype=np.float32)
    for rank, (_, coll, _) in enumerate(ranks[1][world]):
        np.testing.assert_array_equal(coll["psum"], [np.sum(ranks_f + 0.5),
                                                     -np.sum(ranks_f)])
        np.testing.assert_array_equal(coll["pmax"], [world - 0.5, 0.0])
        np.testing.assert_array_equal(coll["pmin"], [0.5, 1 - world])
        np.testing.assert_array_equal(
            coll["all_gather"], np.stack([ranks_f + 0.5, -ranks_f], 1)[
                :, None, :])
        np.testing.assert_array_equal(coll["bf16"], coll["psum"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy,m_avg,solver", RUNNERS)
def test_schedule_runner(ranks, policy, m_avg, solver, world):
    """Sharded against sequential (bit for bit at one shard, else n_sel
    exact and 3e-7), the sequential runner against the reference's."""
    _, out, want = ranks
    seq = out[1][0][2][(policy, solver)][0]
    for rank, (_, _, runners) in enumerate(out[world]):
        got = runners[(policy, solver)][world]
        assert all(x.shape == (RUNNER_ROUNDS,) for x in got)
        np.testing.assert_array_equal(got[2], seq[2], err_msg=f"{rank}")
        if world == 1:
            for a, b in zip(got, seq):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(got[:2], seq[:2]):
            np.testing.assert_allclose(a, b, rtol=3e-7, atol=0)
    ref_t, ref_p, ref_n = want[policy]
    np.testing.assert_array_equal(seq[2], ref_n)
    np.testing.assert_allclose(seq[0], ref_t, rtol=1e-5)
    np.testing.assert_allclose(seq[1], ref_p, rtol=1e-5)
    assert (seq[2] >= 1).all()
