"""The client-sharded scheduling path over gloo ranks (the twin of
tests/test_client_sharded.py).

Every case runs in spawned CPU ranks (``test_torch_ranks.py``) on draws
recorded from the reference's own key chain (``record_draws``), so the
port's runs and the reference's see the same randomness:

* world 1 — ``SimConfig(client_shards=1)`` equals the port's sequential
  run bit for bit (every history key, the selections and q);
* worlds 2, 3 and 4 — ``client_shards`` = the world size: n_selected and
  the selections exact, comm_time and avg_power within rtol 3e-7 of the
  sequential run (the reference's own cross-mesh bound), test_acc within
  atol 2e-2 (participant sums re-associate in training);
* against the reference — each sharded run against the reference's
  ``run_simulation_scan`` (its mesh 1) on those draws: n_selected exact,
  comm_time and avg_power at rtol 1e-5 (the tolerance of
  tests/test_torch_engine.py).

The cases: the reference's five (policy x channel) cases, N = 21 (pad
lanes on every mesh; at world 3 and 4 whole shards of pads), the solve
kernel (``solver="cuda"``, its plain version on the CPU) and the fused
decision kernel (``"cuda_fused"``) per shard, and every guard. The
scheduling-only runner is tests/test_torch_blocked_total.py's.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_ranks import numpy_images, reference_dataset, start
from test_torch_reference import ReplayDraws, record_draws, reference

from repro_torch.convert import params_from_jax
from repro_torch.core.channel import ChannelConfig, heterogeneous_sigmas
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.data.synthetic import from_numpy, make_cifar10_like
from repro_torch.fl.client_shard import (ClientLayout, check_client_shards,
                                         make_schedule_runner)
from repro_torch.fl.engine import SimConfig, run_simulation_scan
from repro_torch.fl.grid import GridSpec, run_grid
from repro_torch.launch.distributed import check_backend

N = 48
ODD_N = 21
PER_CLIENT = 32
BITS = 32 * 50_000.0
SIM = dict(rounds=4, eval_every=2, m_cap=5, batch=4, local_steps=2,
           eval_size=128, model="mlp")
HIST_KEYS = ("round", "comm_time", "test_acc", "avg_power", "n_selected")
WORLDS = (1, 2, 3, 4)

# the reference's five cases: >= 2 channel models x >= 2 policies; the
# lognormal and rician rows cover the two-leaf and (2, N) raws
CASES = [
    ("proposed", 0.0, "rayleigh", ()),
    ("proposed", 0.0, "lognormal", (("shadow_db", 3.0),)),
    ("uniform", 4.0, "rayleigh", ()),
    ("uniform", 4.0, "gauss_markov", (("rho", 0.8),)),
    ("greedy_channel", 3.0, "rician", (("k_factor", 3.0),)),
]
# leg -> (N, SimConfig fields, the reference run it is held against): the
# solve kernel's and the fused kernel's legs against case 0's, since the
# reference's "jnp", "pallas" and "pallas_fused" runs are equal bit for bit
LEGS = {f"case{i}": (N, dict(policy=p, uniform_m=m, channel=c,
                             channel_params=cp, solver="stitched"),
                     f"case{i}")
        for i, (p, m, c, cp) in enumerate(CASES)}
LEGS["odd_n"] = (ODD_N, dict(solver="stitched"), "odd_n")
LEGS["cuda"] = (N, dict(solver="cuda"), "case0")
LEGS["cuda_fused"] = (N, dict(solver="cuda_fused"), "case0")


def _draw_key(leg):
    """Legs on one network and channel share their recorded draws."""
    n, fields, _ = LEGS[leg]
    return n, fields.get("channel", "rayleigh")

# the odd shard count (3) runs one leg of each policy, N = 21 and K2
ODD_WORLD_LEGS = ("case0", "case2", "case4", "odd_n", "cuda_fused")

def _configs(n, device="cpu"):
    return (SchedulerConfig(n_clients=n, model_bits=BITS),
            ChannelConfig(n_clients=n), heterogeneous_sigmas(n, device=device))


def client_ranks(payload):
    """Rank body: every leg at ``client_shards`` = the world size (and the
    sequential run at world 1); numpy out."""
    world = dist.get_world_size()
    out = {}
    for name, (n, fields, _) in LEGS.items():
        if world == 3 and name not in ODD_WORLD_LEGS:
            continue
        data = payload["data"][n]
        pds = from_numpy(*data["ds"], device="cpu")
        params = params_from_jax(data["params"], device="cpu")
        draws = ReplayDraws(payload["draws"][_draw_key(name)])
        sim = SimConfig(**SIM, **fields)
        runs = {"sharded": dataclasses.replace(sim, client_shards=world)}
        if world == 1:
            runs["sequential"] = sim
        out[name] = {k: run_simulation_scan(draws, params, pds, s,
                                            *_configs(n),
                                            keep_selection=True)
                     for k, s in runs.items()}
    if world == 2:
        out["guards"] = world_guards(payload)
    return out


def world_guards(payload):
    """The errors a 2-rank gloo group raises for meshes of another size
    and for CUDA tensors."""
    data = payload["data"][N]
    pds = from_numpy(*data["ds"], device="cpu")
    params = params_from_jax(data["params"], device="cpu")
    errors = {}
    for label, fields in (("client", dict(client_shards=1)),
                          ("mesh", dict(client_shards=2,
                                        participant_shards=2))):
        try:
            run_simulation_scan(None, params, pds,
                                SimConfig(**SIM, **fields), *_configs(N))
        except ValueError as e:
            errors[label] = str(e)
    try:
        check_backend("cuda")
    except ValueError as e:
        errors["backend"] = str(e)
    return errors


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """The reference's runs on the recorded draws, then the ranks' runs at
    worlds 1-4 (all four worlds at once)."""
    jax = ref.jax
    data, ref_data = {}, {}
    mlp = None
    for n in (N, ODD_N):
        arrays = numpy_images(n, seed=n, per_client=PER_CLIENT)
        ds = reference_dataset(ref, arrays)
        if mlp is None:
            mlp = ref.registry.make_model("mlp", ds).init_fn(
                jax.random.PRNGKey(1))
        ref_data[n] = ds, mlp
        data[n] = {"ds": arrays,
                   "params": {k: np.asarray(v) for k, v in mlp.items()}}
    key = jax.random.PRNGKey(2)
    draws = {(n, channel): record_draws(
        ref, key, SIM["rounds"], n, (SIM["m_cap"], SIM["local_steps"],
                                     SIM["batch"]), PER_CLIENT, channel)
        for n, channel in {_draw_key(leg) for leg in LEGS}}
    payload = dict(data=data, draws=draws)
    want = {}
    for name, (n, fields, held_by) in LEGS.items():
        if held_by != name:
            continue
        ds, params = ref_data[n]
        sim = ref.engine.SimConfig(**SIM, **dict(fields, solver="jnp"))
        want[name] = ref.engine.run_simulation_scan(
            key, params, ds, sim,
            ref.scheduler.SchedulerConfig(n_clients=n, model_bits=BITS),
            ref.channel.ChannelConfig(n_clients=n),
            ref.channel.heterogeneous_sigmas(n))
    tmp = tmp_path_factory.mktemp("client_sharded")
    started = {w: start(tmp, w, __name__, "client_ranks", payload)
               for w in WORLDS}
    return {w: r.results() for w, r in started.items()}, want


def _accounting(seq, got, tag):
    np.testing.assert_array_equal(seq["round"], got["round"], err_msg=tag)
    np.testing.assert_array_equal(seq["n_selected"], got["n_selected"],
                                  err_msg=tag)
    for k in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[k], seq[k], rtol=3e-7, atol=0,
                                   err_msg=f"{tag} {k}")


@pytest.mark.parametrize("leg", list(LEGS))
def test_world1_bitwise(runs, leg):
    """One client shard is the sequential engine, bit for bit."""
    (out,) = runs[0][1]
    seq, got = out[leg]["sequential"], out[leg]["sharded"]
    for k in HIST_KEYS + ("selected", "q"):
        np.testing.assert_array_equal(seq[k], got[k], err_msg=k)


def _world_legs(worlds):
    return [(leg, w) for w in worlds for leg in LEGS
            if w != 3 or leg in ODD_WORLD_LEGS]


@pytest.mark.parametrize("leg,world", _world_legs(WORLDS[1:]))
def test_worldN_accounting(runs, leg, world):
    """Selections exact, the float accounting within 3e-7, test_acc within
    2e-2 of the sequential run; every rank returns the same history."""
    seq = runs[0][1][0][leg]["sequential"]
    ranks = runs[0][world]
    got = ranks[0][leg]["sharded"]
    _accounting(seq, got, f"world {world} {leg}")
    np.testing.assert_array_equal(seq["selected"], got["selected"])
    np.testing.assert_allclose(got["test_acc"], seq["test_acc"], atol=2e-2)
    assert np.isfinite(got["comm_time"]).all()
    assert (got["n_selected"] <= LEGS[leg][0]).all()
    for other in ranks[1:]:
        for k in HIST_KEYS:
            np.testing.assert_array_equal(other[leg]["sharded"][k], got[k])


@pytest.mark.parametrize("leg,world", _world_legs(WORLDS))
def test_sharded_matches_reference(runs, leg, world):
    """Each sharded run against the reference's on its draws."""
    out, want = runs
    got = out[world][0][leg]["sharded"]
    want = {leg: want[LEGS[leg][2]]}
    np.testing.assert_array_equal(got["round"], want[leg]["round"])
    np.testing.assert_array_equal(got["n_selected"], want[leg]["n_selected"])
    for k in ("comm_time", "avg_power"):
        np.testing.assert_allclose(got[k], want[leg][k], rtol=1e-5,
                                   err_msg=k)


def test_guards_without_a_group():
    """No process group: a sharded config raises, naming initialize; the
    shard count, the policy, the matched M and the grid are checked
    before any group is needed."""
    n = 8
    scfg, ch, sig = _configs(n)
    ds = make_cifar10_like(torch.Generator().manual_seed(0), n_clients=n,
                           per_client=4, n_test=8, h=4, w=4, device="cpu")
    assert not dist.is_initialized()

    def run(**fields):
        run_simulation_scan(None, {}, ds, SimConfig(**SIM, **fields), scfg,
                            ch, sig)

    for fields in (dict(client_shards=1), dict(participant_shards=1),
                   dict(client_shards=1, participant_shards=1)):
        with pytest.raises(ValueError,
                           match="repro_torch.launch.distributed.initialize"):
            run(**fields)
    with pytest.raises(ValueError, match="ACCOUNT_BLOCKS"):
        run(client_shards=5)
    with pytest.raises(ValueError, match="sharded"):
        run(client_shards=1, policy="update_aware", uniform_m=4.0)
    with pytest.raises(ValueError, match="unknown channel"):
        check_client_shards(1, "proposed", "fading")
    with pytest.raises(ValueError, match="m_avg"):
        make_schedule_runner(sig, scfg, ch, rounds=2, policy="uniform",
                             m_avg=0.0, client_shards=1)
    with pytest.raises(ValueError, match="loop engine"):
        run(client_shards=1, engine="loop")
    with pytest.raises(ValueError, match="CONFIG axis"):
        run_grid(None, {}, ds, SimConfig(**SIM, client_shards=1), scfg, ch,
                 GridSpec())
    with pytest.raises(ValueError, match="CONFIG axis"):
        run_grid(None, {}, ds, SimConfig(**SIM, participant_shards=1), scfg,
                 ch, GridSpec())


def test_guards_of_a_two_rank_group(runs):
    """In a 2-rank group a mesh of another size and a device off the
    group's backend raise."""
    errors = runs[0][2][0]["guards"]
    assert "mesh (1, 1) = 1 ranks" in errors["client"]
    assert "world size 2" in errors["client"]
    assert "mesh (2, 2) = 4 ranks" in errors["mesh"]
    assert errors["backend"] == ("tensors on cuda need a nccl process "
                                 "group, this one runs gloo")


@pytest.mark.parametrize("n,shards", [(21, 1), (21, 4), (48, 3), (96, 2),
                                      (200, 8)])
def test_layout_slices_and_pads(n, shards):
    """Every lane lands on exactly one shard, pads past N take the fill,
    and a single shard holds the axis unpadded."""
    x = torch.arange(n, dtype=torch.float32)
    rows = torch.stack([x, -x])
    parts, pads = [], 0
    for i in range(shards):
        lay = ClientLayout(n, shards, i, None)
        loc = lay.local(x, -7.0)
        assert loc.shape == (lay.n_local,)
        assert torch.equal(lay.local(rows, 0.0)[0], torch.where(
            loc == -7.0, 0.0, loc))
        ids, valid = lay.lanes("cpu")
        assert torch.equal(ids, torch.arange(lay.start,
                                             lay.start + lay.n_local))
        if valid is None:
            assert not lay.has_pads and (loc != -7.0).all()
        else:
            assert torch.equal(valid, loc != -7.0)
            pads += int((~valid).sum())
        parts.append(loc)
    joined = torch.cat(parts)
    assert torch.equal(joined[:n], x)
    assert (joined[n:] == -7.0).all() and pads == joined.shape[0] - n
    if shards == 1:
        assert joined.shape == (n,)
