"""``repro_torch.optim`` against ``repro.optim`` on the same seeded numpy
parameters and gradients: SGD, momentum and Adam over several steps,
``clip_by_global_norm`` above and below its threshold, and the constant
and WSD schedules at every step of a run and past its end.

Tolerances: the optimizers are elementwise float32 in the reference's
op order, so the parameters, moments and clipped gradients are held at
rtol 1e-6 / atol 1e-7 (measured: equal); the schedules at rtol 1e-6.
"""

import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch import optim  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ref():
    reference()
    return importlib.import_module("repro.optim")


def tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32),
            "g": rng.standard_normal(3).astype(np.float32)}


def both(params):
    import jax.numpy as jnp
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v.copy()) for k, v in params.items()})


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("momentum", {}),
                                     ("momentum", {"beta": 0.5}),
                                     ("adam", {}),
                                     ("adam", {"b1": 0.8, "b2": 0.99,
                                               "eps": 1e-6})])
def test_optimizer_matches_reference(ref, name, kw):
    r_init, r_update = getattr(ref, name)(**kw)
    p_init, p_update = getattr(optim, name)(**kw)
    rp, pp = both(tree(0))
    rs, ps = r_init(rp), p_init(pp)
    for step in range(4):
        rg, pg = both(tree(step + 1))
        lr = 0.05 / (step + 1)
        rp, rs = r_update(rg, rs, rp, lr)
        pp, ps = p_update(pg, ps, pp, lr)
        assert int(ps.step) == int(rs.step) == step + 1
        for k in pp:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       **TOL)
        for moment in ("mu", "nu"):
            if getattr(rs, moment) is None:
                assert getattr(ps, moment) is None
                continue
            for k in pp:
                np.testing.assert_allclose(
                    getattr(ps, moment)[k].numpy(),
                    np.asarray(getattr(rs, moment)[k]), **TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(ref, max_norm):
    rg, pg = both(tree(9))
    r_out, r_norm = ref.clip_by_global_norm(rg, max_norm)
    p_out, p_norm = optim.clip_by_global_norm(pg, max_norm)
    np.testing.assert_allclose(float(p_norm), float(r_norm), rtol=1e-6)
    for k in pg:
        np.testing.assert_allclose(p_out[k].numpy(), np.asarray(r_out[k]),
                                   **TOL)
    if max_norm > 100:      # under the threshold: untouched
        for k in pg:
            assert torch.equal(p_out[k], pg[k])


@pytest.mark.parametrize("name,lr,total", [("wsd", 0.1, 50),
                                           ("wsd", 3e-4, 7),
                                           ("constant", 0.02, 10)])
def test_schedules_match_reference(ref, name, lr, total):
    r_sched = importlib.import_module("repro.optim.schedule").get_schedule(
        name, lr, total)
    p_sched = optim.get_schedule(name, lr, total)
    for step in range(total + 5):
        got = p_sched(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(r_sched(step)),
                                   rtol=1e-6)
    # a tensor step, as a jitted loop would pass it
    np.testing.assert_allclose(float(p_sched(torch.tensor(3))),
                               float(r_sched(3)), rtol=1e-6)


def test_wsd_shape():
    """Warmup rises to lr, the plateau holds it, the decay ends at
    floor * lr."""
    f = optim.wsd_schedule(1.0, 100)
    assert float(f(0)) == 0.0 and float(f(5)) == pytest.approx(0.5)
    assert float(f(10)) == 1.0 and float(f(89)) == 1.0
    assert float(f(100)) == pytest.approx(0.1)
