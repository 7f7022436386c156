"""The port's package surface against the reference's.

Every ``__all__`` under ``src/repro/`` is read with ``ast`` (the reference
is not imported for that), and each name must import from the port's twin
module (``repro.x.y`` -> ``repro_torch.x.y``), except the names still open
in ROADMAP §A, listed below by item; a listed name that the port gains
fails the test, so the list shrinks as the port grows. Then
``make_solve_fn``'s two solvers against the reference's (``"stitched"``
against ``"jnp"``, ``"cuda"``, its plain version on CPU tensors, against
``"pallas"`` in interpret mode; q rtol 1e-5 / atol 1e-6, P rtol 1e-5 /
atol 1e-3, the solve tolerances of tests/test_torch_kernels.py), and the
example twins of item 12 and item 10 at ``--device cpu`` at a reduced
size.
"""

import ast
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REFERENCE = Path(__file__).resolve().parents[1] / "src" / "repro"

# names of a reference __all__ the port does not have yet, by ROADMAP §A
# item: 5 the legacy loop engine (left out on purpose), 8 multi-device,
# 11 launch planning (sharding/); item 10's optim/ is ported
OPEN = {
    "repro_torch.fl": {"run_simulation_loop": 5,
                       "make_sharded_round_update": 8,
                       "make_schedule_runner": 8},
    "repro_torch.fl.simulation": {"run_simulation_loop": 5},
    "repro_torch.sharding": dict.fromkeys(
        ["batch_pspec", "param_pspecs", "ShardingMode",
         "serve_batch_pspec"], 11),
}


def reference_alls():
    """``{twin module: names}`` of every ``__all__`` under src/repro."""
    out = {}
    for path in sorted(REFERENCE.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__"
                    for t in node.targets):
                parts = path.relative_to(REFERENCE.parent).with_suffix(
                    "").parts
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                twin = ".".join(("repro_torch",) + parts[1:])
                out[twin] = ast.literal_eval(node.value)
    return out


ALLS = reference_alls()


def test_every_reference_all_is_found():
    assert {"repro_torch.fl", "repro_torch.data", "repro_torch.kernels",
            "repro_torch.kernels.ops", "repro_torch.core",
            "repro_torch.service", "repro_torch.obs",
            "repro_torch.checkpoint"} <= set(ALLS)
    for module, names in OPEN.items():
        assert set(names) <= set(ALLS[module]), module


@pytest.mark.parametrize("module", sorted(ALLS))
def test_reference_all_imports_from_the_port(module):
    open_names = OPEN.get(module, {})
    if set(open_names) == set(ALLS[module]):
        # a package still open as a whole
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(module)
        return
    mod = importlib.import_module(module)
    missing = [n for n in ALLS[module]
               if n not in open_names and not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"
    gained = [n for n in open_names if hasattr(mod, n)]
    assert not gained, f"{module} has {gained}: drop them from OPEN"
    if hasattr(mod, "__all__"):
        assert not set(ALLS[module]) - set(open_names) - set(mod.__all__)


def test_item_12_exports():
    """The four gaps item 12 named: fl's round and solve entry points,
    data's builders, kernels' kernels and ops' re-exported solve; the
    kernels package imports without a CUDA toolkit (builds are lazy)."""
    from repro_torch import data, fl, kernels
    from repro_torch.fl import round as fl_round_mod
    from repro_torch.kernels import decision_fused as _  # noqa: F401
    assert fl.fl_round is fl_round_mod.fl_round
    assert fl.make_solve_fn is importlib.import_module(
        "repro_torch.fl.engine").make_solve_fn
    assert data.make_token_stream.__module__ == "repro_torch.data.synthetic"
    assert kernels.ops.scheduler_solve is kernels.scheduler_solve
    assert kernels.N_DECISION_OPS == 14
    assert kernels.ops.on_tpu() is False
    for name in ("scheduler_solve", "decision_fused",
                 "decision_fused_batched", "ssd_scan",
                 "flash_attention_bhsd"):
        assert callable(getattr(kernels, name)), name


def test_item_10_training_surface():
    """Item 10's training: optim (with get_schedule), the registry's
    transformer_lm resolving on token data, make_lm_federated exported,
    launch.train and distributed.main_print."""
    from repro_torch import data, optim
    from repro_torch.launch import distributed, train
    from repro_torch.models.registry import MODELS, make_model
    assert set(MODELS) == {"cnn", "mlp", "transformer_lm"}
    ds = data.make_lm_federated(torch.Generator().manual_seed(0),
                                n_clients=3, per_client=4, seq=8, vocab=16,
                                n_test=4, device="cpu")
    spec = make_model("transformer_lm", ds, n_layers=1)
    assert spec.name == "transformer_lm"
    assert set(spec.init_fn(torch.Generator().manual_seed(0))) == {
        "emb.emb", "layers.0.ln1.g", "layers.0.attn.wq.w",
        "layers.0.attn.wk.w", "layers.0.attn.wv.w", "layers.0.attn.wo.w",
        "layers.0.ln2.g", "layers.0.mlp.wi.w", "layers.0.mlp.wg.w",
        "layers.0.mlp.wo.w", "lnf.g"}
    assert callable(optim.get_schedule) and callable(train.run_lm)
    assert callable(train.run_fl) and callable(distributed.main_print)


# ------------------------------------------------------------ make_solve_fn

@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from test_torch_reference import reference
    return reference()


@pytest.mark.parametrize("n", [7, 200])
@pytest.mark.parametrize("solver,ref_solver", [("stitched", "jnp"),
                                               ("cuda", "pallas")])
def test_make_solve_fn_matches_reference(ref, solver, ref_solver, n):
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fl import make_solve_fn
    rng = np.random.default_rng(n)
    gains = rng.exponential(2.0, n).astype(np.float32)
    z = rng.uniform(0.0, 50.0, n).astype(np.float32)
    kw = dict(n_clients=n, model_bits=32 * 50_000.0, lam=10.0, V=1000.0)
    q, p = make_solve_fn(SchedulerConfig(**kw), ChannelConfig(n_clients=n),
                         solver)(torch.from_numpy(gains), torch.from_numpy(z))
    rq, rp = ref.engine.make_solve_fn(
        ref.scheduler.SchedulerConfig(**kw),
        ref.channel.ChannelConfig(n_clients=n), ref_solver)(
        ref.jnp.asarray(gains), ref.jnp.asarray(z))
    np.testing.assert_allclose(q.numpy(), np.asarray(rq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=1e-5,
                               atol=1e-3)


def test_make_solve_fn_rejects_unknown_solvers(ref):
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fl import make_solve_fn
    kw = dict(n_clients=4, model_bits=1e6)
    scfg, ch = SchedulerConfig(**kw), ChannelConfig(n_clients=4)
    with pytest.raises(ValueError, match="unknown solver"):
        make_solve_fn(scfg, ch, "pallas")
    with pytest.raises(ValueError, match="unknown solver"):
        ref.engine.make_solve_fn(ref.scheduler.SchedulerConfig(**kw),
                                 ref.channel.ChannelConfig(n_clients=4),
                                 "cuda")


# ----------------------------------------------------------------- examples

def test_scheduler_service_example_on_cpu(capsys):
    from repro_torch.examples import scheduler_service
    out = scheduler_service.main(["--device", "cpu", "--scale", "0.02"])
    assert out == dict(tenants=20, replay_exact=True, reload_exact=True)
    text = capsys.readouterr().out
    assert "round 5: served 20 tenants" in text
    assert "compact_log()" in text


def test_wireless_heterogeneous_example_on_cpu(capsys):
    from repro_torch.examples import wireless_heterogeneous
    out = wireless_heterogeneous.main(["--device", "cpu", "--rounds", "4"])
    assert out["rounds"] == 4 and np.isfinite(out["bound"])
    assert capsys.readouterr().out.count("selected") == 4


def test_serve_mamba_example_on_cpu(capsys):
    from repro_torch.examples import serve_mamba
    serve_mamba.main(["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [r["arch"] for r in lines] == ["mamba2-130m-reduced",
                                         "mixtral-8x22b-reduced"]
    assert all(len(r["sample_output"]) == 16 for r in lines)
