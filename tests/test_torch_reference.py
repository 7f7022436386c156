"""Reference access for the PyTorch port's parity tests (holds no tests).

The port (``src/repro_torch``) is checked against the JAX package
(``src/repro``) on the same inputs. Under the installed jax the reference
does not import: ``repro/core/fences.py`` asks
``optimization_barrier_p in batching.primitive_batchers``, and jax 0.9's
``PrimitiveBatchersProxy`` has no ``__contains__``. :func:`reference` gives
the proxy type one (a lookup in
``jax._src.interpreters.batching.fancy_primitive_batchers``, where jax
keeps the registered rules) and then imports the reference. Nothing of
``src/repro`` changes.

The shim is process-global, so it is applied lazily: the parity files call
:func:`reference` from a module-scoped fixture, never at import, and the
JAX package's own test files (collected before any fixture runs) see the
interpreter exactly as they would without the port's tests.

:func:`record_draws` draws, with the reference engine's own key chain, the
arrays that :class:`ReplayDraws` feeds to the port's engine, so both sides
see identical randomness; :func:`record_sweep_draws` and
:class:`ReplaySweepDraws` do the same for the policy x seed sweep.
"""

from __future__ import annotations

import importlib
import types

import numpy as np
import torch


def _make_reference_importable():
    from jax.interpreters import batching

    proxy_type = type(batching.primitive_batchers)
    if not hasattr(proxy_type, "__contains__"):
        from jax._src.interpreters import batching as _batching

        def contains(self, prim):
            return prim in _batching.fancy_primitive_batchers

        proxy_type.__contains__ = contains


def reference() -> types.SimpleNamespace:
    """The reference's modules that the parity tests compare against."""
    _make_reference_importable()
    import jax
    import jax.numpy as jnp

    # import_module, not ``import a.b as c``: repro.kernels re-exports
    # functions named like its submodules
    names = dict(channel="core.channel", lambertw="core.lambertw",
                 policies="core.policies", scheduler="core.scheduler",
                 synthetic="data.synthetic", decision="fl.decision",
                 engine="fl.engine", round="fl.round",
                 sharding="fl.sharding", simulation="fl.simulation",
                 decision_fused="kernels.decision_fused",
                 scheduler_solve="kernels.scheduler_solve",
                 cnn="models.cnn", registry="models.registry",
                 config="models.config", mamba="models.mamba",
                 model="models.model", ops="kernels.ops", ref="kernels.ref",
                 ssd_scan="kernels.ssd_scan", configs="configs",
                 serve="launch.serve", attention="models.attention",
                 layers="models.layers",
                 flash_attention="kernels.flash_attention",
                 bound="core.bound", mlp="models.mlp",
                 femnist="configs.femnist_cnn")
    mods = {k: importlib.import_module(f"repro.{v}") for k, v in names.items()}
    return types.SimpleNamespace(jax=jax, jnp=jnp, **mods)


def record_draws(ref, key, rounds: int, n: int, batch_shape: tuple,
                 per_client: int) -> dict:
    """Every draw of ``rounds`` reference rounds from ``key``, as numpy.

    The chain is the engine's: ``key, k = split(key)`` per round
    (``fl/engine.py::scan_chunk``), ``k_ch, k_sel, k_bat = split(k, 3)``
    (``make_round_core``), the rayleigh draw on ``k_ch``, the proposed
    policy's uniforms and the uniform baseline's raws on ``k_sel``, and the
    minibatch indices on ``k_bat`` (``fl/round.py::sample_batches``).
    """
    jax = ref.jax
    out = {"channel_raw": [], "selection_u": [], "take": [], "scores": [],
           "batch_idx": []}
    for _ in range(rounds):
        key, k = jax.random.split(key)
        k_ch, k_sel, k_bat = jax.random.split(k, 3)
        out["channel_raw"].append(ref.channel._rayleigh_draw(k_ch, n))
        out["selection_u"].append(
            ref.policies.draw_selection_uniform(k_sel, n))
        uni = ref.policies._draw_uniform(k_sel, n)
        out["take"].append(uni["take"])
        out["scores"].append(uni["scores"])
        out["batch_idx"].append(
            jax.random.randint(k_bat, batch_shape, 0, per_client))
    return {k: np.stack([np.asarray(x) for x in v]) for k, v in out.items()}


class ReplayDraws:
    """The port's ``Draws`` interface over :func:`record_draws` arrays."""

    def __init__(self, arrays: dict, device="cpu"):
        self._a = {k: torch.as_tensor(v, device=device)
                   for k, v in arrays.items()}
        self._a["batch_idx"] = self._a["batch_idx"].long()

    def channel_raw(self, r):
        return self._a["channel_raw"][r]

    def selection_u(self, r):
        return self._a["selection_u"][r]

    def uniform_raw(self, r):
        return {"take": self._a["take"][r], "scores": self._a["scores"][r]}

    def batch_idx(self, r):
        return self._a["batch_idx"][r]


def record_sweep_draws(ref, key, rounds: int, n: int, seeds,
                       match_rounds: int) -> dict:
    """Every draw of the reference's ``run_sweep`` from ``key``, as numpy.

    The chain is ``fl/engine.py``'s: seed ``s`` runs on ``fold_in(key, s)``
    (shared by every policy), its round keys are ``split(cfg_key,
    rounds)``, each round key splits into ``k_ch, k_sel``; the rayleigh
    draw takes ``k_ch``, the proposed policy's uniforms and the uniform
    baseline's raws ``k_sel``. The matched-M estimate draws its channel
    from ``split(fold_in(key, 7), match_rounds)``. Per-round arrays are
    (rounds, S, ...).
    """
    jax = ref.jax
    out = {"channel_raw": [], "selection_u": [], "take": [], "scores": []}
    for s in seeds:
        rows = {k: [] for k in out}
        for k in jax.random.split(jax.random.fold_in(key, s), rounds):
            k_ch, k_sel = jax.random.split(k)
            rows["channel_raw"].append(ref.channel._rayleigh_draw(k_ch, n))
            rows["selection_u"].append(
                ref.policies.draw_selection_uniform(k_sel, n))
            uni = ref.policies._draw_uniform(k_sel, n)
            rows["take"].append(uni["take"])
            rows["scores"].append(uni["scores"])
        for k, v in rows.items():
            out[k].append(np.stack([np.asarray(x) for x in v]))
    arrays = {k: np.stack(v, axis=1) for k, v in out.items()}
    arrays["match"] = np.stack([
        np.asarray(ref.channel._rayleigh_draw(k, n)) for k in
        jax.random.split(jax.random.fold_in(key, 7), match_rounds)])
    return arrays


class ReplaySweepDraws:
    """The port's ``SweepDraws`` interface over :func:`record_sweep_draws`
    arrays."""

    def __init__(self, arrays: dict, device="cpu"):
        self._a = {k: torch.as_tensor(v, device=device)
                   for k, v in arrays.items()}

    def channel_raw(self, r):
        return self._a["channel_raw"][r]

    def selection_u(self, r):
        return self._a["selection_u"][r]

    def uniform_raw(self, r):
        return {"take": self._a["take"][r], "scores": self._a["scores"][r]}

    def match_raws(self, rounds):
        return self._a["match"][:rounds]
