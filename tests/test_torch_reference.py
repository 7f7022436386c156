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
see identical randomness, under any fading model and with the population's
draws; :func:`record_sweep_draws` and :class:`ReplaySweepDraws` do the
same for the policy x seed sweep, :func:`grid_draws` for the scenario
grid's configs.
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
                 femnist="configs.femnist_cnn", population="fl.population",
                 grid="fl.grid", tournament="fl.tournament",
                 moe="models.moe")
    mods = {k: importlib.import_module(f"repro.{v}") for k, v in names.items()}
    return types.SimpleNamespace(jax=jax, jnp=jnp, **mods)


def _np_stack(trees: list, axis):
    """Stack equally shaped raws (arrays, tuples or None) leaf by leaf at
    ``axis(leaf)``."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return tuple(_np_stack([t[i] for t in trees], axis)
                     for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees], axis(np.asarray(first)))


def _rounds_axis(x):
    return 0


def _seed_axis(x):
    """The seed axis sits just before the client axis, as the port's
    ``fl/engine.py::stack_seeds`` puts it."""
    return max(x.ndim - 1, 0)


def _channel_init_raw(ref, key, channel: str, n: int):
    """The reference model's init raw on ``key``, as its ``init`` draws
    it: (2, N) normals for gauss_markov and mobility, (N,) uniforms for
    outage_burst, None for the memoryless models."""
    jax = ref.jax
    if channel in ("gauss_markov", "mobility"):
        return np.asarray(jax.random.normal(key, (2, n)))
    if channel == "outage_burst":
        return np.asarray(jax.random.uniform(key, (n,)))
    return None


def _tensors(tree, device):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_tensors(x, device) for x in tree)
    return torch.as_tensor(np.array(tree), device=device)


def _at(tree, r):
    if isinstance(tree, tuple):
        return tuple(x[r] for x in tree)
    return tree[r]


def record_draws(ref, key, rounds: int, n: int, batch_shape: tuple,
                 per_client: int, channel: str = "rayleigh") -> dict:
    """Every draw of ``rounds`` reference rounds from the config key
    ``key``, as numpy.

    The chain is the engine's: the channel init on ``fold_in(key,
    CHANNEL_INIT_TAG)`` and the round-0 activity uniforms on
    ``fold_in(key, POP_INIT_TAG)``; per round ``key, k = split(key)``
    (``fl/engine.py::scan_chunk``), ``k_ch, k_sel, k_bat = split(k, 3)``
    (``make_round_core``), the model's draw on ``k_ch``, the proposed
    policy's uniforms and the uniform baseline's raws on ``k_sel``, the
    minibatch indices on ``k_bat`` (``fl/round.py::sample_batches``), and
    the churn and failure uniforms on ``fold_in(k, POP_CHURN_TAG /
    POP_FAIL_TAG)`` (``fl/population.py``).
    """
    jax = ref.jax
    draw = ref.channel.CHANNEL_RAW[channel][0]
    out = {"channel_init": _channel_init_raw(
               ref, jax.random.fold_in(key, ref.engine.CHANNEL_INIT_TAG),
               channel, n),
           "init_mask_u": np.asarray(jax.random.uniform(
               jax.random.fold_in(key, ref.population.POP_INIT_TAG), (n,)))}
    rows = {"channel_raw": [], "selection_u": [], "take": [], "scores": [],
            "batch_idx": [], "churn_u": [], "fail_u": []}
    for _ in range(rounds):
        key, k = jax.random.split(key)
        k_ch, k_sel, k_bat = jax.random.split(k, 3)
        raw = draw(k_ch, n)
        rows["channel_raw"].append(tuple(map(np.asarray, raw))
                                   if isinstance(raw, tuple) else raw)
        rows["selection_u"].append(
            ref.policies.draw_selection_uniform(k_sel, n))
        uni = ref.policies._draw_uniform(k_sel, n)
        rows["take"].append(uni["take"])
        rows["scores"].append(uni["scores"])
        rows["batch_idx"].append(
            jax.random.randint(k_bat, batch_shape, 0, per_client))
        rows["churn_u"].append(ref.population.draw_churn_raw(k, n))
        rows["fail_u"].append(ref.population.draw_fail_raw(k, n))
    out.update({k: _np_stack(v, _rounds_axis) for k, v in rows.items()})
    return out


class ReplayDraws:
    """The port's ``Draws`` interface over :func:`record_draws` arrays."""

    def __init__(self, arrays: dict, device="cpu"):
        self._a = {k: _tensors(v, device) for k, v in arrays.items()}
        self._a["batch_idx"] = self._a["batch_idx"].long()

    def channel_init(self):
        return self._a["channel_init"]

    def init_mask_u(self):
        return self._a["init_mask_u"]

    def channel_raw(self, r):
        return _at(self._a["channel_raw"], r)

    def selection_u(self, r):
        return self._a["selection_u"][r]

    def uniform_raw(self, r):
        return {"take": self._a["take"][r], "scores": self._a["scores"][r]}

    def churn_u(self, r):
        return self._a["churn_u"][r]

    def fail_u(self, r):
        return self._a["fail_u"][r]

    def batch_idx(self, r):
        return self._a["batch_idx"][r]


def grid_draws(ref, key, n: int, per_client: int):
    """The port grid's ``draws(sim_one, seed)`` factory replaying the
    reference grid's chain: config ``seed`` runs on ``fold_in(key,
    seed)`` (``fl/grid.py::grid_cell_inputs``)."""
    def draws(one, seed):
        return ReplayDraws(record_draws(
            ref, ref.jax.random.fold_in(key, seed), one.rounds, n,
            (one.m_cap, one.local_steps, one.batch), per_client,
            one.channel))
    return draws


def record_sweep_draws(ref, key, rounds: int, n: int, seeds,
                       match_rounds: int, channel: str = "rayleigh") -> dict:
    """Every draw of the reference's ``run_sweep`` from ``key`` under
    ``channel``, as numpy.

    The chain is ``fl/engine.py``'s: seed ``s`` runs on ``fold_in(key, s)``
    (shared by every policy): its channel init on ``fold_in(.,
    CHANNEL_INIT_TAG)``, its round keys ``split(., rounds)``, each
    splitting into ``k_ch, k_sel``; the model's draw takes ``k_ch``, the
    policies' uniforms and the uniform baseline's raws ``k_sel``. The
    matched-M estimate runs on ``fold_in(key, 7)``: the model's init on
    ``fold_in(., 1)`` and a draw on each of ``split(., match_rounds)``.
    Per-round arrays are (rounds, ...) with the seed axis just before the
    client axis.
    """
    jax = ref.jax
    draw = ref.channel.CHANNEL_RAW[channel][0]
    per_seed = {k: [] for k in ("channel_raw", "selection_u", "take",
                                "scores")}
    inits = []
    for s in seeds:
        cfg_key = jax.random.fold_in(key, s)
        inits.append(_channel_init_raw(
            ref, jax.random.fold_in(cfg_key, ref.engine.CHANNEL_INIT_TAG),
            channel, n))
        rows = {k: [] for k in per_seed}
        for k in jax.random.split(cfg_key, rounds):
            k_ch, k_sel = jax.random.split(k)
            raw = draw(k_ch, n)
            rows["channel_raw"].append(tuple(map(np.asarray, raw))
                                       if isinstance(raw, tuple) else raw)
            rows["selection_u"].append(
                ref.policies.draw_selection_uniform(k_sel, n))
            uni = ref.policies._draw_uniform(k_sel, n)
            rows["take"].append(uni["take"])
            rows["scores"].append(uni["scores"])
        for k, v in rows.items():
            per_seed[k].append(_np_stack(v, _rounds_axis))
    # (rounds, ...) per seed -> the seed axis before the client axis
    arrays = {k: _np_stack(v, lambda x: max(x.ndim - 1, 1))
              for k, v in per_seed.items()}
    arrays["channel_init"] = _np_stack(inits, _seed_axis)
    key7 = jax.random.fold_in(key, 7)
    match = []
    for k in jax.random.split(key7, match_rounds):
        raw = draw(k, n)
        match.append(tuple(map(np.asarray, raw)) if isinstance(raw, tuple)
                     else np.asarray(raw))
    arrays["match"] = _np_stack(match, _rounds_axis)
    arrays["match_init"] = _channel_init_raw(
        ref, jax.random.fold_in(key7, 1), channel, n)
    return arrays


class ReplaySweepDraws:
    """The port's ``SweepDraws`` interface over :func:`record_sweep_draws`
    arrays."""

    def __init__(self, arrays: dict, device="cpu"):
        self._a = {k: _tensors(v, device) for k, v in arrays.items()}

    def channel_init(self):
        return self._a.get("channel_init")

    def channel_raw(self, r):
        return _at(self._a["channel_raw"], r)

    def selection_u(self, r):
        return self._a["selection_u"][r]

    def uniform_raw(self, r):
        return {"take": self._a["take"][r], "scores": self._a["scores"][r]}

    def match_raws(self, rounds):
        m = self._a["match"]
        return (tuple(x[:rounds] for x in m) if isinstance(m, tuple)
                else m[:rounds])

    def match_init(self):
        return self._a.get("match_init")
