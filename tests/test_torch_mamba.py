"""The port's Mamba-2 model (``mamba2-130m``) against the reference, on the
CPU.

The reference initialises its parameters; ``convert.lm_params_from_jax``
carries them across, and seeded numpy tokens and activations go to both
packages. On CPU tensors the port runs the plain SSD scan (``ops.ssd``),
the reference its chunked jnp version (its Pallas kernel runs on a TPU
only); ``tests/test_torch_ssd.py`` holds the two scans against the Pallas
kernel in interpret mode.

Tolerances, each with its reason: the two sides sum float32 products in
other orders (XLA's dot against PyTorch's matmul, over d_model = 256 or
768 and d_inner = 512 or 1536 terms). Block outputs rtol 1e-4 / atol 2e-5
(measured max |d| 2.9e-6 at |out| up to 3.2, full width); the carried
conv and ssm states rtol 1e-4 / atol 1e-6 (measured 1.2e-6 at |conv| up
to 1.9 and 1.8e-8 at |ssm| up to 0.007). LM logits
atol 2e-5 / rtol 1e-4 (measured 1.4e-6 at |logit| up to 1.3); the loss
rtol 1e-5. Greedy tokens are exact wherever every earlier step's top-2
logit margin exceeds 1e-4, five times the logits' tolerance. Prefill plus
decode against the port's own teacher-forced forward: < 2e-4, the bound
of ``tests/test_arch_smoke.py::test_decode_matches_forward``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
from test_torch_reference import reference  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data.synthetic import make_token_stream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import LayerSpec, ModelConfig  # noqa: E402

BLOCK_TOL = dict(rtol=1e-4, atol=2e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def ref():
    return reference()


def lm_cfgs(ref, **reduce):
    """The port's and the reference's mamba2-130m, reduced alike."""
    return (configs.get_config("mamba2-130m").reduced(**reduce),
            ref.configs.get_config("mamba2-130m").reduced(**reduce))


@pytest.fixture(scope="module")
def lm(ref):
    """The reduced LM (2 layers, d_model 256): the reference's parameters
    and the port's copy of them."""
    cfg, rcfg = lm_cfgs(ref, n_layers=2, d_model=256)
    rparams = ref.model.init_params(ref.jax.random.PRNGKey(0), rcfg)
    tree = ref.jax.tree.map(np.asarray, rparams)
    return cfg, rcfg, rparams, lm_params_from_jax(tree, cfg, device="cpu")


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# -------------------------------------------------------------- configs

def test_configs_match_reference(ref):
    assert configs.ARCH_IDS == ref.configs.ARCH_IDS
    port = configs.get_config("mamba2-130m")
    want = ref.configs.get_config("mamba2-130m")
    assert dataclasses.asdict(port) == dataclasses.asdict(want)
    for kw in ({}, dict(n_layers=2, d_model=256), dict(n_layers=1)):
        assert (dataclasses.asdict(port.reduced(**kw))
                == dataclasses.asdict(want.reduced(**kw)))
    assert port.param_count() == want.param_count()
    assert ([dataclasses.astuple(s) for s in port.layer_specs()]
            == [dataclasses.astuple(s) for s in want.layer_specs()])
    for name in sorted(set(configs.ARCH_IDS) - set(configs.PORTED_IDS)):
        with pytest.raises(NotImplementedError, match="§A item 10"):
            configs.get_config(name)
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_every_layer_spec_builds():
    """Nothing raises any more: the MoE stacks and a hybrid's Mamba layers
    with an mlp run since the MoE slice (tests/test_torch_moe.py),
    cross-attention layers and the encoder-decoder since the zoo's second
    slice (tests/test_torch_zoo.py), and a layer no id of the zoo has, a
    cross-attention mixer with an MoE mlp or an attention mixer without
    an mlp, since the layer became generic over mixer x mlp
    (tests/test_torch_layer_specs.py holds them against the reference).
    Each builds, and its cache initialises as the reference's."""
    moe = ModelConfig(name="m", arch_type="moe", n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=32,
                      n_experts=4, top_k=2)
    hybrid = dataclasses.replace(moe, n_experts=0, top_k=0, attn_period=2,
                                 attn_offset=1)
    vlm = dataclasses.replace(moe, n_experts=0, top_k=0, cross_attn_every=2)
    moe_vlm = dataclasses.replace(moe, cross_attn_every=2)
    for cfg in (moe, hybrid, vlm, moe_vlm):
        M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    spec = moe_vlm.layer_specs()[1]
    assert (spec.mixer, spec.mlp) == ("cross_attn", "moe")
    assert M._layer_cache_init(spec, moe_vlm, 1, 8, torch.float32,
                               "cpu") is None
    bare = M._init_layer(torch.Generator().manual_seed(0),
                         LayerSpec("attn", "none"), moe, torch.float32,
                         "cpu")
    assert bare.mlp is None and bare.norm2 is None
    cache = M._layer_cache_init(LayerSpec("attn", "none"), moe, 1, 8,
                                torch.float32, "cpu")
    assert tuple(cache.k.shape[:2]) == (1, 8)


def test_init_params_matches_reference_layout(ref, lm):
    """The port's own init: the reference's parameter names, shapes and
    count (the analytic ``param_count`` within 1%, as
    ``test_arch_smoke.py::test_param_count_formula`` holds it), and its
    deterministic leaves (a_log, d_skip, dt_bias, norms)."""
    cfg, _, rparams, carried = lm
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    got = {k: tuple(v.shape) for k, v in params.named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in carried.named_parameters()}
    count = sum(v.numel() for v in params.parameters())
    assert count == sum(x.size for x in ref.jax.tree.leaves(rparams))
    assert abs(count - cfg.param_count()) / count < 0.01
    assert "layers.1.mixer.in_proj.w" in got
    mine, theirs = params.state_dict(), carried.state_dict()
    for name in ("a_log", "d_skip", "dt_bias", "norm_g", "conv_b"):
        key = f"layers.0.mixer.{name}"
        close(mine[key], theirs[key], dict(rtol=1e-6, atol=0.0))
    w = mine["layers.0.mixer.conv_w"]
    assert w.abs().max() <= 0.2 and 0.03 < w.std() < 0.1
    assert all(v.dtype == torch.float32 for v in mine.values())


def test_make_token_stream():
    g = torch.Generator().manual_seed(0)
    toks, labels = make_token_stream(g, 3, 17, 50, device="cpu")
    assert toks.shape == labels.shape == (3, 17)
    assert toks.dtype == torch.int64
    assert 0 <= int(toks.min()) and int(toks.max()) < 50
    assert torch.equal(labels[:, :-1], toks[:, 1:])
    assert torch.equal(labels[:, -1], toks[:, 0])


# -------------------------------------------------------------- one block

@pytest.mark.parametrize("width", ["reduced", "full"])
def test_mamba_block_matches_reference(ref, width):
    """``apply_mamba`` (with and without the final state) and three
    ``decode_mamba`` steps of one block, at ``reduced()`` and at
    mamba2-130m's full widths (one layer, S = 200: the scan pads)."""
    if width == "reduced":
        cfg, rcfg = lm_cfgs(ref)
        b, s = 2, 40
    else:
        cfg = configs.get_config("mamba2-130m")
        rcfg = ref.configs.get_config("mamba2-130m")
        b, s = 1, 200
    jnp = ref.jnp
    rp = ref.mamba.init_mamba(ref.jax.random.PRNGKey(3), rcfg, jnp.float32)
    block = mam.Mamba2Block(
        {k: ({"w": torch.from_numpy(np.array(v["w"]))} if isinstance(v, dict)
             else torch.from_numpy(np.array(v))) for k, v in rp.items()},
        cfg)
    x = np.random.default_rng(4).standard_normal(
        (b, s + 3, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)

    want, rstate = ref.mamba.apply_mamba(rp, jnp.asarray(x[:, :s]), rcfg,
                                         return_state=True)
    with torch.inference_mode():
        got, state = block(xt[:, :s], return_state=True)
        alone = block(xt[:, :s])
    close(got, want, BLOCK_TOL)
    assert torch.equal(alone, got)
    close(state.conv, rstate.conv, STATE_TOL)
    close(state.ssm, rstate.ssm, STATE_TOL)
    for t in range(s, s + 3):
        want, rstate = ref.mamba.decode_mamba(rp, jnp.asarray(x[:, t:t + 1]),
                                              rcfg, rstate)
        with torch.inference_mode():
            got, state = block.decode(xt[:, t:t + 1], state)
        close(got, want, BLOCK_TOL)
        close(state.ssm, rstate.ssm, STATE_TOL)


# -------------------------------------------------------------- the LM

def test_lm_forward_and_loss_match_reference(ref, lm):
    cfg, rcfg, rparams, params = lm
    tok = tokens(cfg, 2, 70)
    lab = np.roll(tok, -1, axis=1)
    jt, jl = ref.jnp.asarray(tok), ref.jnp.asarray(lab)
    tt, tl = torch.from_numpy(tok).long(), torch.from_numpy(lab).long()
    want, raux = ref.model.forward(rparams, ref.model.Batch(tokens=jt), rcfg)
    got, aux = M.forward(params, M.Batch(tokens=tt), cfg)
    assert got.shape == (2, 70, cfg.vocab_size)
    assert torch.isfinite(got).all() and float(aux) == float(raux) == 0.0
    close(got, want, LOGIT_TOL)
    rloss = ref.model.loss_fn(rparams, ref.model.Batch(tokens=jt, labels=jl),
                              rcfg)
    loss = M.loss_fn(params, M.Batch(tokens=tt, labels=tl), cfg)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)


def test_lm_prefill_and_decode_match_reference(ref, lm):
    """prefill on 60 tokens, then 8 decode steps: logits and every layer's
    carried state against the reference's."""
    cfg, rcfg, rparams, params = lm
    tok = tokens(cfg, 2, 68, seed=2)
    rl, rst = ref.model.prefill(
        rparams, ref.model.Batch(tokens=ref.jnp.asarray(tok[:, :60])), rcfg,
        cache_len=68)
    pl, st = M.prefill(params, M.Batch(tokens=torch.from_numpy(
        tok[:, :60]).long()), cfg, cache_len=68)
    assert pl.shape == (2, 1, cfg.vocab_size) and st.position == 60
    close(pl, rl, LOGIT_TOL)
    for t in range(60, 68):
        rl, rst = ref.model.decode_step(
            rparams, ref.jnp.asarray(tok[:, t:t + 1]), rst, rcfg)
        pl, st = M.decode_step(params, torch.from_numpy(
            tok[:, t:t + 1]).long(), st, cfg)
        close(pl, rl, LOGIT_TOL)
    assert st.position == int(rst.position) == 68
    for i, cache in enumerate(st.layers):
        close(cache.conv, rst.period["layer0"].conv[i], STATE_TOL)
        close(cache.ssm, rst.period["layer0"].ssm[i], STATE_TOL)
    want = ref.model._layer_cache_init(rcfg.layer_specs()[0], rcfg, 2, 68,
                                       ref.jnp.float32)
    got = M._layer_cache_init(cfg.layer_specs()[0], cfg, 2, 68,
                              torch.float32, "cpu")
    assert [tuple(t.shape) for t in got] == [t.shape for t in want]


def test_generate_matches_reference_greedy_loop(ref, lm):
    """``serve.generate``'s tokens against the reference serve loop's
    (prefill, then argmax fed back), exact while the margins allow."""
    cfg, rcfg, rparams, params = lm
    gen = 8
    tok = tokens(cfg, 3, 24, seed=5)
    out = serve.generate(params, M.Batch(tokens=torch.from_numpy(tok).long()),
                         cfg, gen)
    assert out.tokens.shape == (3, gen) and out.prefill_s > 0
    logits, st = ref.model.prefill(
        rparams, ref.model.Batch(tokens=ref.jnp.asarray(tok)), rcfg,
        cache_len=24 + gen)
    want, margins = [], []
    for _ in range(gen):
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        nxt = last.argmax(-1)
        want.append(nxt)
        logits, st = ref.model.decode_step(
            rparams, ref.jnp.asarray(nxt[:, None].astype(np.int32)), st, rcfg)
    want, margins = np.stack(want, 1), np.stack(margins, 1)
    trusted = np.cumprod(margins > MARGIN, axis=1).astype(bool)
    assert trusted[:, 0].all()
    np.testing.assert_array_equal(out.tokens.numpy()[trusted],
                                  want[trusted])


def test_decode_matches_forward(lm):
    """The port's twin of ``test_arch_smoke.py::test_decode_matches_forward``
    at ``reduced()``: prefill plus decode steps reproduce the teacher-forced
    logits."""
    cfg = configs.get_config("mamba2-130m").reduced()
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    b, s, pre = 2, 20, 16
    tok = torch.from_numpy(tokens(cfg, b, s)).long()
    full, _ = M.forward(params, M.Batch(tokens=tok), cfg)
    lg, st = M.prefill(params, M.Batch(tokens=tok[:, :pre]), cfg,
                       cache_len=s)
    errs = [float((lg[:, 0] - full[:, pre - 1]).abs().max())]
    for i in range(pre, s - 1):
        lg, st = M.decode_step(params, tok[:, i:i + 1], st, cfg)
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 2e-4, errs


def test_serve_main_on_cpu(capsys):
    serve.main(["--device", "cpu", "--gen", "4", "--prompt-len", "40"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"arch", "batch", "prompt_len", "generated",
                        "prefill_s", "decode_s_per_token", "sample_output"}
    assert out["arch"] == "mamba2-130m-reduced" and out["generated"] == 4
    assert len(out["sample_output"]) == 4


def test_serve_main_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--gen", "1"])
