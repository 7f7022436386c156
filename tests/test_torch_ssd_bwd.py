"""K4's backward on the CPU: the plain gradient ``ssd_scan_bwd_ref`` (the
function ``csrc/ssd_scan_bwd.cu`` computes, held against it on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``), the autograd
route ``ops.ssd`` -> ``SsdScan`` under ``torch.func.grad`` and
``vmap(grad)``, what the backward's wrapper plans and refuses, and Mamba
training through ``launch/train.py`` and its example twin.

Inputs come from numpy with a seed (``tests/test_torch_ssd.py``'s
``ssd_inputs``: dt = softplus(N(0, 1)) * 0.2, a = -exp(N(0, 1)); x, B, C,
h0, dy and the final state's cotangent standard normal).

Tolerances, each of a gradient's largest |reference| entry:

* against torch autograd of ``ssd_chunked_ref``: 1e-5. Both sides are
  float32 products of the same terms, summed in other orders (measured
  up to 1.3e-6, da, a sum over every (b, S));
* against ``jax.vjp`` of the reference's ``ssd_chunked_ref``: 1e-4, the
  train tests' gradient bound (XLA's dot and cumsum orders against
  PyTorch's, over up to 128-term chunks; measured up to 8.2e-6, da, and
  8.2e-7 elsewhere);
* ``vmap(grad)`` against the loop over samples: bit for bit (one folded
  call computes each sample's rows as the per-sample call does);
* the Mamba train step against ``jax.grad`` of the reference's
  ``loss_fn``: ``tests/test_torch_train_dense.py``'s (loss rtol 1e-5,
  gradients 1e-4, stepped parameters rtol 1e-5 / atol 1e-7).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import (ssd_chunked_ref, ssd_scan_bwd_gemm_ref,
                                     ssd_scan_bwd_ref)
from repro_torch.kernels.ssd_scan import (MAX_SMEM_BYTES, SsdScan,
                                          bwd_gemm_smem_bytes,
                                          bwd_head_group, bwd_smem_bytes,
                                          bwd_work_floats, check_kernel_shape,
                                          saved_shapes, ssd_scan_bwd)

AUTOGRAD_TOL = 1e-5
JAX_TOL = 1e-4
NAMES = ("dx", "ddt", "da", "dbm", "dcm", "dh0")


def ssd_inputs(b, s, h, p, n, seed=0, rows=None):
    """x, dt, a, B, C, h0, dy, dh as float32 numpy arrays; a is (rows, H)
    where ``rows`` is given."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = normal(b, s, h, p)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.2).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h if rows is None else (rows, h))))
    return (x, dt, a.astype(np.float32), normal(b, s, n), normal(b, s, n),
            normal(b, h, n, p), normal(b, s, h, p), normal(b, h, n, p))


def torch_of(arrs):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrs]


def assert_close_to(got, want, tol, names=NAMES):
    for name, g, w in zip(names, got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((g - w).abs().max())
        assert err <= tol * scale, (name, err, scale)


# ------------------------------------------- the plain gradient, autograd

@pytest.mark.parametrize("b,s,h,p,n,chunk,rows", [
    (2, 64, 3, 32, 16, 32, None),
    (2, 192, 2, 32, 8, 64, None),      # 3 chunks
    (4, 64, 2, 16, 8, 32, 2),          # a per pair of batch elements
])
@pytest.mark.parametrize("state", [False, True])
def test_bwd_ref_matches_autograd(b, s, h, p, n, chunk, rows, state):
    x, dt, a, bm, cm, h0, dy, dh = torch_of(
        ssd_inputs(b, s, h, p, n, seed=s + n, rows=rows))
    if not state:
        h0 = dh = None
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    h0_leaf = None if h0 is None else h0.clone().requires_grad_()
    y, h_final = ssd_chunked_ref(*leaves, chunk=chunk, h0=h0_leaf)
    loss = (y * dy).sum() + (0.0 if dh is None else (h_final * dh).sum())
    want = torch.autograd.grad(loss, leaves + (
        [h0_leaf] if state else []))
    got = ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk=chunk, h0=h0, dh=dh)
    assert_close_to(got[:len(want)], want, AUTOGRAD_TOL)


def test_bwd_ref_without_h0_gives_the_zero_state_gradient():
    """dh0 with h0 None is the gradient of a zero initial state."""
    x, dt, a, bm, cm, _, dy, dh = torch_of(ssd_inputs(1, 64, 2, 16, 8, 5))
    zero = torch.zeros((1, 2, 8, 16))
    got = ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk=32, dh=dh)
    again = ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk=32, h0=zero, dh=dh)
    for g, w in zip(got, again):
        assert torch.equal(g, w)


# ------------------------------------------------ against jax.vjp

@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from test_torch_reference import reference
    return reference()


# (b, S, H, P, N, chunk): every chunk, N 16 and 128, P 32 and 64; S = 100,
# 200 and 300 pad to a chunk multiple
JAX_SHAPES = [
    (2, 64, 3, 32, 16, 32),
    (1, 100, 2, 32, 16, 32),
    (2, 128, 2, 64, 16, 64),
    (1, 200, 2, 64, 128, 64),
    (1, 256, 2, 32, 128, 128),
    (1, 300, 2, 64, 128, 128),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", JAX_SHAPES)
@pytest.mark.parametrize("state", [False, True])
def test_bwd_matches_jax_vjp(ref, b, s, h, p, n, chunk, state):
    """``ops.ssd``'s gradients (``SsdScan``: the padding, then
    ``ssd_scan_bwd_ref``) against ``jax.vjp`` of the reference's
    ``ssd_chunked_ref`` on the same padded inputs, y cut back to S; with
    ``state`` an initial state and the final state's cotangent."""
    jax, jnp = ref.jax, ref.jnp
    arrs = ssd_inputs(b, s, h, p, n, seed=s + n + p)
    x, dt, a, bm, cm, h0, dy, dh = arrs
    pad = (-s) % chunk

    def f(x, dt, a, bm, cm, *h0):
        widths = ((0, 0), (0, pad))
        y, h_final = ref.ref.ssd_chunked_ref(
            jnp.pad(x, widths + ((0, 0), (0, 0))),
            jnp.pad(dt, widths + ((0, 0),)), a,
            jnp.pad(bm, widths + ((0, 0),)), jnp.pad(cm, widths + ((0, 0),)),
            chunk=chunk, h0=h0[0] if h0 else None)
        return y[:, :s], h_final

    primals = [jnp.asarray(v) for v in (x, dt, a, bm, cm)] + (
        [jnp.asarray(h0)] if state else [])
    _, vjp = jax.vjp(f, *primals)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh) if state
                else jnp.zeros((b, h, n, p), jnp.float32)))

    tx, tdt, ta, tbm, tcm, th0, tdy, tdh = torch_of(arrs)
    if not state:
        th0 = None

    def loss(x, dt, a, bm, cm, h0):
        y, h_final = ops.ssd(x, dt, a, bm, cm, chunk=chunk, h0=h0,
                             return_state=True)
        return (y * tdy).sum() + ((h_final * tdh).sum() if state else 0.0)

    argnums = (0, 1, 2, 3, 4, 5) if state else (0, 1, 2, 3, 4)
    got = torch.func.grad(loss, argnums=argnums)(tx, tdt, ta, tbm, tcm, th0)
    assert_close_to(got, want, JAX_TOL)


# (b, S, H, P, N, chunk, head group) of the kernel-order plain gradient:
# JAX_SHAPES with 2 or 3 heads a group where H allows, padded as ops.ssd
# pads
GEMM_SHAPES = [(2, 64, 3, 32, 16, 32, 3), (1, 100, 2, 32, 16, 32, 2),
               (2, 128, 2, 64, 16, 64, 1), (1, 200, 2, 64, 128, 64, 2),
               (1, 256, 2, 32, 128, 128, 2), (1, 300, 2, 64, 128, 128, 1)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,hg", GEMM_SHAPES)
@pytest.mark.parametrize("state", [False, True])
def test_bwd_gemm_ref_matches_ref_and_jax_vjp(ref, b, s, h, p, n, chunk, hg,
                                              state):
    """``ssd_scan_bwd_gemm_ref`` (the kernel's order of sums: U and Y for
    every head, dCB by head groups, dB and dC one product of depth L + H
    P) against ``ssd_scan_bwd_ref`` (``AUTOGRAD_TOL``: the same terms in
    another order) and ``jax.vjp`` of the reference's ``ssd_chunked_ref``
    (``JAX_TOL``) on the same padded inputs."""
    jax, jnp = ref.jax, ref.jnp
    arrs = ssd_inputs(b, s, h, p, n, seed=s + n + p)
    x, dt, a, bm, cm, h0, dy, dh = torch_of(arrs)
    if not state:
        h0 = dh = None
    xp, dtp, bmp, cmp = ops.pad_to_chunk(chunk, x, dt, bm, cm)
    dyp = ops.pad_to_chunk(chunk, dy, dt, bm, cm)[0]
    kw = dict(chunk=chunk, h0=h0, dh=dh)
    got = ssd_scan_bwd_gemm_ref(xp, dtp, a, bmp, cmp, dyp, head_group=hg,
                                **kw)
    plain = ssd_scan_bwd_ref(xp, dtp, a, bmp, cmp, dyp, **kw)
    assert_close_to(got, [t.numpy() for t in plain], AUTOGRAD_TOL)

    primals = [jnp.asarray(v.numpy()) for v in (xp, dtp, a, bmp, cmp)] + (
        [jnp.asarray(h0.numpy())] if state else [])
    _, vjp = jax.vjp(lambda *v: ref.ref.ssd_chunked_ref(
        *v[:5], chunk=chunk, h0=v[5] if state else None), *primals)
    want = vjp((jnp.asarray(dyp.numpy()), jnp.asarray(dh.numpy()) if state
                else jnp.zeros((b, h, n, p), jnp.float32)))
    names = NAMES if state else NAMES[:5]
    assert_close_to(got, want, JAX_TOL, names=names)


# ------------------------------------------- grad and vmap(grad), ops.ssd

def test_grad_through_ops_ssd_is_the_plain_gradient():
    """``torch.func.grad`` through ``ops.ssd`` (padded S = 100, chunk 32)
    runs ``ssd_scan_bwd_ref`` on the padded inputs, bit for bit, and the
    forward's saved scratch is empty on the CPU."""
    x, dt, a, bm, cm, h0, dy, dh = torch_of(ssd_inputs(2, 100, 2, 16, 8, 9))

    def loss(x, dt, a, bm, cm, h0):
        y, h_final = ops.ssd(x, dt, a, bm, cm, chunk=32, h0=h0,
                             return_state=True)
        return (y * dy).sum() + (h_final * dh).sum()

    got = torch.func.grad(loss, argnums=tuple(range(6)))(x, dt, a, bm, cm,
                                                         h0)
    xp, dtp, bmp, cmp = ops.pad_to_chunk(32, x, dt, bm, cm)
    dyp = ops.pad_to_chunk(32, dy, dt, bm, cm)[0]
    want = ssd_scan_bwd_ref(xp, dtp, a, bmp, cmp, dyp, chunk=32, h0=h0,
                            dh=dh)
    for g, w in zip(got, (want[0][:, :100], want[1][:, :100], want[2],
                          want[3][:, :100], want[4][:, :100], want[5])):
        assert torch.equal(g, w)
    *_, lc, states, cb = SsdScan.apply(xp, dtp, a, bmp, cmp, h0, 32)
    assert [t.shape for t in (lc, states, cb)] == [(2, 0)] * 3


@pytest.mark.parametrize("shared_a", [False, True])
def test_vmap_grad_equals_per_sample_grads(shared_a):
    """``vmap(grad)`` over 3 samples of (x, a), each a batch of 2 (a per
    sample, or one a for all), equals the per-sample ``grad`` bit for bit,
    and the vmapped forward equals the per-sample forwards."""
    samples = [torch_of(ssd_inputs(2, 70, 2, 16, 8, seed=20 + i))
               for i in range(3)]
    xs = torch.stack([s_[0] for s_ in samples])
    as_ = torch.stack([s_[2] for s_ in samples])
    _, dt, a, bm, cm, _, dy, _ = samples[0]

    def loss(a, x):
        y, h_final = ops.ssd(x, dt, a, bm, cm, chunk=32, return_state=True)
        return (y * dy).sum() + h_final.square().sum()

    if shared_a:
        got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                              in_dims=(None, 0))(a, xs)
    else:
        got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(as_, xs)
    for i in range(3):
        ai = a if shared_a else as_[i]
        want = torch.func.grad(loss, argnums=(0, 1))(ai, xs[i])
        assert torch.equal(got[0][i], want[0]) and torch.equal(
            got[1][i], want[1])
    ys = torch.func.vmap(lambda a, x: ops.ssd(x, dt, a, bm, cm, chunk=32))(
        as_, xs)
    for i in range(3):
        assert torch.equal(ys[i], ops.ssd(xs[i], dt, as_[i], bm, cm,
                                          chunk=32))


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("chunk,n,p,want", [
    (128, 128, 64, 221_312),   # mamba2-130m: pass 3's block
    (128, 16, 64, 221_312),    # jamba-v0.1-52b: the same pass-3 block
    (32, 32, 32, 99_328),      # the reduced configs: the GEMM passes' block
    (64, 16, 32, 99_328),
])
def test_bwd_smem_fits_a_block(chunk, n, p, want):
    """Pass 3 holds C B^T (L rows of L + 8), two head buffers of dy and x
    (L rows of P + 4 each), lc and dt, eight arrays of L, 12 rows of L of
    partial sums and 32 floats; the GEMM passes a 32-deep slab of their
    64-row A and 128-row B tiles in hi and lo, two raw stages and 1 KB."""
    assert bwd_smem_bytes(chunk, n, p) == want <= MAX_SMEM_BYTES
    check_kernel_shape(chunk, n, p)


@pytest.mark.parametrize("cols", [32, 64, 128])
def test_bwd_gemm_blocks_fit_two_an_sm(cols):
    """A GEMM pass's block (99,328 B at 128 columns, 512 B of static
    shared memory besides) leaves room for a second on the SM's 228 KB (1
    KB reserved a block)."""
    assert 2 * (bwd_gemm_smem_bytes(cols) + 512 + 1024) <= 228 * 1024


def test_every_kernel_shape_fits():
    for chunk in (32, 64, 128):
        for p in (32, 64):
            for n in (1, 16, 32, 33, 64, 100, 128):
                check_kernel_shape(chunk, n, p)
                assert bwd_smem_bytes(chunk, n, p) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("shape,np_,saved,bwd,hg", [
    # mamba2-130m at 4 x 2048: lc, the states (N = 128), C B^T; dS, U and
    # Y, the 8 head groups' dCB and their sum, the chunks' da shares
    ((4, 2048, 24, 64, 128, 128), 128, 13_828_096, 47_187_456, 3),
    # jamba-v0.1-52b at 4 x 2048 (N = 16 padded to 32 state columns; 16
    # head groups)
    ((4, 2048, 128, 64, 16, 128), 32, 18_874_368, 168_828_928, 8),
])
def test_scratch_at_the_training_shapes(shape, np_, saved, bwd, hg):
    b, s, h, p, n, chunk = shape
    assert saved_shapes(*shape) == ((b, h, s), (b, s // chunk, h, p, np_),
                                    (b, s // chunk, chunk, chunk))
    assert sum(np.prod(sh) for sh in saved_shapes(*shape)) == saved
    assert bwd_work_floats(*shape) == bwd
    assert bwd_head_group(b, s, h, chunk) == hg


@pytest.mark.parametrize("b,s,h,chunk,hg", [
    (4, 2048, 24, 128, 3),     # 512 blocks: 4 heads a block would give 384
    (2, 2048, 128, 128, 8),    # jamba's cut training batch: 512 blocks
    (2, 256, 24, 128, 1),      # too few chunks for any group
    (4, 2048, 7, 128, 1),      # 7 heads: 7 a block would give 64 blocks
])
def test_bwd_head_group(b, s, h, chunk, hg):
    assert bwd_head_group(b, s, h, chunk) == hg
    assert h % hg == 0


@pytest.mark.parametrize("bad", ["dy", "dh", "a_rows", "dtype", "chunk"])
def test_bwd_wrapper_refuses(bad):
    x, dt, a, bm, cm, h0, dy, dh = torch_of(ssd_inputs(2, 64, 2, 16, 8, 1))
    kw = dict(chunk=32, h0=h0, dh=dh)
    if bad == "dy":
        dy = dy[:, :32]
    elif bad == "dh":
        kw["dh"] = dh[:, :1]
    elif bad == "a_rows":
        a = torch.stack([a, a, a])          # 3 rows do not divide b = 2
    elif bad == "dtype":
        dy = dy.double()
    else:
        kw["chunk"] = 48
    with pytest.raises((ValueError, TypeError)):
        ssd_scan_bwd(x, dt, a, bm, cm, dy, **kw)


def test_bwd_wrapper_refuses_other_devices():
    """``meta`` is the dry run's device: the gradients' shapes, nothing
    run, the backward's operations tallied; any other device but the CPU
    and CUDA is refused by name."""
    from repro_torch.kernels import tally
    arrs = [t.to("meta") for t in torch_of(ssd_inputs(1, 32, 2, 16, 8))]
    x, dt, a, bm, cm, _, dy, _ = arrs
    tally.reset()
    grads = ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=32)
    assert [g.shape for g in grads] == [t.shape for t in (x, dt, a, bm, cm)
                                        ] + [(1, 2, 8, 16)]
    assert all(g.device.type == "meta" for g in grads)
    assert tally.read()["ssd_scan_bwd"] == tally.ssd_bwd_flops(1, 32, 2, 16,
                                                               8, 32)
    from test_torch_ssd import Elsewhere
    other = [t.as_subclass(Elsewhere) for t in torch_of(ssd_inputs(
        1, 32, 2, 16, 8))]
    x, dt, a, bm, cm, _, dy, _ = other
    with pytest.raises(ValueError, match="tensors on xpu.*CUDA"):
        ssd_scan_bwd(x, dt, a, bm, cm, dy, chunk=32)


# -------------------------------------------- training through launch.train

def test_train_mamba_step_matches_reference(ref, monkeypatch, tmp_path,
                                            capsys):
    """``launch/train.py --arch mamba2-130m --device cpu``, one SGD step
    (reduced: 2 layers, d_model 64, batch 2 x 16) from the reference's
    ``init_params`` carried across by ``convert.py`` and on seeded numpy
    tokens: its loss and stepped parameters (the checkpoint) against
    ``jax.grad`` of the reference's ``loss_fn``."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch import train
    from repro_torch.models import model as M
    jax, jnp = ref.jax, ref.jnp
    gamma, seq, batch = 0.05, 16, 2
    cfg = get_config("mamba2-130m").reduced(n_layers=2, d_model=64)
    rcfg = ref.configs.get_config("mamba2-130m").reduced(n_layers=2,
                                                         d_model=64)
    rparams = ref.model.init_params(jax.random.PRNGKey(3), rcfg)
    host = jax.tree.map(np.asarray, rparams)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)

    monkeypatch.setattr(M, "init_params", lambda gen, c, device: (
        lm_params_from_jax(host, c, device=device)))
    monkeypatch.setattr(train, "make_token_stream", lambda *a, **k: (
        torch.from_numpy(tok).long(), torch.from_numpy(lab).long()))
    path = tmp_path / "step.npz"
    out = train.main(["--device", "cpu", "--arch", "mamba2-130m", "--steps",
                      "1", "--seq", str(seq), "--batch", str(batch),
                      "--layers", "2", "--d-model", "64", "--gamma",
                      str(gamma), "--checkpoint", str(path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "arch"] == "mamba2-130m-reduced"

    rbatch = ref.model.Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab))
    rloss, rgrads = jax.value_and_grad(
        lambda p: ref.model.loss_fn(p, rbatch, rcfg))(rparams)
    np.testing.assert_allclose(out["loss_first"], float(rloss), rtol=1e-5)
    want = dict(lm_params_from_jax(
        jax.tree.map(lambda w, g: np.asarray(w - gamma * g), rparams, rgrads),
        cfg, device="cpu").named_parameters())
    start = dict(lm_params_from_jax(host, cfg,
                                    device="cpu").named_parameters())
    got = load_pytree(str(path), {k: v.detach() for k, v in start.items()})
    assert set(got) == set(want)
    for name, w in want.items():
        torch.testing.assert_close(got[name], w.detach(), rtol=1e-5,
                                   atol=1e-7)
    moved = max(float((got[k] - start[k]).abs().max()) for k in got)
    assert moved > 0


def test_train_lm_e2e_example_on_cpu(tmp_path, capsys):
    """The example twin at a tiny size: it prints the train JSON line and
    writes its checkpoint."""
    from repro_torch.examples import train_lm_e2e
    path = tmp_path / "e2e.npz"
    out = train_lm_e2e.main(["--device", "cpu", "--steps", "2", "--seq",
                             "32", "--batch", "2", "--layers", "1",
                             "--d-model", "64", "--checkpoint", str(path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "mamba2-130m-reduced" and line["steps"] == 2
    assert line["device"] == "cpu" and all(np.isfinite(out["losses"]))
    with np.load(path) as data:
        leaves = [data[k] for k in data.files]
    assert sum(v.size for v in leaves) == out["params"]
    assert all(np.isfinite(v).all() for v in leaves)
