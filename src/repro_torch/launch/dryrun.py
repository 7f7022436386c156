"""Multi-pod dry run on the ``meta`` device: every (arch x input shape x
mesh) planned and run for its shapes (twin of ``repro/launch/dryrun.py``).

Run it as its own process: ``python -m repro_torch.launch.dryrun``.
:func:`main` first makes a fake process group of ``REPRO_DRYRUN_DEVICES``
ranks (default 512) in this one process (``torch.distributed``'s "fake"
backend, whose collectives do nothing), the twin of the reference's 512
forced host devices; the meshes are ``DeviceMesh``es over it.

Per combination it:

1. builds the production mesh (16 x 16 single-pod, 2 x 16 x 16 multi-pod)
   or, with ``--debug-mesh``, the 8-device one;
2. builds the model at full size and depth on ``meta`` (no memory) and
   the step's inputs as ``meta`` tensors;
3. plans every leaf (``param_pspecs``; ``batch_pspecs``;
   ``serve_state_pspecs`` for the serving state and outputs;
   ``token_pspec``) and puts each plan through ``distribute_tensor`` on
   the mesh, checking its local shape against the global one over the
   axes' sizes;
4. runs the step once on ``meta`` under ``FlopCounterMode``: an SGD step
   (single pod) or an FL round (multi-pod: ``vmap`` over the pods of
   local SGD, then the paper's weighted aggregation or the bfloat16 delta
   one), a prefill, or a decode step after a short prefill;
5. prints one JSON record with the reference's keys.

The reference lowers and compiles each step through XLA, and its FLOPs,
bytes accessed, collective bytes and memory analysis are XLA's products
for a TPU pod. The port compiles nothing that plans collectives or
buffers, and does not invent them: ``flops`` is ``FlopCounterMode``'s
count of the step's matrix products plus K4's and K5's own counts
(``kernels/tally.py``: the kernels are not torch operators, so the mode
does not see them); ``argument_size_in_bytes`` and
``output_size_in_bytes`` are the busiest device's share of the step's
arguments and outputs under the plan (shards are even, so rank 0's);
``bytes_accessed``, ``collectives``, ``collective_bytes_total``,
``modeled_link_bytes``, ``temp_size_in_bytes`` and
``generated_code_size_in_bytes`` are null. ``--probe-cost`` and
``--exact-cost`` give the same full-depth count (``meta`` runs every
layer at no cost, so there is nothing to probe or unroll); ``--dump-hlo``
is refused, there being no HLO.

Exit code != 0 on any failure: a plan that does not place, or a step
that does not run, is a bug of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.fl.round import (delta_aggregate, make_train_step,
                                  weighted_aggregate)
from repro_torch.kernels import tally
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Batch
from repro_torch.sharding.rules import (PartitionSpec as P, ShardingMode,
                                        axis_size, param_pspecs,
                                        to_placements)

# the reference's keys that are XLA compile products, null here
XLA_ONLY = ("bytes_accessed", "collectives", "collective_bytes_total",
            "modeled_link_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")


class _WholeModel:
    """A stand-in for ``FlopCounterMode``'s module tracker that files every
    count under "Global" and hooks no module."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


class FlopCounter(FlopCounterMode):
    """``FlopCounterMode`` without its per-module breakdown: its tracker's
    module hooks put autograd nodes on each module's inputs, which the
    remat layers' recompute (a ``torch.func.vjp`` inside the backward)
    cannot run through. Only the total is read here."""

    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = _WholeModel()


def init_fake_group(world_size: int | None = None):
    """The process's default group: ``world_size`` fake ranks (default
    ``REPRO_DRYRUN_DEVICES``, else 512), this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if world_size is None:
        world_size = int(os.environ.get("REPRO_DRYRUN_DEVICES", "512"))
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world_size,
                                store=FakeStore())


def make_mesh(multi_pod: bool, debug_mesh: bool):
    make = make_debug_mesh if debug_mesh else make_production_mesh
    return make(multi_pod=multi_pod, device_type="cpu")


# ---------------------------------------------------------------- helpers

def param_shape_tree(cfg: ModelConfig) -> M.LM:
    """The model at full size on ``meta``: shapes, no memory."""
    return M.init_params(torch.Generator(), cfg, device="meta")


def _leaves(tree, specs):
    """(tensor, spec) pairs of two parallel trees (dicts, tuples,
    NamedTuples), skipping None and Python ints."""
    if tree is None or isinstance(tree, int):
        return []
    if torch.is_tensor(tree):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [p for k in tree for p in _leaves(tree[k], specs[k])]
    return [p for t, s in zip(tree, specs, strict=True)
            for p in _leaves(t, s)]


class Placer:
    """Puts plans through ``distribute_tensor`` on one mesh, once for each
    (shape, dtype, spec) seen (the layers repeat theirs), and returns the
    per-device bytes."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = S.mesh_axis_sizes(mesh)
        self.done = {}

    def local_bytes(self, t, spec) -> int:
        spec = P() if spec is None else spec
        key = (tuple(t.shape), t.dtype, tuple(spec))
        if key not in self.done:
            self.done[key] = self._place(t, spec)
        return self.done[key]

    def _place(self, t, spec) -> int:
        from torch.distributed.tensor import distribute_tensor
        if len(spec) > t.ndim:
            raise ValueError(f"a {len(spec)}-entry plan for a {t.ndim}-D "
                             f"tensor {tuple(t.shape)}")
        want = [n // axis_size(e, self.sizes) if e is not None else n
                for n, e in zip(t.shape, tuple(spec) + (None,) * t.ndim)]
        for n, e in zip(t.shape, spec):
            if e is not None and n % axis_size(e, self.sizes):
                raise ValueError(f"{e!r} does not divide {n} of "
                                 f"{tuple(t.shape)}")
        empty = torch.empty(t.shape, dtype=t.dtype, device="meta")
        local = distribute_tensor(empty, self.mesh,
                                  to_placements(spec, self.mesh)).to_local()
        if list(local.shape) != want:
            raise ValueError(f"{tuple(t.shape)} under {spec}: a local "
                             f"{tuple(local.shape)}, want {tuple(want)}")
        return math.prod(want) * t.element_size()

    def tree_bytes(self, tree, specs) -> int:
        return sum(self.local_bytes(t, s) for t, s in _leaves(tree, specs))


def _batch_dims(batch: Batch):
    return Batch(*(None if t is None else 0 for t in batch))


def _index(batch: Batch, s: int) -> Batch:
    return Batch(*(None if t is None else t[s] for t in batch))


# ------------------------------------------------------------- step builders

def build_train(cfg: ModelConfig, case, mesh, mode: ShardingMode,
                fl_clients: int, local_steps: int, gamma: float = 0.01,
                aggregation: str = "paper", remat: bool = False):
    """Single-pod: a plain SGD step. Multi-pod: an FL round across pods.

    aggregation: 'paper' (Algorithm 1 line 7, the float32 weighted
    parameter average) or 'delta_bf16' (the bfloat16 delta aggregation).
    remat: ``remat_layers``, each layer recomputed in the backward.
    Returns (step, args, (arg specs, out specs of the step's output)).
    """
    lm = param_shape_tree(cfg)
    pspecs = param_pspecs(lm, mode, S.mesh_axis_sizes(mesh), cfg=cfg)
    if remat:
        cfg = dataclasses.replace(cfg, remat_layers=True)
    params = dict(lm.named_parameters())

    def loss(p, b):
        return torch.func.functional_call(lm, p, (b, cfg))

    if fl_clients:
        # batch leaves (pods, steps, B / pods, ...), q / selected (pods,)
        inner = S.batch_specs(cfg, case, client_dim=fl_clients)
        batch = Batch(*(None if t is None else torch.empty(
            (fl_clients, local_steps) + tuple(t.shape[1:]), dtype=t.dtype,
            device="meta") for t in inner))
        bspec_inner = S.batch_pspecs(inner, mesh, client_dim=True)
        # the steps dim after the pod dim
        bspecs = Batch(*(None if sp is None else P(sp[0], None, *sp[1:])
                         for sp in bspec_inner))
        agg = delta_aggregate if aggregation == "delta_bf16" \
            else weighted_aggregate

        def step(params, batch, selected, q):
            n = q.shape[0]
            bparams = {k: v.expand(n, *v.shape) for k, v in params.items()}

            def client(p, b):
                for s in range(local_steps):
                    g = torch.func.grad(loss)(p, _index(b, s))
                    p = {k: w - gamma * g[k].to(w.dtype)
                         for k, w in p.items()}
                return p

            updated = torch.func.vmap(client, in_dims=(0, _batch_dims(
                batch)))(bparams, batch)
            return agg(params, updated, selected, q)

        vec = torch.empty((fl_clients,), dtype=torch.float32, device="meta")
        args = (params, batch, vec, vec)
        return step, args, ((pspecs, bspecs, P(), P()), pspecs)

    batch = S.batch_specs(cfg, case)
    bspecs = S.batch_pspecs(batch, mesh)
    train = make_train_step(loss, gamma)
    return train, (params, batch), ((pspecs, bspecs), (pspecs, P()))


def _out_specs(out, cfg, mesh):
    """(logits, ServeState) specs: the state's by ``serve_state_pspecs``,
    the logits by the same shape heuristic."""
    logits, state = out
    sspecs = S.serve_state_pspecs(state, cfg, mesh)
    bp = S.data_axes(mesh)
    lspec = S._state_spec(tuple(logits.shape), False,
                          S.mesh_axis_sizes(mesh),
                          bp if len(bp) > 1 else bp[0])
    return lspec, sspecs


def build_prefill(cfg: ModelConfig, case, mesh, mode: ShardingMode):
    lm = param_shape_tree(cfg)
    pspecs = param_pspecs(lm, mode, S.mesh_axis_sizes(mesh), cfg=cfg)
    batch = S.batch_specs(cfg, case)
    bspecs = S.batch_pspecs(batch, mesh)

    def step(params, batch):
        return M.prefill(lm, batch, cfg, cache_len=case.seq_len)

    return step, (dict(lm.named_parameters()), batch), ((pspecs, bspecs),
                                                       None)


def build_decode(cfg: ModelConfig, case, mesh, mode: ShardingMode):
    """A decode step on the state that a short (8-token) prefill leaves in
    a cache of the case's length (the window where shorter)."""
    lm = param_shape_tree(cfg)
    pspecs = param_pspecs(lm, mode, S.mesh_axis_sizes(mesh), cfg=cfg)
    b = case.global_batch
    cache_len = min(case.seq_len, cfg.sliding_window) \
        if cfg.sliding_window else case.seq_len
    short = S.batch_specs(cfg, dataclasses.replace(case, seq_len=8))
    pb = Batch(tokens=torch.empty((b, 8), dtype=torch.int64, device="meta"),
               media=short.media, frames=short.frames)
    _, state = M.prefill(lm, pb, cfg, cache_len=cache_len)
    sspecs = S.serve_state_pspecs(state, cfg, mesh)
    token = torch.empty((b, 1), dtype=torch.int64, device="meta")
    tspec = S.token_pspec(b, mesh)

    def step(params, token, state):
        return M.decode_step(lm, token, state, cfg)

    return (step, (dict(lm.named_parameters()), token, state),
            ((pspecs, tspec, sspecs), (tspec, sspecs)))


# ---------------------------------------------------------------- runner

def _skip(arch, shape, multi_pod, quiet):
    rec = {"arch": arch, "shape": shape,
           "mesh": "multi" if multi_pod else "single",
           "status": "SKIP(full-attn)"}
    if not quiet:
        print(json.dumps(rec), flush=True)
    return rec


def _case_cfg(arch, attn_bf16, ssd_chunk):
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16",
                              attn_probs_bf16=attn_bf16)
    if ssd_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=ssd_chunk)
    return cfg


def _run(cfg, case, mesh, multi_pod, fsdp, fl_local_steps, aggregation,
         remat):
    """The step's FLOPs by source and its per-device argument and output
    bytes under the plan."""
    mode = ShardingMode(tensor_axis="model",
                        fsdp_axis="data" if fsdp else None)
    if case.kind == "train":
        fl_clients = S.mesh_axis_sizes(mesh)["pod"] if multi_pod else 0
        step, args, (arg_specs, out_specs) = build_train(
            cfg, case, mesh, mode, fl_clients, fl_local_steps,
            aggregation=aggregation, remat=remat)
    elif case.kind == "prefill":
        step, args, (arg_specs, out_specs) = build_prefill(cfg, case, mesh,
                                                           mode)
    else:
        step, args, (arg_specs, out_specs) = build_decode(cfg, case, mesh,
                                                          mode)
    placer = Placer(mesh)
    arg_bytes = placer.tree_bytes(args, arg_specs)
    tally.reset()
    counter = FlopCounter()
    with counter:
        out = step(*args)
    kernel_flops = tally.read()
    if out_specs is None:
        out_specs = _out_specs(out, cfg, mesh)
    out_bytes = placer.tree_bytes(out, out_specs)
    return counter.get_total_flops(), kernel_flops, arg_bytes, out_bytes


def run_case(arch: str, shape: str, multi_pod: bool, *, debug_mesh=False,
             fl_local_steps: int = 1, fsdp: bool = True,
             dump_hlo: str = "", quiet: bool = False,
             exact_cost=False, aggregation: str = "paper",
             remat: bool = False, ssd_chunk: int = 0,
             attn_bf16: bool = False) -> dict:
    if dump_hlo:
        raise ValueError("--dump-hlo: the port compiles no HLO (the dry run "
                         "runs on meta)")
    case = S.INPUT_SHAPES[shape]
    if case.name == "long_500k" and arch not in S.LONG_CONTEXT_ARCHS:
        return _skip(arch, shape, multi_pod, quiet)
    cfg = _case_cfg(arch, attn_bf16, ssd_chunk)
    mesh = make_mesh(multi_pod, debug_mesh)
    matmul, kernels, arg_bytes, out_bytes = _run(
        cfg, case, mesh, multi_pod, fsdp, fl_local_steps, aggregation, remat)
    result = {
        "arch": arch, "shape": shape,
        "mesh": "x".join(map(str, mesh.shape)),
        "exact_cost": exact_cost,
        "variant": {"aggregation": aggregation, "remat": remat,
                    "ssd_chunk": ssd_chunk, "attn_bf16": attn_bf16},
        "status": "OK",
        "flops": float(matmul + sum(kernels.values())),
        "matmul_flops": float(matmul),
        "kernel_flops": {k: float(v) for k, v in kernels.items()},
        "n_devices": mesh.size(),
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        **dict.fromkeys(XLA_ONLY),
    }
    if not quiet:
        print(json.dumps(result), flush=True)
    return result


def probe_case(arch: str, shape: str, multi_pod: bool, *, debug_mesh=False,
               fl_local_steps: int = 1, fsdp: bool = True,
               quiet: bool = False, aggregation: str = "paper",
               remat: bool = False, ssd_chunk: int = 0,
               attn_bf16: bool = False) -> dict:
    """The reference's k / 2k-period probe gives the full-depth cost from
    two shallow compiles; on ``meta`` the full depth runs at no cost, so
    this is :func:`run_case` at full depth, marked as the probe's
    record."""
    rec = run_case(arch, shape, multi_pod, debug_mesh=debug_mesh,
                   fl_local_steps=fl_local_steps, fsdp=fsdp, quiet=True,
                   exact_cost="probe", aggregation=aggregation, remat=remat,
                   ssd_chunk=ssd_chunk, attn_bf16=attn_bf16)
    if rec["status"] == "OK":
        rec["variant"]["remat_layers"] = remat
    if not quiet:
        print(json.dumps(rec), flush=True)
    return rec


def probe_case_seq(arch: str, shape: str, multi_pod: bool = False, *,
                   seqs=None, fsdp: bool = True, fl_local_steps: int = 1,
                   quiet: bool = False, aggregation: str = "paper",
                   remat: bool = False, ssd_chunk: int = 0) -> dict:
    """The reference's sequence-length probe (for scans too long to
    unroll) fits the cost from short sequences; on ``meta`` the target
    length runs directly, on the production mesh: :func:`run_case`."""
    rec = run_case(arch, shape, multi_pod, fl_local_steps=fl_local_steps,
                   fsdp=fsdp, quiet=True, exact_cost="probe-seq",
                   aggregation=aggregation, remat=remat, ssd_chunk=ssd_chunk)
    if not quiet:
        print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=list(S.INPUT_SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--debug-mesh", action="store_true",
                    help="use the 8-device mesh (for tests)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="FL local steps I in the multi-pod train step")
    ap.add_argument("--dump-hlo", default="",
                    help="refused: the port compiles no HLO")
    ap.add_argument("--exact-cost", action="store_true",
                    help="the full-depth count (always, on meta)")
    ap.add_argument("--probe-cost", action="store_true",
                    help="the full-depth count (always, on meta)")
    ap.add_argument("--aggregation", default="paper",
                    choices=["paper", "delta_bf16"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--attn-bf16", action="store_true")
    args = ap.parse_args(argv)
    if args.dump_hlo:
        ap.error("--dump-hlo: the port compiles no HLO; the dry run runs "
                 "the step on meta (flops by FlopCounterMode and the "
                 "kernels' own counts)")

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(S.INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    init_fake_group()

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    if args.probe_cost:
                        probe_case(arch, shape, mp,
                                   debug_mesh=args.debug_mesh,
                                   fl_local_steps=args.local_steps,
                                   fsdp=not args.no_fsdp,
                                   aggregation=args.aggregation,
                                   remat=args.remat,
                                   ssd_chunk=args.ssd_chunk,
                                   attn_bf16=args.attn_bf16)
                    else:
                        run_case(arch, shape, mp, debug_mesh=args.debug_mesh,
                                 fl_local_steps=args.local_steps,
                                 fsdp=not args.no_fsdp,
                                 exact_cost=args.exact_cost,
                                 aggregation=args.aggregation,
                                 remat=args.remat, ssd_chunk=args.ssd_chunk,
                                 attn_bf16=args.attn_bf16)
                except Exception as e:  # noqa: BLE001 — report and fail
                    failures.append((arch, shape, mp, repr(e)))
                    print(json.dumps({"arch": arch, "shape": shape,
                                      "mesh": "multi" if mp else "single",
                                      "status": f"FAIL: {e!r}"}), flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
