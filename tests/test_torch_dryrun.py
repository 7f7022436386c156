"""The port's dry run (``python -m repro_torch.launch.dryrun``), the mirror
of ``tests/test_dryrun_small.py``: each call in a subprocess, since the
dry run makes its fake process group of ``REPRO_DRYRUN_DEVICES`` ranks
(8 here, for the debug meshes) and a process has one default group.

The records keep the reference's keys; the XLA compile products
(collectives, bytes accessed, temporaries, code size) are null. ``flops``
is counted, not compiled: ``FlopCounterMode``'s matrix products plus K4's
and K5's own counts, so it is checked against a hand count of yi-6b's
prefill (2 x the matmul parameters x the tokens, the head on each
sequence's last token only, plus K5 at each layer) within 1%, and
``--remat`` against the same train step without it: the layers' forward
once more (their matmuls and K5's forward).
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.kernels import tally

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = dict(os.environ)
    env["REPRO_DRYRUN_DEVICES"] = "8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)


def _records(out):
    assert out.returncode == 0, out.stdout + out.stderr
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


XLA_ONLY = ("bytes_accessed", "collectives", "collective_bytes_total",
            "modeled_link_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")


def test_dryrun_single_and_multi_pod_mamba2():
    lines = _records(_run(["--arch", "mamba2-130m", "--shape", "decode_32k",
                           "--mesh", "both", "--debug-mesh"]))
    assert {rec["mesh"] for rec in lines} == {"2x4", "2x2x2"}
    for rec in lines:
        assert rec["status"] == "OK" and rec["n_devices"] == 8
        assert rec["flops"] > 0
        assert rec["argument_size_in_bytes"] > rec["output_size_in_bytes"] > 0
        assert all(rec[k] is None for k in XLA_ONLY)


def test_dryrun_fl_train_multipod_moe():
    """The multi-pod FL round (vmap over the pods of local SGD, then the
    weighted aggregation) runs for an MoE id; the delta aggregation too."""
    for agg in ("paper", "delta_bf16"):
        rec = _records(_run(["--arch", "mixtral-8x22b", "--shape",
                             "train_4k", "--mesh", "multi", "--debug-mesh",
                             "--aggregation", agg]))[-1]
        assert rec["status"] == "OK" and rec["mesh"] == "2x2x2"
        assert rec["variant"]["aggregation"] == agg
        assert rec["kernel_flops"]["flash_attention_bwd"] > 0
        assert rec["flops"] > rec["matmul_flops"] > 0


def test_dryrun_long_context_skip_policy():
    out = _run(["--arch", "yi-6b", "--shape", "long_500k", "--mesh",
                "single", "--debug-mesh"])
    rec = _records(out)[-1]
    assert rec["status"].startswith("SKIP")


def test_dryrun_refuses_dump_hlo():
    out = _run(["--arch", "yi-6b", "--shape", "decode_32k", "--debug-mesh",
                "--dump-hlo", "x.hlo"])
    assert out.returncode == 2 and "no HLO" in out.stderr


def _matmul_params(cfg):
    """yi-6b's matrices: per layer wq, wk, wv, wo and the SwiGLU's three;
    the untied head."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    return cfg.n_layers * (attn + 3 * d * cfg.d_ff), d * cfg.vocab_size


def test_dense_prefill_flops_match_a_hand_count():
    cfg = get_config("yi-6b")
    assert not cfg.tie_embeddings
    rec = _records(_run(["--arch", "yi-6b", "--shape", "prefill_32k",
                         "--debug-mesh"]))[-1]
    b, s = 32, 32768
    layers, head = _matmul_params(cfg)
    attention = cfg.n_layers * tally.flash_flops(
        b * cfg.n_heads, s, s, cfg.resolved_head_dim, True, None)
    want = 2 * layers * b * s + 2 * head * b + attention
    assert rec["kernel_flops"]["flash_attention_bhsd"] == attention
    assert abs(rec["flops"] - want) <= 0.01 * want, (rec["flops"], want)


def test_remat_adds_the_layers_forward():
    cfg = get_config("yi-6b")
    base, remat = (_records(_run(["--arch", "yi-6b", "--shape", "train_4k",
                                  "--debug-mesh", *extra]))[-1]
                   for extra in ((), ("--remat",)))
    assert remat["variant"]["remat"] and not base["variant"]["remat"]
    b, s = 256, 4096
    layers, _ = _matmul_params(cfg)
    fwd = base["kernel_flops"]["flash_attention_bhsd"]
    assert remat["kernel_flops"]["flash_attention_bhsd"] == 2 * fwd
    assert (remat["kernel_flops"]["flash_attention_bwd"]
            == base["kernel_flops"]["flash_attention_bwd"])
    want = 2 * layers * b * s + fwd
    got = remat["flops"] - base["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)


@pytest.mark.parametrize("flag", ["--probe-cost", "--exact-cost"])
def test_cost_flags_give_the_full_depth_count(flag):
    plain, probed = (_records(_run(["--arch", "jamba-v0.1-52b", "--shape",
                                    "decode_32k", "--debug-mesh",
                                    *extra]))[-1]
                     for extra in ((), (flag,)))
    assert probed["flops"] == plain["flops"] > 0
    assert probed["exact_cost"] == ("probe" if flag == "--probe-cost"
                                    else True)
