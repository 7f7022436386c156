"""The span stretch (``spans.py``): its attribution of device operations
to the program's spans on a hand-built trace, the readers of its record,
the step's phase counts at yi-6b's sizes, the LM stretch at a tiny size
on the CPU, and on the card (``python -m pytest -m cuda bench_port/tests``)
at one yi-6b layer: the kernels land in the spans that launched them."""

import time

import pytest

import harness
import roofline
import spans
from conftest import tiny_context

YI = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=4,
          intermediate_size=11008, vocab_size=64000, num_hidden_layers=4)
PEAK = 165e12


def ev(cat, name, ts, dur, tid=1, corr=None):
    """One complete event of a Chrome trace as the profiler writes it."""
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


# One step: the forward launches on the caller's thread, the backward
# from another thread while the caller waits in ``train_step``, the
# update on the caller's thread, and a copy after the step.
STEP = [
    ev("user_annotation", "train_step", 0, 100),
    ev("user_annotation", "train_step.forward", 10, 30),
    ev("user_annotation", "train_step.update", 80, 15),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 1, corr=1),
    ev("kernel", "fwd_gemm", 25, 20, tid=7, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 50, 1, tid=2, corr=2),
    ev("kernel", "bwd_gemm", 50, 25, tid=7, corr=2),
    ev("overhead", "Activity Buffer Request", 76, 10, tid=3),
    ev("cuda_runtime", "cudaLaunchKernel", 85, 1, corr=3),
    ev("kernel", "sgd_update", 86, 4, tid=7, corr=3),
    ev("cuda_runtime", "cudaMemcpyAsync", 110, 1, corr=4),
    ev("gpu_memcpy", "Memcpy DtoD", 111, 1, tid=7, corr=4),
    ev("cpu_op", "aten::mm", 20, 2),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 20, "id": 1},
]


def test_attribution_goes_to_the_launching_span():
    got = {name: span for span, name, _ in spans.attribute(STEP)}
    assert got == {"fwd_gemm": "train_step.forward",
                   "bwd_gemm": "train_step",
                   "sgd_update": "train_step.update",
                   "Memcpy DtoD": "unattributed"}


def test_launch_without_its_runtime_call_is_unattributed():
    events = [ev("user_annotation", "train_step", 0, 100),
              ev("kernel", "orphan", 10, 5, tid=7, corr=9)]
    assert spans.attribute(events) == [("unattributed", "orphan", 5e-6)]


def test_reduce_self_seconds_and_named_gaps():
    out = spans.reduce(STEP, steps=1)
    assert out["device_s"] == pytest.approx(
        {"train_step.forward": 20e-6, "train_step": 25e-6,
         "train_step.update": 4e-6, "unattributed": 1e-6})
    assert out["host_s"] == pytest.approx(
        {"train_step": 55e-6, "train_step.forward": 30e-6,
         "train_step.update": 15e-6})
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["ops"]["train_step"] == [["bwd_gemm", 1, pytest.approx(25e-6)]]
    assert [[n, pytest.approx(s)] for n, s in out["idle_gaps"]] == [
        ["train_step.forward: host between runtime calls", 25e-6],
        ["host between runtime calls", 21e-6],
        ["train_step.update: Activity Buffer Request", 11e-6],
        ["train_step: host between runtime calls", 5e-6]]
    two = spans.reduce(STEP + [dict(e, ts=e["ts"] + 200) for e in STEP],
                       steps=2)
    assert two["device_s"] == pytest.approx(out["device_s"])
    assert two["host_s"] == pytest.approx(out["host_s"])


@pytest.mark.parametrize("batch,seq,fwd_tflop", [(4, 2048, 16.18),
                                                 (2, 4096, 16.73)])
def test_phase_counts_at_yi_sizes(batch, seq, fwd_tflop):
    fwd = spans.lm_fwd_flops(YI, 4, batch, seq)
    assert fwd / 1e12 == pytest.approx(fwd_tflop, abs=0.01)
    assert fwd == pytest.approx(roofline.lm_step_flops(YI, 4, batch, seq)
                                / 3, rel=1e-12)
    assert spans.lm_update_bytes(YI, 4) == 12 * 1_216_385_024


def _record(**device_s):
    return {"spans": {"device_s": device_s}}


@pytest.mark.parametrize("metric,device_s,want", [
    ("lm.fwd_mfu", {"train_step.forward": 0.4},
     100 * 16.1840e12 / (0.4 * PEAK)),
    ("lm.bwd_mfu", {"train_step": 0.6}, 100 * 32.3680e12 / (0.6 * PEAK)),
    ("lm.update_roofline", {"train_step.update": 0.01},
     100 * 14.596620288e9 / 3.35e12 / 0.01),
])
def test_readers_on_known_seconds(metric, device_s, want):
    _, cfg, traffic = harness.cell_files("yi6b.train_2k")
    reader = harness.load_module("metrics", metric)
    assert reader.read(_record(**device_s), cfg, traffic) == \
        pytest.approx(want, rel=1e-4)
    assert reader.read(_record(unattributed=1.0), cfg, traffic) is None
    assert reader.read({"busy_s": 1.0}, cfg, traffic) is None
    assert reader.read(None, cfg, traffic) is None


def test_lm_stretch_on_the_cpu_finds_the_step_spans():
    from repro_torch import obs
    out = spans.lm_stretch(tiny_context("yi6b.train_2k"))
    assert set(out["host_s"]) == {"train_step", "train_step.forward",
                                  "train_step.update"}
    assert all(v > 0 for v in out["host_s"].values())
    assert out["device_s"] == {} and out["busy_s"] == 0
    assert out["steps"] == spans.STEPS and out["plain_s"] > 0
    assert not obs.enabled()


@pytest.mark.cuda
def test_span_stretch_on_the_card_at_one_yi_layer():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, cfg, traffic = harness.cell_files("yi6b.train_2k")
    ctx = harness.Context(torch=torch, device="cuda",
                          cfg=dict(cfg, num_hidden_layers=1),
                          traffic=traffic, seed=876543210987, seconds=0.0,
                          trace=True, start_window=time.perf_counter)
    out = spans.lm_stretch(ctx)

    def launches(span, symbol):
        return sum(c for name, c, _ in out["ops"].get(span, [])
                   if symbol in name)

    for symbol, home in (("flash_attention_kernel", "train_step.forward"),
                         ("flash_bwd_dkdv", "train_step"),
                         ("flash_bwd_dq", "train_step")):
        assert launches(home, symbol) == spans.STEPS, (symbol, out["ops"])
        assert all(launches(s, symbol) == 0 for s in out["ops"]
                   if s != home), (symbol, out["ops"])
    dev, busy = out["device_s"], out["busy_s"]
    assert dev.get("unattributed", 0.0) < 0.01 * busy, dev
    phases = sum(dev[k] for k in ("train_step.forward", "train_step",
                                  "train_step.update"))
    assert abs(phases - busy) <= 0.02 * busy, (dev, busy)
