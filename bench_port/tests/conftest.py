"""Tiny sizes of the benchmark's cells for CPU tests: the same drivers,
references and checks, shapes a test run can hold."""

import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import harness  # noqa: E402

TINY = {
    "yi6b.train_2k": (
        dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_key_value_heads=2, num_hidden_layers=2, vocab_size=128),
        dict(batch=2, seq=16)),
}


def tiny_context(cell, seed=1234567890123, seconds=0.3, **traffic):
    """A CPU context for ``cell`` cut to a tiny size."""
    import torch
    _, cfg, tr = harness.cell_files(cell)
    cfg_cut, tr_cut = TINY[cell]
    return harness.Context(torch=torch, device="cpu", cfg=dict(cfg, **cfg_cut),
                           traffic=dict(tr, **tr_cut, **traffic), seed=seed,
                           seconds=seconds, trace=False,
                           start_window=time.perf_counter)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
