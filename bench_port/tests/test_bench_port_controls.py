"""The controls on the card: the plain reference in the program's place
computed in TF32 (the precision below the configurations' float32), and
the planted faults (each minibatch's first half alone; the state left
unchanged), each fail one of the cell's numbers under the cell's limits.
Run on the card: ``python -m pytest -m cuda bench_port/tests``."""

import time

import pytest

import controls
import harness


def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


def fails(readings, limits):
    return any(k in limits and not v <= limits[k]
               for k, v in readings.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell,cut,kinds", [
    ("yi6b.train_2k", dict(num_hidden_layers=1),
     ("tf32", "half_batch", "unchanged")),
])
def test_control_and_faults_fail_a_number(cell, cut, kinds):
    torch = card()
    _, cfg, traffic = harness.cell_files(cell)
    ctx = harness.Context(torch=torch, device="cuda", cfg=dict(cfg, **cut),
                          traffic=traffic, seed=987654321012, seconds=0.0,
                          trace=False, start_window=time.perf_counter)
    limits = traffic["limits"]
    out = controls.readings(ctx)
    for kind in kinds:
        assert fails(out[kind], limits), (kind, out[kind])
