"""Model FLOP utilisation of the train step's forward: its model FLOPs
(``spans.lm_fwd_flops``: 2 per token and matmul weight, causal attention
at the live pairs; a third of the step's) over the device seconds a step
of the operations launched inside the program's ``train_step.forward``
span (the span stretch, ``spans.lm_train_spans``) times the H100's
float32-accurate peak, 165 TFLOP/s (495 TFLOP/s TF32 over 3, 700 W)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import roofline  # noqa: E402
import spans  # noqa: E402


def read(record, cfg, traffic):
    secs = ((spans.lm_train_spans(record, cfg, traffic) or {})
            .get("device_s", {}).get("train_step.forward"))
    if not secs:
        return None
    flops = spans.lm_fwd_flops(cfg, cfg["num_hidden_layers"],
                               traffic["batch"], traffic["seq"])
    return 100.0 * flops / (secs * roofline.F32_ACCURATE_PEAK)
