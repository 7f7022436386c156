"""Model FLOP utilisation of the train step's backward: its model FLOPs
(``roofline.lm_step_flops`` less ``spans.lm_fwd_flops``: two thirds of
the step's) over the device seconds a step of the operations launched in
the program's ``train_step`` span but in none of its child spans (its
self part; the span stretch, ``spans.lm_train_spans``) times the H100's
float32-accurate peak, 165 TFLOP/s (495 TFLOP/s TF32 over 3, 700 W)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import roofline  # noqa: E402
import spans  # noqa: E402


def read(record, cfg, traffic):
    secs = ((spans.lm_train_spans(record, cfg, traffic) or {})
            .get("device_s", {}).get("train_step"))
    if not secs:
        return None
    shape = (cfg, cfg["num_hidden_layers"], traffic["batch"], traffic["seq"])
    flops = roofline.lm_step_flops(*shape) - spans.lm_fwd_flops(*shape)
    return 100.0 * flops / (secs * roofline.F32_ACCURATE_PEAK)
