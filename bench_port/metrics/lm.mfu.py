"""Model FLOP utilisation of the traced training steps: 6 FLOPs per
token and matmul weight (the head included, the embedding a lookup) and
causal attention at half of S^2, no recompute, over the seconds the
same steps took untraced just before the stretch, times the H100's
float32-accurate peak, 495 TFLOP/s TF32 over 3 (3xTF32) = 165 TFLOP/s
at the 700 W limit."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import roofline  # noqa: E402


def read(record, cfg, traffic):
    if not record or not record.get("steps") or not record.get("plain_s"):
        return None
    flops = record["steps"] * roofline.lm_step_flops(
        cfg, cfg["num_hidden_layers"], traffic["batch"], traffic["seq"])
    return 100.0 * flops / (record["plain_s"] * roofline.F32_ACCURATE_PEAK)
