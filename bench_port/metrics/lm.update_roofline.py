"""The SGD update's share of its roofline: its least bytes
(``spans.lm_update_bytes``: 12 B a parameter, float32 weight and
gradient read, weight written) at the H100's 3.35 TB/s over the device
seconds a step of the operations launched inside the program's
``train_step.update`` span (the span stretch, ``spans.lm_train_spans``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import roofline  # noqa: E402
import spans  # noqa: E402


def read(record, cfg, traffic):
    secs = ((spans.lm_train_spans(record, cfg, traffic) or {})
            .get("device_s", {}).get("train_step.update"))
    if not secs:
        return None
    least = spans.lm_update_bytes(cfg, cfg["num_hidden_layers"]) / \
        roofline.HBM_BYTES_PER_S
    return 100.0 * least / secs
