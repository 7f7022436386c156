"""K5's share of its roofline (``csrc/flash_attention.cu``): the least
time of one call at the cell's shape (``roofline.flash_bound``: 3xTF32
products over the live pairs, bytes once at 3.35 TB/s) over the device
time a launch of its kernels (``flash_attention_prepare_kv``,
``flash_attention_kernel``) in the traced stretch."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402
import roofline  # noqa: E402

SYMBOLS = ("flash_attention_kernel", "flash_attention_prepare_kv",
           "flash_attention_kv_mean")


def read(record, cfg, traffic):
    launches = (record or {}).get("launches", {}).get("flash_attention_bhsd")
    if not launches:
        return None
    _, secs = harness.kernel_seconds(record, *SYMBOLS)
    if secs <= 0:
        return None
    heads = cfg["num_attention_heads"]
    bound = roofline.flash_bound(
        traffic["batch"] * heads, traffic["seq"], traffic["seq"],
        cfg["hidden_size"] // heads, True, None, 4,
        heads // cfg["num_key_value_heads"])["bound_ms"]
    return 100.0 * bound / (secs / launches * 1e3)
