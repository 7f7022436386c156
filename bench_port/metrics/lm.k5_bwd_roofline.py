"""K5 backward's share of its roofline (``csrc/flash_attention_bwd.cu``):
the least time of one call at the cell's shape
(``roofline.flash_bwd_bound``: five 3xTF32 products over the live pairs,
bytes once at 3.35 TB/s) over the device time a launch of its kernels
(``flash_bwd_prepare``, ``flash_bwd_dkdv``, ``flash_bwd_dq``, and the
dead-row pass where it runs) in the traced stretch."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402
import roofline  # noqa: E402


def read(record, cfg, traffic):
    launches = (record or {}).get("launches", {}).get("flash_attention_bwd")
    if not launches:
        return None
    _, secs = harness.kernel_seconds(record, "flash_bwd_")
    if secs <= 0:
        return None
    heads = cfg["num_attention_heads"]
    bound = roofline.flash_bwd_bound(
        traffic["batch"] * heads, traffic["seq"], traffic["seq"],
        cfg["hidden_size"] // heads, True, None, 4,
        heads // cfg["num_key_value_heads"])["bound_ms"]
    return 100.0 * bound / (secs / launches * 1e3)
