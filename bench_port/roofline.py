"""The yardstick's arithmetic: the H100's peaks, the least time of a K5
call and of its backward, and the model FLOPs behind the MFU metrics.

The kernel bounds are copies of ``chip_smoke.py::flash_bound`` and
``flash_bwd_bound`` (the port's smoke), except that the live (query,
key) pairs are counted here (causal: S (S + 1) / 2 a head) instead of
from the port's mask helper, so nothing of the program is read.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM
# bandwidth, the float32 rate outside the tensor cores, the TF32 tensor
# core rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# A float32-accurate product on the tensor cores costs three TF32
# products (3xTF32): the float32 peak that both MFU metrics divide by.
F32_ACCURATE_PEAK = TF32_OPS_PER_S / 3


def live_pairs(sq: int, sk: int, causal: bool, window=None) -> int:
    """(query, key) pairs a head computes: all Sq Sk, or under a causal
    mask key j <= query i (0-based positions on both sides), within
    ``window`` keys of the query where one is given."""
    if not causal:
        return sq * sk
    total = 0
    for i in range(sq):
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, min(i, sk - 1) - lo + 1)
    return total


def _bound(n_bytes, products, cuda_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * products / TF32_OPS_PER_S * 1e3
    t_cuda = cuda_ops / F32_OPS_PER_S * 1e3
    t = max(t_bytes, t_tc, t_cuda)
    by = ("bytes" if t == t_bytes else
          "tensor-core operations (3xTF32)" if t == t_tc else
          "CUDA-core operations")
    return dict(bound_ms=t, bound_by=by, bytes=n_bytes,
                flops=products + cuda_ops, tensor_core_ms=t_tc,
                cuda_core_ms=t_cuda, bytes_ms=t_bytes)


def flash_bound(bh, sq, sk, d, causal, window, itemsize, kv_group=1):
    """Least time of one K5 call. Bytes: q and o (BH heads) and k and v
    (BH / kv_group heads, unexpanded) read or written once at HBM rate.
    Operations: per live (q, k) pair 2 D for q . k and 2 D for p v, each
    a float32 product that float32-accurate tensor-core work takes as
    three TF32 products; per live pair its max, exp and sum, and per
    output element the scale and the division, on the CUDA cores. The
    bound is the largest of the three times."""
    live = live_pairs(sq, sk, causal, window)
    n_bytes = itemsize * d * (2 * bh * sq + 2 * (bh // kv_group) * sk)
    products = bh * live * 4 * d
    softmax = bh * (live * 3 + 2 * sq * d)
    return _bound(n_bytes, products, softmax)


def flash_bwd_bound(bh, sq, sk, d, causal, window, itemsize, kv_group=1):
    """Least time of one K5-backward call. Bytes: q, o, dO and dq (BH
    heads) and k, v, dk, dv (BH / kv_group) read or written once.
    Operations: per live pair the five products of the gradient (q k^T,
    dO V^T, P^T dO, dS K, dS^T q), 2 D each, in 3xTF32, and its exp,
    subtract and products on the CUDA cores."""
    live = live_pairs(sq, sk, causal, window)
    n_bytes = itemsize * d * (4 * bh * sq + 4 * (bh // kv_group) * sk)
    products = bh * live * 5 * 2 * d
    elementwise = bh * live * 4
    return _bound(n_bytes, products, elementwise)


# ------------------------------------------------------------- model FLOPs

def lm_matmul_params(cfg: dict, n_layers: int) -> int:
    """Weights that multiply every token in a dense GQA decoder with a
    SwiGLU mlp: q, k, v, o, the three mlp matrices per layer, and the
    untied head (the embedding is a lookup)."""
    d, hd = cfg["hidden_size"], cfg["hidden_size"] // cfg[
        "num_attention_heads"]
    q = d * cfg["num_attention_heads"] * hd
    kv = 2 * d * cfg["num_key_value_heads"] * hd
    o = cfg["num_attention_heads"] * hd * d
    mlp = 3 * d * cfg["intermediate_size"]
    return n_layers * (q + kv + o + mlp) + d * cfg["vocab_size"]


def lm_step_flops(cfg: dict, n_layers: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, no
    recompute): 6 per token and matmul weight, and causal attention's
    q k^T and p v at half of S^2 (the live pairs), 4 D a pair and head
    forward, twice that backward."""
    tokens = batch * seq
    dense = 6.0 * tokens * lm_matmul_params(cfg, n_layers)
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    live = seq * (seq + 1) / 2
    attn_fwd = 4.0 * hd * live * cfg["num_attention_heads"] * batch
    return dense + n_layers * 3.0 * attn_fwd
