"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]
(twin of ``repro/configs/mixtral_8x22b.py``).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
SWA window 4096 (the Mixtral family's sliding window) — which is what lets
this arch run the 500k-context decode shape with a rolling cache.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1000000.0,
    citation="arXiv:2401.04088 (Mixtral of Experts)",
)
