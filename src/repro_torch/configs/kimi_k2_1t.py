"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table) [arXiv:2501.kimi2]
(twin of ``repro/configs/kimi_k2_1t.py``).

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8, first layer dense (n_dense_prefix=1). head_dim=128
per the released config (64 heads x 128 > d_model, as in DeepSeek-style
archs). Dense prefix d_ff follows the wide first-layer MLP (18432).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,            # dense prefix layer MLP width
    moe_d_ff=2048,         # per-expert width (the assigned d_ff)
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    n_dense_prefix=1,
    capacity_factor=1.25,
    citation="arXiv:2501.kimi2 (Kimi K2 paper table)",
)
