"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887]
(twin of ``repro/configs/jamba_v01_52b.py``).

32L d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536,
MoE 16 experts top-2 on every other layer; one attention layer per 8
(attn_offset=4 matches the released layout).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,          # jamba uses mamba(-1) d_state=16
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    citation="arXiv:2403.19887 (Jamba: hybrid Transformer-Mamba)",
)
