"""llama-3.2-vision-11b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision] (twin of
``repro/configs/llama32_vision_11b.py``).

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; every 5th layer is
a cross-attention layer over vision embeddings. Vision frontend (ViT +
projector) is STUBBED per the assignment carve-out: input_specs provides
precomputed patch embeddings (B, 1601, d_model) — one CLS + 40x40 patches.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_media_tokens=1601,
    citation="hf:meta-llama/Llama-3.2-11B-Vision (model card)",
)
