"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060] (twin of
``repro/configs/mamba2_130m.py``).

24L d_model=768, attention-free, d_ff=0 (mamba2 blocks carry the channel
mixing), vocab=50280, ssm_state=128. headdim=64, expand=2 per the paper's
released 130m config.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,            # SSD heads = expand*d_model/headdim
    n_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    citation="arXiv:2405.21060 (Transformers are SSMs; mamba2-130m card)",
)
