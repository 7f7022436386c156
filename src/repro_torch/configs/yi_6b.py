"""yi-6b — llama-arch dense GQA [arXiv:2403.04652] (twin of
``repro/configs/yi_6b.py``).

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5000000.0,
    citation="arXiv:2403.04652 (Yi: open foundation models)",
)
