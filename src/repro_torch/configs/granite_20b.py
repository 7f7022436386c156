"""granite-20b — llama-arch dense code model, MQA (kv=1) [arXiv:2405.04324]
(twin of ``repro/configs/granite_20b.py``).

52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    citation="arXiv:2405.04324 (Granite Code Models)",
)
