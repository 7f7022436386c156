"""minicpm-2b — llama-like dense with WSD learning-rate schedule
[arXiv:2404.06395] (twin of ``repro/configs/minicpm_2b.py``).

40L d_model=2304 36H (kv=36 -> full MHA) d_ff=5760 vocab=122753.
The WSD (warmup-stable-decay) schedule is wired via lr_schedule='wsd';
embeddings are tied as in the released model.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    lr_schedule="wsd",
    citation="arXiv:2404.06395 (MiniCPM: unveiling the potential of SLMs)",
)
