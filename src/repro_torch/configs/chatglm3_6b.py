"""chatglm3-6b — dense, GQA kv=2, 2d (half-dimension) RoPE
[arXiv:2406.12793] (twin of ``repro/configs/chatglm3_6b.py``).

28L d_model=4096 32H kv=2 d_ff=13696 vocab=65024. partial_rotary=0.5
implements the ChatGLM family's rotary-on-half-dims convention.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    partial_rotary=0.5,
    citation="arXiv:2406.12793 (ChatGLM family; chatglm3-6b card)",
)
