"""seamless-m4t-large-v2 — encoder-decoder, multimodal (audio)
[arXiv:2308.11596] (twin of ``repro/configs/seamless_m4t_v2.py``).

24L d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. Encoder-decoder:
24 encoder layers over stub frame embeddings (the mel-spectrogram +
conformer feature extractor is STUBBED per the assignment carve-out;
input_specs provides precomputed frames (B, S_enc, d_model)) and 24
decoder layers with per-layer cross-attention, vocab 256206 (NLLB).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    encoder_seq=4096,       # stub frame count for full-size shapes
    citation="arXiv:2308.11596 (SeamlessM4T)",
)
