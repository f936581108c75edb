"""whisper-small [audio] — enc-dec, conv frontend stubbed (input_specs()
provides precomputed 1500×80 frame features). [arXiv:2212.04356]
max_position_embeddings honours the assigned decode_32k stress shape (the
real model stops at 448 decoder positions)."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51_865, head_dim=64,
    rope_theta=0.0, norm_eps=1e-5,
    encoder_layers=12, encoder_seq_len=1500, frontend_dim=80,
    max_position_embeddings=32_768,
    param_dtype="bfloat16",
)
