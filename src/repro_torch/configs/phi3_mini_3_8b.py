"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA(kv=32). [arXiv:2404.14219]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32_064, head_dim=96,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)
