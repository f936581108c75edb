"""minicpm-2b [dense] — WSD schedule (arch=llama-like). [arXiv:2404.06395]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122_753, head_dim=64,
    rope_theta=10_000.0, tie_embeddings=True,
    param_dtype="bfloat16",
)
