"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2. [arXiv:2402.19427]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12_288, vocab_size=256_000, head_dim=256,
    rope_theta=10_000.0,
    block_pattern=("rec", "rec", "attn"), attn_window=2048,
    rnn_width=4096, conv_kernel=4,
    param_dtype="bfloat16",
)
