"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2; paper-table]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163_840, head_dim=128,
    rope_theta=1_000_000.0,
    num_experts=384, num_experts_per_tok=8, moe_d_ff=2048,
    num_shared_experts=1,
    param_dtype="bfloat16",
)
