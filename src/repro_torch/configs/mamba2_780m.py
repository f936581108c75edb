"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280, head_dim=0,
    ssm_state_size=128, ssm_expand=2, ssm_head_dim=64, ssm_n_groups=1,
    ssm_chunk=256, conv_kernel=4, tie_embeddings=True,
    param_dtype="bfloat16",
)
