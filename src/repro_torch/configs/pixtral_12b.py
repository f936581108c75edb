"""pixtral-12b [vlm] — pixtral-ViT (stub) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409] The frontend is a patch-embedding stub:
prefill takes precomputed (B, num_patches, 1024) ViT outputs; the backbone
owns only the multimodal projection."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14_336, vocab_size=131_072, head_dim=128,
    rope_theta=1_000_000.0,
    num_patches=1024, frontend_dim=1024,
    param_dtype="bfloat16",
)
