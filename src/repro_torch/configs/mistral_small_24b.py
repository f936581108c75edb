"""mistral-small-24b — the paper's own Table-1 serving model
(Mistral Small 3.2 24B Instruct 2506). Not one of the 10 assigned cells;
used by benchmarks/table1.py."""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-small-24b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=32_768, vocab_size=131_072, head_dim=128,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)
