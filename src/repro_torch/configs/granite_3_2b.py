"""granite-3-2b — dense GQA decoder.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    head_dim=64,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)

REDUCED = CONFIG.replace(
    name="granite-3-2b-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat="none",
)
