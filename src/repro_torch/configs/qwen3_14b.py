"""qwen3-14b — dense GQA with qk-norm.
[hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (family)",
)

REDUCED = CONFIG.replace(
    name="qwen3-14b-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16, remat="none",
)
