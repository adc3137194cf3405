"""qwen1.5-32b — dense, near-MHA (kv=40), QKV bias.
[hf:Qwen/Qwen1.5-0.5B family scaling; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B (family)",
)

REDUCED = CONFIG.replace(
    name="qwen1.5-32b-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=192,
    vocab_size=256, head_dim=16, remat="none",
)
