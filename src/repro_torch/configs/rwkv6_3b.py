"""rwkv6-3b (Finch) — attention-free, data-dependent decay linear attention.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,                     # 2560 / head_dim 64
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=128),
    source="arXiv:2404.05892",
)

REDUCED = CONFIG.replace(
    name="rwkv6-3b-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    ssm=SSMConfig(state_dim=16, head_dim=16, chunk_size=32),
    remat="none",
)
