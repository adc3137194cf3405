"""zamba2-2.7b — hybrid: Mamba2 trunk + shared full-attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
    hybrid=HybridConfig(attn_every=6, shared_attn=True, num_shared_blocks=2),
    source="arXiv:2411.15242",
)

REDUCED = CONFIG.replace(
    name="zamba2-2.7b-reduced",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=32),
    hybrid=HybridConfig(attn_every=2, shared_attn=True, num_shared_blocks=2),
    remat="none",
)
