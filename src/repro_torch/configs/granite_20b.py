"""granite-20b — dense MQA (kv=1), llama-arch code model.
[arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    source="arXiv:2405.04324",
)

REDUCED = CONFIG.replace(
    name="granite-20b-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
    vocab_size=256, head_dim=16, remat="none",
)
