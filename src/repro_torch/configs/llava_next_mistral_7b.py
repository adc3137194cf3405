"""llava-next-mistral-7b — mistral-7b backbone + vision-prefix stub.
The anyres tiling / CLIP tower is upstream of this system: the batches
carry precomputed patch embeddings (already projected to d_model).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    vision=VisionStubConfig(num_patches=2880),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

REDUCED = CONFIG.replace(
    name="llava-next-mistral-7b-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    vision=VisionStubConfig(num_patches=16),
    remat="none",
)
