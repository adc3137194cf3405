"""llama4-scout-17b-16e — MoE 16 experts top-1 + shared expert, early fusion.
Early-fusion multimodality is stubbed the same way as llava (prefix embeds).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,                        # dense-path FFN width
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
        capacity_factor=1.25,
        score_func="sigmoid",
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

REDUCED = CONFIG.replace(
    name="llama4-scout-17b-a16e-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128,
                  num_shared_experts=1, d_ff_shared=128,
                  capacity_factor=2.0, score_func="sigmoid"),
    remat="none",
)
