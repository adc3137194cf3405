"""deepseek-v3-671b — MLA attention, 1 shared + 256 routed top-8 MoE, MTP.
First 3 layers use a dense FFN (width 18432) per the paper.
opt_state_dtype bf16 is the reference's choice for its sharded training.
[arXiv:2412.19437; hf]"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                      # dense layers' FFN width
    vocab_size=129280,
    head_dim=128,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        first_moe_layer=3,
        d_ff_dense=18432,
        capacity_factor=1.25,
        routed_scaling_factor=2.5,
        score_func="sigmoid",
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    opt_state_dtype="bfloat16",
    source="arXiv:2412.19437",
)

REDUCED = CONFIG.replace(
    name="deepseek-v3-671b-reduced",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=192,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, d_ff_shared=64, first_moe_layer=1,
                  d_ff_dense=192, capacity_factor=2.0,
                  routed_scaling_factor=2.5, score_func="sigmoid"),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    mtp_depth=1,
    opt_state_dtype="float32",
    remat="none",
)
