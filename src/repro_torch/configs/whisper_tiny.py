"""whisper-tiny — encoder-decoder; the conv/mel frontend is a STUB (the
batches carry precomputed frame embeddings at d_model).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,                     # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    encdec=EncDecConfig(num_encoder_layers=4, num_frames=1500),
    source="arXiv:2212.04356",
)

REDUCED = CONFIG.replace(
    name="whisper-tiny-reduced",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    encdec=EncDecConfig(num_encoder_layers=2, num_frames=32),
    remat="none",
)
