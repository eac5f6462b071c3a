"""gemma3-1b [dense]: 5 local : 1 global attention, MQA, 128k-class context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,            # MQA
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    local_window=512,
    qk_norm=True,
    mlp_kind="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    rope_theta=1_000_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, local_window=32, dtype="float32")
