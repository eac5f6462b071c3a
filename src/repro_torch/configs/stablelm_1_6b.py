"""stablelm-1.6b [dense]: partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100_352,
    layer_pattern=("attn",),
    rope_pct=0.25,
    norm_kind="layernorm",
    mlp_kind="swiglu",
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=160, vocab_size=512, dtype="float32")
