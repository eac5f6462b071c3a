"""seamless-m4t-large-v2 [audio]: encoder-decoder backbone; the speech
frontend is a stub emitting precomputed frame embeddings per the assignment
spec. [arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    layer_pattern=("attn",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    frontend="audio",
    frontend_tokens=4096,      # encoder frames per sample (overridden by shape)
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        frontend_tokens=32, dtype="float32")
