"""gemma-7b [dense]: GeGLU, head_dim=256. [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    layer_pattern=("attn",),
    mlp_kind="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=512, dtype="float32")
