"""internvl2-76b [vlm]: llama3-70b-class language backbone; InternViT
frontend is a stub emitting precomputed patch embeddings per the assignment
spec. [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,            # GQA
    head_dim=128,
    d_ff=28672,
    vocab_size=128_256,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    frontend="vision",
    frontend_tokens=256,       # patch embeddings per image
    rope_theta=500_000.0,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512, frontend_tokens=16, dtype="float32")
