"""deepseek-7b [dense]: llama-architecture. [arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,           # MHA
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    layer_pattern=("attn",),
    mlp_kind="swiglu",
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=160, vocab_size=512, dtype="float32")
