"""deepseek-moe-16b [moe]: fine-grained 2 shared + 64 routed top-6 experts,
first layer dense. [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # per-expert hidden
    vocab_size=102_400,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=64, num_shared=2, top_k=6, d_ff_expert=1408,
                  first_k_dense=1, d_ff_dense=10944, capacity_factor=1.25),
    mlp_kind="swiglu",
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512, dtype="float32",
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_ff_expert=32,
                      first_k_dense=1, d_ff_dense=128))
