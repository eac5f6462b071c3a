"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 2 shared / 160 routed top-6
experts, first layer dense. [arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA expands to MHA; spec field kept faithful
    head_dim=128,
    d_ff=1536,                 # per-expert hidden
    vocab_size=102_400,
    layer_pattern=("mla",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, num_shared=2, top_k=6, d_ff_expert=1536,
                  first_k_dense=1, d_ff_dense=12288, capacity_factor=1.25),
    mlp_kind="swiglu",
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512, dtype="float32",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_shared=2, top_k=2, d_ff_expert=32,
                      first_k_dense=1, d_ff_dense=128))
