"""mamba2-2.7b [ssm]: attention-free, SSD (state-space duality) mixer.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=80,              # d_inner / head_dim (informational)
    num_kv_heads=80,
    head_dim=64,
    d_ff=0,                    # no MLP sublayer
    vocab_size=50_280,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk_size=256, ngroups=1),
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        vocab_size=512, dtype="float32",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=32, ngroups=1))
