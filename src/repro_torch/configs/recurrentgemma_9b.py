"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2 recurrent : 1
local-attn pattern. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,            # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=("rec", "rec", "local"),
    local_window=2048,
    rnn_width=4096,
    rnn_heads=16,
    mlp_kind="geglu",
    tie_embeddings=True,
    scale_embeddings=True,
    attn_logit_softcap=0.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, rnn_width=64, rnn_heads=4,
        local_window=32, dtype="float32")
