"""Config system: frozen dataclasses + arch registry.

The port's own copy of ``repro.configs`` (plain data, no JAX); the port
imports nothing of ``repro``. Every assigned architecture has a module
``repro_torch.configs.<id>`` exposing ``CONFIG`` (full size) and
``smoke()`` (a reduced config of the same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int                 # routed experts
    num_shared: int                  # shared (always-on) experts
    top_k: int
    d_ff_expert: int                 # per-expert hidden size
    first_k_dense: int = 1           # leading layers use a dense MLP
    d_ff_dense: int = 0              # hidden size of those dense MLPs
    capacity_factor: float = 1.25    # dropping-dispatch capacity
    router_aux_weight: float = 1e-3  # load-balance aux loss weight


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536          # 0 = full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128               # N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64               # P
    chunk_size: int = 256
    ngroups: int = 8


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- layer pattern -----------------------------------------------------
    # One period of mixer kinds, cycled over depth. Kinds:
    #   "attn" (global), "local" (sliding window), "rec" (RG-LRU), "ssm".
    layer_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 0
    # --- attention ----------------------------------------------------------
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0            # partial rotary (stablelm: 0.25)
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    # --- mlp ----------------------------------------------------------------
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu (non-gated)
    # --- families -----------------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- RG-LRU (Griffin) recurrent blocks -----------------------------------
    rnn_width: int = 0               # 0 => d_model
    rnn_heads: int = 16              # block-diagonal gate heads
    rnn_conv: int = 4
    rglru_c: float = 8.0
    encoder_layers: int = 0          # >0 => encoder-decoder
    frontend: str = "none"           # none | audio | vision (stubbed per spec)
    frontend_tokens: int = 256       # frames/patches the stub frontend emits
    # --- misc ----------------------------------------------------------------
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma-style sqrt(d_model) input scaling
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    logits_softcap: float = 0.0
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"
    # --- distribution knobs (overridable per run) ----------------------------
    remat: str = "full"              # none | full | dots_saveable
    scan_layers: bool = True
    pipeline_stages: int = 1
    qkv_constraint: str = "none"     # none | batch  (§Perf hillclimb knob)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind for every layer (pattern cycled over depth)."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def mlp_kind_at(self, layer_idx: int) -> str:
        if self.moe is not None and layer_idx >= self.moe.first_k_dense:
            return "moe"
        return "dense"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way TP."""
        return (self.vocab_size + 255) // 256 * 256


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set; identical for all LM-family archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# Archs whose every layer is full global attention cannot run long_500k
# (see DESIGN.md §4); SSM / hybrid / mostly-local archs run it.
LONG_CONTEXT_ARCHS = ("recurrentgemma-9b", "gemma3-1b", "mamba2-2.7b")


def shape_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "recurrentgemma-9b",
    "deepseek-7b",
    "gemma-7b",
    "stablelm-1.6b",
    "gemma3-1b",
    "seamless-m4t-large-v2",
    "internvl2-76b",
    "deepseek-v2-236b",
    "deepseek-moe-16b",
    "mamba2-2.7b",
)


def _module_for(arch: str):
    mod = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _module_for(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module_for(arch).smoke()
