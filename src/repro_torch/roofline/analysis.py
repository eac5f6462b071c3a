"""Roofline terms from dry-run counts, on NVIDIA H100 SXM figures
(mirrors ``repro/roofline/analysis.py``, whose constants are TPU v5e's).

    compute    = FLOPs/dev ÷ peak FLOP/s
    memory     = bytes/dev ÷ HBM bandwidth
    collective = collective_bytes/dev ÷ NVLink bandwidth

The per-device counts come from ``roofline.counter`` (a fake-tensor trace
of one rank's step). MODEL_FLOPS follows the reference: 6·N·D for dense
training, 6·N_active·D for MoE; forward-only shapes use the 2·N·D forward
term; decode adds the attention cache-read term (2·2·L·S·kv_dim per
sequence) since that dominates real decode work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s dense bf16 on the tensor cores
# (1979 with 2:4 sparsity), quoted at 700 W
PEAK_FLOPS = 989e12
# the same sheet: 3.35 TB/s of HBM3 (80 GB)
HBM_BW = 3.35e12
# fp32 outside the tensor cores, the same sheet (67 TFLOP/s); the bounds of
# the fp32 kernels read it
PEAK_F32_FLOPS = 67e12
# NVLink 4: 18 links of 25 GB/s each way, 900 GB/s per GPU counting both
# directions. A rank's collective bytes leave it in one direction, so the
# one-way 450 GB/s is the rate that moves them. Within one 8-GPU node
# (NVSwitch, all to all) that is the rate; a mesh beyond one node crosses
# the NICs (some 50 GB/s per GPU with one 400 Gb/s NIC each), so for the
# 256- and 512-rank production meshes this term is optimistic
NVLINK_BW = 450e9


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float
    useful_ratio: float           # MODEL_FLOPS/chips ÷ FLOPs/dev
    bottleneck: str
    step_s: float                 # max of the three (no-overlap bound)
    roofline_frac: float          # compute_s / step_s (how compute-bound)

    def as_dict(self):
        return dict(self.__dict__)


def analyze(*, flops_per_dev: float, bytes_per_dev: float,
            coll_bytes_per_dev: float, model_flops_total: float,
            n_devices: int) -> Roofline:
    c = flops_per_dev / PEAK_FLOPS
    m = bytes_per_dev / HBM_BW
    k = coll_bytes_per_dev / NVLINK_BW
    terms = {"compute": c, "memory": m, "collective": k}
    bn = max(terms, key=terms.get)
    step = max(c, m, k)
    useful = (model_flops_total / n_devices) / max(flops_per_dev, 1.0)
    return Roofline(compute_s=c, memory_s=m, collective_s=k,
                    model_flops_total=model_flops_total,
                    useful_ratio=useful, bottleneck=bn, step_s=step,
                    roofline_frac=c / step if step > 0 else 0.0)


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------


def _cfg_of(lm_or_cfg):
    return getattr(lm_or_cfg, "cfg", lm_or_cfg)


def count_params(lm_or_cfg) -> Dict[str, float]:
    """Total and active (MoE-discounted) parameter counts of an ``LM`` or a
    ``ModelConfig``, read from ``LM(cfg, device="meta").defs()``: shapes
    only, at any width."""
    from repro_torch.models.layers import flatten_paths
    from repro_torch.models.model import LM
    cfg = _cfg_of(lm_or_cfg)
    total = routed = 0
    for _, leaf in flatten_paths(LM(cfg, device="meta").defs()):
        n = 1
        for s in leaf.shape:
            n *= s
        total += n
        if "experts" in leaf.axes:
            routed += n
    active = total - routed
    if cfg.moe is not None and routed:
        active += routed * cfg.moe.top_k / cfg.moe.num_experts
    return {"total": float(total), "active": float(active)}


def model_flops(lm_or_cfg, shape, counts: Optional[Dict[str, float]] = None
                ) -> float:
    cfg = _cfg_of(lm_or_cfg)
    counts = counts or count_params(cfg)
    n = counts["active"] if cfg.moe is not None else counts["total"]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * B * S
    if shape.kind == "prefill":
        return 2.0 * n * B * S
    # decode: one token per sequence + attention reads over the cache
    flops = 2.0 * n * B
    has_attn = any(k in ("attn", "local", "mla", "xdec")
                   for k in cfg.layer_kinds)
    if has_attn:
        for k in cfg.layer_kinds:
            if k == "local":
                eff, per_head = min(cfg.local_window, S), cfg.head_dim
            elif k in ("attn", "xdec"):
                eff, per_head = S, cfg.head_dim
            elif k == "mla":
                eff = S
                per_head = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            else:
                continue
            flops += 4.0 * B * eff * cfg.num_heads * per_head
    return flops
