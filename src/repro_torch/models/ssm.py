"""Mamba-2 block (SSD mixer), mirrors ``repro/models/ssm.py``: in_proj ->
causal depthwise conv -> SSD -> gated RMSNorm -> out_proj.

The full-sequence path runs the chunked SSD through ``kernels.ops.ssd`` (the
CUDA kernel for CUDA tensors). ``ssm_prefill`` returns the output and the
decode cache (conv window, SSD state) from ONE SSD pass; the reference runs
the SSD twice in prefill, once for the cache and once for the output. Decode
keeps the reference's plain step and writes the cache IN PLACE, as the
attention layers write their k/v rows. Each step keeps the reference's
dtypes: matrices and the conv in the compute dtype, dt, the SSD and the
norm in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, conv_history


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return s, d_inner, H, conv_dim


def ssm_def(cfg: ModelConfig):
    s, d_inner, H, conv_dim = _dims(cfg)
    D = cfg.d_model
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.d_state + H
    return {
        "in_proj": ParamDef((D, d_in_proj), ("embed", "ffn")),
        "conv_w": ParamDef((s.d_conv, conv_dim), (None, "ffn"), scale=1.0),
        "dt_bias": ParamDef((H,), (None,), "zeros"),
        "A_log": ParamDef((H,), (None,), "zeros"),
        "D": ParamDef((H,), (None,), "ones"),
        "norm": ParamDef((d_inner,), ("norm",), "zeros"),
        "out_proj": ParamDef((d_inner, D), ("ffn", "embed")),
    }


def _split(cfg, zxbcdt):
    s, d_inner, H, conv_dim = _dims(cfg)
    gn = s.ngroups * s.d_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xBC, dt, (s, d_inner, H, gn)


def _conv_full(xBC, w):
    """Causal depthwise conv over time. xBC: [B,S,C]; w: [K,C]."""
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    y = sum(pad[:, j:j + xBC.shape[1]] * w[j][None, None] for j in range(K))
    return F.silu(y)


def _gated_norm(y, z, scale, eps):
    yf = (y * F.silu(z)).float()
    o = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    return (o * (1.0 + scale.float())).to(y.dtype)


def ssm_prefill(cfg: ModelConfig, p, x, *, impl=None):
    """x: [B,S,D] -> (y [B,S,D], decode cache {"conv", "h"})."""
    B, S, _ = x.shape
    dt_ = x.dtype
    z, xBC, dt, (s, d_inner, H, gn) = _split(cfg,
                                            x @ p["in_proj"].to(dt_))
    xc = _conv_full(xBC, p["conv_w"].to(dt_))
    xs = xc[..., :d_inner].reshape(B, S, H, s.head_dim)
    Bm = xc[..., d_inner:d_inner + gn].reshape(B, S, s.ngroups, s.d_state)
    Cm = xc[..., d_inner + gn:].reshape(B, S, s.ngroups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    y, hT = ops.ssd(xs, dt, p["A_log"], Bm, Cm, D=p["D"],
                    chunk=s.chunk_size, impl=impl)
    y = _gated_norm(y.reshape(B, S, d_inner), z, p["norm"], cfg.norm_eps)
    cache = {"conv": conv_history(xBC, s.d_conv), "h": hT}
    return y @ p["out_proj"].to(dt_), cache


def ssm_forward(cfg: ModelConfig, p, x, *, impl=None):
    """x: [B,S,D] -> [B,S,D]."""
    return ssm_prefill(cfg, p, x, impl=impl)[0]


def ssm_cache_def(cfg: ModelConfig, batch, dtype):
    """One layer's cache as meta tensors (shape and dtype, no storage)."""
    s, d_inner, H, conv_dim = _dims(cfg)
    return {
        "conv": torch.empty((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device="meta"),
        "h": torch.empty((batch, H, s.head_dim, s.d_state),
                         dtype=torch.float32, device="meta"),
    }


def ssm_cache_axes(cfg: ModelConfig):
    return {"conv": ("batch", None, "ffn"),
            "h": ("batch", "heads", None, None)}


def ssm_decode(cfg: ModelConfig, p, x, cache):
    """x: [B,1,D] -> (y [B,1,D], cache); the cache is updated in place."""
    B = x.shape[0]
    dt_ = x.dtype
    z, xBC, dt, (s, d_inner, H, gn) = _split(
        cfg, x[:, 0] @ p["in_proj"].to(dt_))
    # conv over (stored window ++ new input)
    w = p["conv_w"].to(dt_)
    hist = torch.cat([cache["conv"], xBC[:, None]], 1)        # [B,K,C]
    conv = F.silu(torch.einsum("bkc,kc->bc", hist, w))
    xs = conv[..., :d_inner].reshape(B, H, s.head_dim)
    Bm = conv[..., d_inner:d_inner + gn].reshape(B, s.ngroups, s.d_state)
    Cm = conv[..., d_inner + gn:].reshape(B, s.ngroups, s.d_state)
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    y, h = ops.ssd_decode(cache["h"], xs, dtv, p["A_log"], Bm, Cm, D=p["D"])
    y = _gated_norm(y.reshape(B, 1, d_inner), z[:, None], p["norm"],
                    cfg.norm_eps)
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return y @ p["out_proj"].to(dt_), cache
