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

Under tensor parallelism (``tp``, a ``sharding.tp.Region`` whose plan
splits ``ssm``) the block runs on this rank's SSD heads, as the
reference's GSPMD splits it by "ffn": the input enters by ``copy_to``;
``in_proj``'s compute copy holds this rank's z, x and dt columns and
every B and C column (``ngroups`` groups shared by all heads), and
``conv_w``'s its x channels and B and C (``section_index``); ``dt_bias``,
``A_log``, ``D`` and ``norm`` are cut to its heads; the SSD runs on
``[B,S,H/tp,P]`` with B and C whole; the gated norm's mean over the whole
``d_inner`` sums its squares over the ranks (``tp.sum_over``, whose
backward sums too); ``out_proj`` is a row shard followed by
``reduce_from``. The decode state is this rank's heads, its storage shard
over "model". The conv window is stored on the flat ``conv_dim``
channels (``ssm_cache_axes``), whose shard over "model" cuts across the
x, B and C sections: the prefill and each decode step all-gather the x
parts (and a decode step the stored window) and write back this rank's
flat slice (``tp.shard("ssm.conv")``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, conv_history
from repro_torch.sharding import tp as TP


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


def _split(cfg, zxbcdt, tp=None):
    """``in_proj``'s output (under ``tp`` this rank's sections) -> z, xBC,
    dt and (s, d_inner, H, gn), the widths local under ``tp``."""
    s, d_inner, H, _ = _dims(cfg)
    if tp is not None:
        d_inner, H = d_inner // tp.size, H // tp.size
    gn = s.ngroups * s.d_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, xBC, dt, (s, d_inner, H, gn)


def section_index(cfg: ModelConfig, leaf: str, rank: int, size: int):
    """The columns of ``in_proj`` ([z | x | B | C | dt]) or ``conv_w`` ([x |
    B | C]) that rank ``rank`` of ``size`` computes with: its heads' z, x
    and dt, and every B and C column, in that order (a LongTensor)."""
    s, d_inner, H, _ = _dims(cfg)
    gn2 = 2 * s.ngroups * s.d_state
    d, h = d_inner // size, H // size

    def cols(start, n):
        return torch.arange(start, start + n)
    x_bc = torch.cat([cols(rank * d, d), cols(d_inner, gn2)])  # conv_w's
    if leaf == "conv_w":
        return x_bc
    if leaf != "in_proj":
        raise ValueError(leaf)
    return torch.cat([cols(rank * d, d), x_bc + d_inner,
                      cols(2 * d_inner + gn2 + rank * h, h)])


def _conv_full(xBC, w):
    """Causal depthwise conv over time. xBC: [B,S,C]; w: [K,C]."""
    K = w.shape[0]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    y = sum(pad[:, j:j + xBC.shape[1]] * w[j][None, None] for j in range(K))
    return F.silu(y)


def _gated_norm(y, z, scale, eps, tp=None, width=None):
    """RMSNorm of ``y * silu(z)`` over its last dim; under ``tp`` that dim
    is this rank's channels of ``width`` in all, and the sum of squares
    is summed over the ranks (in fp32, its gradient summed too)."""
    yf = (y * F.silu(z)).float()
    if tp is None:
        ms = yf.square().mean(-1, keepdim=True)
    else:
        ms = TP.sum_over(yf.square().sum(-1, keepdim=True), tp) / width
    o = yf * torch.rsqrt(ms + eps)
    return (o * (1.0 + scale.float())).to(y.dtype)


def _flat_rows(cfg, rows, tp):
    """Rows of this rank's conv sections [..., d_inner/tp + 2gn] -> the
    rows over the whole flat ``conv_dim`` (every rank's x part
    all-gathered, B and C this rank's, which all share)."""
    d = _dims(cfg)[1] // tp.size
    x = TP.all_gather(rows[..., :d].contiguous(), tp.group, -1)
    return torch.cat([x, rows[..., d:]], -1)


def _own_slice(t, shard):
    """This shard's slice of the last dim of ``t`` (its flat channels)."""
    n = t.shape[-1] // shard.heads_count
    return t[..., shard.heads_index * n:(shard.heads_index + 1) * n]


def _own_heads(tp):
    """Check that the state's cache shard is this rank's heads and the
    conv window's a slice of ``tp.size`` (``conv_dim`` divides as the
    heads do); -> the window's shard."""
    h, conv = tp.shard("ssm"), tp.shard("ssm.conv")
    assert (h.heads_index, h.heads_count) == (tp.rank, tp.size), h
    assert conv.heads_count == tp.size, conv
    return conv


def ssm_prefill(cfg: ModelConfig, p, x, *, impl=None, tp=None,
                with_cache=True):
    """x: [B,S,D] -> (y [B,S,D], decode cache {"conv", "h"}, or None
    without ``with_cache``); under ``tp`` on this rank's heads (the
    module's docstring)."""
    B, S, _ = x.shape
    dt_ = x.dtype
    if tp is not None:
        x = TP.copy_to(x, tp)
    z, xBC, dt, (s, d_inner, H, gn) = _split(
        cfg, x @ p["in_proj"].to(dt_), tp)
    xc = _conv_full(xBC, p["conv_w"].to(dt_))
    xs = xc[..., :d_inner].reshape(B, S, H, s.head_dim)
    Bm = xc[..., d_inner:d_inner + gn].reshape(B, S, s.ngroups, s.d_state)
    Cm = xc[..., d_inner + gn:].reshape(B, S, s.ngroups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    y, hT = ops.ssd(xs, dt, p["A_log"], Bm, Cm, D=p["D"],
                    chunk=s.chunk_size, impl=impl)
    y = _gated_norm(y.reshape(B, S, d_inner), z, p["norm"], cfg.norm_eps,
                    tp, _dims(cfg)[1])
    out = y @ p["out_proj"].to(dt_)
    if tp is not None:
        out = TP.reduce_from(out, tp)
    if not with_cache:
        return out, None
    conv = conv_history(xBC, s.d_conv)
    if tp is not None:
        conv = _own_slice(_flat_rows(cfg, conv, tp),
                          _own_heads(tp)).contiguous()
    return out, {"conv": conv, "h": hT}


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


def _window(cfg, stored, row, tp):
    """The whole flat conv window [B,K,conv_dim] of a split decode step:
    this rank's stored slice [B,K-1,conv_dim/tp] and the new row of its
    sections [B,d_inner/tp + 2gn]; every rank's slice and x part come in
    one all-gather."""
    B, K1, c = stored.shape
    d = _dims(cfg)[1] // tp.size
    mine = torch.cat([stored.reshape(B, K1 * c), row[:, :d]], -1)
    every = TP.all_gather(mine, tp.group, -1).reshape(B, tp.size, -1)
    stored = every[..., :K1 * c].reshape(B, tp.size, K1, c).transpose(1, 2)
    x = every[..., K1 * c:].reshape(B, tp.size * d)
    new = torch.cat([x, row[:, d:]], -1)
    return torch.cat([stored.reshape(B, K1, tp.size * c), new[:, None]], 1)


def ssm_decode(cfg: ModelConfig, p, x, cache, tp=None):
    """x: [B,1,D] -> (y [B,1,D], cache); the cache is updated in place.
    Under ``tp`` the state is this rank's heads and the conv window its
    flat slice (the module's docstring)."""
    B = x.shape[0]
    dt_ = x.dtype
    z, xBC, dt, (s, d_inner, H, gn) = _split(
        cfg, x[:, 0] @ p["in_proj"].to(dt_), tp)
    # conv over (stored window ++ new input)
    w = p["conv_w"].to(dt_)
    if tp is None:
        hist = torch.cat([cache["conv"], xBC[:, None]], 1)    # [B,K,C]
        stored = hist[:, 1:]
    else:
        whole = _window(cfg, cache["conv"], xBC, tp)
        stored = _own_slice(whole[:, 1:], _own_heads(tp))
        hist = torch.cat([whole[..., tp.rank * d_inner:
                                (tp.rank + 1) * d_inner],
                          whole[..., _dims(cfg)[1]:]], -1)
    conv = F.silu(torch.einsum("bkc,kc->bc", hist, w))
    xs = conv[..., :d_inner].reshape(B, H, s.head_dim)
    Bm = conv[..., d_inner:d_inner + gn].reshape(B, s.ngroups, s.d_state)
    Cm = conv[..., d_inner + gn:].reshape(B, s.ngroups, s.d_state)
    dtv = F.softplus(dt.float() + p["dt_bias"].float())
    y, h = ops.ssd_decode(cache["h"], xs, dtv, p["A_log"], Bm, Cm, D=p["D"])
    y = _gated_norm(y.reshape(B, 1, d_inner), z[:, None], p["norm"],
                    cfg.norm_eps, tp, _dims(cfg)[1])
    cache["conv"].copy_(stored)
    cache["h"].copy_(h)
    out = y @ p["out_proj"].to(dt_)
    return (out if tp is None else TP.reduce_from(out, tp)), cache
