"""Griffin recurrent block (RecurrentGemma), mirrors
``repro/models/rglru.py``: dual linear branches, causal depthwise conv,
RG-LRU recurrence with block-diagonal gates, GeLU gating.

The full-sequence path runs the RG-LRU through ``kernels.ops.rglru`` (the
CUDA kernel for CUDA tensors). ``rec_prefill`` returns the output and the
decode cache (pre-conv window, final state) from ONE scan; the reference's
``layer_prefill`` runs the scan twice, once for the cache and once for the
output. Decode keeps the reference's plain step and writes the cache IN
PLACE, as the SSM and attention layers do. Each step keeps the reference's
dtypes: the products, the conv and the block gates in the compute dtype,
the scan in fp32, y back in the compute dtype before ``(y * g) @ wo``.

Under tensor parallelism (``tp``, a ``sharding.tp.Region`` whose plan
splits ``rec``) the block runs on this rank's RNN channels, as the
reference's GSPMD splits it by "ffn" (``repro/models/rglru.py:51-61``,
``:76-90``): the input enters by ``copy_to``, ``wx``/``wg`` are column
shards, the conv, the gates (the block-diagonal ``w_ga``/``w_gx`` by RNN
heads, ``a_log`` and the biases cut to the channels) and the scan act on
the local channels alone (the scan is elementwise over the width, so the
kernel runs unchanged on ``[B,S,R/tp]``), ``wo`` is a row shard followed
by ``reduce_from``. The decode cache is then this rank's channels of the
window and the state, which is the storage shard of ``rec_cache_axes``
over "model".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, conv_history
from repro_torch.sharding import tp as TP


def _dims(cfg: ModelConfig):
    R = cfg.rnn_width or cfg.d_model
    nh = cfg.rnn_heads
    assert R % nh == 0
    return R, nh, R // nh


def rec_def(cfg: ModelConfig):
    R, nh, bh = _dims(cfg)
    D = cfg.d_model
    return {
        "wx": ParamDef((D, R), ("embed", "ffn")),
        "wg": ParamDef((D, R), ("embed", "ffn")),
        "conv_w": ParamDef((cfg.rnn_conv, R), (None, "ffn")),
        "a_log": ParamDef((R,), (None,), "ones", scale=0.5),
        "w_ga": ParamDef((nh, bh, bh), ("heads", None, None)),
        "b_ga": ParamDef((R,), (None,), "zeros"),
        "w_gx": ParamDef((nh, bh, bh), ("heads", None, None)),
        "b_gx": ParamDef((R,), (None,), "zeros"),
        "wo": ParamDef((R, D), ("ffn", "embed")),
    }


def _conv_full(u, w):
    """Causal depthwise conv over time, no activation. u: [B,S,R]; w: [K,R]."""
    K = w.shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    return sum(pad[:, j:j + u.shape[1]] * w[j][None, None] for j in range(K))


def _block_gate(u, w, b, nh, bh):
    """u: [..., R]; w: [nh, bh, bh] block-diagonal projection."""
    shp = u.shape
    ub = u.reshape(*shp[:-1], nh, bh)
    g = torch.einsum("...hi,hij->...hj", ub, w.to(u.dtype))
    return g.reshape(shp) + b.to(u.dtype)


def _own_channels(tp):
    """Check that a split block's cache shard is this rank's channels."""
    shard = tp.shard("rec")
    assert (shard.heads_index, shard.heads_count) == (tp.rank, tp.size), \
        (shard, tp.rank, tp.size)


def rec_prefill(cfg: ModelConfig, p, x, *, impl=None, tp=None,
                with_cache=True):
    """x: [B,S,D] -> (y [B,S,D], decode cache {"conv", "h"}, or None
    without ``with_cache``); under ``tp`` on this rank's channels (the
    module's docstring)."""
    _, _, bh = _dims(cfg)
    nh = p["w_ga"].shape[0]                 # this rank's heads under tp
    if tp is not None:
        x = TP.copy_to(x, tp)
    dt = x.dtype
    u = x @ p["wx"].to(dt)
    g = F.gelu(x @ p["wg"].to(dt), approximate="tanh")
    uc = _conv_full(u, p["conv_w"].to(dt))
    ga = _block_gate(uc, p["w_ga"], p["b_ga"], nh, bh)
    gx = _block_gate(uc, p["w_gx"], p["b_gx"], nh, bh)
    y, hT = ops.rglru(uc, p["a_log"], ga, gx, c=cfg.rglru_c, impl=impl)
    out = (y * g) @ p["wo"].to(dt)
    if tp is not None:
        out = TP.reduce_from(out, tp)
    if not with_cache:
        return out, None
    if tp is not None:
        _own_channels(tp)
    # the cache keeps the PRE-conv window, as the reference's prefill does
    return out, {"conv": conv_history(u, cfg.rnn_conv), "h": hT}


def rec_forward(cfg: ModelConfig, p, x, *, impl=None):
    """x: [B,S,D] -> [B,S,D]."""
    return rec_prefill(cfg, p, x, impl=impl)[0]


def rec_cache_def(cfg: ModelConfig, batch, dtype):
    """One layer's cache as meta tensors (shape and dtype, no storage)."""
    R, _, _ = _dims(cfg)
    return {
        "conv": torch.empty((batch, cfg.rnn_conv - 1, R), dtype=dtype,
                            device="meta"),
        "h": torch.empty((batch, R), dtype=torch.float32, device="meta"),
    }


def rec_cache_axes(cfg: ModelConfig):
    return {"conv": ("batch", None, "ffn"), "h": ("batch", "ffn")}


def rec_decode(cfg: ModelConfig, p, x, cache, tp=None):
    """x: [B,1,D] -> (y [B,1,D], cache); the cache is updated in place.
    Under ``tp`` the cache leaves are this rank's channels."""
    _, _, bh = _dims(cfg)
    nh = p["w_ga"].shape[0]
    if tp is not None:
        _own_channels(tp)
    dt = x.dtype
    u = x[:, 0] @ p["wx"].to(dt)
    g = F.gelu(x[:, 0] @ p["wg"].to(dt), approximate="tanh")
    w = p["conv_w"].to(dt)
    hist = torch.cat([cache["conv"], u[:, None]], 1)           # [B,K,R]
    conv = torch.einsum("bkc,kc->bc", hist, w)
    ga = _block_gate(conv, p["w_ga"], p["b_ga"], nh, bh)
    gx = _block_gate(conv, p["w_gx"], p["b_gx"], nh, bh)
    y, h = ops.rglru_decode(cache["h"], conv, p["a_log"], ga, gx,
                            c=cfg.rglru_c)
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    out = ((y * g) @ p["wo"].to(dt))[:, None]
    return (out if tp is None else TP.reduce_from(out, tp)), cache
