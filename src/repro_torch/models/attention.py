"""GQA/MQA attention mixers, global (``"attn"``), sliding-window
(``"local"``) and the encoder's bidirectional ``"enc"``, DeepSeek-V2's
Multi-head Latent Attention (``"mla"``), and the encoder-decoder's
cross-attention (mirrors ``repro/models/attention.py``).

Full-sequence paths (prefill) route through ``repro_torch.kernels.ops``,
with ``cfg.local_window`` as the window of ``"local"`` layers; decode
writes the new token's k/v into the cache IN PLACE (the reference returns
a new cache), which saves a copy of the whole KV cache per step. A local
layer's cache is a ring of ``W = min(local_window, capacity)`` slots:
position p lives in slot ``p % W``, and ``slot_pos`` records which
position each slot holds (-1 for none).
MLA's prefill runs the shared flash kernel at head dim ``qk_nope +
qk_rope`` (192 at deepseek-v2's widths) with v zero-padded to it, and
keeps the compressed ``ckv``/``kpe`` rows as its cache; its decode is the
reference's absorbed-matmul attention over that cache, plain torch in
fp32.
Cross-attention projects the encoder output to k/v once per prefill
(``xattn_kv``) and keeps them in the decoder's cache as ``xk``/``xv``;
its full-sequence path is ``ops.attention(causal=False)``, the flash
kernel on CUDA tensors, and its decode reads the cached k/v without a
write.
The reference's sharding ``constrain`` calls and ``qkv_constraint`` have no
counterpart on one card and are left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, apply_rope


def attn_def(cfg: ModelConfig):
    D = cfg.d_model
    d = {
        "wq": ParamDef((D, cfg.q_dim), ("embed", "heads")),
        "wk": ParamDef((D, cfg.kv_dim), ("embed", "heads")),
        "wv": ParamDef((D, cfg.kv_dim), ("embed", "heads")),
        "wo": ParamDef((cfg.q_dim, D), ("heads", "embed")),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef((cfg.head_dim,), ("norm",), "zeros")
        d["k_norm"] = ParamDef((cfg.head_dim,), ("norm",), "zeros")
    return d


def _rms_head(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _qkv(cfg: ModelConfig, p, x, positions, rope=True):
    dt = x.dtype
    B, S, _ = x.shape
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Kh, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Kh, hd)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    return q, k, v


def _window(cfg: ModelConfig, kind):
    return cfg.local_window if kind == "local" else 0


def attn_core(cfg: ModelConfig, p, q, k, v, *, kind="attn", causal=True,
              impl=None):
    """Attention over projected q/k/v and the output projection -> [B,S,D]."""
    B, S = q.shape[:2]
    o = ops.attention(q, k, v, causal=causal, window=_window(cfg, kind),
                      softcap=cfg.attn_logit_softcap, impl=impl)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(q.dtype)


def attn_forward(cfg: ModelConfig, p, x, positions, *, kind="attn",
                 causal=True, impl=None):
    """x: [B,S,D]; positions: [B,S] absolute. Returns [B,S,D]."""
    q, k, v = _qkv(cfg, p, x, positions)
    return attn_core(cfg, p, q, k, v, kind=kind, causal=causal, impl=impl)


def _ring(cfg: ModelConfig, capacity):
    return min(cfg.local_window, capacity)


def attn_cache_def(cfg: ModelConfig, kind, batch, capacity, dtype):
    """One layer's cache as meta tensors (shape and dtype, no storage)."""
    S = _ring(cfg, capacity) if kind == "local" else capacity
    shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    d = {"k": torch.empty(shape, dtype=dtype, device="meta"),
         "v": torch.empty(shape, dtype=dtype, device="meta")}
    if kind == "local":
        d["slot_pos"] = torch.empty((batch, S), dtype=torch.int32,
                                    device="meta")
    return d


def _write_at(cache, new, idx):
    """cache: [B,S,...]; new: [B,1,...]; idx: [B]. Writes row b at
    ``idx[b]`` in place. Like ``jax.lax.dynamic_update_slice`` the index is
    clamped to [0, S-1]: an idle engine slot whose length has run past the
    capacity writes its last row instead of raising."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long().clamp(0, cache.shape[1] - 1)] = new[:, 0].to(
        cache.dtype)
    return cache


def attn_decode(cfg: ModelConfig, p, x, cache, positions, *, kind="attn"):
    """x: [B,1,D]; positions: [B] index of the new token. -> (y, cache)."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, positions[:, None])
    slot_pos = None
    if kind == "local":
        slot = positions % cache["k"].shape[1]
        _write_at(cache["slot_pos"], positions[:, None], slot)
        slot_pos = cache["slot_pos"]
    else:
        slot = positions
    _write_at(cache["k"], k, slot)
    _write_at(cache["v"], v, slot)
    o = ops.attention_decode(q, cache["k"], cache["v"], positions + 1,
                             window=_window(cfg, kind),
                             softcap=cfg.attn_logit_softcap,
                             slot_positions=slot_pos)
    y = o.reshape(B, 1, cfg.q_dim) @ p["wo"].to(x.dtype)
    return y, cache


def attn_prefill_cache(cfg: ModelConfig, k, v, capacity, *, kind="attn"):
    """Build a decode cache from a full prefix's k/v [B,S,Kh,hd] at
    positions 0..S-1 (the reference recomputes them from x; the port reuses
    the prefill's). A local layer keeps the last W positions at their ring
    slots: slot s holds the largest p <= S-1 with p % W == s, or zeros and
    ``slot_pos`` -1 where that p would be negative."""
    B, S, Kh, hd = k.shape
    if kind == "local":
        W = _ring(cfg, capacity)
        last = S - 1
        s = torch.arange(W, device=k.device)
        pos = last - torch.remainder(last - s, W)               # [W]
        ok = pos >= 0
        src = pos.clamp(0, S - 1)
        keep = ok[None, :, None, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        return {"k": torch.where(keep, k[:, src], zero),
                "v": torch.where(keep, v[:, src], zero),
                "slot_pos": torch.where(ok, pos, -1).to(torch.int32)
                .expand(B, W).contiguous()}
    pad = torch.zeros((B, capacity - S, Kh, hd), dtype=k.dtype,
                      device=k.device)
    return {"k": torch.cat([k, pad], 1), "v": torch.cat([v, pad], 1)}


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_def(cfg: ModelConfig):
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    d = {}
    if m.q_lora_rank:
        d["wq_a"] = ParamDef((D, m.q_lora_rank), ("embed", "lora"))
        d["q_norm"] = ParamDef((m.q_lora_rank,), ("norm",), "zeros")
        d["wq_b"] = ParamDef((m.q_lora_rank, H * qk_head), ("lora", "heads"))
    else:
        d["wq"] = ParamDef((D, H * qk_head), ("embed", "heads"))
    d["wkv_a"] = ParamDef((D, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", "lora"))
    d["kv_norm"] = ParamDef((m.kv_lora_rank,), ("norm",), "zeros")
    d["wkv_b"] = ParamDef((m.kv_lora_rank,
                           H * (m.qk_nope_head_dim + m.v_head_dim)),
                          ("lora", "heads"))
    d["wo"] = ParamDef((H * m.v_head_dim, D), ("heads", "embed"))
    return d


def _mla_q(cfg: ModelConfig, p, x, positions):
    """-> (q_nope [B,S,H,nope], q_pe [B,S,H,rope] with RoPE)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = x.dtype
    if m.q_lora_rank:
        qa = _rms_head(x @ p["wq_a"].to(dt), p["q_norm"], cfg.norm_eps)
        q = (qa @ p["wq_b"].to(dt)).reshape(B, S, H, qk_head)
    else:
        q = (x @ p["wq"].to(dt)).reshape(B, S, H, qk_head)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_pe, positions, 1.0, cfg.rope_theta)


def _mla_ckv(cfg: ModelConfig, p, x, positions):
    """-> (c [B,S,kv_lora] normed, kpe [B,S,rope] with RoPE): the rows the
    decode cache keeps."""
    m = cfg.mla
    ckv = x @ p["wkv_a"].to(x.dtype)
    c, kpe = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = _rms_head(c, p["kv_norm"], cfg.norm_eps)
    kpe = apply_rope(kpe[..., None, :], positions, 1.0,
                     cfg.rope_theta)[..., 0, :]
    return c, kpe


def mla_prefill(cfg: ModelConfig, p, x, positions, *, capacity=None,
                impl=None):
    """x: [B,S,D] -> (y [B,S,D], the decode cache or None). RoPE on the
    rope part of q and k only, the rope key shared by every head; v
    zero-padded to ``qk_head`` for the flash call (scale ``qk_head**-0.5``)
    and the output sliced back to ``v_head_dim``. With ``capacity`` the
    same ``c``/``kpe`` also fill the cache (the reference computes them
    twice)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dt = x.dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_nope, q_pe = _mla_q(cfg, p, x, positions)
    c, kpe = _mla_ckv(cfg, p, x, positions)
    kv = (c @ p["wkv_b"].to(dt)).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, kpe[:, :, None].expand(q_pe.shape)], -1)
    vp = F.pad(v, (0, qk_head - m.v_head_dim))
    o = ops.attention(q, k, vp, causal=True, scale=qk_head ** -0.5,
                      impl=impl)[..., :m.v_head_dim]
    y = o.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(dt)
    cache = (mla_prefill_cache(c, kpe, capacity)
             if capacity is not None else None)
    return y, cache


def mla_forward(cfg: ModelConfig, p, x, positions, *, impl=None):
    return mla_prefill(cfg, p, x, positions, impl=impl)[0]


def mla_cache_def(cfg: ModelConfig, batch, capacity, dtype):
    m = cfg.mla
    return {"ckv": torch.empty((batch, capacity, m.kv_lora_rank),
                               dtype=dtype, device="meta"),
            "kpe": torch.empty((batch, capacity, m.qk_rope_head_dim),
                               dtype=dtype, device="meta")}


def mla_prefill_cache(c, kpe, capacity):
    """A decode cache from a prefix's ``c`` [B,S,kv_lora] and ``kpe``
    [B,S,rope] at positions 0..S-1, zero rows after them."""
    B, S, _ = c.shape

    def padded(t):
        pad = torch.zeros((B, capacity - S, t.shape[-1]), dtype=t.dtype,
                          device=t.device)
        return torch.cat([t, pad], 1)
    return {"ckv": padded(c), "kpe": padded(kpe)}


def mla_decode(cfg: ModelConfig, p, x, cache, positions):
    """Absorbed-matmul decode over the compressed cache, in fp32 as the
    reference computes it. x: [B,1,D]; positions: [B]. The new token's
    ``c``/``kpe`` are written into the cache in place."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    dt = x.dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_nope, q_pe = _mla_q(cfg, p, x, positions[:, None])        # [B,1,H,*]
    c, kpe = _mla_ckv(cfg, p, x, positions[:, None])
    _write_at(cache["ckv"], c, positions)
    _write_at(cache["kpe"], kpe, positions)
    wkv_b = p["wkv_b"].to(dt).reshape(
        m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    w_k = wkv_b[..., :m.qk_nope_head_dim]                      # [L,H,nope]
    w_v = wkv_b[..., m.qk_nope_head_dim:]                      # [L,H,v]
    q_eff = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], w_k)    # [B,H,L]
    ckv = cache["ckv"].float()
    S = ckv.shape[1]
    sc = (torch.einsum("bhl,bsl->bhs", q_eff.float(), ckv) +
          torch.einsum("bhr,bsr->bhs", q_pe[:, 0].float(),
                       cache["kpe"].float())) * qk_head ** -0.5
    valid = torch.arange(S, device=x.device)[None] < (positions + 1)[:, None]
    sc = torch.where(valid[:, None], sc, torch.full_like(sc, -1e30))
    ctx = torch.einsum("bhs,bsl->bhl", torch.softmax(sc, dim=-1), ckv)
    o = torch.einsum("bhl,lhv->bhv", ctx, w_v.float())
    y = o.reshape(B, 1, H * m.v_head_dim).to(dt) @ p["wo"].to(dt)
    return y, cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def xattn_def(cfg: ModelConfig):
    D = cfg.d_model
    return {
        "wq": ParamDef((D, cfg.q_dim), ("embed", "heads")),
        "wk": ParamDef((D, cfg.kv_dim), ("embed", "heads")),
        "wv": ParamDef((D, cfg.kv_dim), ("embed", "heads")),
        "wo": ParamDef((cfg.q_dim, D), ("heads", "embed")),
    }


def xattn_kv(cfg: ModelConfig, p, enc_out):
    """The encoder output [B,Se,D] as cross k, v [B,Se,Kh,hd] (no RoPE)."""
    B, Se, _ = enc_out.shape
    dt = enc_out.dtype
    k = (enc_out @ p["wk"].to(dt)).reshape(B, Se, cfg.num_kv_heads,
                                           cfg.head_dim)
    v = (enc_out @ p["wv"].to(dt)).reshape(B, Se, cfg.num_kv_heads,
                                           cfg.head_dim)
    return k, v


def xattn_forward(cfg: ModelConfig, p, x, k, v, *, impl=None):
    """x: [B,S,D] over the encoder's k, v: every query sees every frame."""
    B, S, _ = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.num_heads, cfg.head_dim)
    o = ops.attention(q, k, v, causal=False, impl=impl)
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(dt)


def xattn_decode(cfg: ModelConfig, p, x, cache):
    """Cross-attention decode over the cached encoder k/v (no cache write)."""
    B = x.shape[0]
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    Se = cache["xk"].shape[1]
    lengths = torch.full((B,), Se, dtype=torch.int32, device=x.device)
    o = ops.attention_decode(q, cache["xk"], cache["xv"], lengths)
    return o.reshape(B, 1, cfg.q_dim) @ p["wo"].to(dt)
