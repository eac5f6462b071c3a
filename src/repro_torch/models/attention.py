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
The reference's sharding ``constrain`` calls and ``qkv_constraint`` have
no counterpart: on a mesh the train step computes ``attn``/``local``
attention (and the encoder-decoder's ``enc`` and ``xdec`` self-attention
the same way) on this rank's heads (``tp``, a ``sharding.tp.Region``): ``x``
enters by ``copy_to``, ``wq`` (and ``wk``/``wv`` where the kv heads split)
are column shards, ``wo`` a row shard followed by ``reduce_from``. Where
the kv heads do not split, wk/wv are gathered and each rank projects only
the kv heads its q heads read (``_local_heads``). Serving on a mesh does
the same, and its decode cache stays at the reference's storage spec,
this rank's ``tp.CacheShard`` (``partition.cache_layout``): the prefill
keeps the slots of its slice of the capacity (or ring) and its kv heads;
the decode writes the new token's k/v on the rank that owns its slot, and
attends over its shard alone, the partial softmax combined over the
sequence's axes (``tp.combine_partial``). Where the cache holds every kv
head but the compute splits them, the new k/v are all-gathered over the
model axis (or, where the kv heads are gathered, projected whole), so that
a leaf replicated over the axis stays equal on every rank; where the cache
holds every kv head over a slice of the sequence, q is all-gathered over
the axis, every head attends, and each rank keeps its own heads for its
row shard of ``wo``. MLA splits the same way by heads (``wq_b`` or
``wq``, ``wkv_b`` and ``wo``): its ``wq_a``, ``q_norm``, ``wkv_a`` and
``kv_norm`` act ahead of the split on gathered weights, so the region
starts after them (``copy_to`` on the normed q LoRA ``qa``, or on x without
one, and on ``c`` and ``kpe``), and their gradients come out whole. Its
cache has no heads dim: the sequence is split, this rank's slice of the
capacity's positions kept at the prefill, the new row written by the rank
that owns its slot, and the decode, 4b's MQA case, scores every head
against the local rows (``q_eff``/``q_pe`` all-gathered), combines the
partial softmax over the sequence's axes and keeps this rank's heads for
``w_v`` and ``wo``. The cross-attention splits by heads as attention
does: q from ``copy_to`` of the decoder's normed x, the k/v of the kv
heads its q heads read from the encoder output (which the model takes into
the region once, ahead of the decoder), the flash kernel non-causal on the
local heads, this rank's rows of ``wo`` and ``reduce_from``. Its cache
``xk``/``xv`` is kept at its storage spec (``tp.shard("cross")``): the kv
heads over the model axis and, where the batch leaves "data" free, the
frames over it, whose partial softmax the decode combines.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, apply_rope
from repro_torch.sharding import tp as TP


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


def _local_heads(cfg: ModelConfig, p, tp):
    """This rank's heads under tensor parallelism -> (q heads, kv heads,
    wk, wv, per-q-head kv index or None). Local q head ``i`` of rank ``r``
    is global head ``r*H/tp + i`` and reads kv head ``(r*H/tp + i) //
    (H/Kh)``. Split kv heads are the local shards of wk/wv; gathered ones
    are projected from the columns of the kv heads this rank reads, and
    where those do not pair with the local q heads in equal groups, taken
    once per q head (index)."""
    hd, Hl = cfg.head_dim, cfg.num_heads // tp.size
    if tp.plan.kv:
        return Hl, cfg.num_kv_heads // tp.size, p["wk"], p["wv"], None
    lo, n, index = _kv_heads(cfg, tp)
    cols = slice(lo * hd, (lo + n) * hd)
    return Hl, n, p["wk"][:, cols], p["wv"][:, cols], index


def _kv_heads(cfg: ModelConfig, tp):
    """The kv heads this rank's q heads read: (first, count, per-q-head
    index into them or None where they pair in equal groups)."""
    H, Kh = cfg.num_heads, cfg.num_kv_heads
    Hl = H // tp.size
    first, G = tp.rank * Hl, H // Kh
    kv = [(first + i) // G for i in range(Hl)]
    lo, n = kv[0], kv[-1] + 1 - kv[0]
    if Hl % n == 0 and kv == [lo + i // (Hl // n) for i in range(Hl)]:
        return lo, n, None
    return lo, n, [h - lo for h in kv]


def _qkv(cfg: ModelConfig, p, x, positions, rope=True, tp=None):
    """-> q [B,S,H,hd], k, v [B,S,Kh,hd]; under ``tp`` this rank's heads."""
    dt = x.dtype
    B, S, _ = x.shape
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wk, wv, index = p["wk"], p["wv"], None
    if tp is not None:
        x = TP.copy_to(x, tp)
        H, Kh, wk, wv, index = _local_heads(cfg, p, tp)
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = (x @ wk.to(dt)).reshape(B, S, Kh, hd)
    v = (x @ wv.to(dt)).reshape(B, S, Kh, hd)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_norm"], cfg.norm_eps)
        k = _rms_head(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    if index is not None:
        k, v = k[:, :, index], v[:, :, index]
    return q, k, v


def _kv_whole(cfg: ModelConfig, p, x, positions):
    """k, v [B,S,Kh,hd] of every kv head from the whole ``wk``/``wv``."""
    dt = x.dtype
    B, S, _ = x.shape
    Kh, hd = cfg.num_kv_heads, cfg.head_dim
    k = (x @ p["wk"].to(dt)).reshape(B, S, Kh, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Kh, hd)
    if cfg.qk_norm:
        k = _rms_head(k, p["k_norm"], cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    return k, v


def cache_kv(k, v, tp, shard, whole):
    """The k, v of the kv heads this rank's cache shard holds, from its
    compute's (``_qkv`` or ``xattn_kv`` under ``tp``): these where the
    cache splits the kv heads as the compute does, every kv head
    all-gathered over the model axis where the compute splits them and the
    cache does not, else ``whole()``, projected from the whole
    ``wk``/``wv`` this rank holds (its compute's are a subset, or copies
    per q head)."""
    if shard.heads_count > 1:
        assert tp.plan.kv and shard.heads_count == tp.size, (shard, tp.plan)
        return k, v
    if tp.plan.kv:
        return TP.all_gather(k, tp.group, 2), TP.all_gather(v, tp.group, 2)
    return whole()


def _window(cfg: ModelConfig, kind):
    return cfg.local_window if kind == "local" else 0


def attn_core(cfg: ModelConfig, p, q, k, v, *, kind="attn", causal=True,
              impl=None, tp=None):
    """Attention over projected q/k/v and the output projection -> [B,S,D];
    under ``tp`` this rank's heads, summed over the axis."""
    B, S, H, hd = q.shape
    o = ops.attention(q, k, v, causal=causal, window=_window(cfg, kind),
                      softcap=cfg.attn_logit_softcap, impl=impl)
    y = o.reshape(B, S, H * hd) @ p["wo"].to(q.dtype)
    return y if tp is None else TP.reduce_from(y, tp)


def attn_forward(cfg: ModelConfig, p, x, positions, *, kind="attn",
                 causal=True, impl=None, tp=None):
    """x: [B,S,D]; positions: [B,S] absolute. Returns [B,S,D]."""
    q, k, v = _qkv(cfg, p, x, positions, tp=tp)
    return attn_core(cfg, p, q, k, v, kind=kind, causal=causal, impl=impl,
                     tp=tp)


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


def attn_cache_axes(cfg: ModelConfig, kind):
    """Logical axes of ``attn_cache_def``'s entries (the reference's):
    KV-head-rich caches shard heads over TP; MQA caches shard the sequence
    dim over whatever mesh axes remain."""
    if cfg.num_kv_heads % 8 == 0:
        kv = ("batch", "seq_data", "heads", None)
    else:
        kv = ("batch", "seq_kv", None, None)
    d = {"k": kv, "v": kv}
    if kind == "local":
        d["slot_pos"] = (kv[0], kv[1])
    return d


def mla_cache_axes(cfg: ModelConfig):
    return {"ckv": ("batch", "seq_kv", None),
            "kpe": ("batch", "seq_kv", None)}


def _write_at(cache, new, idx):
    """cache: [B,S,...]; new: [B,1,...]; idx: [B]. Writes row b at
    ``idx[b]`` in place. Like ``jax.lax.dynamic_update_slice`` the index is
    clamped to [0, S-1]: an idle engine slot whose length has run past the
    capacity writes its last row instead of raising."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.long().clamp(0, cache.shape[1] - 1)] = new[:, 0].to(
        cache.dtype)
    return cache


def _write_own(cache, new, idx):
    """``_write_at`` of the rows whose ``idx`` lies in [0, S): the slots
    this rank's shard owns (``idx`` counted from its first slot); the other
    rows are left as they are, with no host sync."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    i = idx.long().clamp(0, S - 1)
    own = ((idx >= 0) & (idx < S)).reshape((B,) + (1,) * (cache.dim() - 2))
    cache[rows, i] = torch.where(own, new[:, 0].to(cache.dtype),
                                 cache[rows, i])
    return cache


def attn_decode(cfg: ModelConfig, p, x, cache, positions, *, kind="attn",
                tp=None):
    """x: [B,1,D]; positions: [B] index of the new token. -> (y, cache).
    Under ``tp`` the cache leaves are this rank's ``tp.shard(kind)``
    (the module's docstring)."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, positions[:, None], tp=tp)
    if tp is not None:
        return _decode_split(cfg, p, x, q, k, v, cache, positions, kind, tp)
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


def _decode_split(cfg: ModelConfig, p, x, q, k, v, cache, positions, kind,
                  tp):
    """``attn_decode`` on this rank's heads over its cache shard."""
    B = x.shape[0]
    shard = tp.shard(kind)
    k, v = cache_kv(k, v, tp, shard,
                    lambda: _kv_whole(cfg, p, x, positions[:, None]))
    n = cache["k"].shape[1]
    lo = shard.seq_index * n
    if kind == "local":
        slot = positions % (n * shard.seq_count) - lo
        _write_own(cache["slot_pos"], positions[:, None], slot)
        kpos = cache["slot_pos"]
    else:   # clamped into the capacity, as _write_at
        slot = positions.clamp(0, n * shard.seq_count - 1) - lo
        kpos = (lo + torch.arange(n, device=x.device))[None].expand(B, n)
    _write_own(cache["k"], k, slot)
    _write_own(cache["v"], v, slot)
    if shard.heads_count == 1:      # every kv head: every q head attends
        q = TP.all_gather(q, tp.group, 2)
    o, m, l = ops.attention_decode_partial(
        q, cache["k"], cache["v"], positions + 1, window=_window(cfg, kind),
        softcap=cfg.attn_logit_softcap, slot_positions=kpos)
    o = TP.combine_partial(o, m, l, shard.seq_groups)
    if shard.heads_count == 1:      # this rank's heads for its wo rows
        Hl = cfg.num_heads // tp.size
        o = o[:, :, tp.rank * Hl:(tp.rank + 1) * Hl]
    y = o.to(x.dtype).reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return TP.reduce_from(y, tp), cache


def attn_prefill_cache(cfg: ModelConfig, k, v, capacity, *, kind="attn",
                       shard=None):
    """Build a decode cache from a full prefix's k/v [B,S,Kh,hd] at
    positions 0..S-1 (the reference recomputes them from x; the port reuses
    the prefill's). A local layer keeps the last W positions at their ring
    slots: slot s holds the largest p <= S-1 with p % W == s, or zeros and
    ``slot_pos`` -1 where that p would be negative. With ``shard`` (a
    ``tp.CacheShard``; k/v of its kv heads, ``cache_kv``) only its slots:
    its slice of the capacity's positions (not of the prompt's: a slice
    past the prompt holds zeros) or of the ring's slots."""
    B, S, Kh, hd = k.shape
    n = _ring(cfg, capacity) if kind == "local" else capacity
    count = shard.seq_count if shard is not None else 1
    W, n = n, n // count
    lo = shard.seq_index * n if shard is not None else 0
    if kind == "local":
        last = S - 1
        s = torch.arange(lo, lo + n, device=k.device)
        pos = last - torch.remainder(last - s, W)               # [n]
        ok = pos >= 0
        src = pos.clamp(0, S - 1)
        keep = ok[None, :, None, None]
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        return {"k": torch.where(keep, k[:, src], zero),
                "v": torch.where(keep, v[:, src], zero),
                "slot_pos": torch.where(ok, pos, -1).to(torch.int32)
                .expand(B, n).contiguous()}
    hi = min(max(S, lo), lo + n)
    pad = torch.zeros((B, n - (hi - lo), Kh, hd), dtype=k.dtype,
                      device=k.device)
    return {"k": torch.cat([k[:, lo:hi], pad], 1),
            "v": torch.cat([v[:, lo:hi], pad], 1)}


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


def _mla_heads(cfg: ModelConfig, tp):
    return cfg.num_heads if tp is None else cfg.num_heads // tp.size


def _mla_q(cfg: ModelConfig, p, x, positions, tp=None):
    """-> (q_nope [B,S,H,nope], q_pe [B,S,H,rope] with RoPE); under ``tp``
    this rank's heads, the region entered after ``q_norm``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = _mla_heads(cfg, tp)
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = x.dtype
    if m.q_lora_rank:
        qa = _rms_head(x @ p["wq_a"].to(dt), p["q_norm"], cfg.norm_eps)
        if tp is not None:
            qa = TP.copy_to(qa, tp)
        q = (qa @ p["wq_b"].to(dt)).reshape(B, S, H, qk_head)
    else:
        if tp is not None:
            x = TP.copy_to(x, tp)
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
                impl=None, tp=None):
    """x: [B,S,D] -> (y [B,S,D], the decode cache or None). RoPE on the
    rope part of q and k only, the rope key shared by every head; v
    zero-padded to ``qk_head`` for the flash call (scale ``qk_head**-0.5``)
    and the output sliced back to ``v_head_dim``. With ``capacity`` the
    same ``c``/``kpe`` also fill the cache (the reference computes them
    twice). Under ``tp`` the flash call runs on this rank's heads, ``c``
    and ``kpe`` enter the region by ``copy_to``, ``wo`` is a row shard
    followed by ``reduce_from``, and the cache is this rank's shard
    (``tp.shard("mla")``)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = _mla_heads(cfg, tp)
    dt = x.dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_nope, q_pe = _mla_q(cfg, p, x, positions, tp)
    c, kpe = _mla_ckv(cfg, p, x, positions)
    cr, kper = (c, kpe) if tp is None else (TP.copy_to(c, tp),
                                            TP.copy_to(kpe, tp))
    kv = (cr @ p["wkv_b"].to(dt)).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, kper[:, :, None].expand(q_pe.shape)], -1)
    vp = F.pad(v, (0, qk_head - m.v_head_dim))
    o = ops.attention(q, k, vp, causal=True, scale=qk_head ** -0.5,
                      impl=impl)[..., :m.v_head_dim]
    y = o.reshape(B, S, H * m.v_head_dim) @ p["wo"].to(dt)
    if tp is not None:
        y = TP.reduce_from(y, tp)
    cache = None
    if capacity is not None:
        cache = mla_prefill_cache(c, kpe, capacity,
                                  shard=None if tp is None
                                  else tp.shard("mla"))
    return y, cache


def mla_forward(cfg: ModelConfig, p, x, positions, *, impl=None, tp=None):
    return mla_prefill(cfg, p, x, positions, impl=impl, tp=tp)[0]


def mla_cache_def(cfg: ModelConfig, batch, capacity, dtype):
    m = cfg.mla
    return {"ckv": torch.empty((batch, capacity, m.kv_lora_rank),
                               dtype=dtype, device="meta"),
            "kpe": torch.empty((batch, capacity, m.qk_rope_head_dim),
                               dtype=dtype, device="meta")}


def mla_prefill_cache(c, kpe, capacity, shard=None):
    """A decode cache from a prefix's ``c`` [B,S,kv_lora] and ``kpe``
    [B,S,rope] at positions 0..S-1, zero rows after them. With ``shard``
    (a ``tp.CacheShard``) only its slice of the capacity's positions, as
    ``attn_prefill_cache`` keeps it."""
    B, S, _ = c.shape
    count = shard.seq_count if shard is not None else 1
    n = capacity // count
    lo = shard.seq_index * n if shard is not None else 0
    hi = min(max(S, lo), lo + n)

    def padded(t):
        pad = torch.zeros((B, n - (hi - lo), t.shape[-1]), dtype=t.dtype,
                          device=t.device)
        return torch.cat([t[:, lo:hi], pad], 1)
    return {"ckv": padded(c), "kpe": padded(kpe)}


def mla_decode(cfg: ModelConfig, p, x, cache, positions, tp=None):
    """Absorbed-matmul decode over the compressed cache, in fp32 as the
    reference computes it. x: [B,1,D]; positions: [B]. The new token's
    ``c``/``kpe`` are written into the cache in place. Under ``tp`` the
    cache leaves are this rank's ``tp.shard("mla")``
    (``_mla_decode_split``)."""
    if tp is not None:
        return _mla_decode_split(cfg, p, x, cache, positions, tp)
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


def _mla_decode_split(cfg: ModelConfig, p, x, cache, positions, tp):
    """``mla_decode`` on this rank's heads over its cache shard: the new
    row written where its slot lives; ``q_eff`` and ``q_pe`` all-gathered
    over the model axis, so that every head scores the local rows (fp32);
    the partial softmax (a rank without a valid row adds exactly 0)
    combined over the sequence's axes; this rank's heads for ``w_v`` and
    its rows of ``wo``, summed by ``reduce_from``."""
    m = cfg.mla
    B = x.shape[0]
    Hl = _mla_heads(cfg, tp)
    dt = x.dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    shard = tp.shard("mla")
    q_nope, q_pe = _mla_q(cfg, p, x, positions[:, None], tp)   # [B,1,Hl,*]
    c, kpe = _mla_ckv(cfg, p, x, positions[:, None])
    n = cache["ckv"].shape[1]
    lo = shard.seq_index * n
    slot = positions.clamp(0, n * shard.seq_count - 1) - lo
    _write_own(cache["ckv"], c, slot)
    _write_own(cache["kpe"], kpe, slot)
    wkv_b = p["wkv_b"].to(dt).reshape(
        m.kv_lora_rank, Hl, m.qk_nope_head_dim + m.v_head_dim)
    w_k = wkv_b[..., :m.qk_nope_head_dim]                      # [L,Hl,nope]
    w_v = wkv_b[..., m.qk_nope_head_dim:]                      # [L,Hl,v]
    q_eff = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], w_k)    # [B,Hl,L]
    q_eff = TP.all_gather(q_eff, tp.group, 1)                  # [B,H,L]
    q_pe = TP.all_gather(q_pe[:, 0], tp.group, 1)              # [B,H,rope]
    ckv = cache["ckv"].float()
    sc = (torch.einsum("bhl,bsl->bhs", q_eff.float(), ckv) +
          torch.einsum("bhr,bsr->bhs", q_pe.float(),
                       cache["kpe"].float())) * qk_head ** -0.5
    kpos = lo + torch.arange(n, device=x.device)
    valid = (kpos[None] < (positions + 1)[:, None])[:, None]   # [B,1,n]
    sc = torch.where(valid, sc, torch.full_like(sc, -1e30))
    top = sc.amax(-1)                                          # [B,H]
    pr = torch.where(valid, torch.exp(sc - top[..., None]),
                     torch.zeros((), dtype=sc.dtype, device=sc.device))
    o = torch.einsum("bhs,bsl->bhl", pr, ckv)                  # [B,H,L]
    ctx = TP.combine_partial(o[:, None], top, pr.sum(-1),
                             shard.seq_groups)[:, 0]
    ctx = ctx[:, tp.rank * Hl:(tp.rank + 1) * Hl]
    o = torch.einsum("bhl,lhv->bhv", ctx, w_v.float())
    y = o.reshape(B, 1, Hl * m.v_head_dim).to(dt) @ p["wo"].to(dt)
    return TP.reduce_from(y, tp), cache


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


def xattn_kv(cfg: ModelConfig, p, enc_out, tp=None):
    """The encoder output [B,Se,D] as cross k, v [B,Se,Kh,hd] (no RoPE);
    under ``tp`` (``enc_out`` already in the region) the kv heads this
    rank's q heads read (``_local_heads``)."""
    B, Se, _ = enc_out.shape
    dt = enc_out.dtype
    Kh, wk, wv, index = cfg.num_kv_heads, p["wk"], p["wv"], None
    if tp is not None:
        _, Kh, wk, wv, index = _local_heads(cfg, p, tp)
    k = (enc_out @ wk.to(dt)).reshape(B, Se, Kh, cfg.head_dim)
    v = (enc_out @ wv.to(dt)).reshape(B, Se, Kh, cfg.head_dim)
    if index is not None:
        k, v = k[:, :, index], v[:, :, index]
    return k, v


def xattn_cache(cfg: ModelConfig, p, enc_out, k, v, tp, shard):
    """The cross cache ``xk``/``xv`` at this rank's storage shard (a
    ``tp.CacheShard``) from its compute's k, v (``xattn_kv`` under
    ``tp``): the kv heads the shard holds (``cache_kv``) and its slice of
    the frames."""
    k, v = cache_kv(k, v, tp, shard, lambda: xattn_kv(cfg, p, enc_out))
    n = k.shape[1] // shard.seq_count
    lo = shard.seq_index * n
    return {"xk": k[:, lo:lo + n].contiguous(),
            "xv": v[:, lo:lo + n].contiguous()}


def xattn_forward(cfg: ModelConfig, p, x, k, v, *, impl=None, tp=None):
    """x: [B,S,D] over the encoder's k, v: every query sees every frame.
    Under ``tp`` x enters by ``copy_to``, q is this rank's heads over the
    kv heads they read (``xattn_kv`` under the same ``tp``), and ``wo``'s
    rows are summed by ``reduce_from``."""
    B, S, _ = x.shape
    dt = x.dtype
    H = cfg.num_heads
    if tp is not None:
        x, H = TP.copy_to(x, tp), H // tp.size
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, cfg.head_dim)
    o = ops.attention(q, k, v, causal=False, impl=impl)
    y = o.reshape(B, S, H * cfg.head_dim) @ p["wo"].to(dt)
    return y if tp is None else TP.reduce_from(y, tp)


def xattn_decode(cfg: ModelConfig, p, x, cache, tp=None):
    """Cross-attention decode over the cached encoder k/v (no cache write).
    Under ``tp`` the cache is this rank's shard (``tp.shard("cross")``):
    its q heads read the kv heads it holds (where the cache holds every kv
    head, the ones they need), and where the frames are split over the
    batch's free mesh axes the partial softmax over its frames is combined
    over them (``tp.combine_partial``), then ``wo``'s rows are summed."""
    B = x.shape[0]
    dt = x.dtype
    H, hd = cfg.num_heads, cfg.head_dim
    xk, xv = cache["xk"], cache["xv"]
    shard = None
    if tp is not None:
        x, H, shard = TP.copy_to(x, tp), H // tp.size, tp.shard("cross")
        if shard.heads_count == 1:
            # the frames' split must not take the model axis: the combine
            # would mix other heads
            assert tp.group not in shard.seq_groups, shard
            lo, n, index = _kv_heads(cfg, tp)
            xk, xv = xk[:, :, lo:lo + n], xv[:, :, lo:lo + n]
            if index is not None:
                xk, xv = xk[:, :, index], xv[:, :, index]
    q = (x @ p["wq"].to(dt)).reshape(B, 1, H, hd)
    Se = xk.shape[1]
    if shard is None or shard.seq_count == 1:
        lengths = torch.full((B,), Se, dtype=torch.int32, device=x.device)
        o = ops.attention_decode(q, xk, xv, lengths)
    else:
        lengths = torch.full((B,), Se * shard.seq_count, dtype=torch.int32,
                             device=x.device)
        kpos = (shard.seq_index * Se +
                torch.arange(Se, device=x.device))[None].expand(B, Se)
        o, m, l = ops.attention_decode_partial(q, xk, xv, lengths,
                                               slot_positions=kpos)
        o = TP.combine_partial(o, m, l, shard.seq_groups).to(dt)
    y = o.reshape(B, 1, H * hd) @ p["wo"].to(dt)
    return y if tp is None else TP.reduce_from(y, tp)
