"""Public kernel entry points (mirror ``repro/kernels/ops.py``).

``attention``, ``ssd`` and ``rglru`` implementations:
  * None     — the CUDA kernel for CUDA tensors
               (``flash_attention.flash_attention``, ``ssd.ssd_scan``,
               ``rglru.rglru_scan``), its plain blocked version for CPU
               tensors;
  * "plain"  — the plain blocked version on any device (the card's
               comparison path).

``attention_decode``, ``ssd_decode`` and ``rglru_decode`` are plain PyTorch,
as they are plain jnp in the reference; so is ``attention_decode_partial``,
the decode over one rank's shard of a sequence-split cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import ssd as _ssd

_NEG = -1e30


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None,
              impl=None):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,Kh,hd]. Queries right-aligned in keys."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if impl is None:
        return fa.flash_attention(q, k, v, **kw)
    if impl == "plain":
        return fa.attention_plain(q, k, v, **kw)
    raise ValueError(f"unknown attention impl {impl!r}")


def _decode_scores(q, k_cache, lengths, window, softcap, scale,
                   slot_positions):
    """-> (scores [B,Kh,G,S] fp32, -1e30 where masked; valid [B,S])."""
    B, _, H, hd = q.shape
    _, S, Kh, _ = k_cache.shape
    scale = scale if scale is not None else hd ** -0.5
    kpos = (torch.arange(S, device=q.device)[None].expand(B, S)
            if slot_positions is None else slot_positions)
    lengths = lengths[:, None]
    valid = (kpos >= 0) & (kpos < lengths)
    if window > 0:
        valid &= kpos >= (lengths - window)
    qf = q.reshape(B, Kh, H // Kh, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    return torch.where(valid[:, None, None], s, torch.full_like(s, _NEG)), \
        valid


def attention_decode(q, k_cache, v_cache, lengths, *, window=0, softcap=0.0,
                     scale=None, slot_positions=None):
    """Single-token decode over a (possibly ring-buffered) KV cache.

    q: [B,1,H,hd]; caches: [B,S,Kh,hd]; lengths: [B] tokens written so far
    (including the current one). ``slot_positions``: [B,S] absolute position
    held by each cache slot (ring buffers); None => slot i holds position i.
    Like the reference, it reads the whole cache in fp32 every step.
    """
    B, _, H, hd = q.shape
    s, _ = _decode_scores(q, k_cache, lengths, window, softcap, scale,
                          slot_positions)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def attention_decode_partial(q, k_cache, v_cache, lengths, *, window=0,
                             softcap=0.0, scale=None, slot_positions=None):
    """``attention_decode`` over the keys this rank holds (a slice of the
    cache's slots, ``slot_positions`` giving each one's position), left
    unnormalised: -> (o [B,1,H,hd] the exp-weighted sum of the values,
    m [B,H] the largest valid score, l [B,H] the sum of the weights
    exp(s - m)), fp32. A row without a valid key on this rank (a prompt
    shorter than the slice's start, ring slots still at -1) gives o and l
    exactly 0 and m -1e30, so that it adds nothing to
    ``sharding.tp.combine_partial``, whose o / l over every rank's share is
    ``attention_decode``."""
    B, _, H, hd = q.shape
    s, valid = _decode_scores(q, k_cache, lengths, window, softcap, scale,
                              slot_positions)
    m = s.amax(-1)
    p = torch.where(valid[:, None, None], torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd), m.reshape(B, H), p.sum(-1).reshape(B, H)


def rglru(x, a_log, gate_a, gate_x, *, c=8.0, h0=None, impl=None):
    """RG-LRU scan. Shapes as in ``ref.rglru_ref``; ``h0`` [B,D] or None.
    Returns (y [B,S,D] in x's dtype, h_final [B,D] fp32)."""
    if impl is None:
        return _rglru.rglru_scan(x, a_log, gate_a, gate_x, c=c, h0=h0)
    if impl == "plain":
        return _rglru.rglru_plain(x, a_log, gate_a, gate_x, c=c, h0=h0)
    raise ValueError(f"unknown rglru impl {impl!r}")


def rglru_decode(h, x, a_log, gate_a, gate_x, *, c=8.0):
    """One recurrence step. h: [B,D] fp32; x, gates: [B,D]. Returns
    (y [B,D] in x's dtype, new h fp32)."""
    a, b = _rglru.gates(x, a_log, gate_a, gate_x, c)
    h = a * h.float() + b
    return h.to(x.dtype), h


def ssd(x, dt, A_log, B, C, *, D=None, h0=None, chunk=256, impl=None):
    """Chunked Mamba-2 SSD. Shapes as in ``ref.ssd_ref``.
    Returns (y [b,S,H,P], h_final [b,H,P,N] fp32)."""
    kw = dict(D=D, h0=h0, chunk=chunk)
    if impl is None:
        return _ssd.ssd_scan(x, dt, A_log, B, C, **kw)
    if impl == "plain":
        return _ssd.ssd_plain(x, dt, A_log, B, C, **kw)
    raise ValueError(f"unknown ssd impl {impl!r}")


def ssd_decode(h, x, dt, A_log, B, C, *, D=None):
    """One SSD step. h: [b,H,P,N] fp32; x: [b,H,P]; dt: [b,H]; B, C:
    [b,G,N]. Returns (y [b,H,P] in x's dtype, new h fp32)."""
    H = h.shape[1]
    rep = H // B.shape[1]
    xf, dtf = x.float(), dt.float()
    a = torch.exp(-torch.exp(A_log.float())[None] * dtf)          # [b,H]
    Bf = B.float().repeat_interleave(rep, 1)                      # [b,H,N]
    Cf = C.float().repeat_interleave(rep, 1)
    h = a[..., None, None] * h + \
        (dtf[..., None] * xf)[..., None] * Bf[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Cf)
    if D is not None:
        y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), h
