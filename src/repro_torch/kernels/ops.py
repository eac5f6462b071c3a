"""Public attention entry points (mirrors ``repro/kernels/ops.py``).

``attention`` implementations:
  * None     — ``flash_attention.flash_attention``: the CUDA kernel for CUDA
               tensors, its plain blocked version for CPU tensors;
  * "plain"  — the plain blocked online-softmax version on any device (the
               card's comparison path).

``attention_decode`` is plain PyTorch, as it is plain jnp in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa

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


def attention_decode(q, k_cache, v_cache, lengths, *, window=0, softcap=0.0,
                     scale=None, slot_positions=None):
    """Single-token decode over a (possibly ring-buffered) KV cache.

    q: [B,1,H,hd]; caches: [B,S,Kh,hd]; lengths: [B] tokens written so far
    (including the current one). ``slot_positions``: [B,S] absolute position
    held by each cache slot (ring buffers); None => slot i holds position i.
    Like the reference, it reads the whole cache in fp32 every step.
    """
    B, _, H, hd = q.shape
    _, S, Kh, _ = k_cache.shape
    G = H // Kh
    scale = scale if scale is not None else hd ** -0.5
    kpos = (torch.arange(S, device=q.device)[None].expand(B, S)
            if slot_positions is None else slot_positions)
    lengths = lengths[:, None]
    valid = (kpos >= 0) & (kpos < lengths)
    if window > 0:
        valid &= kpos >= (lengths - window)
    qf = q.reshape(B, Kh, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid[:, None, None], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
