"""Naive attention oracle in PyTorch (mirrors ``repro/kernels/ref.py``).

O(S^2) memory, small shapes only: ground truth for the kernel and for the
plain blocked version in ``flash_attention.py``.
"""
from __future__ import annotations

import torch

NEG = -1e30


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
    """Naive masked attention.

    q: [B, Sq, H, hd]; k, v: [B, Sk, Kh, hd] with H % Kh == 0.
    ``window`` > 0 restricts key j for query i to i - window < j <= i.
    Query positions are right-aligned: qpos = Sk - Sq + arange(Sq).
    """
    B, Sq, H, hd = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    scale = scale if scale is not None else hd ** -0.5
    qf = q.reshape(B, Sq, Kh, G, hd).float()
    s = torch.einsum("bqkgh,bckh->bkgqc", qf, k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qpos = (Sk - Sq) + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bckh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
