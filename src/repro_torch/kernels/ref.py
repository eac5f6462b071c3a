"""Naive oracles in PyTorch (mirror ``repro/kernels/ref.py``).

Small shapes only: ``attention_ref`` (O(S^2) memory) is ground truth for
the flash kernel and the plain blocked version in ``flash_attention.py``;
``ssd_ref`` and ``rglru_ref`` (loops over time) are ground truth for
``ssd.py`` and ``rglru.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def rglru_ref(x, a_log, gate_a, gate_x, *, c: float = 8.0):
    """RG-LRU (Griffin eq. 2-4), sequential over time.

    x:       [B, S, D]  input
    a_log:   [D]        learnable Lambda (pre-softplus)
    gate_a:  [B, S, D]  recurrence gate pre-activation  r_t
    gate_x:  [B, S, D]  input gate pre-activation       i_t
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    log a_t = -c * softplus(a_log) * sigmoid(r_t).
    Returns (y [B,S,D] in x's dtype, h_final [B,D] fp32). Computation in
    float32.
    """
    xf = x.float()
    log_a = -c * F.softplus(a_log.float()) * torch.sigmoid(gate_a.float())
    a = torch.exp(log_a)
    gated_x = torch.sigmoid(gate_x.float()) * xf
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bx = beta * gated_x
    h = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(h)
    return torch.stack(ys, 1).to(x.dtype), h


def ssd_ref(x, dt, A_log, B, C, *, D=None, h0=None):
    """Mamba-2 SSD, sequential-over-time oracle.

    x:  [b, S, H, P]   inputs (already post-conv/activation)
    dt: [b, S, H]      softplus'd step sizes (> 0)
    A_log: [H]         per-head decay (a_t = exp(-exp(A_log) * dt))
    B:  [b, S, G, N]   input projections (G groups, H % G == 0)
    C:  [b, S, G, N]   output projections
    D:  [H] or None    skip connection
    h0: [b, H, P, N]   initial state
    Returns (y [b,S,H,P] in x's dtype, h_final [b,H,P,N] fp32).
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf, dtf = x.float(), dt.float()
    a = torch.exp(-torch.exp(A_log.float())[None, None] * dtf)     # [b,S,H]
    Bf = B.float().repeat_interleave(rep, dim=2)                    # [b,S,H,N]
    Cf = C.float().repeat_interleave(rep, dim=2)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = a[:, t, :, None, None] * h + \
            (dtf[:, t, :, None, None] * xf[:, t, :, :, None]) * \
            Bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, 1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), h
