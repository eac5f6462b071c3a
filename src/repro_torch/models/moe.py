"""Mixture-of-Experts block, DeepSeek-style: shared + routed experts, top-k
(mirrors ``repro/models/moe.py``).

One card holds every expert, so ``moe_apply`` always takes the local,
sort-based path (the reference's single-device one): router in fp32,
softmax, top-k, gates renormalised, a Switch-style load-balance aux loss;
the token copies sorted by expert (stable), packed into ``[E, C, D]``
buffers of ``C = _capacity(T)`` rows per expert with the overflow dropped,
the three expert products as batched matmuls, then the combine. The
reference's expert-parallel ``_moe_ep`` (shard_map + all_to_all) waits for
the distributed slice (ROADMAP Queue 1).

Two choices keep the port's numbers fixed from run to run and equal to
the reference's selection:

* top-k is taken from a stable descending sort, so on a tie the lower
  expert index comes first, as ``jax.lax.top_k`` orders it (``torch.topk``
  documents no tie order);
* the combine uses no atomics: ``order`` is a permutation of the T*K token
  copies, so each weighted expert output is put back at its copy's
  unsorted slot, viewed as ``[T, K, D]`` and summed over K. The reference
  adds them by scatter (``.at[tok].add``), which on CUDA (``index_add_``)
  would sum in an order that changes between runs;
* the dispatch gathers each token's K copies from ``xf`` broadcast to
  ``[T, K, D]`` (a view, not a copy) and indexed at the (token, k) pairs
  of the permutation ``order``, not by
  ``xf[order // K]`` (the reference's ``xf[tok]``): the backward of that
  index adds K gradients into each token's row by an accumulating index
  write, whose order CUDA does not fix; here it writes a permutation
  (unique rows) and sums over K by a reduction, so a training step is
  the same bit for bit from run to run.

Dropped copies are written to one spare row (``E * C``), which is thrown
away; no other row receives two copies. An engine's idle slots route
their tokens too and count towards the capacity, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef


def moe_def(cfg: ModelConfig):
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    d = {
        "router": ParamDef((D, E), ("embed", None), scale=0.1),
        "wi_gate": ParamDef((E, D, Fe), ("experts", "embed", "ffn")),
        "wi_up": ParamDef((E, D, Fe), ("experts", "embed", "ffn")),
        "wo": ParamDef((E, Fe, D), ("experts", "ffn", "embed")),
    }
    if m.num_shared > 0:
        Fs = m.num_shared * Fe
        d["shared"] = {
            "wi_gate": ParamDef((D, Fs), ("embed", "ffn")),
            "wi_up": ParamDef((D, Fs), ("embed", "ffn")),
            "wo": ParamDef((Fs, D), ("ffn", "embed")),
        }
    return d


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows per expert: tokens * top_k * capacity_factor / experts, plus
    one, rounded up to a multiple of 4, at least 4."""
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(4, -(-c // 4) * 4)


def route(cfg: ModelConfig, p, xf):
    """xf: [T,D] -> (probs [T,E] fp32, gates [T,K] fp32 renormalised,
    eidx [T,K] int64), the top k by probability, ties to the lower index."""
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = top[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def dispatch(eidx, E, C):
    """The sort-based dispatch of the T*K token copies -> (order, keep,
    dest): ``order`` sorts the copies by expert (stable), ``keep`` marks
    the sorted copies within their expert's first C, ``dest`` is each
    sorted copy's row of the ``[E*C + 1]`` buffer (E*C for a drop)."""
    e_flat = eidx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(e_flat.numel(), device=eidx.device) - starts[se]
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, torch.full_like(se, E * C))
    return order, keep, dest


def _shared(p, xf):
    sp, dt = p["shared"], xf.dtype
    h = F.silu(xf @ sp["wi_gate"].to(dt)) * (xf @ sp["wi_up"].to(dt))
    return h @ sp["wo"].to(dt)


def moe_apply(cfg: ModelConfig, p, x):
    """x: [B,S,D] -> (y [B,S,D], aux loss, a scalar fp32)."""
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    T, E, K = B * S, m.num_experts, m.top_k
    xf = x.reshape(T, D)
    probs, gates, eidx = route(cfg, p, xf)

    # load-balance aux loss (Switch-style)
    me = probs.mean(0)
    ce = torch.bincount(eidx.reshape(-1), minlength=E).float() / (T * K)
    aux = m.router_aux_weight * E * torch.sum(me * ce)

    C = _capacity(T, cfg)
    order, keep, dest = dispatch(eidx, E, C)
    buf = torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
    buf[dest] = xf.unsqueeze(1).expand(T, K, D)[order // K, order % K]
    eb = buf[:E * C].reshape(E, C, D)
    h = F.silu(torch.bmm(eb, p["wi_gate"].to(dt))) * \
        torch.bmm(eb, p["wi_up"].to(dt))
    eo = torch.bmm(h, p["wo"].to(dt))                          # [E,C,D]

    flat = torch.cat([eo.reshape(E * C, D),
                      torch.zeros((1, D), dtype=dt, device=x.device)], 0)
    w = (gates.reshape(-1)[order] * keep).to(dt)
    contrib = torch.empty((T * K, D), dtype=dt, device=x.device)
    contrib[order] = flat[dest] * w[:, None]                   # unsorted slots
    y = contrib.reshape(T, K, D).sum(1)
    if m.num_shared > 0:
        y = y + _shared(p, xf)
    return y.reshape(B, S, D), aux
