"""Mixture-of-Experts block, DeepSeek-style: shared + routed experts, top-k
(mirrors ``repro/models/moe.py``).

Two dispatch paths, chosen by ``moe_apply`` as the reference's:

* **EP** (``_moe_ep``), whenever an active mesh
  (``sharding.partition.activate``) has an ``experts`` axis larger than 1
  that divides the expert count: each rank of that axis owns
  ``E / n`` experts and a slice of the tokens, packs its token copies per
  destination rank, exchanges them with ``all_to_all_single``, runs its
  local experts as batched matmuls and returns the results through the
  reverse exchange; the token slices are gathered back. The collectives
  are differentiable (below).
* **Local**, the sort-based single-device path: router in fp32, softmax,
  top-k, gates renormalised, a Switch-style load-balance aux loss; the
  token copies sorted by expert (stable), packed into ``[E, C, D]``
  buffers of ``C = _capacity(T)`` rows per expert with the overflow
  dropped, the three expert products as batched matmuls, then the combine.

Two choices keep the port's numbers fixed from run to run and equal to
the reference's selection, on both paths:

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
``drop_counts`` counts the copies each path routes and drops.

Gradients under EP. The model computes on each rank's local tensors, and
every rank of the expert axis holds the same activations (its batch slice
is the same). The token slice's backward gathers every rank's slice of
the gradient, and the final gather's backward takes the rank's own slice,
so the input's gradient is whole and the same on every rank of the axis.
The expert weights' gradients are their local shards'. The router's and
the shared experts' are partial: each rank's comes from its token slice,
and the train step sums them over the expert axis (``ep_partial``), as
the transpose of ``shard_map``'s replicated ``in_specs`` does in JAX.
Inside a tensor-parallel region whose plan splits the shared experts
(``sharding.tp``; ``moe_apply``'s ``tp``) they run outside the exchange
instead, as the reference's run outside its ``shard_map`` under GSPMD: on
all of the block's tokens, by this rank's ffn columns of ``wi_gate``/
``wi_up`` and rows of ``wo``, the input entering by ``copy_to`` and the
output summed by ``reduce_from``; their gradients are then their shards'
whole ones, and ``ep_partial`` no longer names them.
``aux`` is averaged over the batch axes and the expert axis; its backward
scales by 1 / (expert-axis size), so that the train step's mean over the
batch axes and sum over the expert axis give the gradient of the one
global ``aux``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef
from repro_torch.sharding import partition as part
from repro_torch.sharding import tp as TP


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


def _per_expert(e, E):
    """How many of the int64 ids ``e`` (each in [0, E)) name each of E
    experts: ``bincount(e, minlength=E)`` with a shape that does not depend
    on the data (a fake-tensor trace can run it)."""
    return torch.zeros(E, dtype=torch.int64, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))


def dispatch(eidx, E, C):
    """The sort-based dispatch of the T*K token copies -> (order, keep,
    dest): ``order`` sorts the copies by expert (stable), ``keep`` marks
    the sorted copies within their expert's first C, ``dest`` is each
    sorted copy's row of the ``[E*C + 1]`` buffer (E*C for a drop)."""
    e_flat = eidx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    counts = _per_expert(e_flat, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(e_flat.numel(), device=eidx.device) - starts[se]
    keep = pos_in_e < C
    dest = torch.where(keep, se * C + pos_in_e, torch.full_like(se, E * C))
    return order, keep, dest


_drops = None       # the open ``drop_counts`` dict, if any


@contextlib.contextmanager
def drop_counts():
    """Counts token copies while open: yields a dict of int64 tensors on
    the device, summed over the MoE calls on this rank. ``copies``: the
    T*K copies routed (under EP this rank's token slice, its padding rows
    included, as they take capacity); ``dropped``: copies over their
    expert's capacity (EP: over their local expert's ``C_loc`` on the rank
    that received them); ``dropped_send`` (EP only): copies over their
    destination shard's ``C_send``, never sent."""
    global _drops
    prev, _drops = _drops, {}
    try:
        yield _drops
    finally:
        _drops = prev


def _count(key, n):
    if _drops is not None:
        _drops[key] = _drops.get(key, 0) + n


def _shared(p, xf, tp=None):
    """The shared experts on ``xf`` [T,D]; under ``tp`` (a
    ``sharding.tp.Region`` whose plan splits them) this rank's ffn columns
    and rows, summed over the model axis."""
    sp, dt = p["shared"], xf.dtype
    if tp is not None:
        xf = TP.copy_to(xf, tp)
    h = F.silu(xf @ sp["wi_gate"].to(dt)) * (xf @ sp["wi_up"].to(dt))
    y = h @ sp["wo"].to(dt)
    return y if tp is None else TP.reduce_from(y, tp)


def expert_axis(cfg: ModelConfig):
    """The active mesh's expert axis when EP applies to ``cfg`` (its size
    larger than 1 and dividing the expert count), else None."""
    mesh, rules = part._active()
    if mesh is None or cfg.moe is None:
        return None
    ax = rules.get("experts")
    size = part.axis_sizes(mesh).get(ax, 0) if isinstance(ax, str) else 0
    return ax if size > 1 and cfg.moe.num_experts % size == 0 else None


def ep_partial(path: str, plan=None) -> bool:
    """Whether a parameter's gradient under EP is partial over the expert
    axis: an MoE layer's router, and its shared experts unless ``plan``
    (a ``partition.TPPlan``) splits them."""
    return path.endswith(".mlp.router") or (
        ".mlp.shared." in path and not (plan is not None and plan.shared))


def ep_context(cfg: ModelConfig):
    """(mesh, rules, expert axis) of the active mesh when EP applies to
    ``cfg`` (``expert_axis``), else None. ``LM`` reads it once per call
    and carries it in its layers' context: a remat recompute may run on
    the autograd engine's device thread, where no mesh is active."""
    ax = expert_axis(cfg)
    if ax is None:
        return None
    mesh, rules = part._active()
    return mesh, rules, ax


ACTIVE = object()     # moe_apply's default: read the active mesh


def moe_apply(cfg: ModelConfig, p, x, ep=ACTIVE, tp=None):
    """x: [B,S,D] -> (y [B,S,D], aux loss, a scalar fp32). Takes the EP
    path over ``ep`` (``ep_context``'s value; by default the caller's
    active mesh, read here), else the local path (``ep`` None). With
    ``tp`` (a ``sharding.tp.Region`` whose plan splits the shared experts)
    the shared experts run split on all of ``x``'s tokens, beside either
    path (the module's docstring)."""
    if ep is ACTIVE:
        ep = ep_context(cfg)
    inner = tp is None
    if ep is not None:
        y, aux = _moe_ep(cfg, p, x, *ep, shared=inner)
    else:
        y, aux = _moe_local(cfg, p, x, shared=inner)
    if not inner and cfg.moe.num_shared > 0:
        B, S, D = x.shape
        y = y + _shared(p, x.reshape(B * S, D), tp).reshape(B, S, D)
    return y, aux


def _moe_local(cfg: ModelConfig, p, x, shared=True):
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    T, E, K = B * S, m.num_experts, m.top_k
    xf = x.reshape(T, D)
    probs, gates, eidx = route(cfg, p, xf)

    # load-balance aux loss (Switch-style)
    me = probs.mean(0)
    ce = _per_expert(eidx.reshape(-1), E).float() / (T * K)
    aux = m.router_aux_weight * E * torch.sum(me * ce)

    C = _capacity(T, cfg)
    order, keep, dest = dispatch(eidx, E, C)
    _count("copies", T * K)
    _count("dropped", (~keep).sum())
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
    if shared and m.num_shared > 0:
        y = y + _shared(p, xf)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Expert-parallel dispatch (all_to_all over the expert axis)
# ---------------------------------------------------------------------------


def _gather(t, group):
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, 0)


class _TokenSlice(torch.autograd.Function):
    """Forward: this rank's ``T`` rows of ``xf`` padded with zero rows to
    ``T * n``. Backward: every rank's slice of the gradient, gathered (the
    input is the same on every rank, so its gradient is their sum of
    disjoint slices)."""

    @staticmethod
    def forward(ctx, xf, T, idx, group):
        ctx.T_all, ctx.group = xf.shape[0], group
        rows = xf[idx * T:(idx + 1) * T]
        return torch.cat([rows, rows.new_zeros((T - rows.shape[0],) +
                                               rows.shape[1:])], 0)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group)[:ctx.T_all], None, None, None


class _TokenGather(torch.autograd.Function):
    """Forward: every rank's ``T`` rows gathered, the padding cut off.
    Backward: this rank's slice of the gradient (the same on every rank)."""

    @staticmethod
    def forward(ctx, y, T_all, idx, group):
        ctx.T, ctx.idx = y.shape[0], idx
        return _gather(y, group)[:T_all]

    @staticmethod
    def backward(ctx, g):
        T, idx = ctx.T, ctx.idx
        g = g[idx * T:(idx + 1) * T]
        if g.shape[0] < T:
            g = torch.cat([g, g.new_zeros((T - g.shape[0],) + g.shape[1:])], 0)
        return g, None, None, None


class _MeanAux(torch.autograd.Function):
    """Forward: the mean of ``aux`` over ``groups`` (each rank's own value
    summed over every group in turn). Backward: the gradient over the
    expert axis's size (see the module's docstring)."""

    @staticmethod
    def forward(ctx, aux, groups, n_expert):
        import torch.distributed as dist
        out, n = aux.clone(), 1
        for g in groups:
            dist.all_reduce(out, group=g)
            n *= dist.get_world_size(g)
        ctx.n_expert = n_expert
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_expert, None, None


def _local_experts(w, idx, E_loc):
    """A full ``[E, ...]`` expert weight's ``E_loc`` rows of this rank, or
    the local shard as it is."""
    return w[idx * E_loc:(idx + 1) * E_loc] if w.shape[0] != E_loc else w


def _moe_ep(cfg: ModelConfig, p, x, mesh, rules, expert_axis, shared=True):
    """The reference's ``_moe_ep`` on this rank. ``x`` [B,S,D] is this
    rank's activations (its batch slice; the same on every rank of the
    expert axis); expert weights are the full ``[E, ...]`` tensors or this
    rank's ``[E/n, ...]`` shard. The shared experts run on this rank's
    token slice where ``shared`` (else the caller adds them). Returns
    (y [B,S,D], aux)."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    sizes = part.axis_sizes(mesh)
    nsh = sizes[expert_axis]
    E, K = m.num_experts, m.top_k
    E_loc = E // nsh
    group = mesh.get_group(expert_axis)
    idx = mesh.get_local_rank(expert_axis)
    batch_groups = [mesh.get_group(a) for a in ("pod", "data")
                    if sizes.get(a, 1) > 1]
    T_all = B * S
    # x is the same across the expert axis: each rank owns a token slice
    # (SP over the expert axis), so routing work isn't duplicated
    T = -(-T_all // nsh)
    xf = _TokenSlice.apply(x.reshape(T_all, D), T, idx, group)
    valid = (idx * T + torch.arange(T, device=x.device)) < T_all
    probs, gates, eidx = route(cfg, p, xf)
    gates = gates * valid[:, None]

    # aux loss from this rank's stats, averaged over the batch axes and
    # the expert axis
    me = probs.mean(0)
    ce = _per_expert(eidx.reshape(-1), E).float() / (T * K)
    aux = m.router_aux_weight * E * torch.sum(me * ce)
    aux = _MeanAux.apply(aux, batch_groups + [group], nsh)

    # ---- pack per destination expert shard -------------------------------
    shard_of = eidx // E_loc
    C_send = max(4, -(-int(T * K * m.capacity_factor / nsh) // 4) * 4)
    order, keep, dest = dispatch(shard_of, nsh, C_send)
    _count("copies", T * K)
    _count("dropped_send", (~keep).sum())
    send_x = torch.zeros((nsh * C_send + 1, D), dtype=dt, device=x.device)
    send_x[dest] = xf.unsqueeze(1).expand(T, K, D)[order // K, order % K]
    send_e = torch.full((nsh * C_send + 1,), -1, dtype=torch.int64,
                        device=x.device)
    send_e[dest] = (eidx.reshape(-1) % E_loc)[order]

    # ---- all-to-all to the expert shards ---------------------------------
    R = nsh * C_send
    recv_x = dnn.all_to_all_single(torch.empty((R, D), dtype=dt,
                                               device=x.device),
                                   send_x[:R], group=group)
    recv_e = torch.empty((R,), dtype=torch.int64, device=x.device)
    dist.all_to_all_single(recv_e, send_e[:R].contiguous(), group=group)

    # ---- local expert compute (pack by local expert id) ------------------
    C_loc = max(4, -(-R // E_loc // 4) * 4)
    rec_e = torch.where(recv_e < 0, torch.full_like(recv_e, E_loc), recv_e)
    order2, keep2, dest2 = dispatch(rec_e, E_loc + 1, C_loc)
    se2 = rec_e[order2]
    _count("dropped", ((se2 < E_loc) & ~keep2).sum())
    keep2 = keep2 & (se2 < E_loc)
    dest2 = torch.where(keep2, dest2, torch.full_like(dest2, E_loc * C_loc))
    ebuf = torch.zeros((E_loc * C_loc + 1, D), dtype=dt, device=x.device)
    ebuf[dest2] = recv_x[order2]
    eb = ebuf[:E_loc * C_loc].reshape(E_loc, C_loc, D)
    wi_g, wi_u, wo = (_local_experts(p[k], idx, E_loc).to(dt)
                      for k in ("wi_gate", "wi_up", "wo"))
    h = F.silu(torch.bmm(eb, wi_g)) * torch.bmm(eb, wi_u)
    eo = torch.bmm(h, wo)                                      # [E_loc,C,D]
    flat = torch.cat([eo.reshape(E_loc * C_loc, D),
                      torch.zeros((1, D), dtype=dt, device=x.device)], 0)
    back = torch.empty((R, D), dtype=dt, device=x.device)
    back[order2] = flat[dest2]

    # ---- return through the reverse all-to-all ---------------------------
    ret = dnn.all_to_all_single(torch.empty_like(back), back, group=group)

    # ---- combine ---------------------------------------------------------
    flat_ret = torch.cat([ret, torch.zeros((1, D), dtype=dt,
                                           device=x.device)], 0)
    w = (gates.reshape(-1)[order] * keep).to(dt)
    contrib = torch.empty((T * K, D), dtype=dt, device=x.device)
    contrib[order] = flat_ret[dest] * w[:, None]               # unsorted slots
    y = contrib.reshape(T, K, D).sum(1)
    if shared and m.num_shared > 0:
        y = y + _shared(p, xf)
    # gather the token slices back from every rank of the expert axis
    y_all = _TokenGather.apply(y, T_all, idx, group)
    return y_all.reshape(B, S, D), aux
