"""Tensor-parallel primitives over the mesh's ``"model"`` axis, on local
tensors (Megatron-style; the counterpart of the reference's GSPMD
partitioning of ``wq``/``wk``/``wv``/``wo`` by ``heads``, the MLP by
``ffn`` and the embedding and head by ``vocab``).

The train step opens a ``region(mesh, plan)`` around its loss and backward
(``optim.adamw``); ``LM.forward`` reads it once (``active()``) and hands it
down with its context, so a remat recompute, which may run on the autograd
engine's device thread, computes in the same region. Each primitive is an
``autograd.Function`` over the region's process group:

* ``copy_to``     — identity forward, all-reduce backward: the input of a
                    column-parallel block (its gradient is partial on each
                    rank and whole after the sum);
* ``reduce_from`` — all-reduce forward, identity backward: the output of a
                    row-parallel block;
* ``sum_over``    — all-reduce forward, all-reduce backward: a sum that
                    every rank's outputs read (Mamba-2's gated norm's sum
                    of squares over the SSD heads), whose gradient on each
                    rank is partial;
* ``vocab_embed`` — a lookup in this rank's vocabulary rows, the ids it
                    does not own masked to zero, then ``reduce_from`` (a sum
                    of one row and zeros: the whole table's lookup, exactly);
                    ``F.embedding`` keeps its fixed-order backward;
* ``vocab_ce``    — next-token cross-entropy over vocabulary-parallel
                    logits: the global max and sum of exponentials by
                    all-reduce, the gold logit from the rank that owns the
                    label.

Serving (``LM.prefill``/``LM.decode_step`` in a region that
``launch.specs.build_fn`` opens) runs the same blocks under no_grad, and
keeps each decode-cache leaf of a split block at its storage shard
(``CacheShard``, from ``partition.cache_layout``): its slice of the
sequence or ring slots, and of the kv heads where those are split over the
model axis. Two more primitives serve it, plain c10d calls without
autograd:

* ``all_gather``      — every rank's tensor concatenated along a dim
                        (``all_gather_into_tensor``, never DTensor's
                        ``redistribute``);
* ``combine_partial`` — attention's partial softmax over each rank's keys
                        (``ops.attention_decode_partial``) combined over the
                        sequence axes' groups: the largest score by an
                        all-reduce MAX, each share rescaled to it, then the
                        sums and the weighted values by one all-reduce.

Without a region (no mesh, or a model axis of 1) the model calls none of
them and computes as on one device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import partition as part


class CacheShard(NamedTuple):
    """This rank's shard of a split block's decode-cache leaves: slice
    ``seq_index`` of ``seq_count`` along the sequence (or ring-slot) dim,
    whose partial softmax is combined over ``seq_groups`` (the groups of
    the sequence's mesh axes, major to minor), and slice ``heads_index`` of
    ``heads_count`` along the kv heads (1: every kv head), or along a scan
    cache's channels or SSD heads."""
    seq_groups: Tuple[object, ...]
    seq_index: int
    seq_count: int
    heads_index: int
    heads_count: int


WHOLE = CacheShard((), 0, 1, 0, 1)


def cache_shard(mesh, layout: part.CacheLayout) -> CacheShard:
    """``layout``'s shard on this rank of ``mesh``: its index along the
    sequence axes taken major to minor, as a spec over several axes
    splits a dim; the combine runs over those of more than one rank."""
    names = list(part.axis_sizes(mesh))

    def where(axes):
        i, n = 0, 1
        for a in axes:
            d = names.index(a)
            i, n = i * mesh.size(d) + mesh.get_local_rank(d), n * mesh.size(d)
        return i, n
    (si, sn), (hi, hn) = where(layout.seq), where(layout.heads)
    groups = tuple(mesh.get_group(a) for a in layout.seq
                   if mesh.size(names.index(a)) > 1)
    return CacheShard(groups, si, sn, hi, hn)


class Region(NamedTuple):
    """This rank's place on the model axis, what computes split, and, for
    serving, each split mixer kind's ``CacheShard`` (None: whole)."""
    group: object
    rank: int
    size: int
    plan: part.TPPlan
    cache: Optional[Dict[str, CacheShard]] = None

    def shard(self, kind: str) -> CacheShard:
        return (self.cache or {}).get(kind, WHOLE)


_state = threading.local()


def active() -> Optional[Region]:
    return getattr(_state, "region", None)


@contextlib.contextmanager
def region(mesh, plan: Optional[part.TPPlan],
           cache: Optional[Dict[str, part.CacheLayout]] = None):
    """Compute split over ``mesh``'s ``TP_AXIS`` by ``plan`` in the block;
    the identity context without a plan, or where the axis is missing or
    of size 1. ``cache`` maps a split mixer kind to its cache leaves'
    layout (``LM.cache_layouts``); a serving call reads and writes those
    leaves as this rank's shards."""
    prev = active()
    names = list(part.axis_sizes(mesh))
    if plan is not None and part.TP_AXIS in names and plan.size > 1:
        shards = {k: cache_shard(mesh, v) for k, v in (cache or {}).items()}
        _state.region = Region(mesh.get_group(part.TP_AXIS),
                               mesh.get_local_rank(part.TP_AXIS), plan.size,
                               plan, shards)
    try:
        yield
    finally:
        _state.region = prev


def _all_reduce(t, group, op=None):
    """``t`` reduced over ``group``, in place. A bf16 or fp16 tensor is
    summed in fp32 and rounded once, as a matmul accumulates its partial
    products, so that a row-parallel product rounds as the unsplit one
    does; summed in its own dtype, each partial sum would round again."""
    import torch.distributed as dist
    op = op or dist.ReduceOp.SUM
    if t.dtype in (torch.bfloat16, torch.float16):
        f = t.float()
        dist.all_reduce(f, op=op, group=group)
        return t.copy_(f)
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def copy_to(x, tp: Region):
    return _CopyToRegion.apply(x, tp.group)


def reduce_from(x, tp: Region):
    return _ReduceFromRegion.apply(x, tp.group)


def sum_over(x, tp: Region):
    """``x`` summed over the region's ranks, whose gradient is summed too:
    each rank's outputs depend on every rank's ``x``."""
    return _SumOver.apply(x, tp.group)


def vocab_embed(tokens, rows, tp: Region, dtype):
    """``rows``: this rank's ``[V / size, D]`` slice of the table ->
    ``[..., D]`` in ``dtype``, the same on every rank of the axis."""
    n = rows.shape[0]
    ids = tokens.long() - tp.rank * n
    own = (ids >= 0) & (ids < n)
    x = F.embedding(torch.where(own, ids, 0), rows).to(dtype)
    return reduce_from(x * own[..., None].to(dtype), tp)


class _VocabCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over the vocabulary
    split across the group; ``logits`` [..., V / size] fp32 holds this
    rank's columns, which start at ``lo``."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        import torch.distributed as dist
        n = logits.shape[-1]
        m = _all_reduce(logits.amax(-1), group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        s = _all_reduce(e.sum(-1), group)
        own = (labels >= lo) & (labels < lo + n)
        idx = torch.where(own, labels - lo, 0)
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
        gold = _all_reduce(torch.where(own, gold, 0.0), group)
        ctx.save_for_backward(e, s, idx, own)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, g):
        e, s, idx, own = ctx.saved_tensors
        grad = e * (g / s)[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          -torch.where(own, g, 0.0)[..., None])
        return grad, None, None, None


def vocab_ce(logits, labels, tp: Region):
    """``logits``: this rank's vocabulary columns, fp32 -> the per-token
    cross-entropy, the same on every rank of the axis."""
    lo = tp.rank * logits.shape[-1]
    return _VocabCE.apply(logits, labels.long(), lo, tp.group)


# ---------------------------------------------------------------------------
# Serving: no autograd
# ---------------------------------------------------------------------------


def all_gather(t, group, dim: int):
    """``t`` of every rank of ``group`` concatenated along ``dim`` in rank
    order (c10d's ``all_gather_into_tensor``, which gloo takes for CUDA
    tensors too)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def combine_partial(o, m, l, groups):
    """Attention over keys split across ``groups``: ``o`` [B,1,H,hd], the
    exp-weighted sum of this rank's values, ``m`` [B,H] its largest score,
    ``l`` [B,H] its sum of weights, all fp32 (``ops.attention_decode_
    partial``) -> the attention output [B,1,H,hd] fp32 over every rank's
    keys. The largest score by an all-reduce MAX, each rank's share scaled
    by exp(m - max) (0 for a rank without a valid key, whose o and l are
    0), then o and l summed by one all-reduce."""
    import torch.distributed as dist
    if groups:
        B, _, H, hd = o.shape
        top = m.clone()
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        c = torch.exp(m - top)
        buf = torch.cat([(o * c[:, None, :, None]).reshape(B, -1), l * c],
                        -1)
        for g in groups:
            dist.all_reduce(buf, group=g)
        o, l = buf[:, :H * hd].reshape(B, 1, H, hd), buf[:, H * hd:]
    return o / l[:, None, :, None]
