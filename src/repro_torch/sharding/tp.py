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
* ``vocab_embed`` — a lookup in this rank's vocabulary rows, the ids it
                    does not own masked to zero, then ``reduce_from`` (a sum
                    of one row and zeros: the whole table's lookup, exactly);
                    ``F.embedding`` keeps its fixed-order backward;
* ``vocab_ce``    — next-token cross-entropy over vocabulary-parallel
                    logits: the global max and sum of exponentials by
                    all-reduce, the gold logit from the rank that owns the
                    label.

Without a region (no mesh, a model axis of 1, or a serving call) the model
calls none of them and computes as on one device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import partition as part


class Region(NamedTuple):
    """This rank's place on the model axis, and what computes split."""
    group: object
    rank: int
    size: int
    plan: part.TPPlan


_state = threading.local()


def active() -> Optional[Region]:
    return getattr(_state, "region", None)


@contextlib.contextmanager
def region(mesh, plan: Optional[part.TPPlan]):
    """Compute split over ``mesh``'s ``TP_AXIS`` by ``plan`` in the block;
    the identity context without a plan, or where the axis is missing or
    of size 1."""
    prev = active()
    names = list(part.axis_sizes(mesh))
    if plan is not None and part.TP_AXIS in names and plan.size > 1:
        _state.region = Region(mesh.get_group(part.TP_AXIS),
                               mesh.get_local_rank(part.TP_AXIS), plan.size,
                               plan)
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


def copy_to(x, tp: Region):
    return _CopyToRegion.apply(x, tp.group)


def reduce_from(x, tp: Region):
    return _ReduceFromRegion.apply(x, tp.group)


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
