"""Moving a local tensor between DTensor layouts on the mesh by plain c10d
calls on the mesh's groups, never DTensor's ``redistribute``: gloo takes
these calls for CUDA tensors (staged through the host), where DTensor's
functional all-gather of a CUDA tensor crashed gloo.

* ``relayout``  — the local tensor at placements ``src`` -> its local
                  tensor at ``dst``: the train step's way from storage to
                  the compute copies and of the gradients back
                  (``optim.adamw``), a serving call's cache rows
                  (``launch.specs``);
* ``Relayout``  — the same move as an ``autograd.Function``, its gradient
                  taken the way back (``partition.constrain``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate


def relayout(t, mesh, src, dst):
    """The local tensor ``t`` of a layout at placements ``src`` (Shard,
    Replicate or Partial on each mesh dim) -> its local tensor at ``dst``
    (Shard or Replicate). Over each mesh dim of more than one rank, a
    Partial is summed (reduce-scatter into a Shard, else all-reduce), a
    Shard it leaves is all-gathered and a Shard it enters is cut; over one
    rank only the cut (a no-op) is taken. A Partial summed by all-reduce
    is summed in ``t``'s own storage where ``t`` is contiguous (the train
    step's gradients are its own): pass a copy to keep ``t``. Shards are
    even (``partition.resolve`` drops an axis that does not divide; the
    tensor-parallel plan splits whole units). A tensor dim over two mesh
    dims (a decode cache's sequence over ("data", "model"), split major to
    minor) is gathered minor dim first and cut major dim first, whole, and
    takes no Partial."""
    owner = {}
    for d in range(mesh.ndim):
        for pl in (src[d], dst[d]):
            if pl.is_shard():
                owner.setdefault(pl.dim, set()).add(d)
    multi = {i for i, ds in owner.items() if len(ds) > 1}
    if multi:
        if any(pl.is_partial() for pl in src):
            raise NotImplementedError(f"a Partial beside two mesh dims on "
                                      f"one tensor dim: {src} -> {dst}")
        return _relayout_multi(t, mesh, src, dst, multi)
    for d in range(mesh.ndim):
        a, b, n = src[d], dst[d], mesh.size(d)
        if a == b:
            continue
        group = mesh.get_group(d)
        if a.is_partial():
            if n > 1 and b.is_shard():
                x = t.movedim(b.dim, 0).contiguous()
                out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
                dist.reduce_scatter_tensor(out, x, group=group)
                t = out.movedim(0, b.dim)
                continue
            if n > 1:
                t = t.contiguous()
                dist.all_reduce(t, group=group)
        elif a.is_shard() and n > 1:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, a.dim)
        if b.is_shard():
            if t.shape[b.dim] % n:
                raise ValueError(f"uneven shard: dim {b.dim} of "
                                 f"{tuple(t.shape)} over {n} ranks")
            k = t.shape[b.dim] // n
            t = t.narrow(b.dim, mesh.get_local_rank(d) * k, k)
    return t


def _relayout_multi(t, mesh, src, dst, multi):
    """``relayout`` where the tensor dims ``multi`` lie on two mesh dims
    or more: such a dim whose mesh dims change is gathered whole and cut
    again; one whose mesh dims stay (a batch over ("pod", "data")) is
    left as it is."""
    def dims(pls, i):
        return [d for d, pl in enumerate(pls) if pl.is_shard() and
                pl.dim == i]
    redo = {i for i in multi if dims(src, i) != dims(dst, i)}

    def moves(a, b):
        return a != b or (a.is_shard() and a.dim in redo) or \
            (b.is_shard() and b.dim in redo)
    for d in reversed(range(mesh.ndim)):
        a, n = src[d], mesh.size(d)
        if a.is_shard() and n > 1 and moves(a, dst[d]):
            x = t.movedim(a.dim, 0).contiguous()
            out = x.new_empty((n * x.shape[0],) + x.shape[1:])
            dist.all_gather_into_tensor(out, x, group=mesh.get_group(d))
            t = out.movedim(0, a.dim)
    for d in range(mesh.ndim):
        b, n = dst[d], mesh.size(d)
        if b.is_shard() and moves(src[d], b):
            k = t.shape[b.dim] // n
            t = t.narrow(b.dim, mesh.get_local_rank(d) * k, k)
    return t


class Relayout(torch.autograd.Function):
    """``relayout`` of a local tensor from placements ``src`` to ``dst``,
    which leaves its input as it was (a Partial's is summed in a copy), and
    of its gradient back (a Partial's as a Replicate)."""

    @staticmethod
    def forward(ctx, t, mesh, src, dst):
        ctx.back = mesh, dst, tuple(Replicate() if pl.is_partial() else pl
                                    for pl in src)
        if any(pl.is_partial() for pl in src):
            t = t.clone()
        return relayout(t, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        return relayout(g, *ctx.back), None, None, None
