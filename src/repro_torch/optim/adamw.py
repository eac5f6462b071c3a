"""AdamW with a cosine schedule, global-norm clipping and an optional int8
gradient-compression hook (mirrors ``repro/optim/adamw.py``).

The state keeps the reference's layout, ``{step, params, m, v}``, with each
tree flattened to a dict keyed by the parameter's dotted path (the
``named_parameters`` names, which are the JAX tree's paths; ``state_tree``
nests it back into the reference's tree for checkpoints). ``params``
holds the ``LM``'s own ``nn.Parameter``s, and ``apply_updates`` writes
params, ``m`` and ``v`` in place under ``torch.no_grad()``: at full width a
functional copy would double the fp32 weights (13 GB for deepseek-7b at 12
layers). The arithmetic is the reference's, in fp32, leaf by leaf.

On a mesh (``sharding.partition.activate``) the state's params, ``m`` and
``v`` are DTensors laid out by ``state_logical`` (``runtime.elastic.
remesh_state`` places them), and ``make_train_step``'s step:

* points each of the LM's parameters at its compute copy, gathered over
  the mesh's axes, but under EP an expert weight keeps this rank's
  experts and under tensor parallelism (``LM.tp_plan`` of the ``"model"``
  axis, ``partition.compute_axis``) a split leaf keeps this rank's heads,
  ffn columns or rows, RNN channels, or vocabulary rows on that axis (a
  leaf stored whole, such as the RG-LRU's ``a_log`` or Mamba-2's
  ``norm``, is cut on its last dim: ``partition.compute_dim``), and a
  leaf taken by sections (Mamba-2's ``in_proj`` and ``conv_w``,
  ``LM.sections``) is gathered over the axis and indexed to this rank's
  columns. Where the compute placement is the storage's (world size 1; a
  split leaf on a mesh whose other axes are 1) the copy is the state's own
  storage, else a copy that holds, after the step, the weights the step
  used;
* runs the loss on this rank's slice of the batch over the ``batch`` axes,
  inside the tensor-parallel region (``sharding.tp``);
* brings each gradient back to its leaf's placement: summed over the
  batch axes and divided by their size (a mean), summed over the expert
  axis for the leaves ``moe.ep_partial`` names (the router, and the shared
  experts where they compute gathered) and over the model axis for
  those ``partition.partial_over_model`` names (``q_norm``/``k_norm``, and
  gathered ``wk``/``wv``, used by this rank's heads only), then this
  rank's shard. A split leaf's gradient is its shard's already (a cut of
  a leaf stored whole goes back by the all-gather, exact: the ranks own
  disjoint channels); a leaf taken by sections scatters its gradient into
  zeros of the whole width and sums it over the model axis, exact too
  (each z, x and dt column is one rank's; B's and C's add the ranks'
  partial gradients); the norms ahead of a split block get whole
  gradients and are not summed;
* runs AdamW on the local shards. The clip norm counts each element once
  (a leaf replicated over a mesh dim counts on that dim's rank 0) and sums
  the leaves in ``apply_updates``' order, so a world-1 step is bit-equal
  to the unsharded one; ``compress_grads`` takes a global scale, and each
  rank draws every leaf's whole noise and keeps its shard of it.

The reported loss, ``ce`` and ``aux`` are means over the batch axes. An
MoE model on a mesh without EP computes each rank's ``aux`` from its batch
slice (the reference's GSPMD computes it over the global batch).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.models import moe as MOE
from repro_torch.models.layers import flatten_paths
from repro_torch.sharding import partition as part


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False     # int8 compression before reduction


def schedule(cfg: OptConfig, step):
    """Linear warmup, then cosine decay to 0; fp32, as the reference."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1 + torch.cos(math.pi * prog)))


def init_state(params) -> Dict[str, object]:
    """``params``: an ``nn.Module`` or a dict of name -> tensor. The state
    holds those very tensors, and zeroed ``m`` and ``v`` beside them."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {"step": torch.zeros((), dtype=torch.int32),
            "params": dict(params),
            "m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()}}


def state_logical(lm) -> Dict[str, object]:
    """The state's logical axes, keyed as ``init_state``'s: ``()`` for the
    step, and each parameter's axes (``lm.specs()``) for params, m and v."""
    axes = {n: d.axes for n, d in flatten_paths(lm.defs())}
    return {"step": (), "params": axes, "m": dict(axes), "v": dict(axes)}


def state_tree(state, lm) -> Dict[str, object]:
    """The state as the reference's pytree ``{step, params, m, v}``: each
    path dict nested along ``lm.defs()``, so that ``core``, ``head`` and
    ``tail`` are lists as in the reference (``tail.10`` after ``tail.9``),
    with the state's own tensors as leaves. ``checkpoint.ckpt`` saves it and
    restores into it in the reference's leaf order."""
    defs = lm.defs()
    paths = {p for p, _ in flatten_paths(defs)}

    def nest(tree, flat, prefix):
        if isinstance(tree, dict):
            return {k: nest(v, flat, f"{prefix}{k}.")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [nest(v, flat, f"{prefix}{i}.")
                    for i, v in enumerate(tree)]
        return flat[prefix[:-1]]

    out = {"step": state["step"]}
    for part in ("params", "m", "v"):
        if state[part].keys() != paths:
            raise KeyError(f"state[{part!r}] paths differ from the LM's: "
                           f"{sorted(state[part].keys() ^ paths)}")
        out[part] = nest(defs, state[part], "")
    return out


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _local(t):
    return t.to_local() if isinstance(t, _dtensor()) else t


def _over_mesh(t, mesh, op=None):
    """``t`` reduced (sum, or ``op``) over every dimension of ``mesh``, in
    place, dimension by dimension."""
    import torch.distributed as dist
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.all_reduce(t, op=op or dist.ReduceOp.SUM,
                            group=mesh.get_group(d))
    return t


def _shard_of(full, like):
    """This rank's shard of ``full`` in ``like``'s (a DTensor's) layout."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def _compress(g, generator: torch.Generator, like=None):
    """int8 stochastic-rounding quantise/dequantise with a per-tensor
    scale, unbiased; the noise comes from ``generator`` (the reference
    draws it from a JAX key, so the bits differ; the statistics agree).
    With ``like``, a DTensor whose local shard ``g`` is, the scale is the
    whole leaf's and the noise this shard's of the whole leaf's draw."""
    import torch.distributed as dist
    amax = g.abs().max()
    if like is not None:
        amax = _over_mesh(amax.clone(), like.device_mesh, dist.ReduceOp.MAX)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    shape = like.shape if like is not None else g.shape
    noise = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    if like is not None:
        noise = _shard_of(noise, like)
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


def _owned(t) -> bool:
    """Whether this rank counts a leaf in the global norm: its coordinate
    is 0 on every mesh dim that replicates the leaf (always, unsharded)."""
    if not isinstance(t, _dtensor()):
        return True
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements)
               if pl.is_replicate())


@torch.no_grad()
def apply_updates(cfg: OptConfig, state, grads,
                  generator: Optional[torch.Generator] = None):
    """One AdamW step: ``grads`` is a dict keyed like ``state["params"]``.
    Params, ``m`` and ``v`` are updated in place; returns (state,
    {"grad_norm", "lr"}). With ``compress_grads`` the noise comes from
    ``generator``, by default a generator seeded with the new step."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    names = list(state["params"])
    grads = {n: grads[n] for n in names}
    DTensor = _dtensor()
    like = {n: t for n, t in state["params"].items()
            if isinstance(t, DTensor)}
    mesh = next(iter(like.values())).device_mesh if like else None

    if cfg.compress_grads:
        gen = generator or torch.Generator(
            device=grads[names[0]].device).manual_seed(int(step))
        grads = {n: _compress(g, gen, like.get(n)) for n, g in grads.items()}

    if cfg.clip_norm > 0:
        sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
        if mesh is not None:
            # each leaf's squared norm once over the mesh, summed in order
            own = torch.tensor([_owned(state["params"][n]) for n in names],
                               device=sq[0].device)
            sq = _over_mesh(torch.stack(sq) * own, mesh).unbind()
        gn = torch.sqrt(sum(sq))
        scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gn, 1e-12),
                            max=1.0)
        grads = {n: g * scale.to(g.dtype) for n, g in grads.items()}
    else:
        gn = torch.zeros((), dtype=torch.float32)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for n in names:
        p, m, v = (_local(state[k][n]) for k in ("params", "m", "v"))
        gf = grads[n].float()
        mf = m.float().mul_(b1).add_(gf, alpha=1 - b1)
        vf = v.float().mul_(b2).addcmul_(gf, gf, value=1 - b2)
        u = (mf / bc1).div_((vf / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        if cfg.weight_decay:
            u.add_(pf, alpha=cfg.weight_decay)
        # p - lr u; for fp32 leaves pf, mf and vf are p, m and v themselves
        p.copy_(pf.sub_(u.mul_(lr)))
        m.copy_(mf)
        v.copy_(vf)
    state = {"step": step, "params": state["params"], "m": state["m"],
             "v": state["v"]}
    return state, {"grad_norm": gn, "lr": lr}


def batch_dims(batch, mesh, rules):
    """The mesh dims the batch is split over (its ``batch`` axes, where
    they divide B) and this rank's slice of every entry."""
    B = next(iter(batch.values())).shape[0]
    spec = part.resolve(("batch",), (B,), mesh, rules)
    axes = () if not spec else ((spec[0],) if isinstance(spec[0], str)
                                else tuple(spec[0]))
    names = list(part.axis_sizes(mesh))
    dims = [names.index(a) for a in axes]
    n, i = 1, 0
    for d in dims:                       # major to minor
        n, i = n * mesh.size(d), i * mesh.size(d) + mesh.get_local_rank(d)
    return dims, n, {k: v.narrow(0, i * (B // n), B // n)
                     for k, v in batch.items()}


def _ep_dim(lm, mesh):
    """The mesh dim of the expert axis when EP applies, else None."""
    ep = MOE.expert_axis(lm.cfg)
    return list(part.axis_sizes(mesh)).index(ep) if ep else None


def tp_plan(lm, mesh, rules=None):
    """The LM's tensor-parallel plan on ``mesh``'s model axis under
    ``rules`` (default: the active ones), or None when the mesh has no
    model axis or it is of size 1."""
    size = part.axis_sizes(mesh).get(part.TP_AXIS, 1)
    return lm.tp_plan(size, rules) if size > 1 else None


def _compute_placements(lm, mesh, plan=None):
    """``fn(name, dtensor)`` -> the placements a rank computes on:
    Replicate, but an expert weight's shard over the expert axis and,
    with ``plan``, a split leaf's shard over the model axis (a leaf taken
    by sections is gathered there, then indexed: ``_sections``)."""
    from torch.distributed.tensor import Replicate, Shard
    logical = state_logical(lm)["params"]
    blocks = lm.leaf_blocks()
    names = list(part.axis_sizes(mesh))
    ep_dim = _ep_dim(lm, mesh)
    tp_dim = names.index(part.TP_AXIS) if plan is not None else None

    def compute_placements(n, dt):
        keep = ep_dim is not None and "experts" in logical[n]
        ax = part.compute_axis(plan, blocks.get(n), n.rsplit(".", 1)[-1])
        out = []
        for d, pl in enumerate(dt.placements):
            if keep and d == ep_dim:
                out.append(pl)
            elif ax not in (None, part.SECTIONS) and d == tp_dim:
                out.append(Shard(part.compute_dim(logical[n], ax)))
            else:
                out.append(Replicate())
        return out
    return compute_placements


def _relayout(t, mesh, src, dst):
    """The local tensor ``t`` of a layout at placements ``src`` (Shard,
    Replicate or Partial on each mesh dim) -> its local tensor at ``dst``
    (Shard or Replicate). The one path both ways of the mesh step take: the
    compute copies from storage, the gradients back to it. Over each mesh
    dim of more than one rank, a Partial is summed (reduce-scatter into a
    Shard, else all-reduce), a Shard it leaves is all-gathered and a Shard
    it enters is cut; over one rank only the cut (a no-op) is taken. These
    are c10d calls on the mesh's groups, which gloo takes for CUDA tensors
    (staged through the host), where DTensor's functional all-gather of a
    CUDA tensor crashed gloo. Shards are even (``partition.resolve`` drops
    an axis that does not divide; the tensor-parallel plan splits whole
    units). A tensor dim over two mesh dims (a decode cache's sequence
    over ("data", "model"), split major to minor) is gathered minor dim
    first and cut major dim first, whole, and takes no Partial."""
    import torch.distributed as dist
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
    """``_relayout`` where the tensor dims ``multi`` lie on two mesh dims
    or more: such a dim whose mesh dims change is gathered whole and cut
    again; one whose mesh dims stay (a batch over ("pod", "data")) is
    left as it is."""
    import torch.distributed as dist

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


def _sections(lm, mesh, plan):
    """The leaves ``plan`` takes by sections -> the indices of this rank's
    columns along their last dim (``LM.sections``); {} without a plan."""
    if plan is None:
        return {}
    return lm.sections(plan, mesh.get_local_rank(part.TP_AXIS))


def _by_layer(fn, t):
    """``fn(t)``, for a stacked leaf ([layers, ...]: more than 2 dims)
    taken one layer at a time, each slice keeping dim 0 (so placements
    still name its dims): a whole-width temporary of a leaf taken by
    sections then holds one layer."""
    if t.dim() <= 2:
        return fn(t)
    return torch.cat([fn(t.narrow(0, i, 1)) for i in range(t.shape[0])])


def _point_at(lm, params, mesh, compute_placements, sections):
    with torch.no_grad():
        for n, p in lm.named_parameters():
            dt = params[n]
            pl = compute_placements(n, dt)

            def compute(t):
                return _relayout(t, mesh, dt.placements, pl)
            if n in sections:
                idx = sections[n].to(dt.device)
                p.data = _by_layer(
                    lambda t: compute(t).index_select(-1, idx),
                    dt.to_local())
            else:
                p.data = compute(dt.to_local())
            p.grad = None


def point_params(lm, params, mesh, plan=None):
    """Point each of the LM's parameters at its compute copy, as the train
    step does: the DTensor ``params[name]`` gathered, but an expert
    weight's shard over the expert axis under EP and, with ``plan``
    (``tp_plan``), a split leaf's shard over the model axis or its
    sections; clears the gradients. What a serving call on a mesh does
    before it runs (``launch.specs.build_fn``); without ``plan`` every
    other leaf is gathered whole."""
    _point_at(lm, params, mesh, _compute_placements(lm, mesh, plan),
              _sections(lm, mesh, plan))


def _mesh_step(lm, cfg, state, batch, impl, schedule_kind, generator,
               mesh, rules):
    """One train step on ``mesh`` (the module's docstring)."""
    from repro_torch.sharding import tp as TP
    from torch.distributed.tensor import Partial
    ep_dim = _ep_dim(lm, mesh)
    plan = tp_plan(lm, mesh, rules)
    blocks = lm.leaf_blocks()
    params = dict(lm.named_parameters())
    compute_placements = _compute_placements(lm, mesh, plan)
    sections = _sections(lm, mesh, plan)
    _point_at(lm, state["params"], mesh, compute_placements, sections)
    dims, n_batch, local = batch_dims(batch, mesh, rules)
    with TP.region(mesh, plan):
        loss, metrics = lm.loss(local, impl=impl, schedule=schedule_kind)
        loss.backward()
    tp_dim = list(part.axis_sizes(mesh)).index(part.TP_AXIS) \
        if plan is not None else None
    grads = {}
    with torch.no_grad():
        for n, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            dt = state["params"][n]
            pl = compute_placements(n, dt)
            partial = list(dims) + ([ep_dim] if ep_dim is not None and
                                    MOE.ep_partial(n, plan) else [])
            if n in sections or part.partial_over_model(
                    plan, blocks.get(n), n.rsplit(".", 1)[-1]):
                partial.append(tp_dim)
            for d in partial:
                pl[d] = Partial()

            def storage(g):
                return _relayout(g, mesh, pl, dt.placements)
            if n in sections:    # scattered into the gathered width
                idx, width = sections[n].to(g.device), dt.shape[-1]
                grads[n] = _by_layer(lambda g: storage(g.new_zeros(
                    g.shape[:-1] + (width,)).index_copy_(-1, idx, g)),
                    g) / n_batch
            else:
                grads[n] = storage(g) / n_batch
        vec = torch.stack([loss.detach(), metrics["ce"].detach(),
                           metrics["aux"].detach()])
        for d in dims:
            torch.distributed.all_reduce(vec, group=mesh.get_group(d))
        out = dict(zip(("loss", "ce", "aux"), (vec / n_batch).unbind()))
    state, om = apply_updates(cfg, state, grads, generator)
    return state, dict(out, **om)


def make_train_step(lm, cfg: OptConfig, *, impl=None, schedule_kind="full",
                    generator: Optional[torch.Generator] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradients by autograd (``lm.loss`` with ``impl`` and the
    attention ``schedule_kind``), then ``apply_updates``. The gradients
    are dropped after the update, so they do not outlive the step. Under
    an active mesh the step is the sharded one (the module's docstring),
    on a state placed by ``runtime.elastic.remesh_state``."""

    def train_step(state, batch):
        mesh, rules = part._active()
        if mesh is not None:
            return _mesh_step(lm, cfg, state, batch, impl, schedule_kind,
                              generator, mesh, rules)
        params = state["params"]
        for p in params.values():
            p.grad = None
        loss, metrics = lm.loss(batch, impl=impl, schedule=schedule_kind)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        state, om = apply_updates(cfg, state, grads, generator)
        for p in params.values():
            p.grad = None
        out = {k: v.detach() for k, v in metrics.items()}
        return state, dict(out, loss=loss.detach(), **om)

    return train_step
