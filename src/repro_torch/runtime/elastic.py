"""Elastic re-meshing: move a sharded train state onto a different mesh
(mirrors ``repro/runtime/elastic.py``).

Supports both scale-down (node loss: fewer data shards) and scale-up.
Logical-axis specs make the state mesh-agnostic: each leaf is gathered
from its old placement and distributed on the new mesh at
``placements(resolve(axes, shape, new_mesh))``, which works between any two
meshes whose axes divide the shapes (the resolver drops the rest). The
strategy choice of ``plan_remesh_migrations`` is a copy of the reference
orchestrator's ``choose_migration_strategy`` (the simulator is not part of
the port).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.sharding import partition as part

# the migration strategies' names, as the reference orchestrator's
STOP_AND_COPY = "stop_and_copy"
PRE_COPY = "pre_copy"
POST_COPY = "post_copy"


def _leaf_moved(axes, leaf, new_mesh, rules, root):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    if axes == ():
        # the step counter stays a plain tensor where it was (the schedule
        # is computed there); the new mesh's first rank sends its value
        t = leaf.detach().to(new_mesh.device_type, copy=True)
        dist.broadcast(t, src=root)
        return t.to(leaf.device)
    if isinstance(leaf, DTensor):
        if leaf.device_mesh.get_coordinate() is not None:
            full = leaf.full_tensor()
        else:     # a rank the old mesh left out holds nothing: it receives
            full = torch.empty(leaf.shape, dtype=leaf.dtype,
                               device=leaf.to_local().device)
    else:
        full = leaf.detach()
    spec = part.resolve(axes, full.shape, new_mesh, rules)
    return distribute_tensor(full, new_mesh, part.placements(spec, new_mesh),
                             src_data_rank=0)


def remesh_state(state, state_logical, old_mesh, new_mesh, rules=None):
    """Re-shard ``state`` (a tree of tensors: DTensors on ``old_mesh``, or
    plain tensors taken whole when ``old_mesh`` is None) onto ``new_mesh``,
    laid out by ``state_logical`` (``optim.adamw.state_logical``).

    Collective over every rank of the default group. The new mesh's first
    rank (coordinate 0 on every dimension) is the source of every leaf
    (``distribute_tensor``'s ``src_data_rank=0``), so it must hold the
    state: a rank of the old mesh, or any rank when ``old_mesh`` is None.
    Ranks joining on a scale-up receive their shards from it; ranks the new
    mesh leaves out on a scale-down keep empty locals."""
    import torch.distributed as dist
    root = int(new_mesh.mesh.reshape(-1)[0])
    if old_mesh is not None and root not in old_mesh.mesh.reshape(-1).tolist():
        raise ValueError(f"the new mesh's first rank {root} is not in the "
                         f"old mesh: it holds no state to send")
    if not dist.is_initialized():
        raise RuntimeError("remesh_state needs torch.distributed's default "
                           "process group")
    return part.map_specs(
        lambda axes, leaf: _leaf_moved(axes, leaf, new_mesh, rules, root),
        state_logical, state)


def scaled_batch(global_batch: int, old_world: int, new_world: int) -> int:
    """Keep per-replica batch constant under rescale (sync SGD semantics:
    the optimizer's LR schedule is rescaled by the caller if desired)."""
    per = global_batch // old_world
    return per * new_world


def choose_migration_strategy(image_bytes: int, dirty_rate_Bps: float,
                              bw_Bps: float, max_downtime_s: float) -> str:
    """Link-bandwidth-budget strategy selection:

    * whole image moves within the downtime budget -> stop-and-copy;
    * dirty rate low enough for deltas to converge  -> pre-copy;
    * otherwise post-copy (stop window bounded by the verbs image alone).
    """
    if bw_Bps <= 0:
        return POST_COPY
    if image_bytes / bw_Bps <= max_downtime_s:
        return STOP_AND_COPY
    if dirty_rate_Bps < 0.5 * bw_Bps:
        return PRE_COPY
    return POST_COPY


def plan_remesh_migrations(shard_bytes: int, moved_ranks, *,
                           bw_Bps: float, max_downtime_s: float,
                           dirty_rate_Bps: float = 0.0) -> Dict[int, str]:
    """Per-rank migration strategy for an elastic re-mesh.

    A rescale moves each displaced rank's container (params/opt shards in
    its MRs) to a new node; the link-bandwidth budget decides per rank
    whether plain stop-and-copy fits the downtime budget or whether the
    move must be a live pre-copy/post-copy."""
    return {int(r): choose_migration_strategy(shard_bytes, dirty_rate_Bps,
                                              bw_Bps, max_downtime_s)
            for r in moved_ranks}
