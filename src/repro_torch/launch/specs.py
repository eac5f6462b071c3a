"""Input and state specs per (arch × shape) (mirrors
``repro/launch/specs.py``): stand-in tensors (``meta`` ones: shapes and
dtypes, no storage) and the resolved shardings of every argument leaf,
shared by the dry-run. No allocation.

``input_specs`` gives, as the reference's: ``cfg``, ``lm``, ``kind``,
``args``, ``in_shardings``, ``out_shardings`` and ``donate_argnums``, plus
``logical`` (each argument leaf's logical axes). The shardings are
``partition.NamedSharding``s at ``partition.resolve``'s specs; ``place``
turns the stand-ins into DTensors at those specs (a train state's
placements are ``runtime.elastic.remesh_state``'s), and ``build_fn``
returns the port's function of the cell: the step of
``optim.adamw.make_train_step``, ``LM.prefill`` or ``LM.decode_step``. On a
mesh the serving calls compute as the train step does
(``adamw.point_params``): in the tensor-parallel region of
``adamw.tp_plan`` (``sharding.tp``), on this rank's slice of the batch,
each split leaf at this rank's heads, ffn columns, RNN channels, SSD
heads' sections or vocabulary rows and the other leaves gathered. A decode cache leaf of a split block goes in
and out as this rank's storage shard, read and written in place; one of a
gathered block (the other mixers, and every block of a model whose plan
splits nothing) is all-gathered over its non-batch axes by c10d
(``adamw._relayout``), written by the step and cut back to its shard.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.models.layers import tree_map
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.sharding import partition as part
from repro_torch.sharding import tp as TP


def _stand_in(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                compute_dtype=torch.bfloat16) -> Tuple[Dict, Dict]:
    """(stand-in tensors, logical axes) for one training or prefill
    batch."""
    B, S = shape.global_batch, shape.seq_len
    sds, axes = {}, {}
    if cfg.family == "vlm":
        Sv = cfg.frontend_tokens
        sds["vision_embeds"] = _stand_in((B, Sv, cfg.d_model),
                                         compute_dtype)
        axes["vision_embeds"] = ("batch", "seq", None)
        sds["tokens"] = _stand_in((B, S - Sv), torch.int32)
        axes["tokens"] = ("batch", "seq")
    elif cfg.family == "encdec":
        sds["frames"] = _stand_in((B, S, cfg.d_model), compute_dtype)
        axes["frames"] = ("batch", "seq", None)
        sds["tokens"] = _stand_in((B, S), torch.int32)
        axes["tokens"] = ("batch", "seq")
    else:
        sds["tokens"] = _stand_in((B, S), torch.int32)
        axes["tokens"] = ("batch", "seq")
    return sds, axes


def shardings_of(tree, tree_axes, mesh, rules=None):
    """A tree of ``NamedSharding``s: each leaf's logical axes resolved
    against its shape on ``mesh``."""
    return part.map_specs(
        lambda axes, t: part.NamedSharding(
            mesh, part.resolve(axes, t.shape, mesh, rules)),
        tree_axes, tree)


def abstract_state(lm) -> Dict[str, Any]:
    """The AdamW state of ``lm``'s parameters as stand-ins of their shapes
    and dtypes, keyed as ``adamw.init_state``'s."""
    params = {n: _stand_in(p.shape, p.dtype)
              for n, p in lm.named_parameters()}
    return {"step": _stand_in((), torch.int32), "params": params,
            "m": {n: torch.empty_like(p) for n, p in params.items()},
            "v": {n: torch.empty_like(p) for n, p in params.items()}}


def input_specs(arch_or_cfg, shape: ShapeConfig, mesh, *, rules=None,
                cfg_overrides=None) -> Dict[str, Any]:
    """Everything needed to run one cell: the module's docstring."""
    cfg = (get_config(arch_or_cfg) if isinstance(arch_or_cfg, str)
           else arch_or_cfg)
    if shape.kind != "train":
        # decode/prefill shapes size the enc-dec frontend to the shape
        if cfg.family == "encdec":
            cfg = cfg.replace(frontend_tokens=shape.seq_len)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    lm = LM(cfg, device="meta")
    cdt = lm.compute_dtype
    p_abs = {n: _stand_in(p.shape, p.dtype)
             for n, p in lm.named_parameters()}
    p_axes = adamw.state_logical(lm)["params"]
    p_sh = shardings_of(p_abs, p_axes, mesh, rules)

    if shape.kind == "train":
        sds, axes = batch_specs(cfg, shape, cdt)
        st_abs = abstract_state(lm)
        st_axes = adamw.state_logical(lm)
        st_sh = shardings_of(st_abs, st_axes, mesh, rules)
        b_sh = shardings_of(sds, axes, mesh, rules)
        return dict(cfg=cfg, lm=lm, kind="train",
                    args=(st_abs, sds), logical=(st_axes, axes),
                    in_shardings=(st_sh, b_sh),
                    out_shardings=(st_sh, None), donate_argnums=(0,))

    if shape.kind == "prefill":
        sds, axes = batch_specs(cfg, shape, cdt)
        b_sh = shardings_of(sds, axes, mesh, rules)
        return dict(cfg=cfg, lm=lm, kind="prefill", capacity=shape.seq_len,
                    args=(p_abs, sds), logical=(p_axes, axes),
                    in_shardings=(p_sh, b_sh),
                    out_shardings=None, donate_argnums=())

    # decode: one new token with a cache of capacity seq_len
    B = shape.global_batch
    cache_abs = tree_map(lambda t: _stand_in(t.shape, t.dtype),
                         lm.init_cache(B, shape.seq_len))
    cache_axes = lm.cache_logical()
    c_sh = shardings_of(cache_abs, cache_axes, mesh, rules)
    tok = _stand_in((B, 1), torch.int32)
    tok_axes = ("batch", None)
    tok_sh = part.NamedSharding(mesh, part.resolve(tok_axes, (B, 1), mesh,
                                                   rules))
    return dict(cfg=cfg, lm=lm, kind="decode", capacity=shape.seq_len,
                args=(p_abs, cache_abs, tok),
                logical=(p_axes, cache_axes, tok_axes),
                in_shardings=(p_sh, c_sh, tok_sh),
                out_shardings=(c_sh, None), donate_argnums=(1,))


def place(spec):
    """The cell's arguments as the port holds them on the mesh: each leaf
    of the train state's params, m and v, and of a serving cell's
    parameters and decode cache, a DTensor at its resolved spec (the
    placements ``runtime.elastic.remesh_state`` gives a state; the step
    counter stays a plain tensor, as there); a batch or tokens whole (the
    step takes each rank's slice itself)."""
    def placed(axes, t, sh):
        return t if axes == () else _placed(t, sh)
    args = tuple(part.map_specs(placed, ax, a, sh) if isinstance(ax, dict)
                 else a
                 for a, ax, sh in zip(spec["args"], spec["logical"],
                                      spec["in_shardings"]))
    if spec["kind"] != "decode":       # the batch stays whole
        args = (args[0], spec["args"][1])
    return args


def _placed(t, sharding):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def _batch_only(axes, placements):
    """Placements with every shard but the one of the ``batch`` dim made
    Replicate: a rank's batch rows, whole otherwise."""
    from torch.distributed.tensor import Replicate
    b = list(axes).index("batch")
    return [pl if pl.is_shard() and pl.dim == b else Replicate()
            for pl in placements]


def cache_in(cache, cache_axes, split, mesh):
    """Each decode-cache leaf (a DTensor at its storage spec) as a serving
    call computes on it: a split block's (``split``, ``LM.cache_split``)
    its local shard itself, written in place; a gathered block's its batch
    rows gathered whole by c10d (``adamw._relayout``)."""
    from repro_torch.optim.adamw import _relayout

    def local(axes, t, s):
        if s:
            return t.to_local()
        return _relayout(t.to_local(), mesh, t.placements,
                         _batch_only(axes, t.placements))
    return part.map_specs(local, cache_axes, cache, split)


def cache_out(cache, cache_axes, split, shardings, mesh):
    """A serving call's local cache leaves back at their storage specs
    (``shardings``) as DTensors: a split block's shard as it is (the
    input's storage after a decode), a gathered block's batch rows cut to
    this rank's shard."""
    from torch.distributed.tensor import DTensor
    from repro_torch.optim.adamw import _relayout

    def out(axes, t, s, sh):
        pl = sh.placements
        if not s:
            t = _relayout(t, mesh, _batch_only(axes, pl), pl).contiguous()
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return part.map_specs(out, cache_axes, cache, split, shardings)


def build_fn(spec, *, opt_cfg=None, impl=None, schedule="full"):
    """The port's function of the cell, taking ``place``'s arguments. On a
    mesh a serving call returns its cache at its storage specs, the
    decode's at ``out_shardings``' as the reference's, the prefill's at
    the same specs (the reference leaves the prefill's out sharding to
    XLA), so that a decode can follow on the mesh; and the logits as a
    DTensor split over the batch axes, whole over the vocabulary."""
    lm = spec["lm"]
    if spec["kind"] == "train":
        opt_cfg = opt_cfg or adamw.OptConfig()
        return adamw.make_train_step(lm, opt_cfg, impl=impl,
                                     schedule_kind=schedule)
    cache_axes = lm.cache_logical()
    cap = spec["capacity"]
    B = (spec["args"][1]["tokens"] if spec["kind"] == "prefill"
         else spec["args"][2]).shape[0]
    at = {}

    def layout(mesh, rules):
        """The cell's cache layouts and storage shardings on ``mesh``, from
        the cell's shapes: once, when the function is built inside
        ``partition.activate`` (so that a dry-run does not count the
        stand-ins they are read from), else at the first call."""
        if at.get("mesh") is not mesh:
            at.update(mesh=mesh, layouts=lm.cache_layouts(
                mesh, B, cap, rules), shardings=shardings_of(
                lm.init_cache(B, cap), cache_axes, mesh, rules))
        return at["layouts"], at["shardings"]
    if part._active()[0] is not None:
        layout(*part._active())

    def serve(params, batch, call):
        """``call(local batch, split)`` -> (local cache, logits) in the
        region, on this rank's weights; -> (cache DTensors, logits
        DTensor)."""
        from torch.distributed.tensor import DTensor
        mesh, rules = part._active()
        plan = adamw.tp_plan(lm, mesh)
        adamw.point_params(lm, params, mesh, plan)
        local = adamw.batch_dims(batch, mesh, rules)[2]
        split = lm.cache_split(plan)
        layouts, shardings = layout(mesh, rules)
        with TP.region(mesh, plan, layouts):
            cache, logits = call(local, split)
        logits = DTensor.from_local(
            logits, mesh, part.placements(part.resolve(
                ("batch", None), (B, logits.shape[-1]), mesh, rules), mesh),
            run_check=False)
        return cache_out(cache, cache_axes, split, shardings, mesh), logits

    if spec["kind"] == "prefill":
        def prefill(params, batch):
            if part._active()[0] is None:
                return lm.prefill(batch, cap, impl=impl)
            return serve(params, batch,
                         lambda local, split: lm.prefill(local, cap,
                                                         impl=impl))
        return prefill

    def decode(params, cache, tokens):
        mesh = part._active()[0]
        if mesh is None:
            return lm.decode_step(cache, tokens)

        def call(local, split):
            return lm.decode_step(
                cache_in(cache, cache_axes, split, mesh), local["tokens"])
        return serve(params, {"tokens": tokens}, call)
    return decode
