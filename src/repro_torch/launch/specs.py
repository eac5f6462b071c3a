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
mesh the serving calls compute as the train step does: each parameter
gathered whole (``adamw.gather_params``) and this rank's slice of the
batch, a decode cache gathered over every axis but its batch axes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, get_config
from repro_torch.models.layers import tree_map
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.sharding import partition as part


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
    return dict(cfg=cfg, lm=lm, kind="decode",
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


def _batch_local(cache, cache_axes, mesh, rules):
    """Each cache leaf (a DTensor) gathered over every mesh axis but its
    batch axes: this rank's batch rows, whole otherwise."""
    def local(axes, t):
        only = tuple(a if a == "batch" else None for a in axes)
        spec = part.resolve(only, t.shape, mesh, rules)
        return t.redistribute(mesh, part.placements(spec, mesh)).to_local()
    return part.map_specs(local, cache_axes, cache)


def build_fn(spec, *, opt_cfg=None, impl=None, schedule="full"):
    """The port's function of the cell, taking ``place``'s arguments."""
    lm = spec["lm"]
    if spec["kind"] == "train":
        opt_cfg = opt_cfg or adamw.OptConfig()
        return adamw.make_train_step(lm, opt_cfg, impl=impl,
                                     schedule_kind=schedule)

    def on_mesh(params, batch):
        mesh, rules = part._active()
        if mesh is None:
            return batch
        adamw.gather_params(lm, params, mesh)
        return adamw.batch_dims(batch, mesh, rules)[2]

    if spec["kind"] == "prefill":
        cap = spec["capacity"]

        def prefill(params, batch):
            return lm.prefill(on_mesh(params, batch), cap, impl=impl)
        return prefill

    cache_axes = spec["logical"][1]

    def decode(params, cache, tokens):
        mesh, rules = part._active()
        tokens = on_mesh(params, {"tokens": tokens})["tokens"]
        if mesh is not None:
            cache = _batch_local(cache, cache_axes, mesh, rules)
        return lm.decode_step(cache, tokens)
    return decode
