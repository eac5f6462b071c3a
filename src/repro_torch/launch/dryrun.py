"""Dry-run: trace one step of every (arch × shape × mesh) cell on meta
tensors over a fake world of 256 or 512 ranks in one process, and report
its per-device memory, FLOPs, bytes and collectives with the roofline
terms (mirrors ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 placeholder host devices).

A host tool by design, as the reference's: it initialises no real backend
and never touches CUDA. The world is torch's ``"fake"`` process group
(every collective returns at once), the mesh the production mesh
(``launch.mesh.make_production_mesh``'s shape on ``"cpu"``), every tensor a
``meta`` one (shapes and dtypes, no storage), and the counts are this process's
rank 0's (``roofline.counter``). The step runs the plain path
(``impl="plain"``): the kernels are ``ctypes`` launches that meta and fake
tensors cannot trace; the reference likewise lowers its XLA "blocked" path
on host devices. A train cell traces the tensor-parallel step (attention,
the encoder-decoder's self- and cross-attention among it, and MLA by
heads, dense MLPs and the MoE layers' shared experts by ffn, the RG-LRU
blocks by RNN width, the Mamba-2 blocks by SSD heads, the vocabulary
over "model", with their all-reduces, the routed experts on EP beside
them; ``partition.tp_plan``), and so does a serving cell,
whose decode cache stays at its storage shard (``launch.specs.build_fn``).
``--qkv-constraint batch`` pins q, k and v to heads over "model", which is
how the port computes them in every cell: it traces the same step.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out dry.jsonl
  python -m repro_torch.launch.dryrun --arch X --shape Y --multi-pod \\
         --schedule triangular --remat dots_saveable
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import specs as speclib
from repro_torch.roofline import analysis as roof
from repro_torch.roofline import counter as countlib
from repro_torch.sharding import partition as part

@contextlib.contextmanager
def fake_world(n: int):
    """torch's ``"fake"`` process group of ``n`` ranks, this process rank
    0, for the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed import fake_pg
    if dist.is_initialized():
        raise RuntimeError("the dry-run builds its own fake world, but a "
                           "process group is initialised already")
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_of(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return meshlib.make_mesh(shape, axes, device="cpu")


def _locals(tree):
    """Each tensor of a tree of dicts, lists and tuples, DTensors as their
    local shards."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def trace(spec, mesh, *, impl="plain", schedule="full", rules=None,
          opt_cfg=None):
    """One step of ``spec``'s cell (``specs.input_specs``) under a
    ``Counter``: on
    ``mesh`` from ``specs.place``'s DTensors, with no mesh (one device)
    the unsharded step on the LM's own parameters. -> (counter, memory
    dict). ``opt_cfg`` is a train step's ``OptConfig`` (the default
    one if None)."""
    from repro_torch.optim import adamw
    if mesh is not None:
        args = speclib.place(spec)
    elif spec["kind"] == "train":
        args = (adamw.init_state(spec["lm"]), spec["args"][1])
    else:
        args = spec["args"]
    with part.activate(mesh, rules):
        fn = speclib.build_fn(spec, opt_cfg=opt_cfg, impl=impl,
                              schedule=schedule)
    arg_ts = _locals(args)
    if mesh is None and spec["kind"] != "train":   # the LM's own weights
        arg_ts = list(spec["lm"].parameters()) + _locals(args[1:])
    arg_keys = {t.untyped_storage()._cdata for t in arg_ts}
    with part.activate(mesh, rules), countlib.Counter() as cnt:
        out = fn(*args)
    out_ts = _locals(out)
    alias = [t for t in out_ts if t.untyped_storage()._cdata in arg_keys]
    mem = {"argument_bytes": _bytes({t.untyped_storage()._cdata: t
                                     for t in arg_ts}.values()),
           "output_bytes": _bytes(out_ts) - _bytes(alias),
           "temp_bytes": int(cnt.peak_bytes),
           "alias_bytes": _bytes(alias)}
    mem["per_device_total"] = mem["argument_bytes"] + mem["temp_bytes"]
    return cnt, mem


def _traced(cfg, shape, mesh, overrides, impl, schedule, rules, opt_cfg):
    with part.activate(mesh, rules):
        spec = speclib.input_specs(cfg, shape, mesh, rules=rules,
                                   cfg_overrides=overrides)
    cnt, mem = trace(spec, mesh, impl=impl, schedule=schedule, rules=rules,
                     opt_cfg=opt_cfg)
    return mem, cnt, spec


def run_cell(arch, shape_name, *, multi_pod: bool = False,
             mesh_shape=None, schedule: str = "full", remat: str = "full",
             impl="plain", rules=None, verbose: bool = True,
             cfg_overrides=None, capacity_factor=None,
             opt_cfg=None) -> dict:
    """One cell's record. ``arch`` is an arch id or a ``ModelConfig``,
    ``shape_name`` a name of ``SHAPES`` or a ``ShapeConfig``; the mesh is
    the production one (``multi_pod``) unless ``mesh_shape`` names another
    (("data", "model"), or ("pod", "data", "model") for three dims); a
    mesh of one device runs the unsharded step, without a process
    group. A train cell's step is ``optim.adamw.make_train_step``'s with
    ``opt_cfg`` (the default ``OptConfig`` if None)."""
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    cfg0 = get_config(arch) if isinstance(arch, str) else arch
    overrides = dict(cfg_overrides or {})
    overrides.setdefault("remat", remat)
    if capacity_factor is not None and cfg0.moe is not None:
        overrides["moe"] = dataclasses.replace(
            cfg0.moe, capacity_factor=capacity_factor)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_shape = tuple(mesh_shape)
    n_dev = math.prod(mesh_shape)
    rec = {"arch": cfg0.name, "shape": shape.name,
           "mesh": "x".join(map(str, mesh_shape)), "devices": n_dev,
           "schedule": schedule, "impl": impl, "remat": overrides["remat"],
           "rules": "replicated_weights" if rules else "default",
           "capacity_factor": capacity_factor,
           "qkv_constraint": overrides.get("qkv_constraint")}
    t0 = time.time()
    world = fake_world(n_dev) if n_dev > 1 else contextlib.nullcontext()
    with world:
        mesh = _mesh_of(mesh_shape) if n_dev > 1 else None
        rec["memory"], cnt, spec = _traced(cfg0, shape, mesh, overrides,
                                           impl, schedule, rules, opt_cfg)
    rec["trace_s"] = round(time.time() - t0, 2)
    tot = cnt.totals()
    rec["cost"] = {"flops_per_dev": tot["flops"],
                   "bytes_per_dev": tot["bytes"]}
    rec["collectives"] = {"bytes_per_dev": tot["collective_bytes"],
                          "by_op": tot["by_op"]}
    rec["op_histogram"] = cnt.op_histogram()
    counts = roof.count_params(spec["cfg"])
    rec["params"] = counts
    mf = roof.model_flops(spec["cfg"], shape, counts)
    rl = roof.analyze(flops_per_dev=tot["flops"],
                      bytes_per_dev=tot["bytes"],
                      coll_bytes_per_dev=tot["collective_bytes"],
                      model_flops_total=mf, n_devices=n_dev)
    rec["roofline"] = rl.as_dict()
    if verbose:
        print(f"[{rec['arch']} × {shape.name} × {rec['mesh']}] "
              f"trace={rec['trace_s']}s "
              f"mem/dev={rec['memory']['per_device_total'] / 1e9:.2f}GB "
              f"compute={rl.compute_s * 1e3:.2f}ms "
              f"memory={rl.memory_s * 1e3:.2f}ms "
              f"coll={rl.collective_s * 1e3:.2f}ms "
              f"bottleneck={rl.bottleneck} useful={rl.useful_ratio:.2f}",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--schedule", default="full",
                    choices=["full", "triangular"])
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots_saveable"])
    ap.add_argument("--impl", default="plain", choices=["plain"],
                    help="the kernels cannot run on fake tensors")
    ap.add_argument("--qkv-constraint", default=None,
                    choices=[None, "none", "batch"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--replicate-weights", action="store_true",
                    help="inference rule override: no FSDP on weights")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)
    overrides = ({"qkv_constraint": args.qkv_constraint}
                 if args.qkv_constraint is not None else None)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                if shape_applicable(a, s):
                    cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = open(args.out, "a") if args.out else None
    failures = 0
    for arch, shp in cells:
        for mp in meshes:
            try:
                rules = ({"embed": None} if args.replicate_weights
                         else None)
                rec = run_cell(arch, shp, multi_pod=mp, impl=args.impl,
                               schedule=args.schedule, remat=args.remat,
                               rules=rules, cfg_overrides=overrides,
                               capacity_factor=args.capacity_factor)
            except Exception as e:  # noqa: BLE001
                failures += 1
                rec = {"arch": arch, "shape": shp, "multi_pod": mp,
                       "error": f"{type(e).__name__}: {e}"}
                print(f"[{arch} × {shp} × mp={mp}] FAILED: {e}",
                      file=sys.stderr)
                traceback.print_exc()
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
    if out:
        out.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
