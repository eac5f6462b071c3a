"""Device meshes on ``torch.distributed`` (mirrors ``repro/launch/mesh.py``).

Every function builds a ``DeviceMesh`` with named dimensions over ranks of
the default process group, which the caller initialises first
(``torch.distributed.init_process_group`` with its address, world size and
rank). Building a mesh is collective: every rank of the default group
calls it, also a rank the mesh leaves out (``new_group`` needs them all).

Single pod : (16, 16)    -> ("data", "model")        = 256 ranks
Multi-pod  : (2, 16, 16) -> ("pod", "data", "model") = 512 ranks
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the first prod(shape) ranks
    of the world, row-major, on ``device``'s type. A mesh smaller than the
    world (the 2 of 4 ranks left after an elastic scale-down) leaves the
    other ranks out; on them ``mesh.get_coordinate()`` is None."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group; call init_process_group first")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(*, device: str = "cuda"):
    """Every rank of the world as a 1-D "data" mesh."""
    import torch.distributed as dist
    return make_mesh((dist.get_world_size(),), ("data",), device=device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                           f" production mesh {shape} needs {need} ranks; "
                           f"this world has {world}")
    return make_mesh(shape, axes, device=device)


def _rank_entry(rank, fn, world, backend, device, init_file, timeout_s,
                out_dir, args):
    import datetime
    import pickle

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def default_backend(device: str, world: int) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else gloo
    (NCCL refuses two ranks on one card; gloo stages CUDA tensors through
    the host)."""
    import torch
    own_card = torch.device(device).type == "cuda" and \
        torch.cuda.device_count() >= world
    return "nccl" if own_card else "gloo"


def run_ranks(fn, world: int, args=(), *, backend: Optional[str] = None,
              device: str = "cuda", timeout_s: float = 120.0,
              workdir: Optional[str] = None):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    with the default process group initialised (``backend``, by default
    ``default_backend(device, world)``; its rendezvous a file under
    ``workdir``, so runs side by side never share a port; a collective that
    waits longer than ``timeout_s`` fails) and one CPU thread; on
    ``device="cuda"`` rank r takes card r modulo the cards.
    Returns each rank's result (picklable, CPU tensors). Every process is
    joined within ``timeout_s``, else killed, and the call raises."""
    import os
    import pickle
    import tempfile
    import time

    import torch
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    backend = backend or default_backend(device, world)
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, backend, device, f"{d}/pg",
                               timeout_s, d, tuple(args)),
            nprocs=world, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks not done in "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(world):
            path = os.path.join(d, f"rank{r}.pkl")
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        return out
