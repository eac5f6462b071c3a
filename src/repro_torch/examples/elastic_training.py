"""Elastic scaling: a sharded train state re-meshed from 4 ranks to 2
mid-run, as after a node loss, and training goes on from the same state
(part 1 of the reference's ``examples/elastic_training.py``).

    PYTHONPATH=src python -m repro_torch.examples.elastic_training [--device cpu]

The stablelm-1.6b smoke LM trains 4 steps on a 4-rank ``"data"`` mesh;
``runtime.elastic.remesh_state`` moves its state onto ranks 0 and 1 (the
other two keep nothing); it trains 4 more steps there. ``main`` spawns the
four ranks (``launch.mesh.run_ranks``): gloo on the CPU, and on a host with
fewer than four cards the four ranks share the card through gloo; NCCL
where each rank has a card of its own.

The reference's part 2, straggler mitigation by live migration, drives
the MigrOS simulator (``runtime/trainer.py``, ``runtime/ft.py``,
``core/``), which imports no JAX and is not part of the port; it is left
out here.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import default_backend, make_mesh, run_ranks
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import remesh_state
from repro_torch.sharding import partition as part

ARCH = "stablelm-1.6b"
STEPS = 4              # on each mesh
WORLD, AFTER = 4, 2    # ranks before and after the loss of two
SEQ, BATCH = 64, 8


def _batch(pipe, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in pipe.next().items()}


def _rank(rank, world, device, steps):
    """One rank's part 1: -> the losses it saw (the global batch's, the
    same on every rank of the mesh), None for steps off the mesh."""
    cfg = get_smoke_config(ARCH)
    lm = LM(cfg, device=device)
    opt = adamw.OptConfig(lr=1e-3)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SEQ, BATCH))
    logical = adamw.state_logical(lm)
    losses = []

    mesh4 = make_mesh((world,), ("data",), device=device)
    with part.activate(mesh4):
        state = remesh_state(adamw.init_state(lm), logical, None, mesh4)
        step_fn = adamw.make_train_step(lm, opt)
        for _ in range(steps):
            state, m = step_fn(state, _batch(pipe, device))
            losses.append(float(m["loss"]))
    if rank == 0:
        print(f"  {world}-rank mesh: step {steps} loss={losses[-1]:.4f}")

    mesh2 = make_mesh((AFTER,), ("data",), device=device)   # ranks lost
    with part.activate(mesh2):
        state = remesh_state(state, logical, mesh4, mesh2)
        if mesh2.get_coordinate() is None:
            return losses + [None] * steps, False
        step_fn = adamw.make_train_step(lm, opt)
        for _ in range(steps):
            state, m = step_fn(state, _batch(pipe, device))
            losses.append(float(m["loss"]))
    if rank == 0:
        print(f"  {AFTER}-rank mesh: step {2 * steps} loss={losses[-1]:.4f} "
              f"(state re-sharded, no restart)")
    return losses, True


def main(argv=None, *, device="cuda"):
    """Returns ``{"losses": [8 losses], "worlds": [4, 2]}``."""
    ap = argparse.ArgumentParser(description="elastic re-mesh 4 -> 2")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps on each mesh")
    ap.add_argument("--device", default=None,
                    help=f"torch device (default {device})")
    args = ap.parse_args(argv)
    device = args.device or device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("elastic_training(device='cuda') but no CUDA "
                           "device is available; pass --device cpu")
    backend = default_backend(device, WORLD)
    print(f"== part 1: elastic re-mesh {WORLD} -> {AFTER} ranks mid-run "
          f"({backend} on {device}) ==")
    out = run_ranks(_rank, WORLD, (device, args.steps), backend=backend,
                    device=device, timeout_s=600)
    losses = out[0][0]
    assert all(r[1] == (i < AFTER) for i, r in enumerate(out)), \
        "ranks 0 and 1 should form the new mesh"
    assert all(r[0][:args.steps] == losses[:args.steps] for r in out)
    assert all(r[0] == losses for r in out[:AFTER])
    print("OK")
    return {"losses": losses, "worlds": [WORLD, AFTER]}


if __name__ == "__main__":
    main()
