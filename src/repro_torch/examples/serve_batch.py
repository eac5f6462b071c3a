"""Batched serving with continuous batching and an engine state dump and
restore (the serving-side analogue of container migration: the whole
engine state — caches, lengths, in-flight requests — moves between
'nodes').

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine, state_to

SLOTS, CAPACITY, MIGRATE_AT = 4, 128, 3


def main(argv=None, *, device="cuda"):
    ap = argparse.ArgumentParser(description="continuous batching with a "
                                 "mid-flight engine migration")
    ap.add_argument("--device", default=None,
                    help=f"torch device (default {device})")
    device = ap.parse_args(argv).device or device

    cfg = get_smoke_config("gemma3-1b")
    lm = LM(cfg, device=device)
    eng = ServingEngine(lm, slots=SLOTS, capacity=CAPACITY, device=device)

    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, 16).astype(np.int32),
                    max_new=8) for i in range(6)]
    pending = list(reqs)
    while pending or any(eng.active):
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
        if eng.steps == MIGRATE_AT:
            # live-migrate the engine: dump its state to host memory,
            # rebuild, restore
            blob = state_to(eng.state_dict(), "cpu")
            eng2 = ServingEngine(lm, slots=SLOTS, capacity=CAPACITY,
                                 device=device)
            eng2.load_state_dict(blob)
            eng2.active = eng.active
            eng = eng2
            print(f"[engine migrated at step {MIGRATE_AT}]")
    for r in reqs:
        print(f"req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> {r.out}")
    assert all(len(r.out) >= r.max_new for r in reqs)
    print("OK: all requests served (through a mid-flight engine migration)")
    return [list(r.out) for r in reqs]


if __name__ == "__main__":
    main()
