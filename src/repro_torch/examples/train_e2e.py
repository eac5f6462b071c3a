"""End-to-end example: train a ~100M-parameter LM with the port's substrate
(config -> model -> AdamW -> checkpointable data pipeline -> periodic
checkpoints + a simulated failure and restart mid-run).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 20 \\
        --device cpu                                           # quick

The loop is the reference's (``examples/train_e2e.py``), so that runs
compare by ``state["step"]``: a checkpoint every 25 steps, and at
``--fail-at`` (by default half of ``--steps`` from 40 steps up) a restart
from the latest one. Two of its traits stay: after a restart the loop
counter resumes at the saved counter, whose update the state already
holds, so a run with a failure makes one update more than ``--steps`` and
prints counters one behind ``state["step"]``. A failure step at or before
the first checkpoint, where the reference crashes restoring from no
checkpoint, is refused before training starts.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import LM
from repro_torch.optim import adamw

# ~100M params: 12 x 768 with a 32k vocab
CFG = ModelConfig(
    name="lm-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=2048,
    vocab_size=32_000, layer_pattern=("attn",), mlp_kind="swiglu",
    tie_embeddings=True, dtype="float32")
CKPT_EVERY = 25


def main(argv=None, *, device="cuda", cfg: ModelConfig = None):
    """Returns ``{"losses": {state step: loss}, "final_step", "restarted",
    "n_params"}``; a step taken twice (after a restart) keeps the later
    loss. ``cfg`` replaces the 100M model (tests pass a narrow one)."""
    ap = argparse.ArgumentParser(description="train with checkpoints and a "
                                 "simulated failure")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash+restart at this step")
    ap.add_argument("--device", default=None,
                    help=f"torch device (default {device})")
    args = ap.parse_args(argv)
    device = args.device or device
    cfg = cfg or CFG

    fail_at = args.fail_at or (args.steps // 2 if args.steps >= 40 else None)
    if fail_at is not None and fail_at <= CKPT_EVERY:
        ap.error(f"a failure at step {fail_at} comes before the first "
                 f"checkpoint, written after step {CKPT_EVERY}: there would "
                 f"be nothing to restart from (use --fail-at above "
                 f"{CKPT_EVERY}, or --steps of 52 or more)")

    lm = LM(cfg, device=device)
    n = sum(p.numel() for p in lm.parameters())
    print(f"model: {n / 1e6:.1f}M params on {device}")

    state = adamw.init_state(lm)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = adamw.make_train_step(lm, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, args.seq, args.batch))

    losses = {}
    restarted = None
    t0 = time.time()
    s = 0
    with tempfile.TemporaryDirectory(prefix="repro_torch_e2e_") as ckpt_dir:
        while s < args.steps:
            if fail_at is not None and s == fail_at:
                print(f"-- simulated failure at step {s}: restarting from "
                      f"latest checkpoint --")
                latest = ckpt.latest(ckpt_dir)
                ckpt.restore(latest, adamw.state_tree(state, lm))
                extra = ckpt.manifest_extra(latest)
                pipe.load_state_dict(extra["data"])
                s = restarted = int(extra["step"])
                fail_at = None
                continue
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in pipe.next().items()}
            state, metrics = step_fn(state, batch)
            losses[int(state["step"])] = metrics["loss"]
            if s % 10 == 0:
                dt = time.time() - t0
                print(f"step {s:4d} loss={float(metrics['loss']):.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({dt / (s + 1):.2f}s/step)")
            if s % CKPT_EVERY == 0 and s > 0:
                ckpt.save(ckpt_dir, adamw.state_tree(state, lm), step=s,
                          extra={"step": s, "data": pipe.state_dict()})
            s += 1
    print(f"done: {args.steps} steps in {time.time() - t0:.0f}s")
    return {"losses": {k: float(v) for k, v in losses.items()},
            "final_step": int(state["step"]), "restarted": restarted,
            "n_params": n}


if __name__ == "__main__":
    main()
