"""Quickstart: train a small LM for a few steps, checkpoint it, restore it
into a fresh LM and keep training — the tour of the port's public API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The restored LM's next step must equal, bit for bit, the same step taken
by the LM that was never checkpointed.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import LM
from repro_torch.optim import adamw

STEPS = 20


def _batch(pipe, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in pipe.next().items()}


def main(argv=None, *, device="cuda"):
    ap = argparse.ArgumentParser(description="train, checkpoint, restore")
    ap.add_argument("--device", default=None,
                    help=f"torch device (default {device})")
    device = ap.parse_args(argv).device or device

    cfg = get_smoke_config("deepseek-7b").replace(num_layers=2)
    lm = LM(cfg, device=device)
    state = adamw.init_state(lm)
    opt = adamw.OptConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    step_fn = adamw.make_train_step(lm, opt)

    pipe = TokenPipeline(DataConfig(cfg.vocab_size, seq_len=64,
                                    global_batch=8))
    print(f"training deepseek-7b (smoke config, 2 layers) for {STEPS} "
          f"steps on {device}...")
    for i in range(STEPS):
        state, metrics = step_fn(state, _batch(pipe, device))
        if i % 5 == 0:
            print(f"  step {i:3d} loss={float(metrics['loss']):.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")

    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save(d, adamw.state_tree(state, lm), step=STEPS,
                         extra={"data": pipe.state_dict()})
        print(f"checkpointed to {path} ({ckpt.compressor()})")
        # a fresh LM from another seed: the restore must overwrite it all
        lm2 = LM(cfg, device=device,
                 generator=torch.Generator(device=device).manual_seed(1))
        state2 = adamw.init_state(lm2)
        ckpt.restore(path, adamw.state_tree(state2, lm2))
        pipe2 = TokenPipeline(DataConfig(cfg.vocab_size, 64, 8))
        pipe2.load_state_dict(ckpt.manifest_extra(path)["data"])
    state2, m2 = adamw.make_train_step(lm2, opt)(state2, _batch(pipe2, device))
    print(f"restored + stepped: loss={float(m2['loss']):.4f}")

    # the same step by the LM that was never checkpointed
    state, m1 = step_fn(state, _batch(pipe, device))
    equal = bool(m1["loss"] == m2["loss"]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            ckpt.flatten(adamw.state_tree(state, lm)),
            ckpt.flatten(adamw.state_tree(state2, lm2))))
    print(f"uninterrupted step: loss={float(m1['loss']):.4f}; the restored "
          f"run's state {'equals' if equal else 'DIFFERS from'} it bit for "
          f"bit")
    assert equal, "the restored step differs from the uninterrupted one"
    print("OK")
    return {"loss_restored": float(m2["loss"]),
            "loss_uninterrupted": float(m1["loss"]), "equal": equal,
            "step": int(state2["step"])}


if __name__ == "__main__":
    main()
