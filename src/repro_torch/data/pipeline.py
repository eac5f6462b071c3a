"""Deterministic, checkpointable synthetic token pipeline (the port's own
copy of ``repro/data/pipeline.py``, numpy only).

Sequences come from a counter-based PRNG (position-independent): batch
``i`` of a given config is identical no matter which host asks, when, or
after how many restarts, and byte for byte the reference's. The cursor is
just an integer, so it rides along in a checkpoint's ``extra``. Batches
stay numpy; the caller moves them with ``torch.as_tensor(v, device=...)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so the LM has something learnable
    structure: float = 0.7


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0

    def _batch_at(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.RandomState((c.seed * 1_000_003 + step) % 2**31)
        B, S, V = c.global_batch, c.seq_len, c.vocab_size
        base = rng.randint(0, V, (B, S))
        # structured component: next token = f(prev) with prob `structure`
        nxt = (base[:, :-1] * 31 + 7) % V
        mask = rng.rand(B, S - 1) < c.structure
        out = base.copy()
        out[:, 1:][mask] = nxt[mask]
        return out.astype(np.int32)

    def next(self) -> Dict[str, np.ndarray]:
        b = {"tokens": self._batch_at(self.step)}
        self.step += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, d: Dict):
        if d["seed"] != self.cfg.seed:
            raise ValueError(f"pipeline seed mismatch: the state has "
                             f"{d['seed']}, this pipeline {self.cfg.seed}")
        self.step = int(d["step"])


def frontend_stub_batch(cfg, shape, rng_seed: int = 0):
    """Precomputed frame/patch embeddings for audio/vlm archs (the modality
    frontend is a stub, as in the reference)."""
    rng = np.random.RandomState(rng_seed)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        Sv = cfg.frontend_tokens
        return {
            "vision_embeds": rng.randn(B, Sv, cfg.d_model).astype(
                np.float32) * 0.02,
            "tokens": rng.randint(0, cfg.vocab_size,
                                  (B, S - Sv)).astype(np.int32),
        }
    if cfg.family == "encdec":
        return {
            "frames": rng.randn(B, S, cfg.d_model).astype(np.float32)
            * 0.02,
            "tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
        }
    return {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
