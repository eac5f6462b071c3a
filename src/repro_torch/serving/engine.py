"""Batched serving engine: continuous batching over a fixed-size slot pool
(mirrors ``repro/serving/engine.py``).

Requests join free slots; every engine step decodes one token for all
slots with one batched ``decode_step``. Prefill runs per request
(right-sized, its cache written into the slot). Slot state (KV caches or
SSM conv windows and states, + lengths) is an explicit tree of tensors, so
the whole engine is dumpable and migratable: ``state_dict`` /
``load_state_dict``.

Unlike the reference's ``_write_slot_cache``, which tells stacked-core
leaves from per-slot leaves by ``shape[0] != slots`` (and writes into the
wrong slot when ``slots == n_periods``), the slot write follows the cache's
head/core/tail structure.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.layers import tree_map
from repro_torch.models.model import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, lm: LM, *, slots: int = 4, capacity: int = 512,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServingEngine(device='cuda') but no CUDA "
                               "device is available; pass device='cpu'")
        if lm.embed.device.type != self.device.type:
            raise ValueError(f"the LM lies on {lm.embed.device}, the engine "
                             f"on {self.device}")
        self.lm = lm
        self.slots = slots
        self.capacity = capacity
        self.cache = lm.materialize_cache(slots, capacity)
        self.active: List[Optional[Request]] = [None] * slots
        self.steps = 0

    def _write_slot_cache(self, slot, req_cache, length):
        """Copy a single-sequence prefill cache into slot ``slot``."""
        dst, src = self.cache["layers"], req_cache["layers"]
        for part in ("head", "tail"):
            for d, s in zip(dst[part], src[part]):
                for key in d:
                    d[key][slot] = s[key][0]
        for d, s in zip(dst["core"], src["core"]):     # [n_periods, B, ...]
            for key in d:
                d[key][:, slot] = s[key][:, 0]
        self.cache["lengths"][slot] = length

    def submit(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.active[s] is None:
                prompt = torch.as_tensor(np.asarray(req.prompt),
                                         device=self.device)[None]
                cache, logits = self.lm.prefill({"tokens": prompt},
                                                self.capacity)
                self._write_slot_cache(s, cache, len(req.prompt))
                req.out.append(int(torch.argmax(logits[0])))
                self.active[s] = req
                return True
        return False

    def step(self):
        """Decode one token for every slot (idle slots decode token 0)."""
        if not any(self.active):
            return
        toks = np.zeros((self.slots, 1), np.int32)
        for s, r in enumerate(self.active):
            if r is not None:
                toks[s, 0] = r.out[-1]
        self.cache, logits = self.lm.decode_step(
            self.cache, torch.as_tensor(toks, device=self.device))
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for s, r in enumerate(self.active):
            if r is None:
                continue
            r.out.append(int(nxt[s]))
            if len(r.out) >= r.max_new:
                r.done = True
                self.active[s] = None
        self.steps += 1

    def run_until_done(self, max_steps: int = 1024):
        """Step until no slot is active, at most ``max_steps`` times."""
        for _ in range(max_steps):
            if not any(self.active):
                break
            self.step()

    # -- migratability ------------------------------------------------------------
    def state_dict(self):
        return {"cache": self.cache, "steps": self.steps}

    def load_state_dict(self, d):
        """Copy a state (from any device, e.g. a host-memory dump) into this
        engine's own cache buffers on its device."""
        def cp(dst, src):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"state leaf {tuple(src.shape)} {src.dtype} "
                                 f"does not fit {tuple(dst.shape)} "
                                 f"{dst.dtype}")
            dst.copy_(src)
        _zip_map(cp, self.cache, d["cache"])
        self.steps = d["steps"]


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise ValueError(f"state keys {sorted(b)} != {sorted(a)}")
        for k in a:
            _zip_map(fn, a[k], b[k])
    elif isinstance(a, list):
        if len(a) != len(b):
            raise ValueError("state lists differ in length")
        for x, y in zip(a, b):
            _zip_map(fn, x, y)
    else:
        fn(a, b)


def state_to(state, device):
    """A copy of an engine state with every tensor moved to ``device``
    (``"cpu"`` dumps it to host memory)."""
    return {"cache": tree_map(lambda t: t.to(device, copy=True),
                              state["cache"]),
            "steps": state["steps"]}
