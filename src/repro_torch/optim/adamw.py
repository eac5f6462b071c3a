"""AdamW with a cosine schedule, global-norm clipping and an optional int8
gradient-compression hook (mirrors ``repro/optim/adamw.py``).

The state keeps the reference's layout, ``{step, params, m, v}``, with each
tree flattened to a dict keyed by the parameter's dotted path (the
``named_parameters`` names, which are the JAX tree's paths; ``state_tree``
nests it back into the reference's tree for checkpoints). ``params``
holds the ``LM``'s own ``nn.Parameter``s, and ``apply_updates`` writes
params, ``m`` and ``v`` in place under ``torch.no_grad()``: at full width a
functional copy would double the fp32 weights (13 GB for deepseek-7b at 12
layers). The arithmetic is the reference's, in fp32, leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.models.layers import flatten_paths


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False     # int8 compression before reduction


def schedule(cfg: OptConfig, step):
    """Linear warmup, then cosine decay to 0; fp32, as the reference."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1 + torch.cos(math.pi * prog)))


def init_state(params) -> Dict[str, object]:
    """``params``: an ``nn.Module`` or a dict of name -> tensor. The state
    holds those very tensors, and zeroed ``m`` and ``v`` beside them."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {"step": torch.zeros((), dtype=torch.int32),
            "params": dict(params),
            "m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()}}


def state_tree(state, lm) -> Dict[str, object]:
    """The state as the reference's pytree ``{step, params, m, v}``: each
    path dict nested along ``lm.defs()``, so that ``core``, ``head`` and
    ``tail`` are lists as in the reference (``tail.10`` after ``tail.9``),
    with the state's own tensors as leaves. ``checkpoint.ckpt`` saves it and
    restores into it in the reference's leaf order."""
    defs = lm.defs()
    paths = {p for p, _ in flatten_paths(defs)}

    def nest(tree, flat, prefix):
        if isinstance(tree, dict):
            return {k: nest(v, flat, f"{prefix}{k}.")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [nest(v, flat, f"{prefix}{i}.")
                    for i, v in enumerate(tree)]
        return flat[prefix[:-1]]

    out = {"step": state["step"]}
    for part in ("params", "m", "v"):
        if state[part].keys() != paths:
            raise KeyError(f"state[{part!r}] paths differ from the LM's: "
                           f"{sorted(state[part].keys() ^ paths)}")
        out[part] = nest(defs, state[part], "")
    return out


def _compress(g, generator: torch.Generator):
    """int8 stochastic-rounding quantise/dequantise with a per-tensor
    scale, unbiased; the noise comes from ``generator`` (the reference
    draws it from a JAX key, so the bits differ; the statistics agree)."""
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(g / scale + noise), -127, 127).to(torch.int8)
    return q.float() * scale


@torch.no_grad()
def apply_updates(cfg: OptConfig, state, grads,
                  generator: Optional[torch.Generator] = None):
    """One AdamW step: ``grads`` is a dict keyed like ``state["params"]``.
    Params, ``m`` and ``v`` are updated in place; returns (state,
    {"grad_norm", "lr"}). With ``compress_grads`` the noise comes from
    ``generator``, by default a generator seeded with the new step."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    names = list(state["params"])
    grads = {n: grads[n] for n in names}

    if cfg.compress_grads:
        gen = generator or torch.Generator(
            device=grads[names[0]].device).manual_seed(int(step))
        grads = {n: _compress(g, gen) for n, g in grads.items()}

    if cfg.clip_norm > 0:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in grads.values()))
        scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gn, 1e-12),
                            max=1.0)
        grads = {n: g * scale.to(g.dtype) for n, g in grads.items()}
    else:
        gn = torch.zeros((), dtype=torch.float32)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for n in names:
        p, m, v = state["params"][n], state["m"][n], state["v"][n]
        gf = grads[n].float()
        mf = m.float().mul_(b1).add_(gf, alpha=1 - b1)
        vf = v.float().mul_(b2).addcmul_(gf, gf, value=1 - b2)
        u = (mf / bc1).div_((vf / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        if cfg.weight_decay:
            u.add_(pf, alpha=cfg.weight_decay)
        # p - lr u; for fp32 leaves pf, mf and vf are p, m and v themselves
        p.copy_(pf.sub_(u.mul_(lr)))
        m.copy_(mf)
        v.copy_(vf)
    state = {"step": step, "params": state["params"], "m": state["m"],
             "v": state["v"]}
    return state, {"grad_norm": gn, "lr": lr}


def make_train_step(lm, cfg: OptConfig, *, impl=None, schedule_kind="full",
                    generator: Optional[torch.Generator] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradients by autograd (``lm.loss`` with ``impl`` and the
    attention ``schedule_kind``), then ``apply_updates``. The gradients
    are dropped after the update, so they do not outlive the step."""

    def train_step(state, batch):
        params = state["params"]
        for p in params.values():
            p.grad = None
        loss, metrics = lm.loss(batch, impl=impl, schedule=schedule_kind)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        state, om = apply_updates(cfg, state, grads, generator)
        for p in params.values():
            p.grad = None
        out = {k: v.detach() for k, v in metrics.items()}
        return state, dict(out, loss=loss.detach(), **om)

    return train_step
