"""Shared building blocks: ParamDef trees, norms, rotary embeddings, MLPs.

Mirrors ``repro/models/layers.py``. Parameters are declared once as trees
(dicts and lists) of :class:`ParamDef`; ``init_params`` materialises such a
tree with an explicit ``torch.Generator``, and ``models.model`` registers the
result as ``nn.Parameter``s under the same paths as the JAX tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import tp as TP

# ---------------------------------------------------------------------------
# ParamDef and trees
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    """A single parameter: shape, logical axis names, initialiser."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | fixed
    scale: float = 1.0        # stddev multiplier for "normal" / "fixed"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def flatten_paths(tree, prefix=""):
    """Yield ``(dotted path, leaf)`` for a tree of dicts and lists; the paths
    are the ``named_parameters`` names of the module built from it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_paths(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def logical_specs(defs):
    """The tree of each parameter's logical axes (a tuple per leaf)."""
    return tree_map(lambda d: d.axes, defs)


def init_params(defs, generator: torch.Generator, dtype: torch.dtype,
                device):
    """Materialise a ParamDef tree into tensors drawn from ``generator``.

    Same distributions as the reference (normal with std scale/sqrt(fan_in),
    "fixed" std, zeros, ones); the draws differ from JAX's, so parity tests
    load the JAX tree through ``repro_torch.bridge`` instead.
    """
    def make(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        if d.init == "fixed":
            std = d.scale
        else:
            fan_in = d.shape[0] if len(d.shape) > 1 else max(d.shape[-1], 1)
            std = d.scale / (fan_in ** 0.5)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dtype)
    return tree_map(make, defs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_def(cfg: ModelConfig, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": ParamDef((dim,), ("norm",), "ones"),
                "bias": ParamDef((dim,), ("norm",), "zeros")}
    return {"scale": ParamDef((dim,), ("norm",), "zeros")}  # gemma-style (1+w)


def apply_norm(cfg: ModelConfig, p, x, eps=None):
    eps = eps or cfg.norm_eps
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * (1.0 + p["scale"].float())
    return y.to(x.dtype)


def conv_history(u, K):
    """The last K-1 pre-conv rows of ``u`` [B,S,C] as a new tensor (not a
    view that would keep the whole projection alive), with zero rows before
    the prompt as a causal conv's padding has them: a decode cache's conv
    window (Mamba-2's and the RG-LRU block's)."""
    B, S, C = u.shape
    pad = torch.zeros((B, max(K - 1 - S, 0), C), dtype=u.dtype,
                      device=u.device)
    return torch.cat([pad, u[:, max(S - (K - 1), 0):]], 1)


# ---------------------------------------------------------------------------
# Rotary embeddings (with partial-rotary support)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, rope_pct: float, theta: float, device=None):
    rot = int(head_dim * rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / (theta ** exps)
    return rot, inv


def apply_rope(x, positions, rope_pct=1.0, theta=10_000.0):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    rot, inv = rope_freqs(hd, rope_pct, theta, device=x.device)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv                     # [..., S, rot/2]
    cos = torch.cos(ang)[..., None, :]                           # [..., S, 1, rot/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# ---------------------------------------------------------------------------
# MLPs (dense)
# ---------------------------------------------------------------------------


def mlp_def(cfg: ModelConfig, d_ff: Optional[int] = None):
    D, Fw = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"wi_gate": ParamDef((D, Fw), ("embed", "ffn")),
                "wi_up": ParamDef((D, Fw), ("embed", "ffn")),
                "wo": ParamDef((Fw, D), ("ffn", "embed"))}
    return {"wi": ParamDef((D, Fw), ("embed", "ffn")),
            "wo": ParamDef((Fw, D), ("ffn", "embed"))}


def apply_mlp(cfg: ModelConfig, p, x, tp=None):
    """The dense MLP; under ``tp`` (a ``sharding.tp.Region``) ``wi*`` are
    this rank's ffn columns and ``wo`` its rows, the output summed over
    the axis."""
    dt = x.dtype
    if tp is not None:
        x = TP.copy_to(x, tp)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        g = x @ p["wi_gate"].to(dt)
        g = F.silu(g) if cfg.mlp_kind == "swiglu" else \
            F.gelu(g, approximate="tanh")
        y = (g * (x @ p["wi_up"].to(dt))) @ p["wo"].to(dt)
    else:
        y = F.gelu(x @ p["wi"].to(dt), approximate="tanh") @ p["wo"].to(dt)
    return y if tp is None else TP.reduce_from(y, tp)
