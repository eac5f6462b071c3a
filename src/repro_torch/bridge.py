"""Load a JAX parameter tree, or a JAX AdamW state, converted to numpy,
into the port's LM and optimizer state.

The tree is what ``repro``'s ``LM.init`` returns after
``jax.tree.map(np.asarray, params)``: nested dicts and lists of numpy
arrays. Every leaf is copied to the parameter registered under the same
path (``decoder.core.0.mixer.wq`` ...), with the shapes checked and the
key sets required to be equal. ``load_jax_opt_state`` does the same for
``repro.optim.adamw``'s ``{step, params, m, v}`` and returns the port's
AdamW state keyed by those paths. No ``jax`` import is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import flatten_paths


def _leaves_like(tree, params):
    """The tree's leaves as numpy arrays keyed by path, checked against the
    parameters' paths and shapes."""
    leaves = dict(flatten_paths(tree))
    if leaves.keys() != params.keys():
        missing = sorted(params.keys() - leaves.keys())
        extra = sorted(leaves.keys() - params.keys())
        raise KeyError(f"parameter paths differ: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for path, arr in leaves.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: torch cannot wrap it
            arr = arr.astype(np.float32)
        if tuple(arr.shape) != tuple(params[path].shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{tuple(params[path].shape)}")
        out[path] = arr
    return out


@torch.no_grad()
def load_jax_numpy(lm: torch.nn.Module, tree) -> None:
    params = dict(lm.named_parameters())
    for path, arr in _leaves_like(tree, params).items():
        params[path].copy_(torch.tensor(arr))  # copies: JAX's are read-only


@torch.no_grad()
def load_jax_opt_state(lm: torch.nn.Module, state) -> dict:
    """A JAX AdamW state ``{step, params, m, v}`` (numpy leaves) into the
    port: params into ``lm``, and the port's state (``optim.adamw``'s
    layout: ``m`` and ``v`` keyed by path, on the params' devices and in
    their dtypes, ``step`` an int32 scalar) returned."""
    load_jax_numpy(lm, state["params"])
    params = dict(lm.named_parameters())

    def moments(tree):
        return {path: torch.tensor(arr).to(device=params[path].device,
                                           dtype=params[path].dtype)
                for path, arr in _leaves_like(tree, params).items()}
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32),
            "params": params, "m": moments(state["m"]),
            "v": moments(state["v"])}
