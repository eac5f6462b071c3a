"""Load a JAX parameter tree, converted to numpy, into the port's LM.

The tree is what ``repro``'s ``LM.init`` returns after
``jax.tree.map(np.asarray, params)``: nested dicts and lists of numpy
arrays. Every leaf is copied to the parameter registered under the same
path (``decoder.core.0.mixer.wq`` ...), with the shapes checked and the
key sets required to be equal. No ``jax`` import is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import flatten_paths


@torch.no_grad()
def load_jax_numpy(lm: torch.nn.Module, tree) -> None:
    leaves = dict(flatten_paths(tree))
    params = dict(lm.named_parameters())
    if leaves.keys() != params.keys():
        missing = sorted(params.keys() - leaves.keys())
        extra = sorted(leaves.keys() - params.keys())
        raise KeyError(f"parameter paths differ: missing {missing}, "
                       f"unexpected {extra}")
    for path, arr in leaves.items():
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":      # ml_dtypes: torch cannot wrap it
            arr = arr.astype(np.float32)
        p = params[path]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(arr))     # copies: JAX's arrays are read-only
