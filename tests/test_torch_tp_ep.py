"""Tensor parallelism beside expert parallelism, held in float64.

The MoE families train with EP beside attention split by heads, dense
MLPs and shared experts by ffn and the vocabulary by rows (the default
rules), or beside gathered compute (rules that keep "heads", "ffn" and
"vocab" off "model", ``GATHERED``). With the split, the deepseek-moe-16b
smoke model's two mesh steps in ``tests/test_torch_moe_ep.py`` move past
that file's rtol of 1e-4 in float32, which is why that file activates its
mesh with ``GATHERED``. This file tells a fault of the split from
float32's rounding: a float64 copy of the port (``tests/encdec_grad_norm.py``'s
``float64_port``) takes the same two AdamW steps of the deepseek-moe-16b
smoke LM (aux weight 0 and capacity factor 8, as that file's unsharded
comparison) on a (2, 2)
("data", "model") mesh of four gloo ranks, with EP alone and with the
split beside it, against its own unsharded steps, by
``tests/float64_steps.py``'s measure; beside them its witness (the
unsharded steps with their sums in parts) and a control that must miss:
the split's shared experts with their output left unsummed over "model".
The float32 port runs the same codes beside it, for the readings.

    PYTHONPATH=src python tests/test_torch_tp_ep.py   # prints the readings
"""
import contextlib
import dataclasses
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from encdec_grad_norm import F64, float64_port  # noqa: E402
from float64_steps import (F64_REL, distance, sums_in_parts,  # noqa: E402
                           two_steps, worst_of)

from repro_torch.launch.mesh import run_ranks  # noqa: E402

ARCH = "deepseek-moe-16b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)   # test_torch_moe_ep's
MESH = (2, 2)
CF = 8.0            # no copy drops on either path, as that file's steps
# rules that keep the compute gathered beside EP, as the reference's GSPMD
# computes a leaf whose logical axis is not on "model"
GATHERED = {"heads": None, "ffn": None, "vocab": None}


def _inputs():
    """The smoke LM's weights (the port's init, seed 0) and two [4, 32]
    token batches, from seeds."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import LM
    cfg = get_smoke_config(ARCH)
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    return ({n: p.detach().numpy().copy() for n, p in lm.named_parameters()},
            [rs.randint(0, cfg.vocab_size, (4, 32)) for _ in range(2)])


@contextlib.contextmanager
def _shared_unsummed(pkg):
    """The control: the split shared experts' output left unsummed over
    "model" (each rank's partial taken as the whole)."""
    import types
    moe = importlib.import_module(f"{pkg}.models.moe")
    real = moe.TP
    moe.TP = types.SimpleNamespace(copy_to=real.copy_to,
                                   reduce_from=lambda y, tp: y)
    try:
        yield
    finally:
        moe.TP = real


def _steps(pkg, weights, batches, mesh_shape=None, split=False,
           control=False, witness=False):
    """Two AdamW steps of package ``pkg``'s smoke LM from ``weights``;
    on ``mesh_shape`` with EP, beside the compute split over "model" (the
    default rules) where ``split``, else gathered (``GATHERED``); under
    ``control`` (``_shared_unsummed``), with the sums in parts under
    ``witness``. -> ``float64_steps.Steps``, whole tensors in float64."""
    base = importlib.import_module(f"{pkg}.configs.base")
    LM = importlib.import_module(f"{pkg}.models.model").LM
    adamw = importlib.import_module(f"{pkg}.optim.adamw")
    part = importlib.import_module(f"{pkg}.sharding.partition")
    make_mesh = importlib.import_module(f"{pkg}.launch.mesh").make_mesh
    remesh = importlib.import_module(f"{pkg}.runtime.elastic").remesh_state
    cfg = base.get_smoke_config(ARCH)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, router_aux_weight=0.0, capacity_factor=CF))
    if pkg == F64:
        cfg = cfg.replace(dtype="float64")
    lm = LM(cfg, device="cpu")
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(torch.from_numpy(weights[n]))
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu") \
        if mesh_shape else None
    state = adamw.init_state(lm)
    def whole(t):
        return (t.full_tensor() if mesh else t).double()
    with (part.activate(mesh, None if split else GATHERED) if mesh
          else contextlib.nullcontext()), \
            (_shared_unsummed(pkg) if control else
             contextlib.nullcontext()), \
            (sums_in_parts() if witness else contextlib.nullcontext()):
        if mesh:
            state = remesh(state, adamw.state_logical(lm), None, mesh)
            plan = adamw.tp_plan(lm, mesh)
            assert plan.heads == plan.ffn == plan.shared == split
        step = adamw.make_train_step(lm, adamw.OptConfig(**OPT))
        return two_steps(step, state, [
            {"tokens": torch.from_numpy(b).long()} for b in batches], whole)


def _rank(rank, world, f64_dir, weights, batches):
    """Both precisions' mesh runs, EP alone and EP beside the split, and
    the float64 control; every rank returns what it read (the whole
    tensors are the same on all)."""
    sys.path.insert(0, f64_dir)
    out = {(pkg, split): _steps(pkg, weights, batches, MESH, split)
           for pkg in ("repro_torch", F64) for split in (False, True)}
    out[F64, "control"] = _steps(F64, weights, batches, MESH, True, True)
    return out


def readings(tmp):
    """{precision: {"ep": distances, "ep_tp": distances}}, each mesh code
    against the same precision's unsharded steps (``float64_steps.
    distance``); in float64 also the control's and the witness's."""
    f64_dir = str(tmp)
    float64_port(f64_dir)
    weights, batches = _inputs()
    mesh = run_ranks(_rank, MESH[0] * MESH[1], (f64_dir, weights, batches),
                     device="cpu", timeout_s=300)
    for r in mesh[1:]:      # every rank read the same whole tensors
        assert r[F64, True].metrics == mesh[0][F64, True].metrics
    out = {}
    for pkg, name in (("repro_torch", "float32"), (F64, "float64")):
        want = _steps(pkg, weights, batches)
        out[name] = {code: distance(mesh[0][pkg, split], want)
                     for code, split in (("ep", False), ("ep_tp", True))}
    out["float64"]["control"] = distance(mesh[0][F64, "control"], want)
    out["float64"]["witness"] = distance(
        _steps(F64, weights, batches, witness=True), want)
    return out


@pytest.fixture(scope="module")
def read(tmp_path_factory):
    return readings(tmp_path_factory.mktemp("f64"))


@pytest.mark.parametrize("code", ["ep", "ep_tp"])
def test_the_split_beside_ep_is_exact_in_float64(read, code):
    """In float64 the (2, 2) mesh's two steps, EP alone and EP beside the
    split attention, dense MLP, shared experts and vocabulary, equal the
    unsharded steps to F64_REL by ``float64_steps.distance`` (float32
    parts their params by up to 2 x the summed lr, 3e-3); the witness
    moves no params term past it either."""
    d = read["float64"][code]
    assert worst_of(d) <= F64_REL, d
    assert read["float64"]["witness"]["params"] <= F64_REL


def test_the_control_misses_the_float64_limit(read):
    """The split shared experts' output left unsummed over "model": the
    float64 steps miss F64_REL by far."""
    d = read["float64"]["control"]
    assert worst_of(d) > 1e3 * F64_REL, d


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(readings(tmp), indent=1))
