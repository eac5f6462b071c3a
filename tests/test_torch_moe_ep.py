"""Expert parallelism in the port (``models/moe.py::_moe_ep``) and the MoE
train step on a mesh, on four gloo processes, against the local path and
against the reference's ``_moe_ep`` on the same numpy weights.

The JAX side runs in one subprocess that sees 8 host devices
(``tests/jax_mesh_ref.py ep``), beside the port's four ranks (one spawn).
Meshes (1,2), (1,4) and (2,2) over ("data", "model"); (1,2) is a mesh of
ranks 0 and 1 of the four. Tolerances are ``tests/test_moe.py``'s: y at
1e-5, every gradient leaf at 1e-5 of its largest element; aux, which EP
computes per token slice and averages (as the reference), against JAX's
EP aux at 1e-5. Capacity factor 8: no copy drops on either path. At the
factors of ``LOW_CFS`` copies drop (at 0.5 at both of EP's capacities,
``C_send`` and ``C_loc``, on every mesh; 1.25 is the MoE configs' own),
and EP is held against the reference's EP alone (the local path drops
other copies).
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models import moe as MOE
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import remesh_state
from repro_torch.sharding import partition as part

ROOT = Path(__file__).resolve().parent.parent
MESHES = ((1, 2), (1, 4), (2, 2))
TOL = 1e-5
RTOL = 1e-4            # the train steps, as tests/test_torch_train.py
LOW_CFS = (0.5, 1.25)  # capacity factors at which copies drop
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
MOE_KEYS = ("router", "wi_gate", "wi_up", "wo", "shared.wi_gate",
            "shared.wi_up", "shared.wo")
# the train steps' rules: EP beside gathered compute (the reference's rules
# with "heads", "ffn" and "vocab" off "model"), what these steps hold; EP
# beside the default split is tests/test_torch_tp_moe.py's
GATHERED = {"heads": None, "ffn": None, "vocab": None}


def _cfg(aux_weight=None, cf=8.0):
    cfg = get_smoke_config("deepseek-moe-16b")
    moe = dataclasses.replace(cfg.moe, capacity_factor=cf)
    if aux_weight is not None:
        moe = dataclasses.replace(moe, router_aux_weight=aux_weight)
    return cfg.replace(moe=moe)


def _inputs():
    """The MoE block's weights (scaled as ``moe_def``'s init), two inputs
    (the second with a token count the expert axis does not divide), the
    smoke LM's weights and two token batches, from numpy seeds."""
    cfg = _cfg()
    rs = np.random.RandomState(0)
    z = {}
    for path, d in flatten_paths(MOE.moe_def(cfg)):
        std = d.scale / np.sqrt(d.shape[0] if len(d.shape) > 1 else 1)
        z[f"p.{path}"] = (rs.randn(*d.shape) * std).astype(np.float32)
    z["x1"] = rs.randn(4, 16, cfg.d_model).astype(np.float32)
    z["x2"] = rs.randn(2, 3, cfg.d_model).astype(np.float32)
    lm = LM(cfg, device="cpu",
            generator=torch.Generator().manual_seed(0))
    for n, p in lm.named_parameters():
        z[f"lm.{n}"] = p.detach().numpy().copy()
    for i in range(2):
        z[f"batch{i}"] = rs.randint(0, cfg.vocab_size, (4, 32)) \
            .astype(np.int32)
    z["opt"] = np.array(json.dumps(OPT))
    z["low_cfs"] = np.array(LOW_CFS)
    return z


def _train(lm, z, mesh=None):
    """Two AdamW steps of ``lm`` on the batches of ``z``; on ``mesh`` (under
    the ``GATHERED`` rules) from the state placed by ``remesh_state``.
    -> (metrics per step, params, ``m`` after the first step)."""
    state = adamw.init_state(lm)
    opt = adamw.OptConfig(**OPT)
    ctx = part.activate(mesh, GATHERED) if mesh is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        if mesh is not None:
            state = remesh_state(state, adamw.state_logical(lm), None, mesh)
        step = adamw.make_train_step(lm, opt)
        mets = []
        for i in range(2):
            state, m = step(state, {"tokens": torch.from_numpy(
                z[f"batch{i}"]).long()})
            mets.append({k: float(v) for k, v in m.items()})
            if i == 0:
                m1 = {n: (t.full_tensor() if mesh is not None else t)
                      .detach().clone() for n, t in state["m"].items()}
        params = {n: (t.full_tensor() if mesh is not None else t).detach()
                  .clone() for n, t in state["params"].items()}
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return mets, params, m1


def _lm(z, aux_weight=None):
    lm = LM(_cfg(aux_weight), device="cpu")
    load_jax_numpy(lm, {k[3:]: v for k, v in z.items()
                        if k.startswith("lm.")})
    return lm


def _ep_rank(rank, world, d):
    """One rank: ``moe_apply`` on each mesh it belongs to, at capacity
    factor 8 and at each of LOW_CFS, forward and backward of sum(y^2); the
    gradients summed over the mesh (the expert weights' are full-shaped
    with this rank's experts' rows, the router's and shared experts'
    partial) and this rank's drop counts; then the (2,2) train steps."""
    import torch.distributed as dist
    z = dict(np.load(os.path.join(d, "in.npz")))
    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in MESHES}
    out = {}
    for (xi, shape), (cf, suffix) in itertools.product(
            itertools.product(("x1", "x2"), MESHES),
            ((8.0, ""),) + tuple((cf, f".cf{cf}") for cf in LOW_CFS)):
        cfg, mesh = _cfg(cf=cf), meshes[shape]
        if mesh.get_coordinate() is None:
            continue
        p = {k: torch.tensor(z[f"p.{k}"], requires_grad=True)
             for k in MOE_KEYS}
        tree = dict({k: p[k] for k in MOE_KEYS[:4]}, shared={
            k: p[f"shared.{k}"] for k in ("wi_gate", "wi_up", "wo")})
        dr = mesh.get_local_rank("data")
        x = torch.tensor(z[xi])
        b = x.shape[0] // shape[0]
        xl = x[dr * b:(dr + 1) * b].clone().requires_grad_()
        with part.activate(mesh), MOE.drop_counts() as drops:
            y, aux = MOE.moe_apply(cfg, tree, xl)
        (y ** 2).sum().backward()
        grads = {}
        for k, t in p.items():
            g = t.grad.clone()
            for dim in range(mesh.ndim):
                dist.all_reduce(g, group=mesh.get_group(dim))
            grads[k] = g
        out[f"ep{shape[0]}{shape[1]}.{xi}{suffix}"] = dict(
            coord=mesh.get_coordinate(), y=y.detach(),
            aux=aux.detach(), gx=xl.grad, g=grads,
            drops={k: int(v) for k, v in drops.items()})
    mesh = meshes[(2, 2)]
    out["train"] = _train(_lm(z), z, mesh)
    out["train_no_aux"] = _train(_lm(z, aux_weight=0.0), z, mesh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    z = _inputs()
    np.savez(d / "in.npz", **z)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_ref.py"), "ep",
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = run_ranks(_ep_rank, 4, (str(d),), timeout_s=240,
                         device="cpu", workdir=str(d))
        _, err = jax_proc.communicate(timeout=240)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, err
    return z, port, dict(np.load(d / "out.npz"))


def _local(z, xi):
    """The port's local path on the whole input: y, aux and gradients."""
    p = {k: torch.tensor(z[f"p.{k}"], requires_grad=True) for k in MOE_KEYS}
    tree = dict({k: p[k] for k in MOE_KEYS[:4]}, shared={
        k: p[f"shared.{k}"] for k in ("wi_gate", "wi_up", "wo")})
    x = torch.tensor(z[xi], requires_grad=True)
    y, aux = MOE.moe_apply(_cfg(), tree, x)
    (y ** 2).sum().backward()
    return y.detach(), aux.detach(), x.grad, {k: t.grad for k, t in
                                              p.items()}


def _assembled(port, key, shape):
    """y and the input's gradient, the data slices put together (from the
    ranks at expert coordinate 0), aux and the summed gradients of rank 0."""
    ranks = [r[key] for r in port if key in r]
    firsts = sorted((r for r in ranks if r["coord"][1] == 0),
                    key=lambda r: r["coord"][0])
    assert len(firsts) == shape[0]
    return (torch.cat([r["y"] for r in firsts]), ranks[0]["aux"],
            torch.cat([r["gx"] for r in firsts]), ranks[0]["g"])


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    denom = max(float(np.abs(b).max()), 1e-6)
    assert float(np.abs(a - b).max()) / denom < TOL, what


@pytest.mark.parametrize("xi", ["x1", "x2"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_matches_local_path_and_jax(runs, shape, xi):
    """y at 1e-5 against the port's local path and the reference's EP; aux
    against the reference's EP; the input's and every weight's gradient
    at 1e-5 of its largest element against both."""
    z, port, jx = runs
    key = f"ep{shape[0]}{shape[1]}.{xi}"
    y, aux, gx, g = _assembled(port, key, shape)
    y_loc, _, gx_loc, g_loc = _local(z, xi)
    np.testing.assert_allclose(y.numpy(), y_loc.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(y.numpy(), jx[f"{key}.y"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jx[f"{key}.aux"]),
                               rtol=TOL)
    _close(gx, gx_loc, "x (local)")
    _close(gx, jx[f"{key}.g.x"], "x (jax)")
    for k in MOE_KEYS:
        _close(g[k], g_loc[k], f"{k} (local)")
        _close(g[k], jx[f"{key}.g.{k}"], f"{k} (jax)")


@pytest.mark.parametrize("cf", LOW_CFS)
@pytest.mark.parametrize("xi", ["x1", "x2"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ep_drops_the_copies_the_reference_drops(runs, shape, xi, cf):
    """At a capacity factor of LOW_CFS: y, aux, the input's and every
    weight's gradient at 1e-5 against the reference's EP on the same
    meshes. At 0.5 on x1 copies drop at both capacities, C_send and C_loc
    (``drop_counts``, summed over the mesh's ranks)."""
    z, port, jx = runs
    key = f"ep{shape[0]}{shape[1]}.{xi}.cf{cf}"
    y, aux, gx, g = _assembled(port, key, shape)
    np.testing.assert_allclose(y.numpy(), jx[f"{key}.y"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(jx[f"{key}.aux"]),
                               rtol=TOL)
    _close(gx, jx[f"{key}.g.x"], "x (jax)")
    for k in MOE_KEYS:
        _close(g[k], jx[f"{key}.g.{k}"], f"{k} (jax)")
    drops = {k: sum(r[key]["drops"][k] for r in port if key in r)
             for k in ("copies", "dropped_send", "dropped")}
    assert drops["copies"] >= z[xi].shape[0] * z[xi].shape[1] * 2, drops
    if (xi, cf) == ("x1", 0.5):
        assert drops["dropped_send"] > 0 and drops["dropped"] > 0, drops


def test_ep_aux_is_the_local_one_where_each_slice_is_a_sequence(runs):
    """On x1 [4,16,D] the (1,4) mesh's token slices are the 4 sequences,
    so aux is the mean of the local path's aux over the sequences."""
    z, port, _ = runs
    _, aux, _, _ = _assembled(port, "ep14.x1", (1, 4))
    per_seq = []
    for i in range(4):
        zi = dict(z, x1=z["x1"][i:i + 1])
        per_seq.append(float(_local(zi, "x1")[1]))
    np.testing.assert_allclose(float(aux), np.mean(per_seq), rtol=TOL)


def _m1_close(m1, want):
    """``m`` after step 1 is (1 - b1) times the clipped gradient, so every
    leaf's gradient, its placement and its share of the clip norm show
    there: each leaf against ``want`` at rtol 1e-4, elements near 0 at
    1e-4 of the leaf's largest."""
    for n, t in m1.items():
        w = np.asarray(want[n])
        np.testing.assert_allclose(t.numpy(), w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=n)


def _lr_sum():
    opt = adamw.OptConfig(**OPT)
    return sum(float(adamw.schedule(opt, s)) for s in (1, 2))


def test_two_steps_on_a_2x2_mesh_match_jax(runs):
    """deepseek-moe-16b smoke on (2,2) with EP against the reference's two
    AdamW steps on the same mesh: loss, ce, aux (EP's, averaged over the
    slices) at rtol 1e-4 at both steps, grad_norm at step 1, params within
    2 * sum(lr), ``m`` after step 1 leaf by leaf (``_m1_close``). Step 2's grad_norm is not held to JAX's: the unsharded
    port's departs from it by 1.2e-3 on these weights too (step 1 moves a
    weight with a gradient near 0 by up to 2 lr the other way), so the
    aux-free test below holds it against the port's own unsharded step."""
    z, port, jx = runs
    mets, params, m1 = port[0]["train"]
    for i, m in enumerate(mets):
        for k in ("loss", "ce", "aux", "lr") + (("grad_norm",) if i == 0
                                                else ()):
            np.testing.assert_allclose(m[k], float(jx[f"train.{i}.{k}"]),
                                       rtol=RTOL, err_msg=f"{i} {k}")
    for n, t in params.items():
        np.testing.assert_allclose(t.numpy(), jx[f"train.params.{n}"],
                                   atol=2 * _lr_sum(), rtol=0, err_msg=n)
    _m1_close(m1, {n: jx[f"train.m1.{n}"] for n in m1})
    assert all(r["train"][0] == mets for r in port)


def test_two_steps_on_a_2x2_mesh_match_the_unsharded_port(runs):
    """The same steps against the port's unsharded steps, with the aux
    weight 0: EP averages per-slice aux losses (as the reference), the
    local path takes one over the batch, so only the cross-entropy is the
    same objective on both. ``m`` after step 1 is held leaf by leaf."""
    z, port, _ = runs
    mets, params, m1 = port[0]["train_no_aux"]
    want, want_params, want_m1 = _train(_lm(z, aux_weight=0.0), z)
    for m, w in zip(mets, want):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], w[k], rtol=RTOL, err_msg=k)
    for n, t in params.items():
        np.testing.assert_allclose(t.numpy(), want_params[n].numpy(),
                                   atol=2 * _lr_sum(), rtol=0, err_msg=n)
    _m1_close(m1, want_m1)
