"""Logical-axis sharding in the port (``sharding/partition.py``) against the
reference's, and the train step on a small mesh.

* ``resolve`` equals the reference's on abstract meshes: the cases of
  ``tests/test_sharding.py`` and every parameter of every architecture,
  full and smoke configs, on meshes (16,16), (2,16,16), (2,4), (4,), (1,8).
* ``placements`` gives each rank the slice that JAX's
  ``NamedSharding.devices_indices_map`` gives the device at the same mesh
  coordinate, dims over two axes among them: eight gloo processes beside
  one JAX subprocess with 8 host devices (``tests/jax_mesh_ref.py``).
* ``tests/test_sharding.py``'s small-mesh train step: gemma3-1b smoke, one
  AdamW step on meshes (1,8) and (2,4) in the same eight processes, its
  loss finite and equal to the unsharded port's and JAX's at rtol 1e-4,
  its grad_norm and params to the unsharded port's.
* ``constrain`` lays a DTensor out as DTensor's ``redistribute`` does,
  the same local tensor, placements and input gradient, through the
  port's c10d relayout, calling no ``redistribute``.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh, run_ranks)
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import remesh_state
from repro_torch.sharding import partition as part

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-4            # as tests/test_torch_train.py
P = part.P
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((4,), ("data",)),
          ((1, 8), ("data", "model"))]
# (mesh shape, axes, spec, tensor shape): dims over one axis, over two
# (batch's ("pod", "data"), seq_kv's ("data", "model")), in and out of the
# mesh's order across dims, replicated dims, a mesh of 4 of the 8 ranks
INDEX_CASES = [
    ((2, 4), ("data", "model"), ["data", "model"], [8, 8]),
    ((2, 4), ("data", "model"), [None, ["data", "model"], None], [1, 16, 3]),
    ((2, 4), ("data", "model"), [None, "model", None, "data"], [3, 4, 5, 2]),
    ((2, 2, 2), ("pod", "data", "model"), [["pod", "data"], "model"],
     [8, 6]),
    ((2, 2, 2), ("pod", "data", "model"), ["model", None, ["pod", "data"]],
     [2, 3, 4]),
    ((1, 8), ("data", "model"), [None, "model"], [3, 16]),
    ((4,), ("data",), [None, "data"], [5, 8]),
    ((2, 4), ("data", "model"), [], [4, 4]),
]
# the small-mesh steps: mesh, compress_grads
STEP_CASES = (((1, 8), False), ((2, 4), False), ((2, 4), True))


def _jax_mesh(shape, axes):
    import jax
    try:   # newer jax: AbstractMesh(axis_sizes, axis_names)
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:   # older jax: AbstractMesh(((name, size), ...))
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _same(port_spec, jax_spec):
    return tuple(port_spec) == tuple(jax_spec)


def test_resolver_cases_of_the_reference():
    """tests/test_sharding.py:19-54, the port's resolver beside JAX's."""
    from repro.sharding import partition as jpart
    cases = [((2, 4), ("data", "model"), ("embed", "ffn"), (64, 64)),
             ((2, 4), ("data", "model"), ("vocab", "embed"), (256, 64)),
             ((2, 4), ("data", "model"), ("embed", "ffn"), (64, 6)),
             ((2, 4), ("data", "model"), (None, None, "heads", None),
              (8, 128, 1, 64)),
             ((2, 4), ("data", "model"), ("batch", "seq_kv", None),
              (8, 128, 16)),
             ((2, 4), ("data", "model"), ("batch", "seq_kv", None),
              (1, 128, 16)),
             ((4,), ("data",), ("batch", None), (8, 16))]
    want = [P("data", "model"), P("model", "data"), P("data"), P(),
            P("data", "model"), P(None, ("data", "model")), P("data")]
    for (shape, axes, logical, tshape), w in zip(cases, want):
        got = part.resolve(logical, tshape, part.AbstractMesh(shape, axes))
        assert got == w, (logical, tshape, got)
        assert _same(got, jpart.resolve(logical, tshape,
                                        _jax_mesh(shape, axes)))
    x = torch.ones(4, 4)
    assert part.constrain(x, ("batch", None)) is x


def test_resolver_takes_the_active_mesh_and_rules():
    mesh = part.AbstractMesh((2, 4), ("data", "model"))
    with part.activate(mesh, {"embed": None}):
        assert part.resolve(("embed", "ffn"), (64, 64)) == P(None, "model")
        assert part.batch_spec(mesh, 3) == P("data")
    assert part.resolve(("embed", "ffn"), (64, 64)) == P("data", "model")
    assert part.batch_spec(part.AbstractMesh((2, 2, 2), ("pod", "data",
                                                        "model")), 2) == \
        P(("pod", "data"))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_parameter_resolves_as_the_reference(arch, full):
    """Each leaf of ``LM.specs()``: the same logical axes as the
    reference's, and the same spec on each mesh (the logical state of
    ``adamw.state_logical`` too)."""
    from repro.configs.base import get_config as jget
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    from repro.sharding import partition as jpart
    cfg = (get_config if full else get_smoke_config)(arch)
    lm = LM(cfg, device="meta")
    jlm = JaxLM((jget if full else jsmoke)(arch))
    assert lm.specs() == jlm.specs()
    jdefs = dict(flatten_paths(jlm.defs()))
    specs = dict(flatten_paths(lm.defs()))
    assert specs.keys() == jdefs.keys()
    logical = adamw.state_logical(lm)
    shardings = {}
    for shape, axes in MESHES:
        mesh, jmesh = part.AbstractMesh(shape, axes), _jax_mesh(shape, axes)
        sh = part.param_shardings(logical["params"], dict(
            lm.named_parameters()), mesh)
        for path, d in specs.items():
            jd = jdefs[path]
            assert (d.axes, d.shape) == (tuple(jd.axes), tuple(jd.shape))
            got = part.resolve(d.axes, d.shape, mesh)
            assert _same(got, jpart.resolve(jd.axes, jd.shape, jmesh)), \
                (path, shape, got)
            assert sh[path].spec == got
            shardings[(shape, got)] = True
    assert len(shardings) > len(MESHES)        # something is sharded


# constrain's cases on the (2, 4) ("data", "model") mesh: an [8, 8] tensor's
# placements (a Partial's local tensor half the whole) -> logical axes
CONSTRAIN_CASES = {
    "replicated->rows,cols": (("R", "R"), ("embed", "ffn")),
    "rows,cols->whole": (("S0", "S1"), (None, None)),
    "partial->rows,cols": (("P", "R"), ("embed", "ffn")),
    "partial->whole": (("R", "P"), (None, None)),
    "cols over both->rows,cols": (("S1", "S1"), ("embed", "ffn")),
    "cols->rows": (("R", "S1"), ("ffn", None)),
}


def _constrain_case(mesh, src, logical):
    """``constrain`` of the case against DTensor's ``redistribute`` to the
    same placements -> for each, (the local tensor, its placements, the
    local input's gradient of sum(local output * (rank + 1)), whether the
    input's local tensor is as it was after the call); constrain with
    ``DTensor.redistribute`` made to raise."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    pl = [{"R": Replicate(), "P": Partial(), "S0": Shard(0),
           "S1": Shard(1)}[k] for k in src]
    full = torch.arange(64.0).reshape(8, 8)
    if any(p.is_partial() for p in pl):
        local0 = full / 2
    else:
        local0 = distribute_tensor(full, mesh, pl).to_local()
    weight = float(torch.distributed.get_rank() + 1)

    def run(fn):
        leaf = local0.clone().requires_grad_()
        x = DTensor.from_local(leaf, mesh, pl, run_check=False,
                               shape=full.shape, stride=full.stride())
        y = fn(x)
        kept = torch.equal(x.to_local(), local0)
        (y.to_local() * weight).sum().backward()
        return (y.to_local().detach().clone(), [
            (p.dim if p.is_shard() else type(p).__name__)
            for p in y.placements], leaf.grad.clone(), kept)

    with part.activate(mesh):
        dst = part.placements(part.resolve(logical, full.shape, mesh), mesh)
        want = run(lambda x: x.redistribute(mesh, dst))

        def refuse(*a, **kw):
            raise AssertionError("constrain called DTensor.redistribute")
        real = DTensor.redistribute
        DTensor.redistribute = refuse
        try:
            got = run(lambda x: part.constrain(x, logical))
        finally:
            DTensor.redistribute = real
    return got, want


def _index_rank(rank, world, d):
    """One of eight ranks: each case's local shard of an arange tensor,
    then the train step on each mesh of STEP_CASES."""
    from torch.distributed.tensor import distribute_tensor
    out = {"shards": [], "steps": {}}
    for shape, axes, spec, tshape in INDEX_CASES:
        mesh = make_mesh(shape, axes, device="cpu")
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        full = torch.arange(int(np.prod(tshape))).reshape(tshape)
        dt = distribute_tensor(full, mesh, part.placements(spec, mesh))
        out["shards"].append(dt.to_local().clone()
                             if mesh.get_coordinate() is not None else None)
    z = dict(np.load(os.path.join(d, "in.npz")))
    for shape, compress in STEP_CASES:
        lm = _gemma3(z)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        with part.activate(mesh):
            state = remesh_state(adamw.init_state(lm),
                                 adamw.state_logical(lm), None, mesh)
            state, m = adamw.make_train_step(lm, adamw.OptConfig(
                compress_grads=compress))(
                    state, {"tokens": torch.from_numpy(z["tokens"]).long()})
        full = {part_: {n: t.full_tensor() for n, t in state[part_].items()}
                for part_ in ("params", "m")}
        out["steps"][shape, compress] = (
            {k: float(v) for k, v in m.items()}, full if rank == 0 else None)
    host = make_host_mesh(device="cpu")
    out["host_mesh"] = (tuple(host.shape), host.mesh_dim_names)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    x = distribute_tensor(torch.arange(64).reshape(8, 8), mesh,
                          part.placements(P(), mesh))
    plain = torch.ones(2)
    with part.activate(mesh):
        c = part.constrain(x, ("embed", "ffn"))
        same = part.constrain(plain, ("embed",)) is plain
    out["constrain"] = (c.to_local().clone(), [
        p.dim if p.is_shard() else None for p in c.placements], same)
    out["constrain_cases"] = {k: _constrain_case(mesh, *v)
                              for k, v in CONSTRAIN_CASES.items()}
    return out


def _gemma3(z):
    lm = LM(get_smoke_config("gemma3-1b"), device="cpu")
    load_jax_numpy(lm, {k[3:]: v for k, v in z.items()
                        if k.startswith("lm.")})
    return lm


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX side (index maps in a subprocess with 8 host devices; the
    gemma3-1b smoke loss here) beside the port's eight ranks."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    d = tmp_path_factory.mktemp("sharding")
    with open(d / "cases.json", "w") as f:
        json.dump(INDEX_CASES, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_ref.py"), "indices",
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        jlm = JaxLM(jsmoke("gemma3-1b"))
        params = jlm.init(jax.random.PRNGKey(0))
        tokens = np.random.RandomState(0).randint(0, 512, (2, 64)) \
            .astype(np.int32)
        jloss = float(jlm.loss(params, {"tokens": jnp.asarray(tokens)})[0])
        z = {f"lm.{k}": v for k, v in flatten_paths(
            jax.tree.map(np.asarray, params))}
        z["tokens"] = tokens
        np.savez(d / "in.npz", **z)
        port = run_ranks(_index_rank, 8, (str(d),), timeout_s=240,
                         device="cpu", workdir=str(d))
        _, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    with open(d / "indices.json") as f:
        indices = json.load(f)
    return port, indices, jloss, z


@pytest.mark.parametrize("case", range(len(INDEX_CASES)))
def test_placements_give_each_rank_jax_slice(ranks, case):
    port, indices, _, _ = ranks
    shape, _, _, tshape = INDEX_CASES[case]
    full = torch.arange(int(np.prod(tshape))).reshape(tshape)
    n = int(np.prod(shape))
    for rank in range(8):
        got = port[rank]["shards"][case]
        if rank >= n:
            assert got is None
            continue
        want = full[tuple(slice(a, b) for a, b in indices[case][rank])]
        assert torch.equal(got, want), (case, rank)


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: "{}x{}{}".format(
    *c[0], "-compressed" if c[1] else ""))
def test_small_mesh_train_step(ranks, case):
    """tests/test_sharding.py:57-74 on the port: one AdamW step of the
    gemma3-1b smoke LM on the mesh; the loss finite, equal on every rank
    and to the unsharded port's and JAX's at rtol 1e-4; grad_norm and the
    updated params to the unsharded port's (params within 2 lr), and ``m``,
    which is (1 - b1) times each leaf's clipped gradient, at rtol 1e-4
    (elements near 0 at 1e-4 of the leaf's largest; compressed, under 1%
    of a leaf's elements may sit one int8 level off). With
    ``compress_grads`` each rank draws every leaf's whole noise from the
    step's generator and keeps its shard, so the unsharded step (whose
    noise is the same draw) is the reference."""
    port, _, jloss, z = ranks
    shape, compress = case
    mets, full = port[0]["steps"][case]
    assert np.isfinite(mets["loss"])
    assert all(r["steps"][case][0] == mets for r in port)
    lm = _gemma3(z)
    state, want = adamw.make_train_step(lm, adamw.OptConfig(
        compress_grads=compress))(
        adamw.init_state(lm),
        {"tokens": torch.from_numpy(z["tokens"]).long()})
    np.testing.assert_allclose(mets["loss"], jloss, rtol=RTOL)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(mets[k], float(want[k]), rtol=RTOL,
                                   err_msg=k)
    lr = float(want["lr"])
    for n, t in state["params"].items():
        np.testing.assert_allclose(full["params"][n].numpy(),
                                   t.detach().numpy(), atol=2 * lr, rtol=0,
                                   err_msg=n)
    for n, t in state["m"].items():         # (1 - b1) x the clipped gradient
        got, w = full["m"][n].numpy(), t.numpy()
        top = float(np.abs(w).max())
        off = ~np.isclose(got, w, rtol=RTOL, atol=RTOL * top)
        if compress:
            # a gradient that differs in its last bits may round to the
            # next int8 level: one level (top / 126 or less) on a few
            # elements
            assert off.mean() < 1e-2, (n, off.mean())
            np.testing.assert_allclose(got, w, rtol=0, atol=top / 126,
                                       err_msg=n)
        else:
            assert not off.any(), (n, np.abs(got - w).max(), top)


def test_host_and_production_meshes(ranks):
    """``make_host_mesh`` is the world as one "data" axis; the production
    meshes need 256 or 512 ranks and say so on a smaller world."""
    port = ranks[0]
    assert all(r["host_mesh"] == ((8,), ("data",)) for r in port)
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {need} ranks"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_constrain_redistributes_a_dtensor(ranks):
    """Under an active mesh ``constrain`` moves a replicated DTensor to its
    spec's placements ((embed, ffn) -> rows over "data", columns over
    "model") and returns a plain tensor as it is."""
    full = torch.arange(64).reshape(8, 8)
    for rank, r in enumerate(ranks[0]):
        local, dims, same = r["constrain"]
        assert dims == [0, 1] and same
        d, m = divmod(rank, 4)
        assert torch.equal(local, full[4 * d:4 * d + 4, 2 * m:2 * m + 2])


@pytest.mark.parametrize("case", list(CONSTRAIN_CASES))
def test_constrain_lays_out_as_redistribute_without_it(ranks, case):
    """On every rank ``constrain``'s local tensor, placements and input
    gradient equal those of DTensor's ``redistribute`` to the same
    placements, and ``constrain`` ran with ``redistribute`` refusing and
    left its input's local tensor as it was (a Partial's sum is taken in a
    copy, as ``redistribute`` takes it)."""
    for r in ranks[0]:
        (local, pls, grad, kept), (want, want_pls, want_grad, _) = \
            r["constrain_cases"][case]
        assert pls == want_pls
        assert torch.equal(local, want)
        assert torch.equal(grad, want_grad)
        assert kept


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_a_world_1_mesh_step_is_the_unsharded_step_bit_for_bit(tmp_path,
                                                                compress):
    """deepseek-moe-16b smoke, two AdamW steps on a world-1 (1, 1) mesh
    (a gloo group in this process) against the same steps without a mesh:
    every leaf of params, m and v, in the same order, and the metrics, bit
    for bit (the card's ``dist-train`` at full width). The mesh step runs
    the code a sharded one does: gradient placement, the clip norm's
    ownership mask and, with ``compress_grads``, the shard of the noise."""
    import datetime

    import torch.distributed as dist
    cfg = get_smoke_config("deepseek-moe-16b")
    tok = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 32)))
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                          compress_grads=compress)

    def run(mesh):
        lm = LM(cfg, device="cpu")
        state = adamw.init_state(lm)
        if mesh is not None:
            state = remesh_state(state, adamw.state_logical(lm), None, mesh)
        mets = []
        with part.activate(mesh) if mesh is not None else \
                contextlib.nullcontext():
            step = adamw.make_train_step(lm, opt)
            for _ in range(2):
                state, m = step(state, {"tokens": tok})
                mets.append({k: v.item() for k, v in m.items()})
        return mets, {f"{k}.{n}": getattr(t, "to_local", lambda: t)()
                      for k in ("params", "m", "v")
                      for n, t in state[k].items()}

    want, want_state = run(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got, got_state = run(make_mesh((1, 1), ("data", "model"),
                                       device="cpu"))
    finally:
        dist.destroy_process_group()
    assert got == want
    assert list(got_state) == list(want_state)
    for k, t in want_state.items():
        assert torch.equal(got_state[k], t), k
