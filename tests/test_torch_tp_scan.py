"""Tensor-parallel compute over "model" for the scan mixers
(``partition.tp_plan``/``compute_axis`` with the ``rec`` and ``ssm``
blocks, ``models/rglru.py``'s RG-LRU block on this rank's RNN channels,
``models/ssm.py``'s Mamba-2 block on its SSD heads, ``optim/adamw.py``'s
mesh step with its cuts of leaves stored whole and its sections, and
``launch.specs.build_fn``'s serving) on four gloo processes, against the
reference's GSPMD step and serving cells on the same mesh and against the
unsharded port.

Smoke recurrentgemma-9b (``rec`` by RNN width: 64 channels, 4 RNN heads;
its ``local`` layers by heads, the MLPs by ffn, the vocabulary by rows)
and smoke mamba2-2.7b (``ssm`` by SSD heads: H = 8, ``in_proj`` of 296
columns, ``conv_dim`` 160; the vocabulary by rows) on meshes (1, 4) and
(2, 2):

* one train step against JAX's GSPMD step (``tests/jax_mesh_ref.py tp``):
  logits at rtol 1e-4 against GSPMD and the unsharded port, loss, ce and
  grad_norm against GSPMD at 1e-4, and ``m`` after the step leaf by leaf
  no farther (relative L2) from a float64 step's than the farther of the
  two float32 witnesses, the unsharded port and GSPMD, lies, plus 1e-4
  (``tests/test_torch_tp_moe.py``'s rule);
* each rank's compute copy of every leaf exactly its slice (split), its
  cut of a leaf stored whole (``a_log``, the gate biases, ``dt_bias``,
  ``A_log``, ``D``, ``norm``), its sections (``in_proj``: its z, x and dt
  columns and every B and C column; ``conv_w``: its x channels and B and
  C), or the whole leaf;
* two AdamW steps of a float64 copy of the port (``tests/
  encdec_grad_norm.py``'s ``float64_port``) equal to its unsharded steps
  by ``tests/float64_steps.py``'s measure at 1e-10, and two controls that must miss that: the RG-LRU block's
  ``wo`` all-reduce dropped, and the gated norm's sum of squares left
  unsummed over "model";
* serving cells on (2, 2) against JAX's (``tests/jax_mesh_ref.py
  serve``) and the unsharded port: a prefill and three decode steps,
  every call's logits and every rank's cache shard after the prefill and
  after the last step at rtol 1e-4, each shard the slice
  ``devices_indices_map`` gives: the RG-LRU's window and state by
  channels, Mamba-2's state by heads and its conv window's flat shard,
  which cuts across the x, B and C sections, at B = 2 (the batch over
  "data") and B = 1;
* with "ffn" kept off "model" both mixers compute gathered: every
  ``rec`` and ``ssm`` compute copy is the whole leaf and the step the
  unsharded one's;
* the gated norm split over four ranks (its sum of squares by
  ``tp.sum_over``) gives autograd's gradients of the unsplit norm, and
  with a sum whose backward does not sum (``tp.reduce_from``) it does
  not.

The port's ranks spawn once; the JAX side runs in two subprocesses that see
8 host devices each, beside them.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from encdec_grad_norm import F64, float64_port  # noqa: E402
from float64_steps import (F64_REL, distance, sums_in_parts,  # noqa: E402
                           two_steps, worst)

from repro_torch.bridge import load_jax_numpy  # noqa: E402
from repro_torch.configs.base import (ShapeConfig,  # noqa: E402
                                      get_smoke_config)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.layers import flatten_paths  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.elastic import remesh_state  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402
from repro_torch.sharding import tp as TP  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 48           # recurrentgemma-9b's smoke window, 32, binds
ARCHS = {"rec": "recurrentgemma-9b", "ssm": "mamba2-2.7b"}
MESHES = ((1, 4), (2, 2))
CASES = [(a, s) for a in ARCHS for s in MESHES]
# the controls, run on (1, 4) in float64: what each breaks, on which arch
CONTROLS = {"rec wo unsummed": "rec", "norm squares unsummed": "ssm"}
GATHERED = {"ffn": None}
SERVE_MESH = (2, 2)
CAP = 64
STEPS = 3
# key: (arch, global batch, prompt length)
SERVE = {"rec-b2": ("rec", 2, 40), "rec-b1": ("rec", 1, 20),
         "ssm-b2": ("ssm", 2, 40), "ssm-b1": ("ssm", 1, 20)}
# the layout (batch, seq, channels or heads) of each case's scan caches
LAYOUTS = {"rec-b2": {"rec": (("data",), (), ("model",))},
           "rec-b1": {"rec": ((), (), ("model",))},
           "ssm-b2": {"ssm": (("data",), (), ("model",)),
                      "ssm.conv": (("data",), (), ("model",))},
           "ssm-b1": {"ssm": ((), (), ("model",)),
                      "ssm.conv": ((), (), ("model",))}}
NORM_W = 32            # the gated norm's width in its split check


def _cfg(arch, smoke=get_smoke_config):
    return smoke(ARCHS[arch])


def _lm(z, pre, arch=None):
    lm = LM(_cfg(arch or pre), device="cpu")
    load_jax_numpy(lm, {k[len(pre) + 1:]: v for k, v in z.items()
                        if k.startswith(f"{pre}.")})
    return lm


def _batch(z):
    return {"tokens": torch.from_numpy(z["tokens"]).long()}


def _step(lm, z, mesh=None, rules=None):
    """One AdamW step, on ``mesh`` under ``rules`` from the state placed by
    ``remesh_state``; records the logits ``lm.forward`` returned and every
    leaf's compute copy when the loss ran. -> (metrics, logits, compute
    copies, state)."""
    rec = {}
    forward, loss = lm.forward, lm.loss

    def recording_forward(*a, **kw):
        out = forward(*a, **kw)
        rec["logits"] = out[0].detach().clone()
        return out

    def recording_loss(*a, **kw):
        rec["compute"] = {n: p.detach().clone()
                          for n, p in lm.named_parameters()}
        return loss(*a, **kw)
    lm.forward, lm.loss = recording_forward, recording_loss
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, adamw.OptConfig(**OPT))
    if mesh is None:
        state, m = step(state, _batch(z))
    else:
        with part.activate(mesh, rules):
            state = remesh_state(state, adamw.state_logical(lm), None, mesh)
            state, m = step(state, _batch(z))
    return ({k: float(v) for k, v in m.items()}, rec["logits"],
            rec["compute"], state)


@dataclasses.dataclass
class _Control:
    """A float64 code that must fail the check: ``name`` of CONTROLS."""
    name: str

    def __enter__(self):
        mod = "rglru" if self.name == "rec wo unsummed" else "ssm"
        self.mod = importlib.import_module(f"{F64}.models.{mod}")
        self.saved = real = self.mod.TP
        if mod == "rglru":
            shim = dict(reduce_from=lambda y, tp: y)
        else:
            shim = dict(sum_over=lambda x, tp: x)
        self.mod.TP = types.SimpleNamespace(**dict(
            {k: getattr(real, k) for k in ("copy_to", "reduce_from",
                                           "sum_over", "all_gather")},
            **shim))

    def __exit__(self, *exc):
        self.mod.TP = self.saved


def _steps64(arch, weights, batches, mesh_shape=None, control=None,
             witness=False):
    """Two AdamW steps of the float64 port's smoke ``arch`` from
    ``weights``, on ``mesh_shape`` with the default split, under
    ``control`` (a CONTROLS name) if given, with the sums in parts under
    ``witness``. -> ``float64_steps.Steps``, whole tensors."""
    import contextlib
    mod = {k: importlib.import_module(f"{F64}.{k}") for k in (
        "configs.base", "models.model", "optim.adamw",
        "sharding.partition", "launch.mesh", "runtime.elastic")}
    opt_mod, prt = mod["optim.adamw"], mod["sharding.partition"]
    cfg = _cfg(arch, smoke=mod["configs.base"].get_smoke_config).replace(
        dtype="float64")
    lm = mod["models.model"].LM(cfg, device="cpu")
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(torch.from_numpy(weights[n]))
    mesh = mod["launch.mesh"].make_mesh(mesh_shape, ("data", "model"),
                                        device="cpu") if mesh_shape else None
    state = opt_mod.init_state(lm)
    whole = (lambda t: t.full_tensor()) if mesh else (lambda t: t)
    with (prt.activate(mesh) if mesh else contextlib.nullcontext()), \
            (_Control(control) if control else contextlib.nullcontext()), \
            (sums_in_parts() if witness else contextlib.nullcontext()):
        if mesh:
            state = mod["runtime.elastic"].remesh_state(
                state, opt_mod.state_logical(lm), None, mesh)
        step = opt_mod.make_train_step(lm, opt_mod.OptConfig(**OPT))
        return two_steps(step, state, [
            {"tokens": torch.from_numpy(b).long()} for b in batches], whole)


def _serve(lm, z, key, mesh=None):
    """The prefill and STEPS decode steps -> (logits per call, the cache
    after the prefill and after the last step, each leaf by path: this
    rank's local shard on a mesh)."""
    tokens = torch.from_numpy(z[f"{key}.tokens"]).long()
    dec = torch.from_numpy(z[f"{key}.dec"]).long()

    def flat(cache):
        return {k: (v.to_local() if mesh is not None else v).clone()
                for k, v in flatten_paths(cache)}
    if mesh is None:
        cache, lg = lm.prefill({"tokens": tokens}, CAP)
        step, whole = lm.decode_step, (lambda t: t)
    else:
        Bs = tokens.shape[0]
        sp = dict(specs.input_specs(lm.cfg, ShapeConfig(
            "p", CAP, Bs, "prefill"), mesh), lm=lm)
        sd = dict(specs.input_specs(lm.cfg, ShapeConfig(
            "d", CAP, Bs, "decode"), mesh), lm=lm)
        params = {n: specs._placed(p.detach(), sp["in_shardings"][0][n])
                  for n, p in lm.named_parameters()}
        cache, lg = specs.build_fn(sp)(params, {"tokens": tokens})
        fn = specs.build_fn(sd)

        def step(cache, t):
            return fn(params, cache, t)

        def whole(t):
            return t.full_tensor()
    logits, prefilled = [whole(lg)], flat(cache)
    for i in range(STEPS):
        cache, lg = step(cache, dec[:, i:i + 1])
        logits.append(whole(lg))
    return logits, prefilled, flat(cache)


def _norm_split(z, rank, mesh, sum_over=None):
    """The gated norm on this rank's quarter of NORM_W channels, its sum
    of squares by ``sum_over`` (default ``tp.sum_over``) over "model" of
    ``mesh`` -> (output, gradients of y, z and the scale under the
    cotangent), this rank's channels."""
    from repro_torch.models import ssm
    plan = part.TPPlan(4, False, False, False, False, False, False, True)
    tp = TP.Region(mesh.get_group("model"), mesh.get_local_rank("model"), 4,
                   plan)
    n = NORM_W // 4
    m = mesh.get_local_rank("model")
    local = [torch.from_numpy(z[f"norm.{k}"][..., m * n:(m + 1) * n].copy())
             .requires_grad_() for k in ("y", "z", "scale")]
    saved = ssm.TP
    if sum_over is not None:
        ssm.TP = types.SimpleNamespace(sum_over=sum_over)
    try:
        out = ssm._gated_norm(*local, 1e-6, tp, NORM_W)
    finally:
        ssm.TP = saved
    cot = torch.from_numpy(z["norm.cot"][..., m * n:(m + 1) * n].copy())
    (out * cot).sum().backward()
    return out.detach(), [t.grad for t in local]


def _rank(rank, world, d, f64_dir):
    """One of four ranks: each case's float32 step and float64 steps, the
    controls, the rules cases and the gated norm on (1, 4), then the
    serving cells on (2, 2). Every rank returns its local readings; rank 0
    also the whole ``m`` (gathered on every rank, as the collective
    needs)."""
    sys.path.insert(0, f64_dir)
    z = dict(np.load(os.path.join(d, "in.npz")))
    weights = {a: {k[len(a) + 1:]: v for k, v in z.items()
                   if k.startswith(f"{a}.")} for a in ARCHS}
    batches = [z["tokens"], z["tokens2"]]
    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in MESHES}
    out = {}
    for arch, shape in CASES:
        mesh = meshes[shape]
        lm = _lm(z, arch)
        mets, logits, compute, state = _step(lm, z, mesh)
        full = {n: t.full_tensor() for n, t in state["m"].items()}
        out[arch, shape] = dict(
            metrics=mets, coord=tuple(mesh.get_coordinate()),
            plan=adamw.tp_plan(lm, mesh), logits=logits, compute=compute,
            m=full if rank == 0 else None,
            f64=_steps64(arch, weights[arch], batches, shape))
    for name, arch in CONTROLS.items():
        out[name] = _steps64(arch, weights[arch], batches, (1, 4), name)
    mesh = meshes[(1, 4)]
    for arch in ARCHS:
        lm = _lm(z, arch)
        ran = _step(lm, z, mesh, GATHERED)
        with part.activate(mesh, GATHERED):
            plan = adamw.tp_plan(lm, mesh)
        out["rules", arch] = dict(metrics=ran[0], compute=ran[2], plan=plan)
    out["norm"] = _norm_split(z, rank, mesh)
    out["norm control"] = _norm_split(z, rank, mesh, TP.reduce_from)
    mesh = meshes[SERVE_MESH]
    for key, (arch, Bs, _) in SERVE.items():
        lm = _lm(z, f"{key}.p", arch)
        with part.activate(mesh):
            logits, prefilled, decoded = _serve(lm, z, key, mesh)
            layouts = lm.cache_layouts(mesh, Bs, CAP)
        out[key] = dict(coord=tuple(mesh.get_coordinate()), logits=logits,
                        prefill=prefilled, decode=decoded,
                        layouts={k: tuple(layouts[k])
                                 for k in LAYOUTS[key]})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights of each case (``LM.init``), the batches and
    prompts from numpy seeds; the JAX side in two subprocesses beside the
    port's four ranks; the unsharded port in float32 and float64."""
    import jax
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    d = tmp_path_factory.mktemp("tp_scan")
    rs = np.random.RandomState(0)
    z = {"tokens": rs.randint(0, 512, (B, S)).astype(np.int32),
         "tokens2": rs.randint(0, 512, (B, S)).astype(np.int32),
         "opt": np.array(json.dumps(OPT))}

    def weights(pre, arch, key):
        params = JaxLM(jsmoke(arch)).init(jax.random.PRNGKey(key))
        for path, v in flatten_paths(jax.tree.map(np.asarray, params)):
            z[f"{pre}.{path}"] = v
    for i, (a, arch) in enumerate(ARCHS.items()):
        weights(a, arch, i)
    for i, (key, (a, Bs, Ss)) in enumerate(SERVE.items()):
        weights(f"{key}.p", ARCHS[a], 3 + i)
        z[f"{key}.tokens"] = rs.randint(0, 512, (Bs, Ss)).astype(np.int32)
        z[f"{key}.dec"] = rs.randint(0, 512, (Bs, STEPS)).astype(np.int32)
    for k in ("y", "z", "cot"):
        z[f"norm.{k}"] = rs.randn(2, 6, NORM_W).astype(np.float32)
    z["norm.scale"] = (0.1 * rs.randn(NORM_W)).astype(np.float32)
    np.savez(d / "in.npz", **z)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    for job, cases in (
            ("tp", [[a, ARCHS[a], {}, list(s), i]
                    for i, (a, s) in enumerate(CASES)]),
            ("serve", [[key, ARCHS[a], {}, list(SERVE_MESH), Bs, CAP]
                       for key, (a, Bs, _) in SERVE.items()])):
        dj = d / job
        dj.mkdir()
        os.symlink(d / "in.npz", dj / "in.npz")
        with open(dj / "cases.json", "w") as f:
            json.dump(cases, f)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "jax_mesh_ref.py"), job,
             str(dj)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        f64_dir = str(d / "f64")
        os.mkdir(f64_dir)
        float64_port(f64_dir)
        port = run_ranks(_rank, 4, (str(d), f64_dir), timeout_s=300,
                         device="cpu", workdir=str(d))
        weights64 = {a: {k[len(a) + 1:]: v for k, v in z.items()
                         if k.startswith(f"{a}.")} for a in ARCHS}
        unsharded = {a: _step(_lm(z, a), z) for a in ARCHS}
        unsharded64 = {a: _steps64(a, weights64[a], [z["tokens"],
                                                     z["tokens2"]])
                       for a in ARCHS}
        witness64 = {a: _steps64(a, weights64[a], [z["tokens"],
                                                   z["tokens2"]],
                                 witness=True)
                     for a in ARCHS}
        served = {key: _serve(_lm(z, f"{key}.p", a), z, key)
                  for key, (a, _, _) in SERVE.items()}
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    jx = dict(np.load(d / "tp" / "out.npz"))
    js = dict(np.load(d / "serve" / "out.npz"))
    with open(d / "serve" / "indices.json") as f:
        indices = json.load(f)
    return dict(z=z, port=port, unsharded=unsharded, unsharded64=unsharded64,
                witness64=witness64,
                served=served, jx=jx, js=js, indices=indices)


def _close(got, want, what):
    """rtol 1e-4, elements near 0 at 1e-4 of the largest."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case_id(c):
    return "{}-{}x{}".format(ARCHS[c[0]], *c[1])


def _full_logits(port, case):
    """The logits over the whole batch and vocabulary from the ranks'
    local ones: rank (d, m) holds batch slice d and vocabulary slice m."""
    shape = case[1]
    rows = [[None] * shape[1] for _ in range(shape[0])]
    for r in port:
        dd, mm = r[case]["coord"]
        rows[dd][mm] = r[case]["logits"]
    assert port[0][case]["plan"].vocab
    return torch.cat([torch.cat(row, -1) for row in rows], 0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_step_matches_gspmd(runs, case):
    """Logits against GSPMD and the unsharded port; loss, ce and grad_norm
    equal on every rank and against GSPMD; ``m`` after the step leaf by
    leaf no farther from the float64 step's than the unsharded port's or
    GSPMD's lies, plus 1e-4 (the module's docstring)."""
    port, jx = runs["port"], runs["jx"]
    i = CASES.index(case)
    got = _full_logits(port, case).numpy()
    assert got.shape == (B, S, _cfg(case[0]).padded_vocab)
    want = runs["unsharded"][case[0]]
    _close(got, want[1].numpy(), "logits against the port")
    _close(got, jx[f"{i}.logits"], "logits against GSPMD")
    mets = port[0][case]["metrics"]
    assert all(r[case]["metrics"] == mets for r in port)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(mets[k], float(jx[f"{i}.{k}"]),
                                   rtol=RTOL, err_msg=k)
    m = port[0][case]["m"]
    unsharded_m = want[3]["m"]
    exact = runs["unsharded64"][case[0]].m1
    assert m.keys() == unsharded_m.keys() == exact.keys()
    for n, t in m.items():
        f64 = exact[n].numpy()
        witness = max(_rel_l2(unsharded_m[n].detach().numpy(), f64),
                      _rel_l2(jx[f"{i}.m.{n}"], f64))
        assert _rel_l2(t.numpy(), f64) <= witness + RTOL, (n, witness)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_compute_copies_are_the_ranks_slices(runs, case):
    """Each rank computed with exactly its slice of each split leaf (the
    RG-LRU's wx, wg, conv_w and wo by channels, w_ga and w_gx by heads;
    Mamba-2's out_proj by rows; recurrentgemma-9b's attention, MLPs and
    both models' vocabulary as before), its cut of each leaf stored whole
    (a_log, b_ga, b_gx; dt_bias, A_log, D, norm), its sections of
    ``in_proj`` and ``conv_w``, and every other leaf whole."""
    z, port = runs["z"], runs["port"]
    arch, shape = case
    cfg = _cfg(arch)
    lm = LM(cfg, device="meta")
    blocks, logical = lm.leaf_blocks(), adamw.state_logical(lm)["params"]
    plan = port[0][case]["plan"]
    assert plan == lm.tp_plan(shape[1])
    assert plan.vocab and (plan.rec if arch == "rec" else plan.ssm)
    kinds = {"split": 0, "cut": 0, "sections": 0, "whole": 0}
    for r in port:
        mi = r[case]["coord"][1]
        for n, got in r[case]["compute"].items():
            full = torch.tensor(z[f"{arch}.{n}"])
            leaf = n.rsplit(".", 1)[-1]
            ax = part.compute_axis(plan, blocks.get(n), leaf)
            if ax == part.SECTIONS:
                kind = "sections"
                full = full.index_select(-1, SSM.section_index(
                    cfg, leaf, mi, shape[1]))
            elif ax is not None:
                kind = "split" if ax in logical[n] else "cut"
                dim = part.compute_dim(logical[n], ax)
                k = full.shape[dim] // shape[1]
                full = full.narrow(dim, mi * k, k)
            else:
                kind = "whole"
            kinds[kind] += 1
            assert torch.equal(got, full), (n, r[case]["coord"], kind)
    assert kinds["split"] and kinds["cut"] and kinds["whole"], kinds
    assert bool(kinds["sections"]) == (arch == "ssm"), kinds


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_steps_are_exact_in_float64(runs, case):
    """In float64 the mesh's two steps equal the unsharded float64 steps to
    F64_REL by ``float64_steps.distance``, every rank alike; the witness
    (the unsharded steps with their sums in parts) moves no params term
    past it either."""
    port = runs["port"]
    want = runs["unsharded64"][case[0]]
    got = port[0][case]["f64"]
    assert all(r[case]["f64"].metrics == got.metrics for r in port)
    assert worst(got, want) <= F64_REL, distance(got, want)
    assert distance(runs["witness64"][case[0]], want)["params"] <= F64_REL


@pytest.mark.parametrize("control", list(CONTROLS))
def test_the_controls_miss_the_float64_limit(runs, control):
    """The RG-LRU block's output left unsummed over "model", or the gated
    norm's sum of squares taken over this rank's heads alone: the float64
    steps on (1, 4) miss F64_REL by far."""
    got = runs["port"][0][control]
    want = runs["unsharded64"][CONTROLS[control]]
    assert worst(got, want) > 1e3 * F64_REL


def _rank_of(coord):
    return coord[0] * SERVE_MESH[1] + coord[1]


@pytest.mark.parametrize("key", list(SERVE))
def test_serving_logits_match_gspmd_and_the_unsharded_port(runs, key):
    """The prefill's last logits and each decode step's, whole over the
    batch and the vocabulary on every rank."""
    arch, Bs, _ = SERVE[key]
    want = runs["served"][key][0]
    for r in runs["port"]:
        for i, got in enumerate(r[key]["logits"]):
            assert got.shape == (Bs, _cfg(arch).padded_vocab)
            _close(got, runs["js"][f"{key}.logits.{i}"],
                   f"call {i} against GSPMD")
            _close(got, want[i], f"call {i} against the port")


@pytest.mark.parametrize("when", ["prefill", "decode"])
@pytest.mark.parametrize("key", list(SERVE))
def test_serving_cache_shards_match_gspmd(runs, key, when):
    """Every rank's local cache leaf, after the prefill and after the last
    decode step, has its storage shard's shape and holds its slice of
    JAX's cache (``devices_indices_map``: Mamba-2's flat conv window
    included) and of the unsharded port's; the scan caches' layouts are
    the ones the case exercises."""
    want_port = runs["served"][key][1 if when == "prefill" else 2]
    for r in runs["port"]:
        assert r[key]["layouts"] == LAYOUTS[key]
        got = r[key][when]
        assert got.keys() == want_port.keys()
        for path, t in got.items():
            rows = runs["indices"][key][path][_rank_of(r[key]["coord"])]
            sl = tuple(slice(a, b) for a, b in rows)
            assert tuple(t.shape) == tuple(b - a for a, b in rows), path
            _close(t, runs["js"][f"{key}.{when}.{path}"][sl],
                   f"{path} vs GSPMD")
            _close(t, want_port[path][sl].numpy(), f"{path} vs the port")


@pytest.mark.parametrize("arch", list(ARCHS), ids=ARCHS.get)
def test_with_ffn_off_model_the_scan_mixers_compute_gathered(runs, arch):
    """Under rules that keep "ffn" off "model" neither scan block splits
    (recurrentgemma-9b's ``local`` layers still split by heads, and with
    them its vocabulary; mamba2-2.7b splits nothing): every ``rec`` and
    ``ssm`` compute copy is the whole leaf, and the step's loss and
    grad_norm are the unsharded step's."""
    z = runs["z"]
    blocks = LM(_cfg(arch), device="meta").leaf_blocks()
    want = runs["unsharded"][arch][0]
    for r in runs["port"]:
        got = r["rules", arch]
        plan = got["plan"]
        assert not (plan.rec or plan.ssm or plan.ffn), plan
        assert plan.heads == plan.vocab == (arch == "rec"), plan
        n_scan = 0
        for n, t in got["compute"].items():
            if blocks.get(n) in part.SCAN_MIXERS:
                assert torch.equal(t, torch.tensor(z[f"{arch}.{n}"])), n
                n_scan += 1
        assert n_scan
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], want[k],
                                       rtol=RTOL, err_msg=k)


def test_the_gated_norm_split_backward_is_autograds(runs):
    """The gated norm over NORM_W channels split four ways (the sum of
    squares by ``tp.sum_over``): each rank's output and its gradients of
    y, z and the scale are its channels' of the unsplit norm's under
    autograd, at 1e-5; with a sum whose backward does not sum
    (``tp.reduce_from``) the output holds and the gradients of y and z do
    not."""
    z = runs["z"]
    whole = [torch.from_numpy(z[f"norm.{k}"]).requires_grad_()
             for k in ("y", "z", "scale")]
    out = SSM._gated_norm(*whole, 1e-6)
    (out * torch.from_numpy(z["norm.cot"])).sum().backward()
    n = NORM_W // 4
    for r in runs["port"]:
        m = r["rec", (1, 4)]["coord"][1]
        sl = slice(m * n, (m + 1) * n)
        for name, control in (("norm", False), ("norm control", True)):
            got, grads = r[name]
            torch.testing.assert_close(got, out.detach()[..., sl],
                                       rtol=1e-5, atol=1e-6)
            for what, g, t in zip("y z".split(), grads, whole):
                close = torch.allclose(g, t.grad[..., sl], rtol=1e-5,
                                       atol=1e-6)
                assert close != control, (name, what)
        torch.testing.assert_close(r["norm"][1][2], whole[2].grad[sl],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,tp,want", [
    ("recurrentgemma-9b", 4, dict(rec=True, heads=True, ffn=True,
                                  vocab=True)),
    ("recurrentgemma-9b", 8, dict(rec=False, heads=False)),  # 4 RNN heads
    ("mamba2-2.7b", 4, dict(ssm=True, vocab=True, heads=False, ffn=False)),
    ("mamba2-2.7b", 8, dict(ssm=True, vocab=True)),
    ("mamba2-2.7b", 16, dict(ssm=False, vocab=False)),       # 8 SSD heads
])
def test_the_plan_splits_the_scan_blocks_in_whole_units(arch, tp, want):
    """``LM.tp_plan`` of the smoke configs: ``rec`` where the RNN width
    and heads divide the axis, ``ssm`` where the SSD heads do, and the
    vocabulary beside any split block (a model none of whose blocks
    split keeps it whole)."""
    plan = LM(get_smoke_config(arch), device="meta").tp_plan(tp)
    assert {k: getattr(plan, k) for k in want} == want, plan


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b"])
def test_the_full_configs_split_on_sixteen_ranks(arch):
    """At full width on a model axis of 16 (the production meshes'):
    recurrentgemma-9b's 4096 channels and 16 RNN heads, mamba2-2.7b's 80
    SSD heads and 50432 vocabulary rows split; with "ffn" off "model"
    neither scan block does."""
    from repro_torch.configs.base import get_config
    lm = LM(get_config(arch), device="meta")
    plan = lm.tp_plan(16)
    assert plan.vocab and (plan.rec if arch == "recurrentgemma-9b"
                           else plan.ssm and not plan.heads), plan
    off = lm.tp_plan(16, GATHERED)
    assert not (off.rec or off.ssm), off
    if arch == "mamba2-2.7b":
        assert not off.vocab, off
        cfg = lm.cfg
        for r in (0, 15):
            cols = SSM.section_index(cfg, "in_proj", r, 16)
            # 320 z, 320 x, 256 B and C, 5 dt columns
            assert cols.numel() == 2 * 320 + 2 * 128 + 5
            assert cols.unique().numel() == cols.numel()
