"""Tensor-parallel compute over "model" for the MoE families beside EP
(``partition.tp_plan``/``compute_axis`` with the ``mla`` mixer and the
``shared`` block, ``models/moe.py``'s split shared experts,
``models/attention.py``'s MLA on local heads and its split decode, the
mesh step of ``optim/adamw.py`` and ``launch.specs.build_fn``'s serving) on
four gloo processes, against the reference's GSPMD step and serving cells
on the same mesh and against the unsharded port.

Smoke deepseek-moe-16b (``attn`` by heads, the dense layer 0 and the
shared experts by ffn, the vocabulary by rows, the routed experts on EP)
and deepseek-v2-236b (the same with ``mla`` by heads) on meshes (1, 4)
and (2, 2), at aux weight 0 and capacity factor 8 (no copy drops on
either path, as ``tests/test_torch_moe_ep.py``'s unsharded comparison):

* one train step against JAX's GSPMD step (``tests/jax_mesh_ref.py tp``):
  logits at rtol 1e-4 against GSPMD and the unsharded port, loss, ce and
  grad_norm against GSPMD at 1e-4, and ``m`` after the step leaf by leaf.
  float32 keeps about four digits of these gradients: the unsharded
  port's ``m`` and GSPMD's lie 1.3e-4 to 2.5e-4 (relative L2) from the
  float64 step's on the dense layer 0 and the embedding, each code's sums
  landing elsewhere in that noise, and the split's lies 3.6e-4 from
  GSPMD's where the unsharded port's lies 1.8e-4 (so
  ``tests/test_torch_tp.py``'s rule, the unsharded port's distance from
  GSPMD plus 1e-4, reads a coin toss here). Each leaf of the split step is
  held instead no farther from the float64 step than the farther of the
  two float32 witnesses, the unsharded port and GSPMD, lies, plus 1e-4;
* each rank's compute copy of every leaf exactly its slice (split), its EP
  shard (the routed experts) or the whole leaf;
* two AdamW steps of a float64 copy of the port
  (``tests/encdec_grad_norm.py``'s ``float64_port``) equal to its
  unsharded steps by ``tests/float64_steps.py``'s measure at 1e-10, and
  two controls that must miss that: MLA's ``q_norm`` gradient summed over
  "model" (it acts ahead of the split and is whole), and the shared
  experts' ``reduce_from`` dropped;
* serving cells on (2, 2) against JAX's (``tests/jax_mesh_ref.py serve``)
  and the unsharded port: a prefill and three decode steps, every call's
  logits and every rank's cache shard after the prefill and after the last
  step at rtol 1e-4, each shard the slice ``devices_indices_map`` gives:
  deepseek-moe-16b with 8 kv heads (its cache's kv heads over "model", as
  at full width) and as is (4 kv heads: the sequence over "model"), and
  deepseek-v2-236b's ``ckv``/``kpe`` split by sequence at B=1 (over
  ("data", "model")) and B=4 (over "model");
* the plan reads the rules: under rules that keep "heads", "ffn" and
  "vocab" off "model" deepseek-7b's smoke plan on (1, 2) splits nothing
  and every compute copy is the whole leaf, as GSPMD computes a leaf
  whose logical axis is not on "model".

The port's ranks spawn once; the JAX side runs in two subprocesses that see
8 host devices each, beside them.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
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
from repro_torch.models.layers import flatten_paths  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.elastic import remesh_state  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 32
MOE = {"router_aux_weight": 0.0, "capacity_factor": 8.0}
ARCHS = {"moe": "deepseek-moe-16b", "mla": "deepseek-v2-236b"}
MESHES = ((1, 4), (2, 2))
CASES = [(a, s) for a in ARCHS for s in MESHES]
# the controls, run on (1, 4) in float64: what each breaks, on which arch
CONTROLS = {"q_norm summed": "mla", "shared reduce_from dropped": "moe"}
GATHERED = {"heads": None, "ffn": None, "vocab": None}
SERVE_MESH = (2, 2)
CAP = 64
STEPS = 3
# key: (arch, config overrides, global batch, prompt length)
SERVE = {"moe-heads": ("moe", {"num_heads": 8, "num_kv_heads": 8}, 2, 40),
         "moe-seq": ("moe", {}, 2, 40),
         "mla-b1": ("mla", {}, 1, 40),
         "mla-b4": ("mla", {}, 4, 40)}
# the layout (batch, seq, heads) of each case's first split mixer's cache
LAYOUTS = {"moe-heads": ("attn", (("data",), (), ("model",))),
           "moe-seq": ("attn", (("data",), ("model",), ())),
           "mla-b1": ("mla", ((), ("data", "model"), ())),
           "mla-b4": ("mla", (("data",), ("model",), ()))}


def _cfg(arch, over=None, smoke=get_smoke_config):
    cfg = smoke(ARCHS[arch])
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **MOE),
                       **(over or {}))


def _lm(z, pre, over=None, arch=None):
    lm = LM(_cfg(arch or pre, over), device="cpu")
    load_jax_numpy(lm, {k[len(pre) + 1:]: v for k, v in z.items()
                        if k.startswith(f"{pre}.")})
    return lm


def _batch(z):
    return {"tokens": torch.from_numpy(z["tokens"]).long()}


def _step(lm, z, mesh=None, rules=None):
    """One AdamW step, on ``mesh`` under ``rules`` from the state placed by
    ``remesh_state`` (which every rank calls; a rank outside the mesh
    takes no step and returns None); records the logits ``lm.forward``
    returned and every leaf's compute copy when the loss ran. ->
    (metrics, logits, compute copies, state)."""
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
            if mesh.get_coordinate() is None:
                return None
            state, m = step(state, _batch(z))
    return ({k: float(v) for k, v in m.items()}, rec["logits"],
            rec["compute"], state)


@dataclasses.dataclass
class _Control:
    """A float64 code that must fail the check: ``name`` of CONTROLS."""
    name: str

    def __enter__(self):
        pkg = F64
        self.part = importlib.import_module(f"{pkg}.sharding.partition")
        self.moe = importlib.import_module(f"{pkg}.models.moe")
        self.saved = self.part.partial_over_model, self.moe.TP
        real, TP = self.saved
        if self.name == "q_norm summed":
            def rule(plan, block, leaf):
                return real(plan, block, leaf) or (
                    plan is not None and block == "mla" and leaf == "q_norm")
            self.part.partial_over_model = rule
        else:
            import types
            self.moe.TP = types.SimpleNamespace(
                copy_to=TP.copy_to, reduce_from=lambda y, tp: y)

    def __exit__(self, *exc):
        self.part.partial_over_model, self.moe.TP = self.saved


def _steps64(arch, weights, batches, mesh_shape=None, control=None,
             witness=False):
    """Two AdamW steps of the float64 port's smoke ``arch`` from
    ``weights``, on ``mesh_shape`` with EP and the default split, under
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


def _specs(lm, B, mesh):
    sp = specs.input_specs(lm.cfg, ShapeConfig("p", CAP, B, "prefill"), mesh)
    sd = specs.input_specs(lm.cfg, ShapeConfig("d", CAP, B, "decode"), mesh)
    return dict(sp, lm=lm), dict(sd, lm=lm)


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
        sp, sd = _specs(lm, tokens.shape[0], mesh)
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


def _rank(rank, world, d, f64_dir):
    """One of four ranks: each case's float32 step and float64 steps, the
    controls, the rules case on (1, 2), then the serving cells on (2, 2).
    Every rank returns its local readings; rank 0 also the whole ``m`` and
    params (gathered on every rank, as the collective needs)."""
    sys.path.insert(0, f64_dir)
    z = dict(np.load(os.path.join(d, "in.npz")))
    weights = {a: {k[len(a) + 1:]: v for k, v in z.items()
                   if k.startswith(f"{a}.")} for a in ARCHS}
    batches = [z["tokens"], z["tokens2"]]
    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in MESHES + ((1, 2),)}
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
    mesh = meshes[(1, 2)]
    lm = LM(get_smoke_config("deepseek-7b"), device="cpu")
    load_jax_numpy(lm, {k[6:]: v for k, v in z.items()
                        if k.startswith("dense.")})
    ran = _step(lm, z, mesh, GATHERED)
    if ran is not None:
        with part.activate(mesh, GATHERED):
            plan = adamw.tp_plan(lm, mesh)
        out["rules"] = dict(metrics=ran[0], compute=ran[2], plan=plan)
    mesh = meshes[SERVE_MESH]
    for key, (arch, over, _, _) in SERVE.items():
        lm = _lm(z, f"{key}.p", over, arch)
        with part.activate(mesh):
            logits, prefilled, decoded = _serve(lm, z, key, mesh)
            cache_kind, _ = LAYOUTS[key]
            layout = lm.cache_layouts(mesh, SERVE[key][2], CAP)[cache_kind]
        out[key] = dict(coord=tuple(mesh.get_coordinate()), logits=logits,
                        prefill=prefilled, decode=decoded,
                        layout=tuple(layout))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights of each case (``LM.init``), the batches and
    prompts from numpy seeds; the JAX side in two subprocesses beside the
    port's four ranks; the unsharded port in float32 and float64."""
    import jax
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    d = tmp_path_factory.mktemp("tp_moe")
    rs = np.random.RandomState(0)
    z = {"tokens": rs.randint(0, 512, (B, S)).astype(np.int32),
         "tokens2": rs.randint(0, 512, (B, S)).astype(np.int32),
         "opt": np.array(json.dumps(OPT))}

    def weights(pre, arch, over, key):
        params = JaxLM(jsmoke(arch).replace(**over)).init(
            jax.random.PRNGKey(key))
        for path, v in flatten_paths(jax.tree.map(np.asarray, params)):
            z[f"{pre}.{path}"] = v
    for i, (a, arch) in enumerate(ARCHS.items()):
        weights(a, arch, {}, i)
    weights("dense", "deepseek-7b", {}, 2)
    for i, (key, (a, over, Bs, Ss)) in enumerate(SERVE.items()):
        weights(f"{key}.p", ARCHS[a], over, 3 + i)
        z[f"{key}.tokens"] = rs.randint(0, 512, (Bs, Ss)).astype(np.int32)
        z[f"{key}.dec"] = rs.randint(0, 512, (Bs, STEPS)).astype(np.int32)
    np.savez(d / "in.npz", **z)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    for job, cases in (
            ("tp", [[a, ARCHS[a], {"moe": MOE}, list(s), i]
                    for i, (a, s) in enumerate(CASES)]),
            ("serve", [[key, ARCHS[a], dict(over, moe=MOE), list(SERVE_MESH),
                        Bs, CAP] for key, (a, over, Bs, _) in SERVE.items()])):
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
        served = {key: _serve(_lm(z, f"{key}.p", over, a), z, key)
                  for key, (a, over, _, _) in SERVE.items()}
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
    dense = LM(get_smoke_config("deepseek-7b"), device="cpu")
    load_jax_numpy(dense, {k[6:]: v for k, v in z.items()
                           if k.startswith("dense.")})
    return dict(z=z, port=port, unsharded=unsharded, unsharded64=unsharded64,
                witness64=witness64,
                served=served, jx=jx, js=js, indices=indices,
                dense=_step(dense, z))


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
    """Each rank computed with exactly its heads' (``attn``: wq, wk, wv,
    wo; ``mla``: wq_b, wkv_b, wo), ffn columns' or rows' (the dense layer
    and the shared experts) and vocabulary rows' slice of the initial
    weights, the routed experts at its EP shard, every other leaf (the
    router, MLA's wq_a, wkv_a and norms, the norms) whole."""
    z, port = runs["z"], runs["port"]
    arch, shape = case
    lm = LM(_cfg(arch), device="meta")
    blocks, logical = lm.leaf_blocks(), adamw.state_logical(lm)["params"]
    plan = port[0][case]["plan"]
    assert plan == lm.tp_plan(shape[1])
    assert plan.heads and plan.ffn and plan.shared and plan.vocab
    kinds = {"split": 0, "expert": 0, "whole": 0}
    for r in port:
        mi = r[case]["coord"][1]
        for n, got in r[case]["compute"].items():
            full = torch.tensor(z[f"{arch}.{n}"])
            ax = part.compute_axis(plan, blocks.get(n), n.rsplit(".", 1)[-1])
            if ax is not None:
                assert "experts" not in logical[n], n
                dim = logical[n].index(ax)
                kind = "split"
            elif "experts" in logical[n]:
                dim, kind = logical[n].index("experts"), "expert"
            else:
                kind = "whole"
            if kind != "whole":
                k = full.shape[dim] // shape[1]
                full = full.narrow(dim, mi * k, k)
            kinds[kind] += 1
            assert torch.equal(got, full), (n, r[case]["coord"], kind)
    leaves = dict(flatten_paths(lm.defs()))
    shared = [n for n in leaves if blocks.get(n) == "shared"]
    assert shared and all(part.compute_axis(plan, "shared", n.rsplit(
        ".", 1)[-1]) == "ffn" for n in shared)
    for n in leaves:        # the routed experts, never cut over ffn
        if blocks.get(n) == "moe":
            assert part.compute_axis(plan, "moe", n.rsplit(".", 1)[-1]) \
                is None, n
    assert min(kinds.values()) > 0, kinds


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_steps_are_exact_in_float64(runs, case):
    """In float64 the mesh's two steps (EP beside the split) equal the
    unsharded float64 steps to F64_REL by ``float64_steps.distance``,
    every rank alike; the witness (the unsharded steps with their sums in
    parts) moves no params term past it either."""
    port = runs["port"]
    want = runs["unsharded64"][case[0]]
    got = port[0][case]["f64"]
    assert all(r[case]["f64"].metrics == got.metrics for r in port)
    assert worst(got, want) <= F64_REL, distance(got, want)
    assert distance(runs["witness64"][case[0]], want)["params"] <= F64_REL


@pytest.mark.parametrize("control", list(CONTROLS))
def test_the_controls_miss_the_float64_limit(runs, control):
    """MLA's ``q_norm`` gradient summed over "model" (it is whole: the
    region starts after it), or the shared experts' output left unsummed:
    the float64 steps on (1, 4) miss F64_REL by far."""
    got = runs["port"][0][control]
    want = runs["unsharded64"][CONTROLS[control]]
    assert worst(got, want) > 1e3 * F64_REL


def _rank_of(coord):
    return coord[0] * SERVE_MESH[1] + coord[1]


@pytest.mark.parametrize("key", list(SERVE))
def test_serving_logits_match_gspmd_and_the_unsharded_port(runs, key):
    """The prefill's last logits and each decode step's, whole over the
    batch and the vocabulary on every rank."""
    Bs = SERVE[key][2]
    want = runs["served"][key][0]
    for r in runs["port"]:
        for i, got in enumerate(r[key]["logits"]):
            assert got.shape == (Bs, _cfg("moe").padded_vocab)
            _close(got, runs["js"][f"{key}.logits.{i}"],
                   f"call {i} against GSPMD")
            _close(got, want[i], f"call {i} against the port")


@pytest.mark.parametrize("when", ["prefill", "decode"])
@pytest.mark.parametrize("key", list(SERVE))
def test_serving_cache_shards_match_gspmd(runs, key, when):
    """Every rank's local cache leaf, after the prefill and after the last
    decode step, has its storage shard's shape and holds its slice of
    JAX's cache (``devices_indices_map``) and of the unsharded port's; the
    layout is the one the case exercises."""
    want_port = runs["served"][key][1 if when == "prefill" else 2]
    kind, layout = LAYOUTS[key]
    for r in runs["port"]:
        assert r[key]["layout"] == layout
        got = r[key][when]
        assert got.keys() == want_port.keys()
        for path, t in got.items():
            rows = runs["indices"][key][path][_rank_of(r[key]["coord"])]
            sl = tuple(slice(a, b) for a, b in rows)
            assert tuple(t.shape) == tuple(b - a for a, b in rows), path
            _close(t, runs["js"][f"{key}.{when}.{path}"][sl],
                   f"{path} vs GSPMD")
            _close(t, want_port[path][sl].numpy(), f"{path} vs the port")


def test_the_plan_reads_the_rules(runs):
    """Under rules that keep "heads", "ffn" and "vocab" off "model" the
    plan splits nothing, on (1, 2) as on any model axis, and each rank
    computes with every leaf whole (GSPMD computes a leaf whose logical
    axis is not on "model" gathered); the step is the unsharded one."""
    ranks = [r["rules"] for r in runs["port"] if "rules" in r]
    assert len(ranks) == 2
    z = runs["z"]
    for r in ranks:
        plan = r["plan"]
        assert not (plan.heads or plan.kv or plan.ffn or plan.vocab or
                    plan.shared), plan
        for n, got in r["compute"].items():
            assert torch.equal(got, torch.tensor(z[f"dense.{n}"])), n
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r["metrics"][k],
                                       runs["dense"][0][k], rtol=1e-6)
    for arch in ("deepseek-7b", "deepseek-moe-16b", "deepseek-v2-236b"):
        lm = LM(get_smoke_config(arch), device="meta")
        for rules, split in ((None, True), (GATHERED, False),
                             ({"heads": None}, "heads")):
            plan = lm.tp_plan(2, rules)
            if split == "heads":
                assert not plan.heads and plan.ffn and plan.vocab, plan
            else:
                assert plan.heads == plan.ffn == plan.vocab == split, plan
