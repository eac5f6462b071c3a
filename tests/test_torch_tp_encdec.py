"""Tensor-parallel compute over "model" for the encoder-decoder's mixers
(``partition.tp_plan``/``compute_axis`` with the ``enc`` and ``xdec``
mixers and the ``cross`` block, ``models/attention.py``'s self- and
cross-attention on this rank's heads, the encoder output taken into the
region once, ``optim/adamw.py``'s mesh step, and ``launch.specs.build_fn``'s
serving with the self and cross caches at their storage specs) on four
gloo processes, against the reference's GSPMD step and serving cells on
the same mesh and against the unsharded port.

Smoke seamless-m4t-large-v2 (4 heads, 4 kv heads, head dim 16, 2 encoder
and 2 decoder layers, 32 seeded frames; its MLPs and tied vocabulary split
beside the mixers) on meshes (1, 4) and (2, 2), and a GQA variant (8 q
heads, 2 kv heads: every ``wk``/``wv`` gathered, each rank projecting the
kv head its q heads read) on (1, 4):

* one train step against JAX's GSPMD step (``tests/jax_mesh_ref.py tp``):
  logits at rtol 1e-4 against the unsharded port, loss and ce against
  GSPMD at 1e-4, and the logits, grad_norm and ``m`` after the step held
  by a float64-witness rule: no farther (relative L2; for ``m`` leaf by
  leaf) from a float64 step's than W_MULT times the farther of the two
  float32 witnesses, the unsharded port and GSPMD, lies, plus 1e-4
  (``tests/test_torch_tp_moe.py``'s rule with ``chip_smoke.py``'s
  ``DIST_TP_M_MULT``). The random-init encoder runs its residual stream
  into the hundreds, and the same fp32 sums taken in another order land
  some 1e-4 to 1e-3 apart: GSPMD's logits lie up to 3.4e-4 from the
  unsharded port's where the largest is 0.76, its grad_norm 7.7e-4 from
  the float64 one and the unsharded port's 6.2e-4, the split step's
  7.8e-4 on (2, 2); on (1, 4) the split step's ``cross.wv`` gradient lies
  9.5e-4 from the float64 one where the witnesses' farther lies 8.4e-4.
  The float64 steps below hold the split to the unsharded step exactly;
* each rank's compute copy of every ``enc``, ``xdec`` and ``cross`` leaf
  exactly its slice by heads (``wk``/``wv`` whole in the GQA variant, and
  partial over "model"), and every other leaf its slice or the whole leaf;
* two AdamW steps of a float64 copy of the port (``tests/
  encdec_grad_norm.py``'s ``float64_port``) equal to its unsharded steps
  at 1e-10, and a control that must miss that: the cross-attention's
  all-reduce dropped;
* with "heads" kept off "model" both mixers and the cross-attention
  compute gathered (their compute copies whole) and the float64 steps
  equal the unsharded ones;
* serving cells on (2, 2) against JAX's (``tests/jax_mesh_ref.py serve``)
  and the unsharded port: a prefill over as many frames as the capacity
  and three decode steps, every call's logits and every rank's ``k``,
  ``v``, ``xk`` and ``xv`` shard after the prefill and after the last step
  at rtol 1e-4, each shard the slice ``devices_indices_map`` gives: at
  B = 2 the self cache's sequence over "model" (4 kv heads do not make a
  kv-head-rich cache) and the cross cache's heads over "model"; at B = 1
  the self cache's sequence over ("data", "model") and the cross cache's
  frames over "data", whose partial softmax the decode combines.

The port's ranks spawn once; the JAX side runs in two subprocesses that see
8 host devices each, beside them.
"""
import contextlib
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

from repro_torch.bridge import load_jax_numpy  # noqa: E402
from repro_torch.configs.base import (ShapeConfig,  # noqa: E402
                                      get_config, get_smoke_config)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models.layers import flatten_paths  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.elastic import remesh_state  # noqa: E402
from repro_torch.sharding import partition as part  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCH = "seamless-m4t-large-v2"
RTOL = 1e-4
F64_REL = 1e-10
W_MULT = 1.25          # the float32 distances' limit over the witnesses'
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S, FRAMES = 4, 32, 32
MODELS = {"seamless": {}, "gqa": {"num_heads": 8, "num_kv_heads": 2}}
CASES = [("seamless", (1, 4)), ("seamless", (2, 2)), ("gqa", (1, 4))]
BLOCKS = ("enc", "xdec", "cross")
GATHERED = {"heads": None}
SERVE_MESH = (2, 2)
CAP = 32               # the capacity, and the frames of a serving cell
STEPS = 3
# key: (global batch, prompt length)
SERVE = {"b2": (2, 20), "b1": (1, 12)}
# the layout (batch, seq, heads) of each case's self and cross caches
LAYOUTS = {"b2": {"xdec": (("data",), ("model",), ()),
                  "cross": (("data",), (), ("model",))},
           "b1": {"xdec": ((), ("data", "model"), ()),
                  "cross": ((), ("data",), ("model",))}}


def _cfg(model, smoke=get_smoke_config):
    return smoke(ARCH).replace(**MODELS[model])


def _lm(z, pre, model="seamless"):
    lm = LM(_cfg(model), device="cpu")
    load_jax_numpy(lm, {k[len(pre) + 1:]: v for k, v in z.items()
                        if k.startswith(f"{pre}.")})
    return lm


def _batch(z, i=0):
    sfx = "2" if i else ""
    return {"tokens": torch.from_numpy(z[f"tokens{sfx}"]).long(),
            "frames": torch.from_numpy(z[f"frames{sfx}"])}


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


@contextlib.contextmanager
def _cross_unsummed():
    """The float64 port's cross-attention with its output left unsummed
    over "model": each rank's share of ``wo`` taken as the whole (its
    backward is the identity either way)."""
    A = importlib.import_module(f"{F64}.models.attention")
    real_fwd, real_tp = A.xattn_forward, A.TP
    shim = types.SimpleNamespace(copy_to=real_tp.copy_to,
                                 reduce_from=lambda y, tp: y)

    def unsummed(*a, **kw):
        A.TP = shim
        try:
            return real_fwd(*a, **kw)
        finally:
            A.TP = real_tp
    A.xattn_forward = unsummed
    try:
        yield
    finally:
        A.xattn_forward = real_fwd


def _steps64(model, weights, batches, mesh_shape=None, rules=None,
             control=False):
    """Two AdamW steps of the float64 port's ``model`` from ``weights``, on
    ``mesh_shape`` under ``rules``, with the cross-attention's all-reduce
    dropped under ``control``. -> (metrics per step, params, ``m`` after
    step 1, step 1's logits: this rank's), whole tensors."""
    mod = {k: importlib.import_module(f"{F64}.{k}") for k in (
        "configs.base", "models.model", "optim.adamw",
        "sharding.partition", "launch.mesh", "runtime.elastic")}
    opt_mod, prt = mod["optim.adamw"], mod["sharding.partition"]
    cfg = _cfg(model, smoke=mod["configs.base"].get_smoke_config).replace(
        dtype="float64")
    lm = mod["models.model"].LM(cfg, device="cpu")
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(torch.from_numpy(weights[n]))
    logits, forward = [], lm.forward

    def recording_forward(*a, **kw):
        out = forward(*a, **kw)
        logits.append(out[0].detach().clone())
        return out
    lm.forward = recording_forward
    mesh = mod["launch.mesh"].make_mesh(mesh_shape, ("data", "model"),
                                        device="cpu") if mesh_shape else None
    state = opt_mod.init_state(lm)
    whole = (lambda t: t.full_tensor()) if mesh else (lambda t: t)
    mets = []
    with (prt.activate(mesh, rules) if mesh else contextlib.nullcontext()), \
            (_cross_unsummed() if control else contextlib.nullcontext()):
        if mesh:
            state = mod["runtime.elastic"].remesh_state(
                state, opt_mod.state_logical(lm), None, mesh)
        step = opt_mod.make_train_step(lm, opt_mod.OptConfig(**OPT))
        for i, (tok, frames) in enumerate(batches):
            state, m = step(state, {"tokens": torch.from_numpy(tok).long(),
                                    "frames": torch.from_numpy(frames)
                                    .double()})
            mets.append({k: float(v) for k, v in m.items()})
            if i == 0:
                m1 = {n: whole(t).detach().clone()
                      for n, t in state["m"].items()}
        params = {n: whole(t).detach().clone()
                  for n, t in state["params"].items()}
    return mets, params, m1, logits[0]


def _serve(lm, z, key, mesh=None):
    """The prefill and STEPS decode steps -> (logits per call, the cache
    after the prefill and after the last step, each leaf by path: this
    rank's local shard on a mesh)."""
    batch = {"tokens": torch.from_numpy(z[f"{key}.tokens"]).long(),
             "frames": torch.from_numpy(z[f"{key}.frames"])}
    dec = torch.from_numpy(z[f"{key}.dec"]).long()

    def flat(cache):
        return {k: (v.to_local() if mesh is not None else v).clone()
                for k, v in flatten_paths(cache)}
    if mesh is None:
        cache, lg = lm.prefill(batch, CAP)
        step, whole = lm.decode_step, (lambda t: t)
    else:
        Bs = batch["tokens"].shape[0]
        sp = dict(specs.input_specs(lm.cfg, ShapeConfig(
            "p", CAP, Bs, "prefill"), mesh), lm=lm)
        sd = dict(specs.input_specs(lm.cfg, ShapeConfig(
            "d", CAP, Bs, "decode"), mesh), lm=lm)
        params = {n: specs._placed(p.detach(), sp["in_shardings"][0][n])
                  for n, p in lm.named_parameters()}
        cache, lg = specs.build_fn(sp)(params, batch)
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
    control and the rules case on (1, 4), then the serving cells on
    (2, 2). Every rank returns its local readings; rank 0 also the whole
    ``m`` (gathered on every rank, as the collective needs)."""
    sys.path.insert(0, f64_dir)
    z = dict(np.load(os.path.join(d, "in.npz")))
    weights = {m: {k[len(m) + 1:]: v for k, v in z.items()
                   if k.startswith(f"{m}.")} for m in MODELS}
    batches = [(z["tokens"], z["frames"]), (z["tokens2"], z["frames2"])]
    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in dict.fromkeys(s for _, s in CASES)}
    out = {}
    for model, shape in CASES:
        mesh = meshes[shape]
        lm = _lm(z, model, model)
        mets, logits, compute, state = _step(lm, z, mesh)
        full = {n: t.full_tensor() for n, t in state["m"].items()}
        out[model, shape] = dict(
            metrics=mets, coord=tuple(mesh.get_coordinate()),
            plan=adamw.tp_plan(lm, mesh), logits=logits, compute=compute,
            m=full if rank == 0 else None,
            f64=_steps64(model, weights[model], batches, shape))
    out["control"] = _steps64("seamless", weights["seamless"], batches,
                              (1, 4), control=True)
    mesh = meshes[(1, 4)]
    lm = _lm(z, "seamless")
    ran = _step(lm, z, mesh, GATHERED)
    with part.activate(mesh, GATHERED):
        plan = adamw.tp_plan(lm, mesh)
    out["rules"] = dict(metrics=ran[0], compute=ran[2], plan=plan,
                        f64=_steps64("seamless", weights["seamless"],
                                     batches, (1, 4), GATHERED))
    mesh = make_mesh(SERVE_MESH, ("data", "model"), device="cpu")
    for key, (Bs, _) in SERVE.items():
        lm = _lm(z, f"{key}.p")
        with part.activate(mesh):
            logits, prefilled, decoded = _serve(lm, z, key, mesh)
            layouts = lm.cache_layouts(mesh, Bs, CAP)
        out[key] = dict(coord=tuple(mesh.get_coordinate()), logits=logits,
                        prefill=prefilled, decode=decoded,
                        layouts={k: tuple(v) for k, v in layouts.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights of each model (``LM.init``), the batches,
    frames and prompts from numpy seeds; the JAX side in two subprocesses
    beside the port's four ranks; the unsharded port in float32 and
    float64."""
    import jax
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    d = tmp_path_factory.mktemp("tp_encdec")
    rs = np.random.RandomState(0)
    z = {"opt": np.array(json.dumps(OPT))}
    for sfx in ("", "2"):
        z[f"tokens{sfx}"] = rs.randint(0, 512, (B, S)).astype(np.int32)
        z[f"frames{sfx}"] = (rs.randn(B, FRAMES, 64) * 0.02).astype(
            np.float32)

    def weights(pre, over, key):
        params = JaxLM(jsmoke(ARCH).replace(**over)).init(
            jax.random.PRNGKey(key))
        for path, v in flatten_paths(jax.tree.map(np.asarray, params)):
            z[f"{pre}.{path}"] = v
    for i, (m, over) in enumerate(MODELS.items()):
        weights(m, over, i)
    for i, (key, (Bs, Ss)) in enumerate(SERVE.items()):
        weights(f"{key}.p", {}, 2 + i)
        z[f"{key}.tokens"] = rs.randint(0, 512, (Bs, Ss)).astype(np.int32)
        z[f"{key}.frames"] = (rs.randn(Bs, CAP, 64) * 0.02).astype(
            np.float32)
        z[f"{key}.dec"] = rs.randint(0, 512, (Bs, STEPS)).astype(np.int32)
    np.savez(d / "in.npz", **z)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    for job, cases in (
            ("tp", [[m, ARCH, MODELS[m], list(s), i]
                    for i, (m, s) in enumerate(CASES)]),
            ("serve", [[key, ARCH, {}, list(SERVE_MESH), Bs, CAP]
                       for key, (Bs, _) in SERVE.items()])):
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
        weights64 = {m: {k[len(m) + 1:]: v for k, v in z.items()
                         if k.startswith(f"{m}.")} for m in MODELS}
        batches = [(z["tokens"], z["frames"]), (z["tokens2"], z["frames2"])]
        unsharded = {m: _step(_lm(z, m, m), z) for m in MODELS}
        unsharded64 = {m: _steps64(m, weights64[m], batches)
                       for m in MODELS}
        served = {key: _serve(_lm(z, f"{key}.p"), z, key) for key in SERVE}
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
    return "{}-{}x{}".format(c[0], *c[1])


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
    """Logits against the unsharded port; loss and ce equal on every rank
    and against GSPMD; the logits, grad_norm, and ``m`` after the step
    leaf by leaf, no farther from the float64 step's than W_MULT times
    the unsharded port's or GSPMD's distance, plus 1e-4 (the module's
    docstring)."""
    port, jx = runs["port"], runs["jx"]
    i = CASES.index(case)
    got = _full_logits(port, case).numpy()
    assert got.shape == (B, S, _cfg(case[0]).padded_vocab)
    want = runs["unsharded"][case[0]]
    _close(got, want[1].numpy(), "logits against the port")
    exact64 = runs["unsharded64"][case[0]]
    lg64 = exact64[3].numpy()
    witness = max(_rel_l2(want[1].numpy(), lg64),
                  _rel_l2(jx[f"{i}.logits"], lg64))
    assert _rel_l2(got, lg64) <= W_MULT * witness + RTOL, witness
    mets = port[0][case]["metrics"]
    assert all(r[case]["metrics"] == mets for r in port)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(mets[k], float(jx[f"{i}.{k}"]),
                                   rtol=RTOL, err_msg=k)
    gn64 = exact64[0][0]["grad_norm"]

    def gn_rel(v):
        return abs(v - gn64) / gn64
    gn_witness = max(gn_rel(want[0]["grad_norm"]),
                     gn_rel(float(jx[f"{i}.grad_norm"])))
    assert gn_rel(mets["grad_norm"]) <= W_MULT * gn_witness + RTOL, \
        gn_witness
    m = port[0][case]["m"]
    unsharded_m = want[3]["m"]
    exact = exact64[2]
    assert m.keys() == unsharded_m.keys() == exact.keys()
    for n, t in m.items():
        f64 = exact[n].numpy()
        witness = max(_rel_l2(unsharded_m[n].detach().numpy(), f64),
                      _rel_l2(jx[f"{i}.m.{n}"], f64))
        assert _rel_l2(t.numpy(), f64) <= W_MULT * witness + RTOL, \
            (n, witness)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_compute_copies_are_the_ranks_slices(runs, case):
    """Each rank computed with exactly its heads' slice of every ``enc``,
    ``xdec`` and ``cross`` leaf that splits (wq and wo, and wk and wv where
    the kv heads divide the axis), its ffn and vocabulary slices as
    before, and every other leaf whole; in the GQA variant the gathered
    wk/wv of all three blocks are partial over "model"."""
    z, port = runs["z"], runs["port"]
    model, shape = case
    lm = LM(_cfg(model), device="meta")
    blocks, logical = lm.leaf_blocks(), adamw.state_logical(lm)["params"]
    plan = port[0][case]["plan"]
    assert plan == lm.tp_plan(shape[1])
    assert plan.heads and plan.vocab and plan.ffn
    assert plan.kv == (model == "seamless")
    split = dict.fromkeys(BLOCKS, 0)
    for r in port:
        mi = r[case]["coord"][1]
        for n, got in r[case]["compute"].items():
            full = torch.tensor(z[f"{model}.{n}"])
            block, leaf = blocks.get(n), n.rsplit(".", 1)[-1]
            ax = part.compute_axis(plan, block, leaf)
            if block in BLOCKS:
                assert ax == ("heads" if leaf in ("wq", "wo") or plan.kv
                              else None), (n, ax)
                assert part.partial_over_model(plan, block, leaf) == (
                    ax is None), n
            if ax is not None:
                dim = logical[n].index(ax)
                k = full.shape[dim] // shape[1]
                full = full.narrow(dim, mi * k, k)
                if block in BLOCKS:
                    split[block] += 1
            assert torch.equal(got, full), (n, r[case]["coord"])
    # wq, wo (and wk, wv) of each stack's blocks, on every rank
    per = {b: sum(blocks.get(n) == b for n in logical) for b in BLOCKS}
    assert per == dict.fromkeys(BLOCKS, 4), per
    assert split == {b: (4 if plan.kv else 2) * len(port) for b in BLOCKS}, \
        split


def _f64_distance(got, want):
    """Largest relative distance of loss and grad_norm over the steps, the
    worst leaf's relative L2 of ``m`` after step 1, the params' largest
    absolute difference."""
    (gm, gp, g1, _), (wm, wp, w1, _) = got, want

    def rel(a, b):
        return abs(a - b) / abs(b)
    return max(
        max(rel(a[k], b[k]) for a, b in zip(gm, wm)
            for k in ("loss", "grad_norm")),
        max(_rel_l2(g1[n].numpy(), w1[n].numpy()) for n in w1),
        max(float((gp[n] - wp[n]).abs().max()) for n in wp))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_steps_are_exact_in_float64(runs, case):
    """In float64 the mesh's two steps equal the unsharded float64 steps to
    F64_REL: loss and grad_norm at both steps, ``m`` after step 1 leaf by
    leaf, every param; every rank alike."""
    port = runs["port"]
    got = port[0][case]["f64"]
    assert all(r[case]["f64"][0] == got[0] for r in port)
    assert _f64_distance(got, runs["unsharded64"][case[0]]) <= F64_REL


def test_the_control_misses_the_float64_limit(runs):
    """The cross-attention's output left unsummed over "model" (each
    rank's share of ``wo`` taken as the whole): the float64 steps on
    (1, 4) miss F64_REL by far."""
    got = runs["port"][0]["control"]
    assert _f64_distance(got, runs["unsharded64"]["seamless"]) > \
        1e3 * F64_REL


def test_with_heads_off_model_the_mixers_compute_gathered(runs):
    """Under rules that keep "heads" off "model" no mixer splits (the MLPs
    and the vocabulary still do): every ``enc``, ``xdec`` and ``cross``
    compute copy is the whole leaf, the float32 step's loss is the
    unsharded one's, and the float64 steps equal the unsharded ones."""
    z = runs["z"]
    blocks = LM(_cfg("seamless"), device="meta").leaf_blocks()
    want = runs["unsharded"]["seamless"][0]
    for r in runs["port"]:
        got = r["rules"]
        plan = got["plan"]
        assert not plan.heads and plan.ffn and plan.vocab, plan
        n_mixer = 0
        for n, t in got["compute"].items():
            if blocks.get(n) in BLOCKS:
                assert torch.equal(t, torch.tensor(z[f"seamless.{n}"])), n
                n_mixer += 1
        assert n_mixer == sum(b in BLOCKS for b in blocks.values()) > 0
        np.testing.assert_allclose(got["metrics"]["loss"], want["loss"],
                                   rtol=RTOL)
        assert _f64_distance(got["f64"], runs["unsharded64"]["seamless"]) \
            <= F64_REL


def _rank_of(coord):
    return coord[0] * SERVE_MESH[1] + coord[1]


@pytest.mark.parametrize("key", list(SERVE))
def test_serving_logits_match_gspmd_and_the_unsharded_port(runs, key):
    """The prefill's last logits and each decode step's, whole over the
    batch and the vocabulary on every rank."""
    Bs = SERVE[key][0]
    want = runs["served"][key][0]
    for r in runs["port"]:
        for i, got in enumerate(r[key]["logits"]):
            assert got.shape == (Bs, _cfg("seamless").padded_vocab)
            _close(got, runs["js"][f"{key}.logits.{i}"],
                   f"call {i} against GSPMD")
            _close(got, want[i], f"call {i} against the port")


@pytest.mark.parametrize("when", ["prefill", "decode"])
@pytest.mark.parametrize("key", list(SERVE))
def test_serving_cache_shards_match_gspmd(runs, key, when):
    """Every rank's local cache leaf (``k``, ``v``, ``xk``, ``xv`` of each
    decoder layer), after the prefill and after the last decode step, has
    its storage shard's shape and holds its slice of JAX's cache
    (``devices_indices_map``) and of the unsharded port's; the self and
    cross caches' layouts are the ones the case exercises."""
    want_port = runs["served"][key][1 if when == "prefill" else 2]
    for r in runs["port"]:
        assert r[key]["layouts"] == LAYOUTS[key]
        got = r[key][when]
        assert got.keys() == want_port.keys()
        assert {p.rsplit(".", 1)[-1] for p in got} == \
            {"lengths", "k", "v", "xk", "xv"}
        for path, t in got.items():
            rows = runs["indices"][key][path][_rank_of(r[key]["coord"])]
            sl = tuple(slice(a, b) for a, b in rows)
            assert tuple(t.shape) == tuple(b - a for a, b in rows), path
            _close(t, runs["js"][f"{key}.{when}.{path}"][sl],
                   f"{path} vs GSPMD")
            _close(t, want_port[path][sl].numpy(), f"{path} vs the port")


@pytest.mark.parametrize("model,tp,want", [
    ("seamless", 4, (True, True, True, True)),
    ("seamless", 8, (False, False, True, True)),   # 4 heads
    ("gqa", 4, (True, False, True, True)),         # 2 kv heads
])
def test_the_plan_splits_the_encdec_mixers_in_whole_units(model, tp, want):
    """``LM.tp_plan`` of the smoke configs: the ``enc``, ``xdec`` and
    ``cross`` blocks by heads where the heads divide the axis, their
    wk/wv where the kv heads do."""
    plan = LM(_cfg(model), device="meta").tp_plan(tp)
    assert (plan.heads, plan.kv, plan.ffn, plan.vocab) == want, plan


def test_the_full_config_splits_on_sixteen_ranks():
    """At full width on a model axis of 16 (the production meshes'):
    seamless-m4t-large-v2's 16 heads and 16 kv heads, 8192 ffn columns and
    its tied vocabulary split; its cache layouts for ``decode_32k``'s
    cell on 16 x 16 put both caches' heads over "model" (16 kv heads make
    a kv-head-rich self cache); with "heads" off "model" no mixer
    splits."""
    lm = LM(get_config(ARCH), device="meta")
    plan = lm.tp_plan(16)
    assert (plan.heads, plan.kv, plan.ffn, plan.vocab) == (True,) * 4, plan
    assert not lm.tp_plan(16, GATHERED).heads
    cfg = get_config(ARCH).replace(frontend_tokens=32768)
    lm = LM(cfg, device="meta")
    mesh = part.AbstractMesh((16, 16), ("data", "model"))
    lay = lm.cache_layouts(mesh, 128, 32768)
    assert lay["cross"] == (("data",), (), ("model",)), lay
    assert lay["xdec"] == (("data",), (), ("model",)), lay
