"""Tensor-parallel compute over "model" in the port's train step
(``sharding/tp.py``, ``partition.tp_plan``/``compute_axis``, the split
blocks of ``models/{attention,layers,model}.py`` and ``optim/adamw.py``'s
mesh step) on four gloo processes, against the unsharded port and
against the reference's GSPMD step on the same mesh.

Smoke configs of deepseek-7b (MHA, untied), gemma-7b (GeGLU, tied,
scaled embeddings), stablelm-1.6b (LayerNorm, partial RoPE) and gemma3-1b
(MQA, ``qk_norm``, window, tied: its one kv head is gathered), and a GQA
variant of deepseek-7b (8 q heads, 2 kv heads: on a model axis of 4 two
ranks read each kv head, sliced from the gathered wk/wv), on meshes
(1, 4) and (2, 2); seamless-m4t on (1, 4), whose encoder, decoder and
cross-attention mixers split by heads beside split dense MLPs and
vocabulary, against the unsharded port alone (the encoder-decoder's
split against GSPMD is ``tests/test_torch_tp_encdec.py``'s, the scan
mixers' ``tests/test_torch_tp_scan.py``'s). Each case's
logits, loss, every gradient and one AdamW step at the rtol 1e-4 of
``tests/test_torch_train.py`` (elements near 0 at 1e-4 of the leaf's
largest; params within 2 lr), and each rank's compute copy of every leaf
exactly its slice (split) or the whole leaf (gathered).

Against GSPMD's step the gradients come from its ``m`` after the step,
(1 - b1) times each leaf's clipped gradient, unscaled by its
``grad_norm``. The same fp32 math summed in other orders lands about 1e-4
apart on deepseek-7b's smoke embed and wk (their RMSNorm over the
0.02-scaled embeddings scales the gradient by some 50), GSPMD's against
the unsharded port's too. So each leaf of the split step is held no
farther from GSPMD's (relative L2) than the unsharded port's lies (the
witness, computed here), plus 1e-4; the elementwise limits hold it to
the unsharded port.
The JAX side runs in two subprocesses that see 8 host devices each
(``tests/jax_mesh_ref.py tp``, half the cases each), beside the port's four
ranks (one spawn).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import remesh_state
from repro_torch.sharding import partition as part
from repro_torch.sharding import tp as TP

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-4            # as tests/test_torch_train.py
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 4, 48           # gemma3-1b's smoke window, 32, binds
MODELS = {"deepseek-7b": ("deepseek-7b", {}),
          "gemma-7b": ("gemma-7b", {}),
          "stablelm-1.6b": ("stablelm-1.6b", {}),
          "gemma3-1b": ("gemma3-1b", {}),
          "gqa": ("deepseek-7b", {"num_heads": 8, "num_kv_heads": 2}),
          "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {})}
MESHES = ((1, 4), (2, 2))
CASES = [(m, s) for m in list(MODELS)[:4] for s in MESHES] + \
    [("gqa", (1, 4))]
# the encoder-decoder's mixers split by heads beside split dense MLPs and
# vocabulary (enc, xdec and cross over 32 seeded frames): against the
# unsharded port
MIXED = [("seamless-m4t-large-v2", (1, 4))]


def _cfg(model):
    arch, over = MODELS[model]
    return get_smoke_config(arch).replace(**over)


def _lm(z, model):
    lm = LM(_cfg(model), device="cpu")
    pre = f"{model}."
    load_jax_numpy(lm, {k[len(pre):]: v for k, v in z.items()
                        if k.startswith(pre)})
    return lm


def _step(lm, z, mesh=None):
    """One AdamW step of ``lm`` on the batch, on ``mesh`` from the state
    placed by ``remesh_state``, recording what the step computed with:
    the logits ``lm.forward`` returned, every leaf's compute copy when the
    loss ran, and the gradients ``apply_updates`` was handed. -> (metrics,
    logits, compute copies, gradients, state)."""
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

    def recording_updates(cfg, state, grads, generator=None):
        rec["grads"] = dict(grads)
        return apply(cfg, state, grads, generator)

    lm.forward, lm.loss = recording_forward, recording_loss
    apply, adamw.apply_updates = adamw.apply_updates, recording_updates
    try:
        state = adamw.init_state(lm)
        batch = {"tokens": torch.from_numpy(z["tokens"]).long()}
        if lm.cfg.encoder_layers:
            batch["frames"] = torch.from_numpy(z["frames"])
        if mesh is None:
            state, m = adamw.make_train_step(lm, adamw.OptConfig(**OPT))(
                state, batch)
        else:
            with part.activate(mesh):
                state = remesh_state(state, adamw.state_logical(lm), None,
                                     mesh)
                state, m = adamw.make_train_step(
                    lm, adamw.OptConfig(**OPT))(state, batch)
    finally:
        adamw.apply_updates = apply
    return ({k: float(v) for k, v in m.items()}, rec["logits"],
            rec["compute"], rec["grads"], state)


def _tp_rank(rank, world, d):
    """One of four ranks: each case's step on its mesh. Returns per case
    the metrics, this rank's mesh coordinate, its logits and compute
    copies (local), and on rank 0 the gradients, the updated params and
    ``m``, gathered whole (on every rank, as the collective needs)."""
    from torch.distributed.tensor import DTensor
    z = dict(np.load(os.path.join(d, "in.npz")))
    meshes = {s: make_mesh(s, ("data", "model"), device="cpu")
              for s in MESHES}
    out = {}
    for model, shape in CASES + MIXED:
        mesh = meshes[shape]
        lm = _lm(z, model)
        mets, logits, compute, grads, state = _step(lm, z, mesh)
        whole = {}
        for n, g in grads.items():
            dt = state["params"][n]
            whole[n] = DTensor.from_local(g, mesh, dt.placements,
                                          run_check=False).full_tensor()
        full = {k: {n: t.full_tensor() for n, t in state[k].items()}
                for k in ("params", "m")}
        out[model, shape] = dict(
            metrics=mets, coord=tuple(mesh.get_coordinate()),
            plan=adamw.tp_plan(lm, mesh), logits=logits, compute=compute,
            **{k: v if rank == 0 else None for k, v in
               dict(full, grads=whole).items()})
    # a bf16 all-reduce of 1 and three 2^-8: 1.015625 summed in fp32 and
    # rounded once; 1.0 or 1.0078125 summed in bf16
    x = torch.full((4,), 2.0 ** -8, dtype=torch.bfloat16)
    if rank == 0:
        x.fill_(1.0)
    out["bf16_sum"] = TP._all_reduce(
        x, meshes[(1, 4)].get_group("model")).float().tolist()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The weights of each model (the reference's ``LM.init``), one batch,
    the JAX GSPMD side in a subprocess beside the port's four ranks, and
    the unsharded port's step on each model."""
    import jax
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    d = tmp_path_factory.mktemp("tp")
    rs = np.random.RandomState(0)
    z = {"tokens": rs.randint(0, 512, (B, S)).astype(np.int32),
         "frames": (rs.randn(B, 32, 64) * 0.02).astype(np.float32),
         "opt": np.array(json.dumps(OPT))}
    for model, (arch, over) in MODELS.items():
        jlm = JaxLM(jsmoke(arch).replace(**over))
        params = jlm.init(jax.random.PRNGKey(1))
        for path, v in flatten_paths(jax.tree.map(np.asarray, params)):
            z[f"{model}.{path}"] = v
    np.savez(d / "in.npz", **z)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = []
    for half in range(2):
        dj = d / f"jax{half}"
        dj.mkdir()
        os.symlink(d / "in.npz", dj / "in.npz")
        with open(dj / "cases.json", "w") as f:
            json.dump([[m, *MODELS[m], list(s), i] for i, (m, s)
                       in enumerate(CASES) if i % 2 == half], f)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "jax_mesh_ref.py"), "tp",
             str(dj)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        port = run_ranks(_tp_rank, 4, (str(d),), timeout_s=240,
                         device="cpu", workdir=str(d))
        unsharded = {m: _step(_lm(z, m), z) for m in MODELS}
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    jx = {}
    for half, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, err
        jx.update(np.load(d / f"jax{half}" / "out.npz"))
    return z, port, unsharded, jx


def _close(got, want, what):
    """rtol 1e-4, elements near 0 at 1e-4 of the largest."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case_id(c):
    return "{}-{}x{}".format(c[0], *c[1])


def _full_logits(port, case):
    """The logits over the whole batch and vocabulary from the ranks'
    local ones: rank (d, m) holds batch slice d and, with the vocabulary
    split, vocabulary slice m."""
    shape = case[1]
    rows = [[None] * shape[1] for _ in range(shape[0])]
    for r in port:
        dd, mm = r[case]["coord"]
        rows[dd][mm] = r[case]["logits"]
    split = port[0][case]["plan"].vocab
    if not split:
        for row in rows:
            assert all(torch.equal(t, row[0]) for t in row)
    return torch.cat([torch.cat(row, -1) if split else row[0]
                      for row in rows], 0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_logits_match_the_unsharded_port_and_gspmd(runs, case):
    z, port, unsharded, jx = runs
    i = CASES.index(case)
    got = _full_logits(port, case).numpy()
    assert got.shape == (B, S, _cfg(case[0]).padded_vocab)
    _close(got, unsharded[case[0]][1].numpy(), "logits against the port")
    _close(got, jx[f"{i}.logits"], "logits against GSPMD")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_loss_and_every_gradient_match(runs, case):
    """The loss equal on every rank; it, grad_norm and every gradient leaf
    (a split leaf's shards, the partial ``q_norm``/``k_norm`` and gathered
    wk/wv summed over "model", the norms ahead of split blocks not summed)
    against the unsharded port's and GSPMD's (its ``m`` unscaled, held by
    relative L2 beside the unsharded port's distance: the module's
    docstring)."""
    z, port, unsharded, jx = runs
    i = CASES.index(case)
    mets = port[0][case]["metrics"]
    assert all(r[case]["metrics"] == mets for r in port)
    want = unsharded[case[0]]
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(mets[k], want[0][k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(mets["loss"], float(jx[f"{i}.loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(mets["grad_norm"],
                               float(jx[f"{i}.grad_norm"]), rtol=RTOL)
    grads = port[0][case]["grads"]
    assert grads.keys() == want[3].keys()
    b1 = adamw.OptConfig(**OPT).b1
    clip = adamw.OptConfig(**OPT).clip_norm
    unclip = max(float(jx[f"{i}.grad_norm"]) / clip, 1.0) / (1 - b1)
    for n, g in grads.items():
        _close(g.numpy(), want[3][n].numpy(), n)
        gspmd = jx[f"{i}.m.{n}"] * unclip
        witness = _rel_l2(want[3][n].numpy(), gspmd)
        assert _rel_l2(g.numpy(), gspmd) <= witness + RTOL, (n, witness)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_adamw_step_matches(runs, case):
    """The updated params within 2 lr of the unsharded port's and JAX's,
    and the step's lr equal."""
    z, port, unsharded, jx = runs
    i = CASES.index(case)
    lr = unsharded[case[0]][0]["lr"]
    np.testing.assert_allclose(port[0][case]["metrics"]["lr"], lr,
                               rtol=RTOL)
    want = unsharded[case[0]][4]["params"]
    for n, t in port[0][case]["params"].items():
        np.testing.assert_allclose(t.numpy(), want[n].detach().numpy(),
                                   atol=2 * lr, rtol=0, err_msg=n)
        np.testing.assert_allclose(t.numpy(), jx[f"{i}.params.{n}"],
                                   atol=2 * lr, rtol=0, err_msg=n)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_compute_copies_are_the_ranks_slices(runs, case):
    """Each rank computed with exactly its heads' (wq/wo, and wk/wv where
    the kv heads split), ffn columns' or rows' (wi*, the MLP's wo) and
    vocabulary rows' (embed, head) slice of the initial weights, and with
    every other leaf whole."""
    z, port, _, _ = runs
    model, shape = case
    lm = LM(_cfg(model), device="meta")
    blocks, logical = lm.leaf_blocks(), adamw.state_logical(lm)["params"]
    plan = port[0][case]["plan"]
    assert plan == lm.tp_plan(shape[1])
    n_split = 0
    for r in port:
        m = r[case]["coord"][1]
        for n, got in r[case]["compute"].items():
            full = torch.tensor(z[f"{model}.{n}"])
            ax = part.compute_axis(plan, blocks.get(n), n.rsplit(".", 1)[-1])
            if ax is not None:
                dim = logical[n].index(ax)
                k = full.shape[dim] // shape[1]
                full = full.narrow(dim, m * k, k)
                n_split += 1
            assert torch.equal(got, full), (n, r[case]["coord"])
    # wq, wo, the MLP's two or three and the vocabulary table(s) at least
    assert n_split >= 4 * len(port)


@pytest.mark.parametrize("case", MIXED, ids=_case_id)
def test_split_mixers_beside_split_mlps(runs, case):
    """seamless-m4t (encoder and decoder-with-cross-attention layers): the
    ``enc``, ``xdec`` and ``cross`` blocks split by heads (and kv heads)
    beside the split dense MLPs and vocabulary; loss, grad_norm and the
    step's params against the unsharded port. Its random-init encoder
    runs its residual stream into the hundreds and carries another
    summation order's last bits past a gradient limit of 1e-4 (its
    encoder wv at 1.1e-4), so its step is held by loss, grad_norm and
    params, as ``tests/test_torch_archs.py`` holds it (and leaf by leaf
    against a float64 step by ``tests/test_torch_tp_encdec.py``)."""
    z, port, unsharded, _ = runs
    model = case[0]
    plan = port[0][case]["plan"]
    assert plan.heads and plan.kv and plan.ffn and plan.vocab, plan
    mets, want = port[0][case]["metrics"], unsharded[model]
    assert all(r[case]["metrics"] == mets for r in port)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(mets[k], want[0][k], rtol=RTOL, err_msg=k)
    for n, t in port[0][case]["params"].items():
        np.testing.assert_allclose(t.numpy(), want[4]["params"][n].detach()
                                   .numpy(), atol=2 * want[0]["lr"], rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("model,tp,want", [
    ("deepseek-7b", 4, (True, True, True, True)),
    ("deepseek-7b", 8, (False, False, True, True)),   # 4 heads, d_ff 160
    ("gemma3-1b", 4, (True, False, True, True)),      # one kv head
    ("gqa", 4, (True, False, True, True)),            # 2 kv heads
    ("gqa", 2, (True, True, True, True)),
    ("mamba2-2.7b", 4, (False, False, False, True)),    # ssm by heads
    ("deepseek-moe-16b", 4, (True, True, True, True)),   # beside EP
    ("seamless-m4t-large-v2", 4, (True, True, True, True)),
])
def test_the_plan_splits_whole_units(model, tp, want):
    """``LM.tp_plan``: heads, kv heads, ffn and vocabulary split only where
    their unit divides the axis, and only in the slice's blocks (mamba2-2.7b
    splits its vocabulary beside its ``ssm`` blocks, which split by SSD
    heads)."""
    cfg = _cfg(model) if model in MODELS else get_smoke_config(model)
    plan = LM(cfg, device="meta").tp_plan(tp)
    assert (plan.heads, plan.kv, plan.ffn, plan.vocab) == want


def test_seamless_splits_its_mixers_on_sixteen_ranks():
    """seamless-m4t-large-v2 at full width on a model axis of 16: its 16
    heads and 16 kv heads (the ``enc``, ``xdec`` and ``cross`` blocks),
    8192 ffn columns and tied vocabulary split."""
    plan = LM(get_config("seamless-m4t-large-v2"), device="meta").tp_plan(16)
    assert (plan.heads, plan.kv, plan.ffn, plan.vocab) == (True,) * 4, plan


@pytest.mark.parametrize("H,Kh,tp", [(8, 2, 4), (12, 3, 2), (12, 3, 4),
                                     (4, 1, 4), (8, 8, 4)])
def test_local_heads_read_their_kv_heads(H, Kh, tp):
    """``attention._qkv`` on each rank's heads: its q heads are global
    heads ``r*H/tp ...``, and the kv head each reads (kv heads split or
    sliced from the gathered wk/wv, expanded per q head where the groups
    do not pair evenly: H 12, Kh 3 on 2 or 4 ranks) is the one the whole
    projection gives global head ``h``: ``h // (H/Kh)``."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import init_params
    cfg = get_smoke_config("deepseek-7b").replace(num_heads=H,
                                                  num_kv_heads=Kh)
    hd, Hl, G = cfg.head_dim, H // tp, H // Kh
    p = init_params(A.attn_def(cfg), torch.Generator().manual_seed(0),
                    torch.float32, "cpu")
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(8)[None]
    q, k, v = A._qkv(cfg, p, x, pos)
    plan = part.tp_plan(cfg, ["attn"], 0, tp)
    assert plan.heads and plan.kv == (Kh % tp == 0)
    for r in range(tp):
        local = dict(p, wq=p["wq"][:, r * Hl * hd:(r + 1) * Hl * hd])
        if plan.kv:
            n = Kh // tp * hd
            local.update(wk=p["wk"][:, r * n:(r + 1) * n],
                         wv=p["wv"][:, r * n:(r + 1) * n])
        ql, kl, vl = A._qkv(cfg, local, x, pos,
                            tp=TP.Region(None, r, tp, plan))
        heads = list(range(r * Hl, (r + 1) * Hl))
        kv = [h // G for h in heads]
        torch.testing.assert_close(ql, q[:, :, heads], rtol=1e-6, atol=1e-6)
        for got, whole in ((kl, k), (vl, v)):
            per_q = got.repeat_interleave(Hl // got.shape[2], 2)
            torch.testing.assert_close(per_q, whole[:, :, kv], rtol=1e-6,
                                       atol=1e-6)


def test_storage_shards_are_not_compute_shards():
    """gemma3-1b at full width on (4, 4): ``resolve`` splits wk's 256
    columns (one kv head) four ways, since it checks the flattened dim;
    the compute plan gathers it (a head is not split), and ``q_norm``,
    ``k_norm`` and the gathered wk/wv are partial over "model"."""
    cfg = get_config("gemma3-1b")
    lm = LM(cfg, device="meta")
    mesh = part.AbstractMesh((4, 4), ("data", "model"))
    assert part.resolve(("embed", "heads"), (cfg.d_model, cfg.kv_dim),
                        mesh) == part.P("data", "model")
    plan = lm.tp_plan(4)
    assert (plan.heads, plan.kv) == (True, False)
    blocks = lm.leaf_blocks()
    mixer = "decoder.core.0.mixer."
    assert blocks[mixer + "wk"] == "local"
    assert part.compute_axis(plan, "local", "wk") is None
    assert part.compute_axis(plan, "local", "wq") == "heads"
    for leaf in ("wk", "wv", "q_norm", "k_norm"):
        assert part.partial_over_model(plan, "local", leaf), leaf
    for leaf in ("wq", "wo"):
        assert not part.partial_over_model(plan, "local", leaf), leaf
    assert blocks["decoder.core.0.ln1.scale"] is None
    assert not part.partial_over_model(plan, None, "scale")


def test_bf16_collectives_sum_in_fp32(runs):
    """A bf16 all-reduce of the tensor-parallel region sums in fp32 and
    rounds once, as a matmul accumulates, on every rank."""
    port = runs[1]
    for r in port:
        assert r["bf16_sum"] == [1.015625] * 4


def test_without_a_region_the_model_computes_as_on_one_device():
    """No mesh, or a model axis of 1: no region, and ``LM.forward`` gives
    the same logits bit for bit with a plan of size 1 in force."""
    cfg = get_smoke_config("deepseek-7b")
    lm = LM(cfg, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(2).randint(0, 512, (2, 16)))
    assert TP.active() is None
    want = lm.forward({"tokens": tok})[0]
    plan = lm.tp_plan(1)
    assert plan.size == 1 and not (plan.heads or plan.ffn or plan.vocab)
    mesh = part.AbstractMesh((2, 1), ("data", "model"))
    with TP.region(mesh, plan):
        assert TP.active() is None
        got = lm.forward({"tokens": tok})[0]
    assert torch.equal(got, want)
