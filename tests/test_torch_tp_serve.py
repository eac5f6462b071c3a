"""Tensor-parallel serving over "model" (``launch.specs.build_fn``'s
prefill and decode on a mesh: ``sharding/tp.py``'s region, all-gather and
partial-softmax combine, ``partition.cache_layout``,
``ops.attention_decode_partial`` and the split decode of
``models/attention.py``) on four gloo processes on a (2, 2) ("data",
"model") mesh, against the reference's GSPMD serving cells
(``repro/launch/specs.py``: the parameters at their specs, the decode
cache at ``cache_logical()`` in and out) and against the unsharded port,
on the same bridged fp32 weights.

Each case prefills a prompt into a cache of capacity ``CAP`` and takes
three decode steps of given tokens. Its cache layouts:

* ``heads``: deepseek-7b with 8 q and 8 kv heads, B=2: the kv heads over
  "model" (a kv-head-rich cache), the batch over "data";
* ``seq-model``: deepseek-7b as is (4 kv heads), B=2: the sequence over
  "model", while the compute splits the kv heads (the new k/v all-gathered
  before their owner writes them);
* ``ring``: gemma3-1b, B=1: its MQA cache and its local ring split by
  sequence over ("data", "model"), a prompt of 8 shorter than a rank's
  slice of the capacity (16) and of the ring (8): three ranks hold no
  valid key of the global layer;
* ``ring-wrapped``: the same at a prompt of 40, past the ring's 32 slots;
* ``heads-seq-data``: deepseek-7b with 8 and 8 heads at B=1: the sequence
  over "data" beside the heads over "model";
* ``gathered``: deepseek-7b with 3 and 3 heads at B=1, which do not
  split over "model": its attention computes gathered beside split MLPs
  and vocabulary, and its cache, the sequence over ("data", "model"), is
  gathered by c10d for each call and cut back to the shards.

Every logits call (prefill and each decode step) and every rank's cache
shard after the prefill and after the last step are held at rtol 1e-4,
elements near 0 at 1e-4 of the largest (``tests/test_torch_tp.py``'s
limit), against GSPMD (a shard against the slice of JAX's cache that
``devices_indices_map`` gives) and the unsharded port. The control, the
combine's all-reduce dropped (each rank's partial softmax taken as
whole), must fail that check wherever the sequence is split.
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
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.sharding import partition as part
from repro_torch.sharding import tp as TP

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-4
MESH = (2, 2)
CAP = 64
STEPS = 3
HEADS8 = {"num_heads": 8, "num_kv_heads": 8}
# key: (arch, config overrides, global batch, prompt length)
CASES = {"heads": ("deepseek-7b", HEADS8, 2, 40),
         "seq-model": ("deepseek-7b", {}, 2, 40),
         "ring": ("gemma3-1b", {}, 1, 8),
         "ring-wrapped": ("gemma3-1b", {}, 1, 40),
         "heads-seq-data": ("deepseek-7b", HEADS8, 1, 40),
         "gathered": ("deepseek-7b", {"num_heads": 3, "num_kv_heads": 3},
                      1, 40)}
# the cache layout of each case's global-attention k (batch, seq, heads)
LAYOUTS = {"heads": (("data",), (), ("model",)),
           "seq-model": (("data",), ("model",), ()),
           "ring": ((), ("data", "model"), ()),
           "ring-wrapped": ((), ("data", "model"), ()),
           "heads-seq-data": ((), ("data",), ("model",)),
           "gathered": ((), ("data", "model"), ())}


def _cfg(key):
    arch, over, _, _ = CASES[key]
    return get_smoke_config(arch).replace(**over)


def _lm(z, key):
    lm = LM(_cfg(key), device="cpu")
    pre = f"{key}.p."
    load_jax_numpy(lm, {k[len(pre):]: v for k, v in z.items()
                        if k.startswith(pre)})
    return lm


def _specs(lm, key, mesh):
    _, _, B, _ = CASES[key]
    sp = specs.input_specs(lm.cfg, ShapeConfig("p", CAP, B, "prefill"),
                           mesh)
    sd = specs.input_specs(lm.cfg, ShapeConfig("d", CAP, B, "decode"), mesh)
    return dict(sp, lm=lm), dict(sd, lm=lm)


def _serve(lm, z, key, mesh=None, watch=contextlib.nullcontext):
    """The prefill and STEPS decode steps -> (logits per call, the cache
    after the prefill and after the last step, each leaf by path: this
    rank's local shard on a mesh). Each serving call runs inside
    ``watch()``."""
    tokens = torch.from_numpy(z[f"{key}.tokens"]).long()
    dec = torch.from_numpy(z[f"{key}.dec"]).long()

    def local(t):
        return t.to_local() if mesh is not None else t

    def flat(cache):
        return {k: local(v).clone() for k, v in flatten_paths(cache)}
    if mesh is None:
        cache, lg = lm.prefill({"tokens": tokens}, CAP)
        step = lm.decode_step
        whole = local
    else:
        sp, sd = _specs(lm, key, mesh)
        params = {n: specs._placed(p.detach(), sp["in_shardings"][0][n])
                  for n, p in lm.named_parameters()}
        with watch():
            cache, lg = specs.build_fn(sp)(params, {"tokens": tokens})
        fn = specs.build_fn(sd)

        def step(cache, t):
            with watch():
                return fn(params, cache, t)

        def whole(t):
            return t.full_tensor()
    logits, prefilled = [whole(lg)], flat(cache)
    for i in range(STEPS):
        cache, lg = step(cache, dec[:, i:i + 1])
        logits.append(whole(lg))
    return logits, prefilled, flat(cache)


def _serve_rank(rank, world, d):
    """One of four ranks: each case served on the (2, 2) mesh, the
    DTensor ``redistribute`` calls of the serving calls counted; then the
    control, the combine's all-reduce dropped."""
    from torch.distributed.tensor import DTensor
    z = dict(np.load(os.path.join(d, "in.npz")))
    mesh = make_mesh(MESH, ("data", "model"), device="cpu")
    calls = [0]
    real = DTensor.redistribute

    def counted(self, *a, **kw):
        calls[0] += 1
        return real(self, *a, **kw)

    @contextlib.contextmanager
    def watch():
        DTensor.redistribute = counted
        try:
            yield
        finally:
            DTensor.redistribute = real

    def uncombined(o, m, l, groups):
        return o / l[:, None, :, None]
    out = {}
    for key in CASES:
        lm = _lm(z, key)
        with part.activate(mesh):
            logits, prefilled, decoded = _serve(lm, z, key, mesh, watch)
            combine, TP.combine_partial = TP.combine_partial, uncombined
            try:
                control = _serve(_lm(z, key), z, key, mesh)[0]
            finally:
                TP.combine_partial = combine
            layout = lm.cache_layouts(mesh, CASES[key][2], CAP)["attn"]
        out[key] = dict(coord=tuple(mesh.get_coordinate()), logits=logits,
                        prefill=prefilled, decode=decoded, control=control,
                        layout=tuple(layout), redistribute=calls[0])
    out["relayout"] = _relayouts(mesh)
    return out


def _relayouts(mesh):
    """``adamw._relayout`` of a [4, 8] tensor whose dim lies on both mesh
    dims (major "data", minor "model"), each case from this rank's shard
    at ``src`` to its local tensor at ``dst``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.optim.adamw import _relayout
    full = torch.arange(32.).reshape(4, 8)
    d, m = mesh.get_coordinate()
    i = d * MESH[1] + m
    S0, S1, R = Shard(0), Shard(1), Replicate()
    cases = {"seq to whole": (full[:, 2 * i:2 * i + 2], (S1, S1), (R, R)),
             "whole to seq": (full, (R, R), (S1, S1)),
             "batch to data": (full[i:i + 1], (S0, S0), (S0, R)),
             "batch stays": (full[i:i + 1], (S0, S0), (S0, S0)),
             "beside heads": (full[2 * d:2 * d + 2, 4 * m:4 * m + 4],
                              (S0, S1), (R, R))}
    return {k: _relayout(t, mesh, src, dst).clone()
            for k, (t, src, dst) in cases.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The weights of each case (the reference's ``LM.init``), its prompt
    and decode tokens; the JAX GSPMD side in one subprocess beside the
    port's four ranks, and the unsharded port."""
    import jax
    from repro.configs.base import get_smoke_config as jsmoke
    from repro.models.model import LM as JaxLM
    d = tmp_path_factory.mktemp("serve")
    rs = np.random.RandomState(0)
    z = {}
    for i, (key, (arch, over, B, S)) in enumerate(CASES.items()):
        params = JaxLM(jsmoke(arch).replace(**over)).init(
            jax.random.PRNGKey(i))
        for path, v in flatten_paths(jax.tree.map(np.asarray, params)):
            z[f"{key}.p.{path}"] = v
        z[f"{key}.tokens"] = rs.randint(0, 512, (B, S)).astype(np.int32)
        z[f"{key}.dec"] = rs.randint(0, 512, (B, STEPS)).astype(np.int32)
    np.savez(d / "in.npz", **z)
    with open(d / "cases.json", "w") as f:
        json.dump([[key, arch, over, list(MESH), B, CAP]
                   for key, (arch, over, B, _) in CASES.items()], f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "jax_mesh_ref.py"), "serve",
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = run_ranks(_serve_rank, 4, (str(d),), timeout_s=240,
                         device="cpu", workdir=str(d))
        unsharded = {key: _serve(_lm(z, key), z, key) for key in CASES}
        err = proc.communicate(timeout=240)[1]
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    jx = dict(np.load(d / "out.npz"))
    with open(d / "indices.json") as f:
        indices = json.load(f)
    return port, unsharded, jx, indices


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _rank(coord):
    return coord[0] * MESH[1] + coord[1]


@pytest.mark.parametrize("key", list(CASES))
def test_logits_match_gspmd_and_the_unsharded_port(runs, key):
    """The prefill's last logits and each decode step's, whole over the
    batch and the vocabulary on every rank."""
    port, unsharded, jx, _ = runs
    B = CASES[key][2]
    for r in port:
        for i, got in enumerate(r[key]["logits"]):
            assert got.shape == (B, _cfg(key).padded_vocab)
            _close(got, jx[f"{key}.logits.{i}"], f"call {i} against GSPMD")
            _close(got, unsharded[key][0][i], f"call {i} against the port")


@pytest.mark.parametrize("when", ["prefill", "decode"])
@pytest.mark.parametrize("key", list(CASES))
def test_cache_shards_match_gspmd_and_the_unsharded_port(runs, key, when):
    """Every rank's local leaf, after the prefill and after the last
    decode step, has the shape of its storage shard and holds its slice of
    JAX's cache (``devices_indices_map``) and of the unsharded port's."""
    port, unsharded, jx, indices = runs
    want_port = unsharded[key][1 if when == "prefill" else 2]
    for r in port:
        got = r[key][when]
        assert got.keys() == want_port.keys()
        for path, t in got.items():
            rows = indices[key][path][_rank(r[key]["coord"])]
            sl = tuple(slice(a, b) for a, b in rows)
            assert tuple(t.shape) == tuple(b - a for a, b in rows), path
            _close(t, jx[f"{key}.{when}.{path}"][sl], f"{path} vs GSPMD")
            _close(t, want_port[path][sl].numpy(), f"{path} vs the port")


@pytest.mark.parametrize("key", list(CASES))
def test_the_cache_layouts_are_the_reference_specs(runs, key):
    """The layout each case was meant to exercise, and no DTensor
    ``redistribute`` on the serving path (gloo crashed on it with CUDA
    tensors; the port gathers by c10d)."""
    port = runs[0]
    for r in port:
        assert r[key]["layout"] == LAYOUTS[key]
        assert r[key]["redistribute"] == 0


@pytest.mark.parametrize("key", [k for k in CASES if LAYOUTS[k][1]
                                 and k != "gathered"])
def test_dropping_the_combine_fails_the_check(runs, key):
    """The control: each rank's partial softmax taken as whole, without
    the combine's all-reduce, misses the limit the split decode meets
    (its prefill, which the combine does not touch, still meets it)."""
    port, unsharded, _, _ = runs
    for r in port:
        _close(r[key]["control"][0], unsharded[key][0][0], "prefill")
        with pytest.raises(AssertionError):
            for i in range(1, STEPS + 1):
                _close(r[key]["control"][i], unsharded[key][0][i], "decode")


def test_a_rank_without_a_valid_key_adds_exactly_zero():
    """``attention_decode_partial`` over slots none of which is valid
    (positions past the length, ring slots at -1): o and l exactly 0, and
    the combine over two halves of a cache is ``attention_decode``."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    lengths = torch.tensor([3, 8])
    want = ops.attention_decode(q, k, v, lengths)
    parts = []
    for lo in (0, 4):
        pos = (lo + torch.arange(4))[None].expand(2, 4)
        parts.append(ops.attention_decode_partial(
            q, k[:, lo:lo + 4], v[:, lo:lo + 4], lengths,
            slot_positions=pos))
    o, m, l = parts[1]
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert torch.equal(l[0], torch.zeros_like(l[0]))
    ring = torch.full((2, 4), -1)
    o, m, l = ops.attention_decode_partial(q, k[:, :4], v[:, :4], lengths,
                                           slot_positions=ring)
    assert not o.any() and not l.any() and torch.isfinite(m).all()
    top = torch.maximum(parts[0][1], parts[1][1])
    c = [torch.exp(p[1] - top) for p in parts]
    num = sum(p[0] * ci[:, None, :, None] for p, ci in zip(parts, c))
    den = sum(p[2] * ci for p, ci in zip(parts, c))
    torch.testing.assert_close(num / den[:, None, :, None], want,
                               rtol=1e-6, atol=1e-6)


def test_relayout_over_two_mesh_dims_on_one_tensor_dim(runs):
    """A cache's sequence over ("data", "model") is split major to minor:
    ``adamw._relayout`` gathers it minor dim first and cuts it major dim
    first (the gathered blocks' cache leaves go in and out that way), and
    leaves a dim whose mesh dims stay as it is."""
    full = torch.arange(32.).reshape(4, 8)
    for r in runs[0]:
        d, m = r["heads"]["coord"]
        i = d * MESH[1] + m
        got = r["relayout"]
        assert torch.equal(got["seq to whole"], full)
        assert torch.equal(got["whole to seq"], full[:, 2 * i:2 * i + 2])
        assert torch.equal(got["batch to data"], full[2 * d:2 * d + 2])
        assert torch.equal(got["batch stays"], full[i:i + 1])
        assert torch.equal(got["beside heads"], full)
