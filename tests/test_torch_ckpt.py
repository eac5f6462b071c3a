"""The port's checkpoint against ``repro.checkpoint.ckpt``, on the CPU.

Leaf order, the cross-restores (a JAX checkpoint into the port, a port
checkpoint into JAX, under zstd and under zlib), compared leaf by leaf by
path and bit for bit, and one train step after each cross-restore against
JAX's step at the tolerances of ``tests/test_torch_train.py``: loss and
grad_norm at rtol 1e-4, params within ``2 * lr``, ``m`` and ``v`` at rtol
1e-4 of each element or of the leaf's largest (``MOMENT_TOL``). JAX is
imported inside the tests, so that a host without it can collect this file.
"""
import functools
import os
import shutil
import subprocess
import sys
import threading
import zlib

import msgpack
import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_opt_state
from repro_torch.checkpoint import _msgpack, ckpt
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.optim import adamw

ARCHS = ["deepseek-7b", "mamba2-2.7b", "recurrentgemma-9b", "gemma3-1b"]
RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# m and v after the step, as a share of the leaf's largest element. The
# mamba2-2.7b smoke model's gradients are ill-conditioned: JAX's fp32
# gradient and the port's each lie up to 1.6e-4 of a leaf's largest element
# from the float64 one, so two correct fp32 codes differ by up to the sum of
# the two; its moments are held at that bound, which
# test_mamba_moment_limit_has_a_float64_witness checks (ROADMAP Queue 3)
MOMENT_TOL = {"mamba2-2.7b": 4e-4}


def _tokens(seed, vocab, B=2, S=32):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _dotted(keypath):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                    for k in keypath)


def _jax_leaves(tree):
    """(dotted path, numpy leaf) in JAX's flatten order."""
    import jax
    return [(_dotted(kp), np.asarray(x)) for kp, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _bits(x):
    """A leaf's bytes, for bit-for-bit comparison (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _assert_same_leaves(port_tree, jax_leaves):
    got = list(ckpt.flatten(port_tree))
    assert [p for p, _ in got] == [p for p, _ in jax_leaves]
    for (path, t), (_, a) in zip(got, jax_leaves):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), path
        assert _bits(t) == _bits(a), path


@pytest.fixture(params=["zstd", "zlib"])
def codec(request, monkeypatch):
    """Both sides write with zstd, or both with zlib (``zstandard`` set to
    None in the port's and the reference's module)."""
    from repro.checkpoint import ckpt as jck
    if request.param == "zlib":
        monkeypatch.setattr(ckpt, "zstandard", None)
        monkeypatch.setattr(jck, "zstandard", None)
    else:
        pytest.importorskip("zstandard")
    return request.param


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX trains two steps; returns its LM, the state after them (the one
    checkpointed), the jitted step, the third batch, and the third step's
    state and metrics."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config as jax_smoke
    from repro.models.model import LM as JaxLM
    from repro.optim import adamw as jadamw
    cfg = jax_smoke(arch)
    jlm = JaxLM(cfg)
    state = jadamw.init_state(jlm.init(jax.random.PRNGKey(0)))
    jstep = jax.jit(jadamw.make_train_step(jlm, jadamw.OptConfig(**OPT)))
    for i in range(2):
        state, _ = jstep(state, {"tokens": jnp.asarray(
            _tokens(30 + i, cfg.vocab_size))})
    tok = _tokens(32, cfg.vocab_size)
    after, m = jstep(state, {"tokens": jnp.asarray(tok)})
    return jstep, state, tok, after, {k: float(v) for k, v in m.items()}


def _assert_step_matches(arch, state, lm, tok):
    """One port step from ``state`` against JAX's third step."""
    _, _, _, jafter, jm = _jax_run(arch)
    state, m = adamw.make_train_step(lm, adamw.OptConfig(**OPT))(
        state, {"tokens": torch.from_numpy(tok)})
    assert int(state["step"]) == 3
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), jm[key], rtol=RTOL,
                                   err_msg=key)
    want = dict(_jax_leaves(jafter))
    for path, t in ckpt.flatten(adamw.state_tree(state, lm)):
        if path == "step":
            continue
        w = want[path]
        tol = 2 * jm["lr"] if path.startswith("params.") else \
            MOMENT_TOL.get(arch, RTOL) * np.abs(w).max()
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=RTOL,
                                   atol=tol, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_matches_jax(arch):
    """The port's flatten of its AdamW state is JAX's: the same paths in
    the same order (``tail.10`` after ``tail.9``), shapes and dtypes."""
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke
    from repro.models.model import LM as JaxLM
    from repro.optim import adamw as jadamw
    jlm = JaxLM(jax_smoke(arch))
    abstract = jadamw.abstract_state(jax.eval_shape(
        jlm.init, jax.random.PRNGKey(0)))
    want, _ = jax.tree_util.tree_flatten_with_path(abstract)
    lm = LM(get_smoke_config(arch), device="cpu")
    tree = adamw.state_tree(adamw.init_state(lm), lm)
    got = list(ckpt.flatten(tree))
    assert [p for p, _ in got] == [_dotted(kp) for kp, _ in want]
    for (path, t), (_, s) in zip(got, want):
        assert tuple(t.shape) == s.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype), path
    assert len(got) == 1 + 3 * len(dict(lm.named_parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_into_port(arch, codec, tmp_path):
    """JAX saves its AdamW state after two steps; the port restores it into
    an LM of other weights, leaf by leaf, bit for bit, and its next step
    matches JAX's."""
    from repro.checkpoint import ckpt as jck
    _, jstate, tok, _, _ = _jax_run(arch)
    jck.save(str(tmp_path), jstate, step=2, extra={"data": {"step": 2}})
    d = ckpt.latest(str(tmp_path))
    with open(os.path.join(d, "leaf_00000.bin"), "rb") as f:
        assert (f.read(4) == ckpt._ZSTD_MAGIC) == (codec == "zstd")
    lm = LM(get_smoke_config(arch), device="cpu",
            generator=torch.Generator().manual_seed(7))
    state = adamw.init_state(lm)
    tree = ckpt.restore(d, adamw.state_tree(state, lm))
    _assert_same_leaves(tree, _jax_leaves(jstate))
    assert state["params"]["embed"] is lm.embed       # written in place
    assert ckpt.manifest_extra(d) == {"data": {"step": 2}}
    _assert_step_matches(arch, state, lm, tok)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_into_jax(arch, codec, tmp_path):
    """The port saves the state JAX trained (bridged in); JAX's ``restore``
    reads it leaf by leaf, bit for bit, and JAX's step from the restored
    tree matches the port's step from its own."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as jck
    jstep, jstate, tok, _, _ = _jax_run(arch)
    lm = LM(get_smoke_config(arch), device="cpu")
    state = load_jax_opt_state(lm, jax.tree.map(np.asarray, jstate))
    d = ckpt.save(str(tmp_path), adamw.state_tree(state, lm), step=2,
                  extra={"step": 2, "data": {"step": 2, "seed": 0}})
    restored = jck.restore(d, jstate)
    _assert_same_leaves(adamw.state_tree(state, lm), _jax_leaves(restored))
    _assert_same_leaves(adamw.state_tree(state, lm), _jax_leaves(jstate))
    assert jck.manifest_extra(d) == {"step": 2,
                                     "data": {"step": 2, "seed": 0}}
    _, jm = jstep(restored, {"tokens": jnp.asarray(tok)})
    assert {k: float(v) for k, v in jm.items()} == _jax_run(arch)[4]
    _assert_step_matches(arch, state, lm, tok)


_F64_GRADS = """
import sys
import numpy as np
import torch
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import LM
src = np.load(sys.argv[1])
lm = LM(get_smoke_config(sys.argv[2]), device="cpu")
assert lm.param_dtype == lm.compute_dtype == torch.float64
with torch.no_grad():
    for n, p in lm.named_parameters():
        p.copy_(torch.from_numpy(src["param." + n]))
lm.loss({"tokens": torch.from_numpy(src["tokens"])})[0].backward()
np.savez(sys.argv[3], **{n: p.grad.numpy() for n, p in lm.named_parameters()})
"""


def _float64_port(dst):
    """A copy of the port whose fp32 casts and dtype names are float64
    ones, so that its plain (CPU) path computes in float64."""
    import repro_torch
    out = dst / "repro_torch"
    shutil.copytree(os.path.dirname(repro_torch.__file__), out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in out.rglob("*.py"):
        text = f.read_text()
        for a, b in (("torch.float32", "torch.float64"),
                     (".float()", ".double()"), ('"float32"', '"float64"')):
            text = text.replace(a, b)
        f.write_text(text)
    return dst


def test_mamba_moment_limit_has_a_float64_witness(tmp_path):
    """The witness behind ``MOMENT_TOL``: at the checkpointed state, the
    third batch's gradient in fp32 by JAX and by the port, each against the
    port's plain path in float64. The port is no further from it than twice
    JAX on any leaf (were it, the port would be at fault), and the two
    fp32 distances sum to at most the moments' limit."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config as jax_smoke
    from repro.models.model import LM as JaxLM
    arch = "mamba2-2.7b"
    _, jstate, tok, _, _ = _jax_run(arch)
    params = dict(flatten_paths(jax.tree.map(np.asarray, jstate["params"])))
    jgrad = dict(flatten_paths(jax.tree.map(np.asarray, jax.grad(
        lambda p: JaxLM(jax_smoke(arch)).loss(
            p, {"tokens": jnp.asarray(tok)})[0])(jstate["params"]))))
    lm = LM(get_smoke_config(arch), device="cpu")
    load_jax_opt_state(lm, jax.tree.map(np.asarray, jstate))
    lm.loss({"tokens": torch.from_numpy(tok)})[0].backward()
    np.savez(tmp_path / "in.npz", tokens=tok, **{
        "param." + n: a.astype(np.float64) for n, a in params.items()})
    subprocess.run(
        [sys.executable, "-c", _F64_GRADS, str(tmp_path / "in.npz"), arch,
         str(tmp_path / "out.npz")], check=True, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(_float64_port(tmp_path))})
    want = np.load(tmp_path / "out.npz")
    for n, p in lm.named_parameters():
        w = want[n]
        assert w.dtype == np.float64, n
        scale = np.abs(w).max()
        port = np.abs(p.grad.numpy() - w).max() / scale
        ref = np.abs(jgrad[n] - w).max() / scale
        assert port <= 2 * ref + 1e-6, (n, port, ref)
        assert port + ref <= MOMENT_TOL[arch], (n, port, ref)


def _bf16_tree(seed):
    r = np.random.RandomState(seed)
    return {"w": r.randn(3, 5).astype(np.float32),
            "layers": [{"b": r.randn(7).astype(np.float32)}],
            "n": np.int32(seed)}


def test_bf16_jax_to_port_and_back(codec, tmp_path):
    """bf16 leaves cross both ways as their raw bits (the port never
    imports ml_dtypes: ``torch.frombuffer`` reads them)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as jck
    src = _bf16_tree(1)
    jtree = {"w": jnp.asarray(src["w"], jnp.bfloat16),
             "layers": [{"b": jnp.asarray(src["layers"][0]["b"],
                                          jnp.bfloat16)}],
             "n": jnp.asarray(src["n"])}
    d = jck.save(str(tmp_path / "j"), jtree, step=1)
    like = {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
            "layers": [{"b": torch.zeros(7, dtype=torch.bfloat16)}],
            "n": torch.zeros((), dtype=torch.int32)}
    _assert_same_leaves(ckpt.restore(d, like), _jax_leaves(jtree))

    other = _bf16_tree(2)
    mine = {"w": torch.from_numpy(other["w"]).bfloat16(),
            "layers": [{"b": torch.from_numpy(
                other["layers"][0]["b"]).bfloat16()}],
            "n": torch.tensor(int(other["n"]), dtype=torch.int32)}
    d = ckpt.save(str(tmp_path / "p"), mine, step=1)
    back = jck.restore(d, jtree)
    assert jax.tree.leaves(back)[0].dtype == jnp.bfloat16
    _assert_same_leaves(mine, _jax_leaves(back))


MSGPACK_CASES = [
    {"dtype": "float32", "shape": [102400, 4096]},
    {"dtype": "bfloat16", "shape": []},
    {"dtype": "int32", "shape": [2, 30, 4096, 11008]},
    {"n_leaves": 202, "step": 25, "treedef": "T" * 70000,
     "extra": {"step": 25, "data": {"step": 26, "seed": 0}}},
    {"n_leaves": 37, "step": 2 ** 40, "treedef": "t" * 200,
     "extra": {}},
    {"extra": {"f": 1.5, "neg": [-1, -32, -33, -128, -129, -2 ** 15 - 1,
                                 -2 ** 31 - 1, -2 ** 63],
               "pos": [127, 128, 255, 256, 65535, 65536, 2 ** 32,
                       2 ** 64 - 1],
               "b": [True, False, None], "s": ["", "é" * 20, "x" * 300],
               "big": list(range(20)),
               "map": {f"k{i}": i for i in range(17)}}},
]


@pytest.mark.parametrize("case", range(len(MSGPACK_CASES)))
def test_msgpack_subset_bytes_equal_msgpack(case):
    obj = MSGPACK_CASES[case]
    assert _msgpack.packb(obj) == msgpack.packb(obj)
    assert _msgpack.unpackb(msgpack.packb(obj)) == \
        msgpack.unpackb(msgpack.packb(obj), raw=False)
    with pytest.raises(TypeError):
        _msgpack.packb({"a": object()})


def test_written_manifest_and_leaf_heads_are_msgpack(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "zstandard", None)      # zlib: readable here
    tree = {"b": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "a": [torch.ones(4, dtype=torch.bfloat16), torch.tensor(3.0)]}
    d = ckpt.save(str(tmp_path), tree, step=5, extra={"data": {"step": 4}})
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        raw = f.read()
    manifest = msgpack.unpackb(raw, raw=False)
    assert msgpack.packb(manifest) == raw
    assert manifest["n_leaves"] == 3 and manifest["step"] == 5
    for i, (_, t) in enumerate(ckpt.flatten(tree)):
        with open(os.path.join(d, f"leaf_{i:05d}.bin"), "rb") as f:
            raw = zlib.decompress(f.read())
        head = msgpack.packb({"dtype": str(t.dtype)[6:],
                              "shape": list(t.shape)})
        assert raw == head + _bits(t)


def test_async_save_then_step_restores_the_pre_step_state(tmp_path,
                                                          monkeypatch):
    """The host copy is taken before ``save`` returns: a train step that
    updates the tensors in place while the writer has not written a byte
    does not reach the checkpoint."""
    cfg = get_smoke_config("deepseek-7b")
    lm = LM(cfg, device="cpu")
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, adamw.OptConfig(**OPT))
    state, _ = step(state, {"tokens": torch.from_numpy(_tokens(1, 512))})
    before = {p: t.clone() for p, t in
              ckpt.flatten(adamw.state_tree(state, lm))}

    go = threading.Event()
    write_leaf = ckpt._write_leaf

    def held(*a):
        assert go.wait(30)
        write_leaf(*a)
    monkeypatch.setattr(ckpt, "_write_leaf", held)
    d, writer = ckpt.save(str(tmp_path), adamw.state_tree(state, lm),
                          step=1, async_write=True)
    state, _ = step(state, {"tokens": torch.from_numpy(_tokens(2, 512))})
    go.set()
    writer.join(30)
    assert not writer.is_alive()

    lm2 = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    state2 = adamw.init_state(lm2)
    ckpt.restore(d, adamw.state_tree(state2, lm2))
    for path, t in ckpt.flatten(adamw.state_tree(state2, lm2)):
        assert torch.equal(t, before[path]), path
    assert not torch.equal(lm.embed, lm2.embed)


def test_writer_error_surfaces_on_join(tmp_path, monkeypatch):
    def broken(*a):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "_write_leaf", broken)
    _, writer = ckpt.save(str(tmp_path), {"w": torch.ones(3)}, step=1,
                          async_write=True)
    with pytest.raises(OSError, match="disk full"):
        writer.join(30)
    assert ckpt.latest(str(tmp_path)) is None       # nothing published


def test_latest_manifest_extra_and_resave(tmp_path):
    """tests/test_substrate.py::test_checkpoint_roundtrip_and_latest, and a
    re-save of a step replacing the old one."""
    path = str(tmp_path)
    assert ckpt.latest(path) is None
    assert ckpt.latest(os.path.join(path, "missing")) is None
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}
    ckpt.save(path, tree, step=3, extra={"x": 1})
    ckpt.save(path, tree, step=7, extra={"x": 2})
    os.makedirs(os.path.join(path, "step_00000009.tmp"))   # unpublished
    latest = ckpt.latest(path)
    assert latest.endswith("step_00000007")
    assert ckpt.manifest_extra(latest) == {"x": 2}
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5,
                                                          dtype=torch.int32)}}
    out = ckpt.restore(latest, like)
    assert out is like and torch.equal(like["a"], tree["a"])

    tree2 = {"a": tree["a"] + 1, "b": {"c": tree["b"]["c"] * 2}}
    assert ckpt.save(path, tree2, step=7, extra={"x": 3}) == latest
    assert sorted(os.listdir(path)) == ["step_00000003", "step_00000007",
                                        "step_00000009.tmp"]
    ckpt.restore(latest, like)
    assert torch.equal(like["a"], tree2["a"])
    assert torch.equal(like["b"]["c"], tree2["b"]["c"])
    assert ckpt.manifest_extra(latest) == {"x": 3}


@pytest.mark.parametrize("bad", ["dtype", "shape", "count"])
def test_mismatch_raises_and_writes_nothing(tmp_path, bad):
    tree = {"a": torch.ones(2, 3), "b": torch.arange(4, dtype=torch.int32)}
    d = ckpt.save(str(tmp_path), tree, step=1)
    like = {"a": torch.zeros(2, 3), "b": torch.zeros(4, dtype=torch.int32)}
    if bad == "dtype":
        like["b"] = torch.zeros(4, dtype=torch.int64)
    elif bad == "shape":
        like["b"] = torch.zeros(5, dtype=torch.int32)
    else:
        like["c"] = torch.zeros(1)
    with pytest.raises(ValueError, match="mismatch" if bad == "count"
                       else "leaf b"):
        ckpt.restore(d, like)
    assert torch.equal(like["a"], torch.zeros(2, 3))   # nothing written


def test_state_tree_nests_along_the_lm_tree():
    """Lists stay lists, the leaves are the state's own tensors, and a state
    of other paths is refused."""
    lm = LM(get_smoke_config("recurrentgemma-9b"), device="cpu")
    state = adamw.init_state(lm)
    tree = adamw.state_tree(state, lm)
    tail = tree["params"]["decoder"]["tail"]
    assert isinstance(tail, list) and len(tail) == 5
    assert tail[0]["ln1"]["scale"] is lm.decoder.tail[0].ln1.scale
    assert tree["m"]["embed"] is state["m"]["embed"]
    assert {p for p, _ in flatten_paths(tree["v"])} == state["v"].keys()
    del state["m"]["embed"]
    with pytest.raises(KeyError, match="embed"):
        adamw.state_tree(state, lm)
