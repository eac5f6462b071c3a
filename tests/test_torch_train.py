"""Training in the port: loss, remat, AdamW and the train step against the
JAX package, on the CPU.

The deepseek-7b smoke LM in fp32, weights from the JAX ``LM.init`` bridged
through numpy, token batches from a numpy seed. The same fp32 math summed
in another order, so loss, ``ce``, ``grad_norm`` and gradients are held at
rtol 1e-4. Params are held more loosely, at ``atol = 2 * sum(lr_t)``: at
step 1 AdamW's update is about ``sign(g) * lr``, so a gradient near 0 can
take the other sign in the other framework and move its weight by up to
``2 * lr`` the other way. JAX is imported inside the tests, so that a host
without it (the card's) can collect this file.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy, load_jax_opt_state
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.optim import adamw

RTOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _pair():
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    jlm = JaxLM(jax_smoke_config("deepseek-7b"))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_smoke_config("deepseek-7b"), device="cpu")
    load_jax_numpy(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _batch(seed, B=2, S=32, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _paths(tree):
    from repro_torch.models.layers import flatten_paths
    return dict(flatten_paths(tree))


def _jax_state_np(state):
    import jax
    return jax.tree.map(np.asarray, state)


def test_loss_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    jlm, params, lm = _pair()
    tok = _batch(0)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(tok)}), has_aux=True)(
            params)
    loss, m = lm.loss({"tokens": torch.from_numpy(tok)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=RTOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    want = _paths(jax.tree.map(np.asarray, jgrads))
    for name, p in lm.named_parameters():
        w = want[name]
        # rtol 1e-4 of each element, or of the leaf's largest element
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=name)


def test_three_train_steps_match_jax():
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    jlm, params, lm = _pair()
    jstate = jadamw.init_state(params)
    jstep = jax.jit(jadamw.make_train_step(jlm, jadamw.OptConfig(**OPT)))
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, adamw.OptConfig(**OPT))
    lr_sum = 0.0
    for i in range(3):
        tok = _batch(10 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        state, m = step(state, {"tokens": torch.from_numpy(tok)})
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        lr_sum += float(jm["lr"])
        want = _paths(jax.tree.map(np.asarray, jstate["params"]))
        for name, p in state["params"].items():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=2 * lr_sum,
                                       err_msg=name)
    assert all(p.grad is None for p in lm.parameters())
    # the state's params are the LM's own
    assert state["params"]["embed"] is lm.embed


def test_resume_from_jax_opt_state():
    """JAX trains two steps; its AdamW state (numpy) resumes in the port;
    the third step matches on both sides."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    jlm, params, lm = _pair()
    jstate = jadamw.init_state(params)
    jstep = jax.jit(jadamw.make_train_step(jlm, jadamw.OptConfig(**OPT)))
    for i in range(2):
        jstate, _ = jstep(jstate, {"tokens": jnp.asarray(_batch(20 + i))})
    state = load_jax_opt_state(lm, _jax_state_np(jstate))
    assert int(state["step"]) == 2
    m_want = _paths(_jax_state_np(jstate)["m"])
    for name, m in state["m"].items():
        np.testing.assert_array_equal(m.numpy(), m_want[name])
    tok = _batch(22)
    jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
    state, m = adamw.make_train_step(lm, adamw.OptConfig(**OPT))(
        state, {"tokens": torch.from_numpy(tok)})
    assert int(state["step"]) == 3
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL)
    got = {"params": state["params"], "m": state["m"], "v": state["v"]}
    for part, leaves in got.items():
        wp = _paths(_jax_state_np(jstate)[part])
        for name, t in leaves.items():
            w = wp[name]
            tol = 2 * float(jm["lr"]) if part == "params" else \
                RTOL * np.abs(w).max()
            np.testing.assert_allclose(t.detach().numpy(), w, rtol=RTOL,
                                       atol=tol, err_msg=f"{part} {name}")


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "gemma3-1b",
                                  "deepseek-moe-16b", "deepseek-v2-236b"])
def test_smoke_train_step(arch):
    """tests/test_archs.py::test_smoke_train_step for the ported layer
    kinds: one step, finite loss, step 1, params moved."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg, device="cpu")
    before = {n: p.detach().clone() for n, p in lm.named_parameters()}
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, adamw.OptConfig(lr=1e-3))
    tok = torch.from_numpy(_batch(1, S=64, vocab=cfg.vocab_size))
    state, m = step(state, {"tokens": tok})
    assert np.isfinite(float(m["loss"]))
    assert int(state["step"]) == 1
    assert any(not torch.equal(p, before[n])
               for n, p in lm.named_parameters())


@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "recurrentgemma-9b",
                                  "deepseek-moe-16b", "deepseek-v2-236b"])
def test_remat_gives_the_gradients_of_none(arch, remat):
    cfg = get_smoke_config(arch)
    tok = torch.from_numpy(_batch(2, S=48, vocab=cfg.vocab_size))
    grads = {}
    for r in ("none", remat):
        lm = LM(cfg.replace(remat=r), device="cpu")
        lm.loss({"tokens": tok})[0].backward()
        grads[r] = {n: p.grad for n, p in lm.named_parameters()}
    for n, g in grads["none"].items():
        torch.testing.assert_close(grads[remat][n], g, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_backward_is_the_same_bit_for_bit(cf):
    """Two backwards of ``moe_apply`` from one input and one set of weights
    give the same gradients bit for bit, at a capacity factor that drops
    copies (1.25, on tokens crowded onto few experts) and at one that
    drops none. Each token's K copies reach the experts through a
    permutation of the broadcast input, so the input's gradient sums over
    K by a reduction, not by an accumulating index write. The CPU sums
    either way in one order, so this pins the property on the CPU path
    only; on the card, chip_smoke.py's two steps from one state are its
    witness."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import init_params, tree_map
    cfg = get_smoke_config("deepseek-moe-16b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    params = init_params(MOE.moe_def(cfg),
                         torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    rng = np.random.RandomState(7)
    common = rng.standard_normal(cfg.d_model)
    x0 = rng.standard_normal((2, 48, cfg.d_model)) + \
        3 * common / np.linalg.norm(common)
    runs = []
    for _ in range(2):
        p = tree_map(lambda t: t.clone().requires_grad_(), params)
        x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
        y, aux = MOE.moe_apply(cfg, p, x)
        (y.square().mean() + aux).backward()
        leaves = [x.grad] + [t.grad for t in
                             dict(flatten_paths(p)).values()]
        runs.append((y.detach(), leaves))
    (y1, g1), (y2, g2) = runs
    assert torch.equal(y1, y2)
    assert len(g1) == len(g2) > 1 and all(torch.equal(a, b)
                                          for a, b in zip(g1, g2))
    assert float(g1[0].abs().max()) > 0


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2)])
def test_full_remat_runs_each_flash_forward_twice(monkeypatch, remat,
                                                  fwd_per_layer):
    """Under full remat the backward recomputes each layer's forward: the
    FlashAttention forward runs twice per layer and step, its backward
    once."""
    cfg = get_smoke_config("deepseek-7b").replace(remat=remat)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.attention_fwd_lse_plain, fa.attention_bwd_plain

    def count(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(fa, "attention_fwd_lse_plain", count("fwd", fwd))
    monkeypatch.setattr(fa, "attention_bwd_plain", count("bwd", bwd))
    lm = LM(cfg, device="cpu")
    lm.loss({"tokens": torch.from_numpy(_batch(3))})[0].backward()
    assert calls == {"fwd": fwd_per_layer * cfg.num_layers,
                     "bwd": cfg.num_layers}
    with torch.no_grad():       # no grad: no remat, no Function
        lm.loss({"tokens": torch.from_numpy(_batch(3))})
    assert calls["fwd"] == fwd_per_layer * cfg.num_layers


def test_stacked_core_gradients_come_from_one_unbind():
    """The core's stacked parameters reach the layers through one unbind per
    leaf, not one index per period: an index's backward would add a zeroed
    full-size gradient per period (traffic quadratic in depth)."""
    lm = LM(get_smoke_config("deepseek-7b").replace(remat="none"),
            device="cpu")
    assert lm.decoder.n_periods == 3
    core = {id(p) for n, p in lm.named_parameters()
            if n.startswith("decoder.core.")}
    loss = lm.loss({"tokens": torch.from_numpy(_batch(5))})[0]
    feeds, todo, seen = [], [loss.grad_fn], set()
    while todo:          # the graph's nodes; note what feeds each core leaf
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for f, _ in node.next_functions:
            if id(getattr(f, "variable", None)) in core:
                feeds.append(type(node).__name__)
            todo.append(f)
    assert feeds == ["UnbindBackward0"] * len(core)


def test_schedules_agree_and_unknown_ones_raise():
    lm = LM(get_smoke_config("deepseek-7b"), device="cpu")
    batch = {"tokens": torch.from_numpy(_batch(4))}
    with torch.no_grad():
        full = lm.loss(batch)[0]
        tri = lm.loss(batch, schedule="triangular")[0]
        assert float(full) == float(tri)
        with pytest.raises(ValueError, match="schedule"):
            lm.loss(batch, schedule="diagonal")


def test_unknown_remat_raises():
    lm = LM(get_smoke_config("deepseek-7b").replace(remat="some"),
            device="cpu")
    with pytest.raises(ValueError, match="remat"):
        lm.loss({"tokens": torch.from_numpy(_batch(4))})


def test_schedule_matches_jax():
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    for kw in (OPT, {}, dict(warmup_steps=0, total_steps=5)):
        for step in (0, 1, 2, 3, 7, 50, 200, 20_000):
            want = float(jadamw.schedule(jadamw.OptConfig(**kw),
                                         jnp.asarray(step)))
            got = float(adamw.schedule(adamw.OptConfig(**kw), step))
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_optimizes_quadratic():
    """tests/test_substrate.py::test_adamw_optimizes_quadratic."""
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params)
    cfg = adamw.OptConfig(lr=0.3, warmup_steps=0, total_steps=200,
                          weight_decay=0.0)
    for _ in range(150):
        state, _ = adamw.apply_updates(cfg, state,
                                       {"w": 2 * state["params"]["w"]})
    assert float(state["params"]["w"].abs().max()) < 0.05
    assert state["params"]["w"] is params["w"]      # updated in place


def test_grad_clipping():
    """tests/test_substrate.py::test_grad_clipping."""
    state = adamw.init_state({"w": torch.zeros(4)})
    _, m = adamw.apply_updates(adamw.OptConfig(clip_norm=1.0), state,
                               {"w": torch.full((4,), 100.0)})
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-3)


def test_grad_compression_roundtrip_is_unbiasedish():
    """tests/test_substrate.py::test_grad_compression_roundtrip_is_unbiasedish:
    the bits differ from JAX's (another generator), the statistics
    agree."""
    g = torch.from_numpy(np.random.RandomState(0).standard_normal(4096)
                         .astype(np.float32))
    outs = [adamw._compress(g, torch.Generator().manual_seed(s)).numpy()
            for s in range(8)]
    err = np.abs(np.mean(outs, 0) - g.numpy()).max()
    scale = float(g.abs().max()) / 127
    assert err < 2.5 * scale / np.sqrt(8)   # averages toward the truth
    # each draw sits within one quantisation step of g
    assert max(np.abs(o - g.numpy()).max() for o in outs) <= scale * 1.0001


def test_compressed_step_runs_and_stays_close():
    cfg = adamw.OptConfig(compress_grads=True, clip_norm=0.0)
    w = torch.randn(256, generator=torch.Generator().manual_seed(0))
    g = torch.randn(256, generator=torch.Generator().manual_seed(1))
    a = adamw.init_state({"w": w.clone()})
    b = adamw.init_state({"w": w.clone()})
    a, _ = adamw.apply_updates(cfg, a, {"w": g})
    b, _ = adamw.apply_updates(cfg.__class__(clip_norm=0.0), b, {"w": g})
    assert not torch.equal(a["m"]["w"], b["m"]["w"])
    step = float(g.abs().max()) / 127
    torch.testing.assert_close(a["m"]["w"], b["m"]["w"], rtol=0,
                               atol=0.1 * step * 1.0001)


# ---------------------------------------------------------------------------
# The scans' autograd Functions against jax.grad of the reference's blocked
# paths (the reference has no backward kernel for either)
# ---------------------------------------------------------------------------


def _jax_vjp(fn, ins, gouts):
    """Gradients of sum(out * gout) over fn's outputs, for every input."""
    import jax
    import jax.numpy as jnp

    def loss(*a):
        return sum(jnp.sum(o * g) for o, g in zip(fn(*a), gouts))
    return [np.asarray(g) for g in jax.grad(
        loss, tuple(range(len(ins))))(*[jnp.asarray(a) for a in ins])]


def _rng_arrays(seed, shapes, scales):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(s) * c).astype(np.float32)
            for s, c in zip(shapes, scales)]


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_function_gradients_match_jax(with_h0):
    """Through y and h_final alike, h0 included: SSDScan's backward (the
    plain version recomputed under autograd) against jax.grad of the
    reference's blocked ``ops.ssd``."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ssd
    b, S, H, P, G, N, chunk = 2, 48, 4, 8, 2, 8, 16
    x, dt_raw, al, bm, cm, d, h0 = _rng_arrays(
        0, [(b, S, H, P), (b, S, H), (H,), (b, S, G, N), (b, S, G, N), (H,),
            (b, H, P, N)], [1, 1, 0.5, 0.3, 0.3, 1, 1])
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)       # softplus'd
    ins = [x, dt, al, bm, cm, d] + ([h0] if with_h0 else [])
    gy, gh = _rng_arrays(1, [(b, S, H, P), (b, H, P, N)], [1, 1])
    want = _jax_vjp(lambda x, dt, al, bm, cm, d, *h: jops.ssd(
        x, dt, al, bm, cm, D=d, h0=h[0] if h else None, chunk=chunk,
        impl="blocked"), ins, (gy, gh))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = ssd.ssd_scan(*leaves[:5], D=leaves[5],
                        h0=leaves[6] if with_h0 else None, chunk=chunk)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_function_gradients_match_jax(with_h0):
    """RGLRUScan's backward against jax.grad of the reference's blocked
    ``ops.rglru``, through y and h_final, h0 included."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import rglru
    B, S, D = 2, 40, 16
    x, al, ga, gx, h0 = _rng_arrays(
        2, [(B, S, D), (D,), (B, S, D), (B, S, D), (B, D)], [1, 1, 1, 1, 1])
    ins = [x, al, ga, gx] + ([h0] if with_h0 else [])
    gy, gh = _rng_arrays(3, [(B, S, D), (B, D)], [1, 1])
    want = _jax_vjp(lambda x, al, ga, gx, *h: jops.rglru(
        x, al, ga, gx, h0=h[0] if h else None, impl="blocked"), ins,
        (gy, gh))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, h = rglru.rglru_scan(*leaves[:4], h0=leaves[4] if with_h0 else None)
    assert type(y.grad_fn).__name__ == "RGLRUScanBackward"
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL)


def test_scan_function_with_one_output_used():
    """Only h_final feeds the loss: the unused y's gradient is None, and
    the gradient still equals autograd through the plain version."""
    from repro_torch.kernels import ssd
    b, S, H, P, G, N = 1, 24, 2, 8, 1, 8
    arrs = _rng_arrays(4, [(b, S, H, P), (b, S, H), (H,), (b, S, G, N),
                           (b, S, G, N)], [1, 1, 0.5, 0.3, 0.3])
    arrs[1] = np.abs(arrs[1])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    got = torch.autograd.grad(ssd.ssd_scan(*leaves, chunk=8)[1].sum(),
                              leaves, allow_unused=True)
    want = torch.autograd.grad(ssd.ssd_plain(*leaves, chunk=8)[1].sum(),
                               leaves, allow_unused=True)
    assert got[4] is None and want[4] is None     # C reaches y only
    for g, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["train", "train-moe", "train-mla"])
def test_chip_smoke_gradient_leaves_exist_at_each_depth(path):
    """Each gradient leaf that chip_smoke.py's train path gates names a
    parameter of its arch at the path's depth, and of the fp32 twin at the
    twin's depth, with an index that picks one matrix; the card run raises
    on a missing one. The smoke configs keep the reference's layer layout
    (the dense first layer of the MoE archs), so the paths are the card's."""
    import importlib.util
    from pathlib import Path
    spec_ = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(chip_smoke)
    spec = chip_smoke.TRAIN_PATHS[path]
    assert set(spec["leaves"]) == set(spec["twin_leaves"])
    assert set(spec["bf16_gated"]) <= set(spec["leaves"])
    for layers, leaves in ((spec["layers"], spec["leaves"]),
                           (spec["twin_layers"], spec["twin_leaves"])):
        cfg = get_smoke_config(spec["arch"]).replace(num_layers=layers)
        params = dict(LM(cfg, device="cpu").named_parameters())
        for label, (name, i) in leaves.items():
            assert name in params, (layers, label, name)
            leaf = params[name] if i is None else params[name][i]
            assert leaf.dim() == 2, (layers, label, name, leaf.shape)
