"""Port vs reference: the MoE block (local dispatch), Multi-head Latent
Attention, and the two models built from them, on the CPU.

deepseek-moe-16b (MHA layers, 1 dense + MoE layers) and deepseek-v2-236b
(MLA layers, 1 dense + MoE layers), each at its smoke config in fp32.
Weights come from the JAX ``LM.init(PRNGKey(0))`` through
``repro_torch.bridge.load_jax_numpy`` (a block's own weights from
``repro.models.layers.init_params``); inputs from a numpy seed.

Tolerance (the same fp32 math summed in another order), that of
``test_torch_archs.py``: each array within a relative L2 error of 1e-4,
and each element within 1e-4 of itself plus 2e-4 of the array's scale
(its largest element, at least 1). The routing must agree exactly: the
same experts (ties to the lower index, as ``jax.lax.top_k``), the same
kept and dropped token copies. The port's combine sums each token's K
expert outputs in top-k order where the reference adds them by scatter
in expert order, inside that tolerance. One AdamW step of each model is
held at ``test_torch_archs.py``'s train-step limits. The ``gpu`` tests
hold the flash kernels at MLA's head dim 192, forward and backward, to
their plain versions on a card. JAX is imported inside the tests, so that
a host without it (the card's) can collect this file.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models.layers import flatten_paths, tree_map
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine, state_to

ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
TOL = 1e-4
B, S = 2, 64


def _close(got, want, err_msg=""):
    """Relative L2 error at most 1e-4; elementwise rtol 1e-4 and atol 2e-4
    of the array's scale (its largest element, at least 1)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= TOL, f"{err_msg}: relative L2 error {rel:.3e}"
    np.testing.assert_allclose(got, want, rtol=TOL, atol=2 * TOL * scale,
                               err_msg=err_msg)


def _np(t):
    return t.detach().float().numpy()


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _configs(arch, **moe_kw):
    """The port's and the reference's smoke configs of ``arch``."""
    from repro.configs.base import get_smoke_config as jax_smoke_config
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if moe_kw:
        cfg, jcfg = _with_moe(cfg, **moe_kw), _with_moe(jcfg, **moe_kw)
    return cfg, jcfg


def _block_params(defs_fn, jcfg, seed=0):
    """A block's JAX params (``init_params`` of its defs) and their torch
    copies."""
    import jax
    import jax.numpy as jnp
    from repro.models.layers import init_params
    jp = init_params(defs_fn(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, jp))
    return jp, tp


def _x(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _crowded(seed, *shape):
    """Tokens that share one direction (3 times a fixed unit row plus
    noise), so the router sends many to the same experts and a capacity
    factor of 1.25 drops copies."""
    common = _x(100, shape[-1])
    return (_x(seed, *shape) + 3 * common / np.linalg.norm(common)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------


def _moe_pair(cf, seed=0):
    from repro.models import moe as JMOE
    cfg, jcfg = _configs("deepseek-moe-16b", capacity_factor=cf)
    jp, tp = _block_params(JMOE.moe_def, jcfg, seed)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_local_matches_jax(cf):
    """y and aux of ``moe_apply`` against the reference's ``_moe_local``;
    at capacity factor 1.25 some token copies really are dropped."""
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    cfg, jcfg, jp, tp = _moe_pair(cf)
    x = _crowded(1, 4, 16, cfg.d_model)
    jy, jaux = JMOE._moe_local(jcfg, jp, jnp.asarray(x))
    y, aux = MOE.moe_apply(cfg, tp, torch.from_numpy(x))
    T, K = 64, cfg.moe.top_k
    _, _, eidx = MOE.route(cfg, tp, torch.from_numpy(x).reshape(T, -1))
    _, keep, _ = MOE.dispatch(eidx, cfg.moe.num_experts,
                              MOE._capacity(T, cfg))
    dropped = T * K - int(keep.sum())
    assert (dropped > 0) if cf < 2 else (dropped == 0), dropped
    _close(_np(y), jy, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)


def _dense_ref(cfg, p, x):
    """tests/test_moe.py::_dense_ref in torch: every expert on every token,
    weighted by the renormalised top-k gates (no capacity)."""
    m = cfg.moe
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    g, idx = torch.topk(probs, m.top_k)
    g = g / g.sum(-1, keepdim=True)
    y = torch.zeros_like(xf)
    for e in range(m.num_experts):
        h = torch.nn.functional.silu(xf @ p["wi_gate"][e]) * \
            (xf @ p["wi_up"][e])
        y += (h @ p["wo"][e]) * ((idx == e) * g).sum(-1)[:, None]
    sp = p["shared"]
    y += (torch.nn.functional.silu(xf @ sp["wi_gate"]) *
          (xf @ sp["wi_up"])) @ sp["wo"]
    return y.reshape(x.shape)


def test_moe_local_matches_dense_reference():
    """At capacity factor 8 nothing drops, and the sort-based dispatch is
    every expert's output weighted by its gate (tests/test_moe.py's
    limits)."""
    cfg, _, _, tp = _moe_pair(8.0)
    x = torch.from_numpy(_x(2, 4, 16, cfg.d_model))
    y, aux = MOE.moe_apply(cfg, tp, x)
    np.testing.assert_allclose(_np(y), _np(_dense_ref(cfg, tp, x)),
                               rtol=1e-4, atol=1e-4)
    assert aux.item() > 0


def _jax_dispatch(eidx, E, C):
    """The reference's dispatch lines (``_moe_local``): stable argsort,
    position in the expert, keep, destination row."""
    import jax.numpy as jnp
    e_flat = eidx.reshape(-1)
    order = jnp.argsort(e_flat)
    se = e_flat[order]
    counts = jnp.zeros((E,), jnp.int32).at[e_flat].add(1)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(e_flat.shape[0]) - starts[se]
    keep = pos_in_e < C
    return order, keep, jnp.where(keep, se * C + pos_in_e, E * C)


def test_moe_ties_route_as_jax():
    """A hand-built router with exactly tied probabilities: each token is
    a unit vector, so its logits are a router row read without rounding.
    Rows like [0.2, 0.3, 0.3, 0.2, ...] tie inside the top k, across its
    edge and outside it; the port's experts, their order, the kept copies
    at a capacity that drops and the block's output equal JAX's."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JMOE
    cfg, jcfg, jp, tp = _moe_pair(0.25)
    D, E, K = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    rows = np.array([[0.2, 0.3, 0.3, 0.2, 0.1, 0.1, 0.0, 0.0],
                     [0.5, 0.1, 0.5, 0.5, 0.1, 0.0, 0.0, 0.2],
                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                     [0.1, 0.4, 0.2, 0.4, 0.2, 0.4, 0.3, 0.1]], np.float32)
    router = np.zeros((D, E), np.float32)
    router[:len(rows)] = rows
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    T = 48
    x = np.zeros((T, D), np.float32)
    x[np.arange(T), np.random.RandomState(3).randint(0, len(rows), T)] = 1.0
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), -1)
    _, jidx = jax.lax.top_k(probs, K)
    _, _, eidx = MOE.route(cfg, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jidx))
    row = x[:, :len(rows)].argmax(1)
    for r, want in enumerate(([1, 2], [0, 2], [0, 1], [1, 3])):
        assert (row == r).any()
        np.testing.assert_array_equal(eidx.numpy()[row == r],
                                      np.tile(want, ((row == r).sum(), 1)))
    C = MOE._capacity(T, cfg)
    order, keep, dest = MOE.dispatch(eidx, E, C)
    jorder, jkeep, jdest = _jax_dispatch(jidx, E, C)
    assert not bool(keep.all())                   # the capacity drops
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    jy, jaux = JMOE._moe_local(jcfg, jp, jnp.asarray(x)[None])
    y, aux = MOE.moe_apply(cfg, tp, torch.from_numpy(x)[None])
    _close(_np(y), jy, "y")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)


def test_moe_dropped_copies_only_fill_the_spare_row():
    """Every kept copy has its own buffer row; only the spare row E*C
    receives more than one."""
    cfg, _, _, tp = _moe_pair(1.25)
    T = 64
    _, _, eidx = MOE.route(cfg, tp,
                           torch.from_numpy(_crowded(4, T, cfg.d_model)))
    E, C = cfg.moe.num_experts, MOE._capacity(T, cfg)
    _, keep, dest = MOE.dispatch(eidx, E, C)
    kept = dest[keep]
    assert len(set(kept.tolist())) == len(kept) and int(kept.max()) < E * C
    assert bool((dest[~keep] == E * C).all()) and int((~keep).sum()) > 0


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_forward_prefill_cache_and_decode_match_jax(q_lora):
    """``mla_forward``, the prefill's cache and one ``mla_decode`` step
    (cache rows written in place) against the reference's, with the
    low-rank q projection and with the full-rank one."""
    import jax.numpy as jnp
    from repro.models import attention as JA
    cfg, jcfg = _configs("deepseek-v2-236b")
    if not q_lora:
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, q_lora_rank=0))
        jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
    jp, tp = _block_params(JA.mla_def, jcfg, 5)
    assert ("wq_a" in tp) == q_lora and ("wq" in tp) != q_lora
    Sp, cap = 24, 32
    x = _x(6, B, Sp, cfg.d_model)
    pos = np.broadcast_to(np.arange(Sp, dtype=np.int32), (B, Sp))
    jy = JA.mla_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    _close(_np(A.mla_forward(cfg, tp, tx, tpos)), jy, "mla_forward")
    jcache = JA.mla_prefill_cache(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                  capacity=cap)
    y, cache = A.mla_prefill(cfg, tp, tx, tpos, capacity=cap)
    _close(_np(y), jy, "mla_prefill")
    direct = A.mla_prefill_cache(*A._mla_ckv(cfg, tp, tx, tpos), cap)
    for key in ("ckv", "kpe"):
        assert tuple(cache[key].shape) == tuple(jcache[key].shape)
        _close(_np(cache[key]), jcache[key], key)
        assert torch.equal(direct[key], cache[key]), key
    x1 = _x(7, B, 1, cfg.d_model)
    p1 = np.array([Sp, Sp - 5], np.int32)      # rows of unequal length
    jy1, jcache1 = JA.mla_decode(jcfg, jp, jnp.asarray(x1), jcache,
                                 jnp.asarray(p1))
    y1, cache1 = A.mla_decode(cfg, tp, torch.from_numpy(x1), cache,
                              torch.from_numpy(p1))
    assert cache1["ckv"] is cache["ckv"]               # written in place
    _close(_np(y1), jy1, "mla_decode")
    for key in ("ckv", "kpe"):
        _close(_np(cache1[key]), jcache1[key], f"decoded {key}")


# ---------------------------------------------------------------------------
# The two models
# ---------------------------------------------------------------------------


def _pair(arch, **moe_kw):
    import jax
    from repro.models.model import LM as JaxLM
    cfg, jcfg = _configs(arch, **moe_kw)
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    load_jax_numpy(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _batch(cfg, seed, n=S):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _assert_cache_close(cache, jcache):
    import jax
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    n = 0
    for path, jleaf in jax.tree_util.tree_leaves_with_path(jcache["layers"]):
        node = cache["layers"]
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert tuple(node.shape) == tuple(jleaf.shape), \
            jax.tree_util.keystr(path)
        _close(_np(node), jleaf, err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n == len(list(flatten_paths(cache["layers"])))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    """Logits and the summed aux loss of the forward, and the loss's ce
    and aux; the dense layer is the stack's unrolled head, of width
    ``moe.d_ff_dense``."""
    import jax.numpy as jnp
    jlm, params, lm = _pair(arch)
    assert lm.decoder.head_kinds[0][1] == "dense"
    assert all(k[1] == "moe" for k in lm.decoder.period_kinds)
    assert tuple(lm.decoder.head[0].mlp.wi_gate.shape) == \
        (lm.cfg.d_model, lm.cfg.moe.d_ff_dense)
    tokens = _batch(lm.cfg, 0)
    jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens":
                                                torch.from_numpy(tokens)}
    want, jaux, _ = jlm.forward(params, jb)
    jloss, jm = jlm.loss(params, jb)
    with torch.no_grad():
        got, aux, off = lm(tb)
        loss, m = lm.loss(tb)
    assert off == 0 and aux.item() > 0
    _close(_np(got), want, "logits")
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(arch):
    """Every prefill cache leaf (k/v of MHA layers, ``ckv``/``kpe`` of MLA
    layers), the last logits, then one decode step's logits and cache."""
    import jax.numpy as jnp
    jlm, params, lm = _pair(arch)
    tokens = _batch(lm.cfg, 1)
    jcache, jlast = jlm.prefill(params, {"tokens": jnp.asarray(tokens)},
                                S + 8)
    cache, last = lm.prefill({"tokens": torch.from_numpy(tokens)}, S + 8)
    _close(_np(last), jlast, "last logits")
    _assert_cache_close(cache, jcache)
    if lm.cfg.mla is not None:
        ckv = cache["layers"]["core"][0]["ckv"]
        assert tuple(ckv.shape) == (lm.decoder.n_periods, B, S + 8,
                                    lm.cfg.mla.kv_lora_rank)
    nxt = np.random.RandomState(3).randint(0, lm.cfg.vocab_size, (B, 1)) \
        .astype(np.int32)
    jcache, jlog = jlm.decode_step(params, jcache, jnp.asarray(nxt))
    cache, lg = lm.decode_step(cache, torch.from_numpy(nxt))
    _close(_np(lg), jlog, "decode logits")
    _assert_cache_close(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_archs.py::test_smoke_decode_matches_forward, torch side,
    at capacity factor 64 (no drops at T = 130 or at T = 2): the prefill's
    last logits are the forward's, a decode step's the forward's over one
    more token."""
    _, _, lm = _pair(arch, capacity_factor=64.0)
    tokens = torch.from_numpy(_batch(lm.cfg, 4))
    cache, last = lm.prefill({"tokens": tokens}, S + 8)
    nxt = torch.from_numpy(np.random.RandomState(5).randint(
        0, lm.cfg.vocab_size, (B, 1)).astype(np.int32))
    cache, dec = lm.decode_step(cache, nxt)
    with torch.no_grad():
        full, _, _ = lm({"tokens": tokens})
        full2, _, _ = lm({"tokens": torch.cat([tokens, nxt], 1)})
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(dec), _np(full2[:, -1]), rtol=2e-2,
                               atol=2e-2)


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step through ``LM.loss`` (ce plus the MoE aux loss) and
    ``optim.adamw.make_train_step`` against the reference's jitted step,
    with the limits of ``test_torch_archs.py::test_train_step_matches_jax``:
    loss, ce, aux and grad_norm at 1e-4, every param within 2 * lr of
    JAX's (at step 1 a gradient near 0 may take the other sign). The
    gradients reach the router, the experts, the shared experts and, for
    deepseek-v2, MLA's low-rank projections through the flash backward at
    the smoke head dim (qk 16 + 8, v zero-padded from 16 to 24)."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    jlm, params, lm = _pair(arch)
    tokens = _batch(lm.cfg, 6)
    jstate = jadamw.init_state(params)
    jstate, jm = jax.jit(jadamw.make_train_step(
        jlm, jadamw.OptConfig(**OPT)))(jstate, {"tokens": jnp.asarray(tokens)})
    state = adamw.init_state(lm)
    before = {n: p.detach().clone() for n, p in state["params"].items()}
    state, m = adamw.make_train_step(lm, adamw.OptConfig(**OPT))(
        state, {"tokens": torch.from_numpy(tokens)})
    assert int(state["step"]) == int(jstate["step"]) == 1
    assert float(m["aux"]) > 0
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=TOL,
                                   err_msg=key)
    lr = float(jm["lr"])
    want = dict(flatten_paths(jax.tree.map(np.asarray, jstate["params"])))
    assert want.keys() == state["params"].keys()
    for name, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2 * lr, err_msg=name)
    moved = {n for n, p in state["params"].items()
             if not torch.equal(p, before[n])}
    leaves = ["decoder.core.0.mlp.router", "decoder.core.0.mlp.wi_gate",
              "decoder.core.0.mlp.shared.wo", "head"]
    leaves += (["decoder.head.0.mixer.wq_a", "decoder.head.0.mixer.wkv_a",
                "decoder.head.0.mixer.wkv_b"] if lm.cfg.mla is not None
               else ["decoder.head.0.mixer.wq", "decoder.head.0.mixer.wk"])
    assert set(leaves) <= moved, set(leaves) - moved


def _serve(eng, reqs, hand_off=None):
    """Submit in order as slots free up; step until every request is done.
    ``hand_off(eng)`` runs after the third step and returns the engine that
    carries on."""
    pending = list(reqs)
    while pending or any(eng.active):
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
        if hand_off is not None and eng.steps == 3:
            eng, hand_off = hand_off(eng), None
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax_engine_across_a_hand_off(arch):
    """The port's engine against the JAX engine, slots (3) != n_periods
    (2): the same streams, and again with the state dumped to host memory
    and restored into a fresh engine after the third step. Idle slots
    route their tokens too, in both. deepseek-moe-16b's cache holds k/v
    rows, deepseek-v2's MLA layers compressed ``ckv``/``kpe`` rows."""
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServingEngine as JaxEngine
    jlm, params, lm = _pair(arch)
    assert lm.decoder.n_periods == 2
    assert ("ckv" in lm.init_cache(1, 8)["layers"]["core"][0]) == \
        (lm.cfg.mla is not None)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, rng.randint(5, 14)).astype(np.int32)
               for _ in range(4)]
    want = _serve(JaxEngine(jlm, params, slots=3, capacity=64),
                  [JaxRequest(i, p, max_new=6)
                   for i, p in enumerate(prompts)])

    def reqs():
        return [Request(i, p, max_new=6) for i, p in enumerate(prompts)]

    def hand_off(eng):
        blob = copy.deepcopy(state_to(eng.state_dict(), "cpu"))
        fresh = ServingEngine(lm, slots=3, capacity=64, device="cpu")
        fresh.load_state_dict(blob)
        fresh.active = eng.active
        return fresh

    got = _serve(ServingEngine(lm, slots=3, capacity=64, device="cpu"),
                 reqs())
    moved = _serve(ServingEngine(lm, slots=3, capacity=64, device="cpu"),
                   reqs(), hand_off=hand_off)
    assert got == want and moved == want
    assert all(len(s) == 6 for s in got)


def test_bridge_carries_moe_and_mla_leaves():
    """The nested ``mlp.shared.*`` and MLA's ``wq_a``/``q_norm``/``wq_b``/
    ``wkv_a``/``kv_norm``/``wkv_b`` arrive at their paths bit for bit; a
    tree without them is refused."""
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    arch = "deepseek-v2-236b"
    params = jax.tree.map(np.asarray, JaxLM(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    lm = LM(get_smoke_config(arch), device="cpu")
    want = dict(flatten_paths(params))
    names = set(dict(lm.named_parameters()))
    assert names == want.keys()
    for leaf in ("mlp.shared.wi_gate", "mlp.shared.wi_up", "mlp.shared.wo",
                 "mlp.router", "mixer.wq_a", "mixer.q_norm", "mixer.wq_b",
                 "mixer.wkv_a", "mixer.kv_norm", "mixer.wkv_b"):
        assert f"decoder.core.0.{leaf}" in names, leaf
    assert "decoder.head.0.mixer.wkv_b" in names
    load_jax_numpy(lm, params)
    for name, p in lm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
    for drop in (("mlp", "shared"), ("mixer", "wkv_b")):
        bad = copy.deepcopy(params)
        del bad["decoder"]["core"][0][drop[0]][drop[1]]
        with pytest.raises(KeyError, match="missing"):
            load_jax_numpy(lm, bad)


def test_cast_weights_keeps_the_router_in_fp32():
    """The reference reads the router in fp32 (the experts and MLA's
    matrices in the compute dtype at each use): ``cast_weights`` leaves
    every router as it is."""
    lm = LM(get_smoke_config("deepseek-v2-236b").replace(dtype="bfloat16"),
            device="cpu").cast_weights()
    params = dict(lm.named_parameters())
    assert params["decoder.core.0.mlp.router"].dtype == torch.float32
    for name in ("decoder.core.0.mlp.wi_gate", "decoder.core.0.mlp.shared.wo",
                 "decoder.core.0.mixer.wkv_b", "decoder.head.0.mlp.wi_up"):
        assert params[name].dtype == torch.bfloat16, name
    assert params["decoder.core.0.mixer.kv_norm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The flash kernels at MLA's head dim 192
# ---------------------------------------------------------------------------


def test_mla_prefill_at_full_width_calls_flash_at_head_dim_192(monkeypatch):
    """deepseek-v2's MLA head widths (qk_nope 128, qk_rope 64, v 128) give
    the flash wrapper q, k and a zero-padded v at head dim 192 with scale
    192**-0.5: bf16 routes to the tensor-core kernel, and TMA can read all
    three in place."""
    from repro_torch.configs.base import MLAConfig
    cfg = get_smoke_config("deepseek-v2-236b").replace(
        num_heads=2, num_layers=1, dtype="bfloat16",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))
    p = LM(cfg, device="cpu").cast_weights().decoder.head[0].mixer
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return fa.attention_plain(q, k, v, **kw)
    monkeypatch.setattr(fa, "flash_attention", spy)
    x = torch.randn(1, 40, cfg.d_model).to(torch.bfloat16)
    with torch.no_grad():
        y = A.mla_forward(cfg, p, x, torch.arange(40)[None])
    assert y.shape == x.shape
    (q, k, v, kw), = seen
    assert q.shape == k.shape == v.shape == (1, 40, 2, 192)
    assert kw["scale"] == 192 ** -0.5 and kw["causal"]
    assert bool((v[..., 128:] == 0).all())
    assert fa.kernel_for(q.dtype, 192) == "tc"
    fa.check_tma(q=q, k=k, v=v)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_cuda_forward_at_head_dim_192_matches_plain_version():
    """Both forward kernels at head dim 192 against the plain version on
    the card: bf16 on the tensor-core kernel (64-key tiles), fp32 on the
    FMA one, causal MHA with v zero-padded from 128 as MLA gives it (the
    padded columns come out 0), ragged S, GQA and the other masks; each
    case's kernel counted by its own counter. Limits of chip_smoke.py's
    sweep: 2e-2 (bf16) or 2e-5 (fp32) elementwise and a relative L2 error
    of 1e-2 or 1e-5."""
    _cuda()
    tol = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (2e-5, 1e-5)}
    cases = [((1, S_, S_, 8, 8), dict(causal=True), True)
             for S_ in (128, 333)]
    cases += [((2, 77, 77, 4, 2), dict(causal=False), False),
              ((1, 100, 333, 8, 2), dict(causal=True, window=111), False),
              ((1, 128, 128, 4, 4), dict(causal=True, softcap=20.0), False)]
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for (B_, Sq, Sk, H, Kh), kw, pad in cases:
            q = torch.randn((B_, Sq, H, 192), generator=g, device="cuda")
            k = torch.randn((B_, Sk, Kh, 192), generator=g, device="cuda")
            v = torch.randn((B_, Sk, Kh, 192), generator=g, device="cuda")
            if pad:
                v[..., 128:] = 0.0
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            route = fa.kernel_for(dt, 192)
            assert route == ("tc" if dt == torch.bfloat16 else "fma")
            before = (fa.launches_tc, fa.launches_fma)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert (fa.launches_tc - before[0], fa.launches_fma - before[1]) \
                == ((1, 0) if route == "tc" else (0, 1))
            want = fa.attention_plain(q, k, v, **kw)
            elem, rel_l2 = tol[dt]
            np.testing.assert_allclose(
                got.float().cpu().numpy(), want.float().cpu().numpy(),
                rtol=elem, atol=elem, err_msg=f"{dt} {Sq} {kw}")
            rel = ((got.float() - want.float()).norm() /
                   want.float().norm()).item()
            assert rel <= rel_l2, (dt, Sq, kw, rel)
            if pad:
                assert bool((got[..., 128:] == 0).all())


@pytest.mark.gpu
def test_cuda_backward_at_head_dim_192_matches_plain_version():
    """Both backward routes at head dim 192 against ``attention_bwd_plain``
    on the card, through the FlashAttention Function (the forward kernel
    with its log-sum-exp, then the backward kernels): bf16 on the
    tensor-core kernels (one shared 64-key tile), fp32 on the FMA ones;
    causal MHA with v and the output's gradient zero-padded from 128 as
    MLA gives them (dv's padded columns come out exactly 0), ragged S, GQA
    with a head split and the other masks; each case's route counted by
    its own counter. Limits of chip_smoke.py's ``sweep-bwd``: 2e-2 (bf16)
    or 2e-5 (fp32) elementwise and a relative L2 error of 1e-2 or
    1e-5."""
    _cuda()
    tol = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (2e-5, 1e-5)}
    cases = [((1, S_, S_, 8, 8), dict(causal=True), True)
             for S_ in (128, 333)]
    cases += [((2, 77, 77, 4, 2), dict(causal=False), False),
              ((1, 100, 333, 8, 2), dict(causal=True, window=111), False),
              ((1, 128, 128, 4, 4), dict(causal=True, softcap=20.0), False)]
    g = torch.Generator(device="cuda").manual_seed(1)
    for dt in (torch.bfloat16, torch.float32):
        for (B_, Sq, Sk, H, Kh), kw, pad in cases:
            q = torch.randn((B_, Sq, H, 192), generator=g, device="cuda")
            k = torch.randn((B_, Sk, Kh, 192), generator=g, device="cuda")
            v = torch.randn((B_, Sk, Kh, 192), generator=g, device="cuda")
            do = torch.randn((B_, Sq, H, 192), generator=g, device="cuda")
            if pad:
                v[..., 128:] = 0.0
                do[..., 128:] = 0.0
            q, k, v, do = q.to(dt), k.to(dt), v.to(dt), do.to(dt)
            route = fa.bwd_kernel_for(dt, 192)
            assert route == ("tc" if dt == torch.bfloat16 else "fma")
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            before = (fa.launches_bwd_tc, fa.launches_bwd_fma)
            out = fa.flash_attention(*leaves, **kw)
            got = torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            assert (fa.launches_bwd_tc - before[0],
                    fa.launches_bwd_fma - before[1]) == \
                ((1, 0) if route == "tc" else (0, 1))
            o, lse = fa.attention_fwd_lse_plain(q, k, v, **kw)
            want = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
            elem, rel_l2 = tol[dt]
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                np.testing.assert_allclose(
                    a.float().cpu().numpy(), b.float().cpu().numpy(),
                    rtol=elem, atol=elem, err_msg=f"{name} {dt} {Sq} {kw}")
                rel = ((a.float() - b.float()).norm() /
                       b.float().norm()).item()
                assert rel <= rel_l2, (name, dt, Sq, kw, rel)
            if pad:
                assert bool((got[2][..., 128:] == 0).all())
