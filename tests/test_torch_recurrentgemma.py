"""Port vs reference: the recurrentgemma-9b smoke LM (RG-LRU ``rec`` and
sliding-window ``local`` layers, d_model 64, MQA 4x16, window 32) and the
gemma3-1b smoke LM (local + global MQA, qk_norm) in fp32 on the CPU.

recurrentgemma runs at its smoke depth (5 layers: no stacked core, all
tail) and at 7 layers (two ``(rec, rec, local)`` periods in the stacked core
plus one ``rec``), so the rec ``conv``/``h`` and local ``k``/``v``/
``slot_pos`` leaves are checked both per layer and stacked over periods.

Weights come from the JAX ``LM.init(PRNGKey(0))`` and cross to the port
through ``repro_torch.bridge.load_jax_numpy``; tokens come from numpy
seeds. Tolerance rtol = atol = 1e-4: the same fp32 math, summed in another
order. JAX is imported inside the fixtures and tests, so that a host
without it (the card's) can collect this file.

One exception, with its cause measured: the 7-layer model against JAX is
held to a relative L2 error of 1e-3 per tensor (RG7_REL_L2) instead. The
reference's RG-LRU gate ``beta = sqrt(max(1 - exp(2 log a), 1e-12))``
cancels where ``sigmoid(gate_a)`` is near 0, which the reference's init
gives often (its block-diagonal gates draw with std 0.5 and reach |100|):
there ONE ulp of ``exp`` moves beta from 1e-6 to 2.4e-4
(``test_beta_cancellation_turns_one_ulp_into_a_large_step``), and torch's
and XLA's CPU ``exp``/``sigmoid`` differ by an ulp on some inputs. In those
lanes ``a`` is 1, so the step persists in h. Measured, port against JAX:
relative L2 5.5e-5 on the 7-layer logits, up to 1.8e-4 on its caches,
with single elements off by up to 1e-2; JAX's own three RG-LRU codes
(blocked, ref, Pallas) agree within 4e-6, since they share XLA's ``exp``.
The 7-layer model's stacked core is held bit for bit against the same
weights run unrolled (``test_stacked_core_equals_unrolled_layers``), and
its engine streams against JAX's token for token.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import LM, params_tree
from repro_torch.serving.engine import Request, ServingEngine, state_to

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-4, atol=1e-4)
RG7_REL_L2 = 1e-3   # the 7-layer model against JAX (see above)
CAP = 64            # > the smoke window of 32: local caches hold 32 slots
# the recurrentgemma depths and gemma3-1b at its smoke depth (8 layers)
MODELS = {"rg5": (ARCH, None), "rg7": (ARCH, 7), "gemma3": ("gemma3-1b",
                                                            None)}


@pytest.fixture(scope="module")
def pair():
    """``pair(which)`` -> (JAX LM, JAX params, port LM) on the same weights,
    built once per module."""
    built = {}

    def get(which):
        if which not in built:
            import jax
            from repro.configs.base import \
                get_smoke_config as jax_smoke_config
            from repro.models.model import LM as JaxLM
            arch, num_layers = MODELS[which]
            jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
            if num_layers is not None:
                jcfg = jcfg.replace(num_layers=num_layers)
                cfg = cfg.replace(num_layers=num_layers)
            jlm = JaxLM(jcfg)
            params = jlm.init(jax.random.PRNGKey(0))
            lm = LM(cfg, device="cpu")
            load_jax_numpy(lm, jax.tree.map(np.asarray, params))
            built[which] = (jlm, params, lm)
        return built[which]
    return get


def _tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, which, msg=""):
    """``got`` (torch) against ``want`` (JAX) at TOL, or for the 7-layer
    model at RG7_REL_L2 (see the module's docstring)."""
    got, want = _np(got), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, msg
    if which != "rg7":
        np.testing.assert_allclose(got, want, **TOL, err_msg=msg)
        return
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= RG7_REL_L2, (msg, rel)


def _leaf(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", getattr(key, "idx", None))]
    return tree


@pytest.mark.parametrize("which", ["rg5", "rg7"])
def test_bridge_and_stack_split_match_reference(which, pair):
    import jax
    from repro_torch.models.layers import flatten_paths
    jlm, params, lm = pair(which)
    assert lm.decoder.n_periods == jlm.decoder.n_periods
    assert len(lm.decoder.tail_kinds) == len(jlm.decoder.tail)
    names = dict(lm.named_parameters())
    jtree = jax.tree.map(np.asarray, params)
    assert dict(flatten_paths(jtree)).keys() == names.keys()
    if which == "rg7":
        assert lm.decoder.n_periods == 2
        assert names["decoder.core.0.mixer.w_ga"].shape == (2, 4, 16, 16)
        assert names["decoder.core.0.mixer.a_log"].shape == (2, 64)
        assert names["decoder.core.2.mixer.wk"].shape == (2, 64, 16)
        assert names["decoder.core.0.mlp.wi_gate"].shape == (2, 64, 128)
    else:
        assert lm.decoder.n_periods == 0
        assert names["decoder.tail.1.mixer.conv_w"].shape == (4, 64)
    for path, arr in flatten_paths(jtree):
        np.testing.assert_array_equal(_np(names[path]), arr)


@pytest.mark.parametrize("fn", ["_conv_full", "_block_gate", "rec_forward",
                                "rec_decode", "attn_forward_local",
                                "layer_apply_rec", "layer_apply_local"])
def test_layer_functions_match_jax(fn, pair):
    """The recurrent block's pieces, the local attention and both layers on
    the 5-layer model's bridged weights (tail layers 0 (rec) and 2
    (local))."""
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import model as JM
    from repro.models import rglru as JR
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import rglru as R
    jlm, params, lm = pair("rg5")
    cfg = lm.cfg
    layer = 2 if fn.endswith("local") else 0
    jp = params["decoder"]["tail"][layer]
    p = params_tree(lm.decoder)["tail"][layer]
    rng = np.random.RandomState(6)
    B, T, D = 2, 45, cfg.d_model          # T > the window of 32
    Rw, nh, bh = R._dims(cfg)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    with torch.no_grad():
        if fn == "_conv_full":
            u = rng.standard_normal((B, T, Rw)).astype(np.float32)
            got = R._conv_full(torch.from_numpy(u), p["mixer"]["conv_w"])
            want = JR._conv_full(jnp.asarray(u), jp["mixer"]["conv_w"])
        elif fn == "_block_gate":
            u = rng.standard_normal((B, T, Rw)).astype(np.float32)
            b = rng.standard_normal(Rw).astype(np.float32)
            got = R._block_gate(torch.from_numpy(u), p["mixer"]["w_ga"],
                                torch.from_numpy(b), nh, bh)
            want = JR._block_gate(jnp.asarray(u), jp["mixer"]["w_ga"],
                                  jnp.asarray(b), nh, bh)
        elif fn == "rec_forward":
            got = R.rec_forward(cfg, p["mixer"], torch.from_numpy(x))
            want = JR.rec_forward(jlm.cfg, jp["mixer"], jnp.asarray(x))
        elif fn == "rec_decode":
            conv = rng.standard_normal((B, cfg.rnn_conv - 1, Rw)).astype(
                np.float32)
            h = rng.standard_normal((B, Rw)).astype(np.float32)
            cache = {"conv": torch.from_numpy(conv.copy()),
                     "h": torch.from_numpy(h.copy())}
            got, new = R.rec_decode(cfg, p["mixer"],
                                    torch.from_numpy(x[:, :1]), cache)
            assert new is cache                 # updated in place
            want, jnew = JR.rec_decode(jlm.cfg, jp["mixer"],
                                       jnp.asarray(x[:, :1]),
                                       {"conv": jnp.asarray(conv),
                                        "h": jnp.asarray(h)})
            for k in ("conv", "h"):
                np.testing.assert_allclose(_np(cache[k]), np.asarray(jnew[k]),
                                           **TOL)
        elif fn == "attn_forward_local":
            got = A.attn_forward(cfg, p["mixer"], torch.from_numpy(x),
                                 torch.from_numpy(pos), kind="local")
            want = JA.attn_forward(jlm.cfg, jp["mixer"], jnp.asarray(x),
                                   jnp.asarray(pos), kind="local")
        else:
            kind = ("local" if fn.endswith("local") else "rec", "dense")
            got, aux = M.layer_apply(cfg, kind, p, torch.from_numpy(x),
                                     {"positions": torch.from_numpy(pos)})
            assert float(aux) == 0.0
            want, _ = JM.layer_apply(jlm.cfg, kind, jp, jnp.asarray(x),
                                     {"positions": jnp.asarray(pos)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("which", ["rg5", "rg7", "gemma3"])
def test_forward_logits_match_jax(which, pair):
    import jax.numpy as jnp
    jlm, params, lm = pair(which)
    tok = _tokens(0, 2, 45)          # longer than the window of 32
    want, _, _ = jlm.forward(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux, off = lm({"tokens": torch.from_numpy(tok)})
    assert off == 0 and float(aux) == 0.0
    _close(got, want, which)


@pytest.mark.parametrize("which,S", [("rg5", 20), ("rg7", 40),
                                     ("gemma3", 40)])
def test_prefill_cache_and_decode_match_jax(which, S, pair):
    """Prefill caches (rec conv and h; local k, v and slot_pos, wrapped
    when S > 32), last logits, then decode steps until the ring has
    wrapped (positions past 32 overwrite slots 0, 1, ...)."""
    import jax
    import jax.numpy as jnp
    jlm, params, lm = pair(which)
    B = 2
    tok = _tokens(1, B, S)
    jcache, jlast = jlm.prefill(params, {"tokens": jnp.asarray(tok)}, CAP)
    cache, last = lm.prefill({"tokens": torch.from_numpy(tok)}, CAP)
    _close(last, jlast, which)

    def same_leaves(what):
        jleaves = jax.tree_util.tree_leaves_with_path(jcache["layers"])
        keys = set()
        for path, jleaf in jleaves:
            leaf = _leaf(cache["layers"], path)
            keys.add(getattr(path[-1], "key", None))
            msg = f"{what} {jax.tree_util.keystr(path)}"
            assert leaf.shape == jleaf.shape, msg
            assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), msg
            if leaf.dtype == torch.int32:
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf),
                                              err_msg=msg)
            else:
                _close(leaf, jleaf, which, msg)
        return keys

    keys = same_leaves("prefill")
    if which == "gemma3":
        assert keys == {"k", "v", "slot_pos"}
    else:
        assert keys == {"conv", "h", "k", "v", "slot_pos"}
    if S > 32:                       # the window binds: the ring is wrapped
        sp = cache["layers"]["tail" if which != "rg7" else "core"][2][
            "slot_pos"]
        assert int(sp.max()) == S - 1 and int(sp.min()) == S - 32
    rng = np.random.RandomState(2)
    for _ in range(34 - S if S < 32 else 4):
        nxt = rng.randint(0, 512, (B, 1)).astype(np.int32)
        jcache, jlog = jlm.decode_step(params, jcache, jnp.asarray(nxt))
        cache, lg = lm.decode_step(cache, torch.from_numpy(nxt))
        _close(lg, jlog, which)
    same_leaves("decode")


def test_stacked_core_equals_unrolled_layers(pair):
    """The 7-layer model with its two periods stacked in the core gives bit
    for bit the logits and caches of the same weights run as 7 unrolled
    layers (``scan_layers=False``), through prefill and decode steps
    across the ring wrap."""
    _, _, lm = pair("rg7")
    flat = LM(lm.cfg.replace(scan_layers=False), device="cpu")
    assert flat.decoder.n_periods == 0 and len(flat.decoder.tail_kinds) == 7
    core, tail = params_tree(lm.decoder)["core"], \
        params_tree(lm.decoder)["tail"]
    per = len(lm.decoder.period_kinds)

    def unstack(tree, i):
        return {k: unstack(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    layers = [unstack(core[j], i) for i in range(2) for j in range(per)] \
        + tail
    with torch.no_grad():
        for dst, src in zip(params_tree(flat.decoder)["tail"], layers):
            for k, v in dst.items():
                if isinstance(v, dict):
                    for kk in v:
                        v[kk].copy_(src[k][kk])
                else:
                    v.copy_(src[k])
        flat.embed.copy_(lm.embed)
        flat.final_norm.scale.copy_(lm.final_norm.scale)
    tok = torch.from_numpy(_tokens(9, 2, 40))
    with torch.no_grad():
        assert torch.equal(flat({"tokens": tok})[0], lm({"tokens": tok})[0])
    c1, l1 = lm.prefill({"tokens": tok}, CAP)
    c2, l2 = flat.prefill({"tokens": tok}, CAP)
    for _ in range(3):
        assert torch.equal(l1, l2)
        got = [unstack(c1["layers"]["core"][j], i)
               for i in range(2) for j in range(per)] + c1["layers"]["tail"]
        for a, b in zip(got, c2["layers"]["tail"]):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
        c1, l1 = lm.decode_step(c1, tok[:, :1])
        c2, l2 = flat.decode_step(c2, tok[:, :1])


def test_beta_cancellation_turns_one_ulp_into_a_large_step():
    """The reference's beta = sqrt(max(1 - exp(2 log a), 1e-12)) where
    log a = -1.4691e-8 (a lane of the 7-layer model, sigmoid(gate_a) near
    0): exp(2 log a) rounds to 1.0 (JAX on the CPU) or to the float below
    it (torch on the CPU), one ulp apart; beta then reads 1e-6 or 2.44e-4,
    where the exact value is 1.71e-4."""
    from repro_torch.kernels import rglru
    below_one = torch.nextafter(torch.tensor(1.0), torch.tensor(0.0))
    beta = [torch.sqrt(torch.clamp_min(1.0 - e, 1e-12)).item()
            for e in (torch.tensor(1.0), below_one)]
    assert beta[0] == pytest.approx(1e-6) and beta[1] > 2.4e-4
    log_a = -1.4691350358475574e-08
    assert (1.0 - np.exp(2.0 * np.float64(log_a))) ** 0.5 == \
        pytest.approx(1.714e-4, rel=1e-3)
    # the port's plain gates compute exactly this formula
    a, b = rglru.gates(torch.ones(1, 1, 1), torch.zeros(1),
                       torch.full((1, 1, 1), -40.0), torch.full((1, 1, 1),
                                                                 40.0), 8.0)
    assert a.item() == 1.0 and b.item() == pytest.approx(1e-6)


@pytest.mark.parametrize("which,S", [("rg7", 28), ("rg5", 2),
                                     ("gemma3", 28)])
def test_decode_matches_forward(which, S, pair):
    """tests/test_archs.py::test_smoke_decode_matches_forward, torch side,
    across the ring wrap (28 + 6 > 32). S=2 is shorter than the RG-LRU
    conv window (rnn_conv - 1 = 3): the cache's pre-conv history is
    zero-padded as the full conv pads (the reference's prefill fails
    there)."""
    _, _, lm = pair(which)
    B = 2
    tok = torch.from_numpy(_tokens(3, B, S))
    cache, last = lm.prefill({"tokens": tok}, CAP)
    with torch.no_grad():
        full, _, _ = lm({"tokens": tok})
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), **TOL)
    seq = tok
    for i in range(6):
        nxt = torch.from_numpy(_tokens(4 + i, B, 1))
        cache, dec = lm.decode_step(cache, nxt)
        seq = torch.cat([seq, nxt], 1)
        with torch.no_grad():
            full, _, _ = lm({"tokens": seq})
        np.testing.assert_allclose(_np(dec), _np(full[:, -1]), **TOL)


def test_cast_weights_keeps_bf16_numbers_rglru():
    """Matrices held in bf16 (conv_w and the block-diagonal w_ga/w_gx
    among them, which the reference casts at each use) give bit for bit the
    logits of fp32 params cast at each use; a_log, b_ga and b_gx (made
    non-trivial here) stay fp32, as the reference reads them."""
    cfg = get_smoke_config(ARCH).replace(num_layers=7, dtype="bfloat16")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.split(".")[-1] in ("scale", "a_log", "b_ga", "b_gx"):
                p.normal_(0.0, 0.5, generator=g)
    tok = torch.from_numpy(_tokens(5, 2, 40))

    def run():
        with torch.no_grad():
            full, _, _ = lm({"tokens": tok})
            cache, last = lm.prefill({"tokens": tok}, CAP)
            _, dec = lm.decode_step(cache, tok[:, :1])
        return full, last, dec

    want = run()
    lm.cast_weights()
    dts = {n: p.dtype for n, p in lm.named_parameters()}
    for leaf in ("wx", "wg", "conv_w", "w_ga", "w_gx", "wo"):
        assert dts[f"decoder.core.0.mixer.{leaf}"] == torch.bfloat16
    for leaf in ("a_log", "b_ga", "b_gx"):
        assert dts[f"decoder.core.0.mixer.{leaf}"] == torch.float32
    assert dts["decoder.core.2.mixer.wq"] == torch.bfloat16
    assert dts["embed"] == torch.bfloat16
    assert dts["decoder.core.0.ln1.scale"] == torch.float32
    for g_, w_ in zip(run(), want):
        assert torch.equal(g_, w_)


# ---------------------------------------------------------------------------
# ServingEngine
# ---------------------------------------------------------------------------


def _prompts(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(5, 45)).astype(np.int32)
            for _ in range(n)]


def _serve(eng, reqs, hand_off=None):
    """Submit in order as slots free up; step until every request is done.
    ``hand_off(eng)`` is called after the third step and returns the engine
    that carries on."""
    pending = list(reqs)
    while pending or any(eng.active):
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
        if hand_off is not None and eng.steps == 3:
            eng, hand_off = hand_off(eng), None
    return [r.out for r in reqs]


def _reqs(prompts, max_new=6):
    return [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("which", ["rg5", "rg7"])
def test_streams_match_jax_engine(which, pair):
    """slots=3, not n_periods (0 or 2), to steer around the reference
    engine's shape-guessed slot write. Prompts up to 44 tokens wrap the
    local rings in prefill and in decode."""
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServingEngine as JaxEngine
    jlm, params, lm = pair(which)
    prompts = _prompts(5)
    jstreams = _serve(JaxEngine(jlm, params, slots=3, capacity=CAP),
                      [JaxRequest(i, p, max_new=6)
                       for i, p in enumerate(prompts)])
    streams = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                     _reqs(prompts))
    assert streams == jstreams
    assert all(len(s) == 6 for s in streams)


def test_state_dict_hand_off_keeps_streams(pair):
    _, _, lm = pair("rg7")
    prompts = _prompts(5, seed=1)
    plain = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                   _reqs(prompts))

    def hand_off(eng):
        blob = copy.deepcopy(state_to(eng.state_dict(), "cpu"))
        core = blob["cache"]["layers"]["core"]
        assert [set(c) for c in core] == [{"conv", "h"}, {"conv", "h"},
                                          {"k", "v", "slot_pos"}]
        assert core[2]["slot_pos"].dtype == torch.int32
        assert core[2]["k"].shape == (2, 3, 32, 1, 16)    # [n_periods,B,W,..]
        fresh = ServingEngine(lm, slots=3, capacity=CAP, device="cpu")
        fresh.load_state_dict(blob)
        fresh.active = eng.active
        return fresh

    moved = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                   _reqs(prompts), hand_off=hand_off)
    assert moved == plain


def test_slots_equal_to_periods_do_not_cross_write(pair):
    """slots == n_periods == 2: the slot write of the stacked rec and local
    leaves follows the cache's structure, so request 1's prefill leaves
    request 0's state alone."""
    _, _, lm = pair("rg7")
    assert lm.decoder.n_periods == 2
    p0, p1 = _prompts(2, seed=2)
    alone = _serve(ServingEngine(lm, slots=2, capacity=CAP, device="cpu"),
                   [Request(0, p0, max_new=6)])
    both = _serve(ServingEngine(lm, slots=2, capacity=CAP, device="cpu"),
                  [Request(0, p0, max_new=6), Request(1, p1, max_new=6)])
    assert both[0] == alone[0]
