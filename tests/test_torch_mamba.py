"""Port vs reference: the mamba2-2.7b smoke LM (4 ("ssm", "none") layers,
d_model 64, 8 heads of 16, d_state 16, chunk 32) in fp32 on the CPU.

Weights come from the JAX ``LM.init(PRNGKey(0))`` and cross to the port
through ``repro_torch.bridge.load_jax_numpy``; tokens and activations come
from numpy seeds. Tolerance 1e-4: the same fp32 math, summed in another
order. JAX is imported inside the fixtures and tests, so that a host
without it (the card's) can collect this file.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import LM, params_tree
from repro_torch.serving.engine import Request, ServingEngine, state_to

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = 64


@pytest.fixture(scope="module")
def models():
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    jlm = JaxLM(jax_smoke_config(ARCH))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_smoke_config(ARCH), device="cpu")
    load_jax_numpy(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _tokens(seed, B, S, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _leaf(tree, path):
    for key in path:
        tree = tree[getattr(key, "key", getattr(key, "idx", None))]
    return tree


def test_bridge_loads_mamba_tree_with_equal_keys(models):
    import jax
    from repro_torch.models.layers import flatten_paths
    jlm, params, lm = models
    jtree = jax.tree.map(np.asarray, params)
    assert dict(flatten_paths(jtree)).keys() == \
        dict(lm.named_parameters()).keys()
    assert lm.decoder.n_periods == jlm.decoder.n_periods == 4
    names = dict(lm.named_parameters())
    assert names["decoder.core.0.mixer.in_proj"].shape == (4, 64, 296)
    assert names["decoder.core.0.mixer.A_log"].shape == (4, 8)
    assert "decoder.core.0.ln2.scale" not in names      # no MLP sublayer
    for path, arr in flatten_paths(jtree):
        np.testing.assert_array_equal(_np(names[path]), arr)


@pytest.mark.parametrize("fn", ["_conv_full", "_gated_norm", "ssm_forward",
                                "ssm_decode", "layer_apply"])
def test_layer_functions_match_jax(models, fn):
    """The mixer's pieces and the layer on period 0's bridged weights."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models import ssm as JS
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S
    jlm, params, lm = models
    cfg = lm.cfg
    jp = jax.tree.map(lambda a: a[0], params["decoder"]["core"][0])
    p = {k: (v[0] if isinstance(v, torch.Tensor) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params_tree(lm.decoder)["core"][0].items()}
    rng = np.random.RandomState(6)
    B, T, D = 2, 37, cfg.d_model
    _, d_inner, H, conv_dim = S._dims(cfg)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    with torch.no_grad():
        if fn == "_conv_full":
            xbc = rng.standard_normal((B, T, conv_dim)).astype(np.float32)
            got = S._conv_full(torch.from_numpy(xbc), p["mixer"]["conv_w"])
            want = JS._conv_full(jnp.asarray(xbc), jp["mixer"]["conv_w"])
        elif fn == "_gated_norm":
            y = rng.standard_normal((B, T, d_inner)).astype(np.float32)
            z = rng.standard_normal((B, T, d_inner)).astype(np.float32)
            scale = rng.standard_normal(d_inner).astype(np.float32)
            got = S._gated_norm(torch.from_numpy(y), torch.from_numpy(z),
                                torch.from_numpy(scale), cfg.norm_eps)
            want = JS._gated_norm(jnp.asarray(y), jnp.asarray(z),
                                  jnp.asarray(scale), cfg.norm_eps)
        elif fn == "ssm_forward":
            got = S.ssm_forward(cfg, p["mixer"], torch.from_numpy(x))
            want = JS.ssm_forward(jlm.cfg, jp["mixer"], jnp.asarray(x))
        elif fn == "ssm_decode":
            s = cfg.ssm
            conv = rng.standard_normal((B, s.d_conv - 1, conv_dim)).astype(
                np.float32)
            h = rng.standard_normal((B, H, s.head_dim, s.d_state)).astype(
                np.float32)
            cache = {"conv": torch.from_numpy(conv.copy()),
                     "h": torch.from_numpy(h.copy())}
            got, new = S.ssm_decode(cfg, p["mixer"],
                                    torch.from_numpy(x[:, :1]), cache)
            assert new is cache                 # updated in place
            want, jnew = JS.ssm_decode(jlm.cfg, jp["mixer"],
                                       jnp.asarray(x[:, :1]),
                                       {"conv": jnp.asarray(conv),
                                        "h": jnp.asarray(h)})
            for k in ("conv", "h"):
                np.testing.assert_allclose(_np(cache[k]), np.asarray(jnew[k]),
                                           **TOL)
        else:
            pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
            kind = ("ssm", "none")
            got, aux = M.layer_apply(cfg, kind, p, torch.from_numpy(x),
                                     {"positions": torch.from_numpy(pos)})
            assert float(aux) == 0.0
            want, _ = JM.layer_apply(jlm.cfg, kind, jp, jnp.asarray(x),
                                     {"positions": jnp.asarray(pos)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_forward_logits_match_jax(models):
    import jax.numpy as jnp
    jlm, params, lm = models
    tok = _tokens(0, 2, 72)          # ragged against the chunk of 32
    want, _, _ = jlm.forward(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux, off = lm({"tokens": torch.from_numpy(tok)})
    assert off == 0 and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_prefill_cache_and_decode_match_jax(models):
    import jax
    import jax.numpy as jnp
    jlm, params, lm = models
    B, S = 2, 40
    tok = _tokens(1, B, S)
    jcache, jlast = jlm.prefill(params, {"tokens": jnp.asarray(tok)}, CAP)
    cache, last = lm.prefill({"tokens": torch.from_numpy(tok)}, CAP)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **TOL)
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    jleaves = jax.tree_util.tree_leaves_with_path(jcache["layers"])
    assert len(jleaves) == 2                      # core conv and h
    for path, jleaf in jleaves:
        leaf = _leaf(cache["layers"], path)
        assert leaf.shape == jleaf.shape
        np.testing.assert_allclose(_np(leaf), np.asarray(jleaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    rng = np.random.RandomState(2)
    for _ in range(5):
        nxt = rng.randint(0, 512, (B, 1)).astype(np.int32)
        jcache, jlog = jlm.decode_step(params, jcache, jnp.asarray(nxt))
        cache, lg = lm.decode_step(cache, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(lg), np.asarray(jlog), **TOL)
    for path, jleaf in jax.tree_util.tree_leaves_with_path(jcache["layers"]):
        np.testing.assert_allclose(_np(_leaf(cache["layers"], path)),
                                   np.asarray(jleaf), **TOL)


@pytest.mark.parametrize("S", [64, 2])
def test_decode_matches_forward(models, S):
    """tests/test_archs.py::test_smoke_decode_matches_forward, torch side.
    S=2 is shorter than the conv window: the cache's history is zero-padded
    as the full conv pads."""
    _, _, lm = models
    B = 2
    tok = torch.from_numpy(_tokens(3, B, S))
    cache, last = lm.prefill({"tokens": tok}, CAP)
    with torch.no_grad():
        full, _, _ = lm({"tokens": tok})
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), **TOL)
    seq = tok
    for i in range(3):
        nxt = torch.from_numpy(_tokens(4 + i, B, 1))
        cache, dec = lm.decode_step(cache, nxt)
        seq = torch.cat([seq, nxt], 1)
        with torch.no_grad():
            full, _, _ = lm({"tokens": seq})
        np.testing.assert_allclose(_np(dec), _np(full[:, -1]), **TOL)


def test_cast_weights_keeps_bf16_numbers_mamba():
    """Matrices held in bf16 give bit for bit the logits of fp32 params cast
    at each use; the 1-D parameters (norm scales, dt_bias, A_log, D; made
    non-trivial here) stay fp32, as the reference reads them."""
    cfg = get_smoke_config(ARCH).replace(dtype="bfloat16")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.split(".")[-1] in ("scale", "norm", "dt_bias", "A_log",
                                       "D"):
                p.normal_(0.0, 0.5, generator=g)
    tok = torch.from_numpy(_tokens(5, 2, 40))
    with torch.no_grad():
        want, _, _ = lm({"tokens": tok})
        cache, want_last = lm.prefill({"tokens": tok}, CAP)
        _, want_dec = lm.decode_step(cache, tok[:, :1])
    lm.cast_weights()
    dts = {n: p.dtype for n, p in lm.named_parameters()}
    for leaf in ("in_proj", "conv_w", "out_proj"):
        assert dts[f"decoder.core.0.mixer.{leaf}"] == torch.bfloat16
    for leaf in ("dt_bias", "A_log", "D", "norm"):
        assert dts[f"decoder.core.0.mixer.{leaf}"] == torch.float32
    assert dts["embed"] == torch.bfloat16
    assert dts["decoder.core.0.ln1.scale"] == torch.float32
    with torch.no_grad():
        got, _, _ = lm({"tokens": tok})
        cache, got_last = lm.prefill({"tokens": tok}, CAP)
        _, got_dec = lm.decode_step(cache, tok[:, :1])
    assert torch.equal(got, want)
    assert torch.equal(got_last, want_last)
    assert torch.equal(got_dec, want_dec)


# ---------------------------------------------------------------------------
# ServingEngine
# ---------------------------------------------------------------------------


def _prompts(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(5, 40)).astype(np.int32)
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


def test_streams_match_jax_engine(models):
    """slots=3, not n_periods=4, to steer around the reference engine's
    shape-guessed slot write."""
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServingEngine as JaxEngine
    jlm, params, lm = models
    prompts = _prompts(5)
    jstreams = _serve(JaxEngine(jlm, params, slots=3, capacity=CAP),
                      [JaxRequest(i, p, max_new=6)
                       for i, p in enumerate(prompts)])
    streams = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                     _reqs(prompts))
    assert streams == jstreams
    assert all(len(s) == 6 for s in streams)


def test_state_dict_hand_off_keeps_streams(models):
    _, _, lm = models
    prompts = _prompts(5, seed=1)
    plain = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                   _reqs(prompts))

    def hand_off(eng):
        blob = copy.deepcopy(state_to(eng.state_dict(), "cpu"))
        assert {"conv", "h"} == set(blob["cache"]["layers"]["core"][0])
        fresh = ServingEngine(lm, slots=3, capacity=CAP, device="cpu")
        fresh.load_state_dict(blob)
        fresh.active = eng.active
        return fresh

    moved = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                   _reqs(prompts), hand_off=hand_off)
    assert moved == plain


def test_slots_equal_to_periods_do_not_cross_write(models):
    """slots == n_periods == 4: the slot write of the SSM's conv and h
    leaves follows the cache's structure, so request 1's prefill leaves
    request 0's state alone."""
    _, _, lm = models
    assert lm.decoder.n_periods == 4
    p0, p1 = _prompts(2, seed=2)
    alone = _serve(ServingEngine(lm, slots=4, capacity=CAP, device="cpu"),
                   [Request(0, p0, max_new=6)])
    both = _serve(ServingEngine(lm, slots=4, capacity=CAP, device="cpu"),
                  [Request(0, p0, max_new=6), Request(1, p1, max_new=6)])
    assert both[0] == alone[0]
