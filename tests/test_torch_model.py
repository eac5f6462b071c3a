"""Port vs reference: the deepseek-7b smoke LM in fp32 on the CPU.

Weights come from the JAX ``LM.init(PRNGKey(0))`` and cross to the port
through ``repro_torch.bridge.load_jax_numpy``; tokens come from a numpy
seed. Tolerance 1e-4: the same fp32 math, summed in another order. JAX is
imported inside the tests, so that a host without it (the card's) can
collect this file.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import LM

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(num_layers):
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    jcfg = jax_smoke_config("deepseek-7b").replace(num_layers=num_layers)
    cfg = get_smoke_config("deepseek-7b").replace(num_layers=num_layers)
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    load_jax_numpy(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _tokens(seed, B, S, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)) \
        .astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("num_layers", [1, 3])
def test_stack_split_matches_reference(num_layers):
    jlm, _, lm = _pair(num_layers)
    assert lm.decoder.n_periods == jlm.decoder.n_periods
    assert len(lm.decoder.tail_kinds) == len(jlm.decoder.tail)
    names = dict(lm.named_parameters())
    if num_layers == 3:
        assert names["decoder.core.0.mixer.wq"].shape == (3, 64, 64)
        assert "decoder.core.0.ln1.scale" in names
    else:
        assert "decoder.tail.0.mixer.wq" in names


@pytest.mark.parametrize("num_layers", [1, 3])
def test_forward_logits_match_jax(num_layers):
    import jax.numpy as jnp
    jlm, params, lm = _pair(num_layers)
    tok = _tokens(0, 2, 24, lm.cfg.vocab_size)
    want, _, _ = jlm.forward(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux, off = lm({"tokens": torch.from_numpy(tok)})
    assert off == 0 and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("num_layers", [1, 3])
def test_prefill_and_decode_match_jax(num_layers):
    import jax
    import jax.numpy as jnp
    jlm, params, lm = _pair(num_layers)
    B, S, cap = 2, 12, 20
    tok = _tokens(1, B, S, lm.cfg.vocab_size)
    jcache, jlast = jlm.prefill(params, {"tokens": jnp.asarray(tok)}, cap)
    cache, last = lm.prefill({"tokens": torch.from_numpy(tok)}, cap)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **TOL)
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    jleaves = jax.tree_util.tree_leaves_with_path(jcache["layers"])
    for path, jleaf in jleaves:
        node = cache["layers"]
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_allclose(_np(node), np.asarray(jleaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))
    rng = np.random.RandomState(2)
    for _ in range(4):
        nxt = rng.randint(0, lm.cfg.vocab_size, (B, 1)).astype(np.int32)
        jcache, jlog = jlm.decode_step(params, jcache, jnp.asarray(nxt))
        cache, lg = lm.decode_step(cache, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(lg), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


@pytest.mark.parametrize("num_layers", [1, 3])
def test_decode_matches_forward(num_layers):
    """tests/test_archs.py::test_smoke_decode_matches_forward, torch side."""
    _, _, lm = _pair(num_layers)
    B, S = 2, 64
    tok = torch.from_numpy(_tokens(3, B, S, lm.cfg.vocab_size))
    cache, last = lm.prefill({"tokens": tok}, S + 8)
    with torch.no_grad():
        full, _, _ = lm({"tokens": tok})
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), rtol=2e-3,
                               atol=2e-3)
    nxt = torch.from_numpy(_tokens(4, B, 1, lm.cfg.vocab_size))
    cache, dec = lm.decode_step(cache, nxt)
    with torch.no_grad():
        full2, _, _ = lm({"tokens": torch.cat([tok, nxt], 1)})
    np.testing.assert_allclose(_np(dec), _np(full2[:, -1]), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("fn", ["layer_apply", "attn_forward"])
def test_layer_functions_match_jax(fn):
    """The per-layer entry points on one layer's bridged weights."""
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import model as JM
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.model import params_tree
    jlm, params, lm = _pair(1)
    jp = params["decoder"]["tail"][0]
    p = params_tree(lm.decoder)["tail"][0]
    x = np.random.RandomState(6).standard_normal(
        (2, 10, lm.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).astype(np.int32)
    kind = ("attn", "dense")
    with torch.no_grad():
        if fn == "layer_apply":
            want, _ = JM.layer_apply(jlm.cfg, kind, jp, jnp.asarray(x),
                                     {"positions": jnp.asarray(pos)})
            got, aux = M.layer_apply(lm.cfg, kind, p, torch.from_numpy(x),
                                     {"positions": torch.from_numpy(pos)})
            assert float(aux) == 0.0
        else:
            want = JA.attn_forward(jlm.cfg, jp["mixer"], jnp.asarray(x),
                                   jnp.asarray(pos))
            got = A.attn_forward(lm.cfg, p["mixer"], torch.from_numpy(x),
                                 torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_cast_weights_keeps_bf16_numbers():
    """Matrices held in bf16 give bit for bit the logits of fp32 params cast
    at each use; norm scales (non-zero here) stay fp32 as the reference
    reads them."""
    cfg = get_smoke_config("deepseek-7b").replace(dtype="bfloat16")
    lm = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.endswith("scale"):
                p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(1))
    tok = torch.from_numpy(_tokens(5, 2, 16, cfg.vocab_size))
    with torch.no_grad():
        want, _, _ = lm({"tokens": tok})
        cache, want_last = lm.prefill({"tokens": tok}, 20)
        _, want_dec = lm.decode_step(cache, tok[:, :1])
    lm.cast_weights()
    dts = {n: p.dtype for n, p in lm.named_parameters()}
    assert dts["decoder.core.0.mixer.wq"] == torch.bfloat16
    assert dts["embed"] == dts["head"] == torch.bfloat16
    assert dts["decoder.core.0.ln1.scale"] == torch.float32
    assert dts["final_norm.scale"] == torch.float32
    with torch.no_grad():
        got, _, _ = lm({"tokens": tok})
        cache, got_last = lm.prefill({"tokens": tok}, 20)
        _, got_dec = lm.decode_step(cache, tok[:, :1])
    assert torch.equal(got, want)
    assert torch.equal(got_last, want_last)
    assert torch.equal(got_dec, want_dec)

