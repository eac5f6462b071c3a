"""Port vs reference: the remaining attention-only architectures on the CPU.

gemma-7b (GeGLU, tied and scaled embeddings), stablelm-1.6b (LayerNorm,
rope_pct 0.25), gemma3-1b (5 local : 1 global MQA), internvl2-76b (vision
embeds ahead of the tokens, loss offset) and seamless-m4t-large-v2 (an
encoder of bidirectional layers, decoder layers with cross-attention), each
at its smoke config in fp32. Weights come from the JAX ``LM.init(PRNGKey(0))``
through ``repro_torch.bridge.load_jax_numpy``; batches follow
``tests/test_archs.py:_batch`` (B=2, S=64; internvl2-76b's 16 vision embeds
take 16 of the 64 positions, seamless-m4t's 32 frames are fewer than its 64
tokens, so its cross-attention has Sq > Sk) from a numpy seed.

Tolerance (the same fp32 math summed in another order): each array within
a relative L2 error of 1e-4, and each element within 1e-4 of itself plus
2e-4 of the array's scale (its largest element, at least 1), as
``test_torch_train.py`` holds gradients against their leaf's largest
element. Random-init layers run the residual stream to magnitudes in the
hundreds (seamless-m4t's encoder) and the scores far from 0, so the
projections' last-bit differences between torch and XLA come out
amplified on the caches (largest elements near 20) and on the logits,
while on the same q, k, v the port's attention and JAX's lie equally far
from a float64 one. The train step's params are held at ``2 * lr``, as
in ``test_torch_train.py``. internvl2-76b's smoke head dim 8 runs the
plain attention here; the kernels take 16 to 256.

Then the flash wrapper's mask check: a non-causal call with Sq > Sk runs
(every key visible to every query), a causal or windowed one raises. The
``gpu`` tests hold the CUDA kernels to the same on a card. JAX is imported
inside the tests, so that a host without it (the card's) can collect this
file.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import load_jax_numpy, load_jax_opt_state
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import flatten_paths
from repro_torch.models.model import LM
from repro_torch.optim import adamw

ARCHS = ("gemma-7b", "stablelm-1.6b", "gemma3-1b", "internvl2-76b",
         "seamless-m4t-large-v2")
TOL = 1e-4
B, S = 2, 64
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _pair(arch):
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    jlm = JaxLM(jax_smoke_config(arch))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_smoke_config(arch), device="cpu")
    load_jax_numpy(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _batch(cfg, seed):
    """tests/test_archs.py:_batch from a numpy seed: numpy arrays."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["tokens"] = batch["tokens"][:, :S - cfg.frontend_tokens]
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    import jax.numpy as jnp
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _np(t):
    return t.detach().float().numpy()


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


def _assert_cache_equal(cache, jcache):
    import jax
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))
    jleaves = jax.tree_util.tree_leaves_with_path(jcache["layers"])
    n = 0
    for path, jleaf in jleaves:
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
    jlm, params, lm = _pair(arch)
    jb, tb = _both(_batch(lm.cfg, 0))
    want, _, joff = jlm.forward(params, jb)
    jloss, jm = jlm.loss(params, jb)
    with torch.no_grad():
        got, aux, off = lm(tb)
        loss, m = lm.loss(tb)
    assert off == joff == (lm.cfg.frontend_tokens
                           if lm.cfg.family == "vlm" else 0)
    assert float(aux) == 0.0
    assert tuple(got.shape) == tuple(want.shape)
    _close(_np(got), want)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_jax(arch):
    """Every cache leaf (k/v, local rings and ``slot_pos``, the cross
    ``xk``/``xv``) and the last logits."""
    jlm, params, lm = _pair(arch)
    jb, tb = _both(_batch(lm.cfg, 1))
    jcache, jlast = jlm.prefill(params, jb, S + 8)
    cache, last = lm.prefill(tb, S + 8)
    _close(_np(last), jlast)
    _assert_cache_equal(cache, jcache)
    if lm.cfg.encoder_layers:
        xk = cache["layers"]["core"][0]["xk"]
        assert tuple(xk.shape) == (lm.decoder.n_periods, B,
                                   lm.cfg.frontend_tokens,
                                   lm.cfg.num_kv_heads, lm.cfg.head_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    import jax.numpy as jnp
    jlm, params, lm = _pair(arch)
    batch = _batch(lm.cfg, 2)
    jb, tb = _both(batch)
    jcache, _ = jlm.prefill(params, jb, S + 8)
    cache, _ = lm.prefill(tb, S + 8)
    nxt = np.random.RandomState(3).randint(0, lm.cfg.vocab_size, (B, 1)) \
        .astype(np.int32)
    jcache, jlog = jlm.decode_step(params, jcache, jnp.asarray(nxt))
    cache, lg = lm.decode_step(cache, torch.from_numpy(nxt))
    _close(_np(lg), jlog)
    _assert_cache_equal(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_archs.py::test_smoke_decode_matches_forward, torch side:
    the prefill's last logits are the forward's, and a decode step's are
    the forward's over one more token (limits of that test)."""
    _, _, lm = _pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batch(lm.cfg, 4).items()}
    cache, last = lm.prefill(batch, S + 8)
    nxt = torch.from_numpy(np.random.RandomState(5).randint(
        0, lm.cfg.vocab_size, (B, 1)).astype(np.int32))
    cache, dec = lm.decode_step(cache, nxt)
    with torch.no_grad():
        full, _, _ = lm(batch)
        full2, _, _ = lm(dict(batch, tokens=torch.cat([batch["tokens"], nxt],
                                                      1)))
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(_np(dec), _np(full2[:, -1]), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step: loss, ce, grad_norm at 1e-4, every param within
    2 * lr of JAX's (a gradient near 0 may take the other sign)."""
    import jax
    from repro.optim import adamw as jadamw
    jlm, params, lm = _pair(arch)
    jb, tb = _both(_batch(lm.cfg, 6))
    jstate = jadamw.init_state(params)
    jstate, jm = jax.jit(jadamw.make_train_step(
        jlm, jadamw.OptConfig(**OPT)))(jstate, jb)
    state = adamw.init_state(lm)
    state, m = adamw.make_train_step(lm, adamw.OptConfig(**OPT))(state, tb)
    assert int(state["step"]) == int(jstate["step"]) == 1
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=TOL,
                                   err_msg=key)
    lr = float(jm["lr"])
    want = dict(flatten_paths(jax.tree.map(np.asarray, jstate["params"])))
    assert want.keys() == state["params"].keys()
    for name, p in state["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2 * lr, err_msg=name)


@pytest.mark.parametrize("loader", ["load_jax_numpy", "load_jax_opt_state"])
def test_bridge_carries_encoder_and_cross_leaves(loader):
    """The key-path walk covers seamless-m4t's ``encoder``, ``enc_norm``,
    ``ln_x`` and ``cross`` leaves: each arrives at its path, bit for bit."""
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    from repro.optim import adamw as jadamw
    arch = "seamless-m4t-large-v2"
    params = jax.tree.map(np.asarray, JaxLM(jax_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    lm = LM(get_smoke_config(arch), device="cpu")
    want = dict(flatten_paths(params))
    names = set(dict(lm.named_parameters()))
    assert names == want.keys()
    for prefix in ("encoder.core.0.mixer.wq", "encoder.core.0.mlp.wi",
                   "enc_norm.scale", "enc_norm.bias",
                   "decoder.core.0.ln_x.scale", "decoder.core.0.cross.wq",
                   "decoder.core.0.cross.wk", "decoder.core.0.cross.wv",
                   "decoder.core.0.cross.wo"):
        assert prefix in names, prefix
    if loader == "load_jax_numpy":
        load_jax_numpy(lm, params)
        moments = {}
    else:
        jstate = jax.tree.map(np.asarray, jadamw.init_state(params))
        jstate["m"] = jax.tree.map(lambda a: a + 1.0, jstate["m"])
        state = load_jax_opt_state(lm, jstate)
        moments = state["m"]
    for name, p in lm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
        if moments:
            np.testing.assert_array_equal(moments[name].numpy(),
                                          np.ones_like(want[name]),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# The flash wrapper's mask check
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, Kh, hd): queries outnumber keys, a cross-attention over a
# shorter encoder output; the last with Sk not a multiple of any key tile
SQ_GT_SK = [(2, 64, 32, 4, 4, 16), (1, 96, 32, 16, 16, 64),
            (1, 200, 77, 8, 2, 128)]


def _qkv(seed, B_, Sq, Sk, H, Kh, hd):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B_, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B_, Sk, Kh, hd)).astype(np.float32),
            rng.standard_normal((B_, Sk, Kh, hd)).astype(np.float32))


@pytest.mark.parametrize("shape", SQ_GT_SK)
def test_noncausal_sq_gt_sk_matches_reference(shape):
    """Forward: the wrapper (the plain version on the CPU) against the
    JAX naive oracle; gradients: the FlashAttention Function against
    ``jax.grad`` of it."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, k, v = _qkv(0, *shape)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    plain = fa.attention_plain(*map(torch.from_numpy, (q, k, v)),
                               causal=False)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False)
    _close(_np(got), want)
    np.testing.assert_array_equal(_np(got), _np(plain))
    do = np.random.RandomState(1).standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=False)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c,
                                                        causal=False),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, w in zip("qkv", grads, vjp(jnp.asarray(do))):
        _close(_np(g), w, err_msg=f"d{name}")


@pytest.mark.parametrize("entry", ["forward", "backward"])
@pytest.mark.parametrize("mask", [dict(causal=True),
                                  dict(causal=False, window=16)],
                         ids=["causal", "window"])
def test_masked_sq_gt_sk_raises(entry, mask):
    """A causal or windowed mask right-aligns the queries, which needs
    Sq <= Sk; both entry points refuse Sq > Sk before choosing a route."""
    q, k, v = map(torch.from_numpy, _qkv(2, *SQ_GT_SK[0]))
    with pytest.raises(ValueError, match="right-aligned"):
        if entry == "forward":
            fa.flash_attention(q, k, v, **mask)
        else:
            lse = torch.zeros(q.shape[:3])
            fa.flash_attention_bwd(q, k, v, q, lse, q, **mask)


# non-causal, on the card: Sq = Sk at the tensor-core head dims, the
# cross shape (Sq < Sk), Sq > Sk with Sk on and off the key tile
CUDA_NONCAUSAL = [(1, 256, 256, 4, 4, hd) for hd in (64, 128, 256)] + [
    (1, 512, 4096, 16, 16, 64), (1, 96, 32, 16, 16, 64),
    (1, 200, 77, 8, 2, 128), (2, 64, 32, 4, 4, 16)]


@pytest.mark.gpu
def test_cuda_noncausal_any_sq_sk_matches_plain():
    """Both forward kernels and both backward routes against the plain
    versions for non-causal calls at Sq = Sk, Sq < Sk and Sq > Sk, each
    launch counted on the route ``kernel_for`` names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed, shape in enumerate(CUDA_NONCAUSAL):
        for tdt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q, k, v = [torch.from_numpy(a).to("cuda", tdt)
                       for a in _qkv(seed, *shape)]
            kw = dict(causal=False, window=0, softcap=0.0,
                      scale=shape[-1] ** -0.5)
            route = fa.kernel_for(tdt, shape[-1])
            before = (fa.launches_tc, fa.launches_fma, fa.launches_bwd_tc,
                      fa.launches_bwd_fma)
            o, lse = fa._launch(q, k, v, want_lse=True, **kw)
            do = torch.randn(q.shape, device="cuda").to(tdt)
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            tc = route == "tc"
            assert (fa.launches_tc - before[0], fa.launches_fma - before[1],
                    fa.launches_bwd_tc - before[2],
                    fa.launches_bwd_fma - before[3]) == \
                (int(tc), int(not tc), int(tc), int(not tc))
            want_o, want_lse = fa.attention_fwd_lse_plain(q, k, v, **kw)
            want = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
            for name, a, b in (("o", o, want_o), ("lse", lse, want_lse),
                               *zip(("dq", "dk", "dv"), grads, want)):
                np.testing.assert_allclose(
                    a.float().cpu().numpy(), b.float().cpu().numpy(),
                    rtol=tol, atol=tol, err_msg=f"{shape} {tdt} {name}")


@pytest.mark.gpu
def test_cuda_masked_sq_gt_sk_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = [torch.from_numpy(a).to("cuda", torch.bfloat16)
               for a in _qkv(3, 1, 96, 32, 16, 16, 64)]
    before = fa.launches
    for mask in (dict(causal=True), dict(causal=False, window=16)):
        with pytest.raises(ValueError, match="right-aligned"):
            fa.flash_attention(q, k, v, **mask)
    assert fa.launches == before
