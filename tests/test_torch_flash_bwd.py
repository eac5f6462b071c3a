"""The flash backward: the port's plain versions and its FlashAttention
Function against the JAX package's hand-written flash VJP
(``repro.kernels.ops.attention(impl="flash")``, the ``_flash`` custom_vjp),
and the CUDA kernels against the plain versions (on a card only).

Inputs are made from a numpy seed and handed to both packages. Tolerance
1e-4 (rtol and atol): the same fp32 math, summed in another order. The JAX
side is imported inside the tests, so that the card's test run (``-m gpu``,
on a host without JAX) can collect this file.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK = 32            # the JAX side's chunk_q and chunk_k
# name: ((B, Sq, Sk, H, Kh, hd), variant)
CASES = {
    "causal": ((2, 64, 64, 4, 4, 16), dict(causal=True)),
    "bidir": ((1, 64, 64, 4, 2, 32), dict(causal=False)),
    # tests/test_kernels.py::test_flash_vjp_grads_match_ref
    "window": ((2, 128, 128, 4, 2, 32), dict(causal=True, window=48)),
    "softcap": ((1, 64, 64, 2, 2, 16), dict(causal=True, softcap=5.0)),
    "gqa": ((1, 64, 64, 8, 2, 16), dict(causal=True)),
    "mqa": ((1, 96, 96, 6, 1, 16), dict(causal=True)),
    "sq_lt_sk": ((1, 32, 96, 4, 2, 16), dict(causal=True)),
}


def _inputs(shape, seed=0):
    B, Sq, Sk, H, Kh, hd = shape
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(B, Sq, H, hd), mk(B, Sk, Kh, hd), mk(B, Sk, Kh, hd), \
        mk(B, Sq, H, hd)


def _kw(variant):
    return {"causal": True, "window": 0, "softcap": 0.0, **variant}


def _jax_grads(q, k, v, do, variant):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops

    def loss(q, k, v):
        o = ops.attention(q, k, v, impl="flash", chunk_q=CHUNK,
                          chunk_k=CHUNK, **variant)
        return jnp.sum(o * do)
    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lse_matches_jax(case):
    import jax.numpy as jnp
    from repro.kernels import ops
    shape, variant = CASES[case]
    q, k, v, _ = _inputs(shape)
    kw = _kw(variant)
    scale = shape[-1] ** -0.5
    o_j, lse_j = ops._fwd_blocked_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kw["causal"],
        kw["window"], kw["softcap"], scale, min(CHUNK, shape[1]), CHUNK)
    o, lse = fa.attention_fwd_lse_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert lse.shape == shape[:2] + (shape[3],) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_flash_vjp(case):
    shape, variant = CASES[case]
    q, k, v, do = _inputs(shape, seed=1)
    want = _jax_grads(q, k, v, do, variant)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = fa.attention_fwd_lse_plain(*t[:3], **_kw(variant))
    got = fa.attention_bwd_plain(*t[:3], o, lse, t[3], chunk_q=16,
                                 chunk_k=24, **_kw(variant))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_jax_flash_vjp(case):
    """On CPU tensors the Function's two halves run the plain versions."""
    shape, variant = CASES[case]
    q, k, v, do = _inputs(shape, seed=2)
    want = _jax_grads(q, k, v, do, variant)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, **variant)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_plain_backward_matches_autograd_of_plain_forward():
    """Two independent torch codes: the hand-written backward and autograd
    through ``attention_plain`` (the comparison path ``impl="plain"``)."""
    shape, variant = CASES["window"]
    q, k, v, do = _inputs(shape, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*leaves, **variant),
                               leaves, torch.from_numpy(do))
    o, lse = fa.attention_fwd_lse_plain(*[t.detach() for t in leaves],
                                        **_kw(variant))
    got = fa.attention_bwd_plain(*[t.detach() for t in leaves], o, lse,
                                 torch.from_numpy(do), **_kw(variant))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_no_function_without_grad():
    """Serving (no grad) takes the forward alone: no graph is recorded."""
    q, k, v, _ = _inputs(CASES["causal"][0])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert fa.flash_attention(*t).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(*[x.requires_grad_() for x in t]) \
            .grad_fn is None


def test_bf16_gradients_come_back_in_bf16():
    q, k, v, do = _inputs(CASES["gqa"][0], seed=4)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
              for a in (q, k, v)]
    out = fa.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(do).bfloat16())
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(
        *[t.bfloat16().float() for t in ref]), ref, torch.from_numpy(do))
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_cuda_backward_matches_plain_version():
    """The backward kernel against ``attention_bwd_plain`` on the same o and
    lse (from the forward kernel, whose lse is held against the plain
    one), every case above and two at the tensor-core head dims (MHA at
    128, MQA with a window at 256) in fp32 and bf16; the chip smoke's
    limits (2e-5 / 2e-2 elementwise, 1e-5 / 1e-2 relative L2). Each call
    counts on its route: bf16 at head dims 128 and 256 on ``tc``, the rest
    on ``fma``."""
    _card()
    lim = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
    cases = dict(CASES, mha128=((1, 224, 224, 4, 4, 128), dict(causal=True)),
                 mqa256=((1, 160, 288, 4, 1, 256),
                         dict(causal=True, window=96)))
    for name, (shape, variant) in cases.items():
        for dt, (tol, rel) in lim.items():
            q, k, v, do = [torch.from_numpy(a).cuda().to(dt)
                           for a in _inputs(shape, seed=5)]
            kw = dict(_kw(variant), scale=shape[-1] ** -0.5)
            o, lse = fa._launch(q, k, v, want_lse=True, **kw)
            _, lse_p = fa.attention_fwd_lse_plain(q, k, v, **kw)
            torch.testing.assert_close(lse, lse_p, rtol=tol, atol=tol)
            n = fa.launches_bwd
            n_route = (fa.launches_bwd_tc, fa.launches_bwd_fma)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            assert fa.launches_bwd == n + 1
            tc = dt == torch.bfloat16 and shape[-1] >= 128
            assert (fa.launches_bwd_tc, fa.launches_bwd_fma) == (
                n_route[0] + tc, n_route[1] + (not tc)), (name, dt)
            want = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
            for g, w in zip(got, want):
                assert g.dtype == dt, name
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
                assert ((g.float() - w.float()).norm() /
                        w.float().norm()).item() <= rel, (name, dt)


@pytest.mark.gpu
def test_cuda_wrappers_record_gradients():
    """The gradient-drop fault of the CUDA wrappers stays repaired: with an
    input that requires grad, each of the three wrappers returns a tensor
    with a grad_fn, and its input gradients equal autograd through the
    plain version (flash: the bf16 limit 1e-2 relative L2, the forward
    kernel rounds P to bf16; the scans: the same recomputed plain
    backward)."""
    _card()
    from repro_torch.kernels import rglru, ssd
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*s, dt=torch.float32):
        return torch.randn(s, generator=g, device="cuda").to(dt) \
            .requires_grad_()
    runs = [
        ("flash", lambda *a: fa.flash_attention(*a),
         lambda *a: fa.attention_plain(*a),
         [rnd(1, 256, 4, 64, dt=torch.bfloat16) for _ in range(3)], 1e-2),
        ("ssd", lambda *a: ssd.ssd_scan(*a[:5], D=a[5], h0=a[6]),
         lambda *a: ssd.ssd_plain(*a[:5], D=a[5], h0=a[6]),
         [rnd(1, 200, 4, 64), rnd(1, 200, 4).abs().detach().requires_grad_(),
          rnd(4), rnd(1, 200, 1, 128), rnd(1, 200, 1, 128), rnd(4),
          rnd(1, 4, 64, 128)], 1e-5),
        ("rglru", lambda *a: rglru.rglru_scan(*a[:4], h0=a[4]),
         lambda *a: rglru.rglru_plain(*a[:4], h0=a[4]),
         [rnd(1, 200, 256), rnd(256), rnd(1, 200, 256), rnd(1, 200, 256),
          rnd(1, 256)], 1e-5)]
    for name, fn, plain, ins, rel in runs:
        out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        assert all(o.grad_fn is not None for o in outs), name
        gos = [torch.randn(o.shape, generator=g, device="cuda").to(o.dtype)
               for o in outs]
        got = torch.autograd.grad(outs, ins, gos)
        ref = plain(*ins)
        want = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,),
                                   ins, gos)
        for a, b in zip(got, want):
            err = ((a.float() - b.float()).norm() / b.float().norm()).item()
            assert err <= rel, (name, err)


@pytest.mark.gpu
def test_cuda_lm_backward_matches_plain_path():
    """A CUDA LM's ``loss.backward()`` reaches every parameter and gives the
    plain path's gradients: the deepseek-7b smoke model in fp32 (the FMA
    forward and the backward kernel), relative L2 1e-4 per parameter."""
    _card()
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import LM
    lm = LM(get_smoke_config("deepseek-7b"), device="cuda")
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (2, 64))).cuda()
    grads = {}
    for impl in (None, "plain"):
        for p in lm.parameters():
            p.grad = None
        n = fa.launches_bwd
        lm.loss({"tokens": tok}, impl=impl)[0].backward()
        assert (fa.launches_bwd - n) == (lm.cfg.num_layers if impl is None
                                         else 0)
        grads[impl] = {k: p.grad.clone() for k, p in lm.named_parameters()}
    for k, want in grads["plain"].items():
        got = grads[None][k]
        assert got.abs().sum() > 0, k
        assert ((got - want).norm() / want.norm()).item() <= 1e-4, k
