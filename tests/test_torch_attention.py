"""Port's attention vs the JAX package's oracles, and the CUDA kernel vs
its plain version (on a card only).

Inputs are made from a numpy seed and handed to both packages. Tolerances
are those of tests/test_kernels.py: 2e-5 in float32 (same math, another
summation order), 2e-2 in bfloat16 (one bf16 rounding of the output).
The JAX side is imported by a fixture, so that the card's test run
(``-m gpu``, on a host without JAX) can collect this file.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

ATTN_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 192, 6, 1, 16)]
VARIANTS = ["causal", "bidir", "window", "softcap"]
DTYPES = {"f32": (torch.float32, "float32"),
          "bf16": (torch.bfloat16, "bfloat16")}


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref, flash=flash_attention)


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else \
        dict(rtol=2e-5, atol=2e-5)


def _kw(variant, S):
    return {"causal": dict(causal=True),
            "bidir": dict(causal=False),
            "window": dict(causal=True, window=S // 3),
            "softcap": dict(causal=True, softcap=20.0)}[variant]


def _qkv_np(seed, B, Sq, Sk, H, Kh, hd):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Kh, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Kh, hd)).astype(np.float32))


def _torch(arrs, dname="f32"):
    return [torch.from_numpy(a).to(DTYPES[dname][0]) for a in arrs]


def _both(J, arrs, dname):
    jdt = DTYPES[dname][1]
    return _torch(arrs, dname), [J.jnp.asarray(a).astype(jdt) for a in arrs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_attention_vs_jax_ref(J, shape, dname, variant):
    B, S, H, Kh, hd = shape
    (q, k, v), (jq, jk, jv) = _both(
        J, _qkv_np(0, B, S, S, H, Kh, hd), dname)
    kw = _kw(variant, S)
    got = ops.attention(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = J.ref.attention_ref(jq, jk, jv, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dname))


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_attention_right_aligned_queries(J, variant):
    """Sq < Sk, ragged lengths, GQA: queries sit at the end of the keys."""
    (q, k, v), (jq, jk, jv) = _both(
        J, _qkv_np(1, 2, 37, 333, 8, 2, 32), "f32")
    kw = _kw(variant, 333)
    got = ops.attention(q, k, v, **kw)
    want = J.ref.attention_ref(jq, jk, jv, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("f32"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_attention_vs_pallas_interpret(J, variant):
    (q, k, v), (jq, jk, jv) = _both(
        J, _qkv_np(2, 2, 128, 128, 4, 2, 16), "f32")
    kw = _kw(variant, 128)
    got = fa.flash_attention(q, k, v, **kw)
    want = J.flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("f32"))


def test_torch_ref_matches_jax_ref(J):
    (q, k, v), (jq, jk, jv) = _both(
        J, _qkv_np(3, 1, 64, 96, 4, 1, 16), "f32")
    kw = dict(causal=True, window=40, softcap=10.0)
    np.testing.assert_allclose(_f32(ref.attention_ref(q, k, v, **kw)),
                               _f32(J.ref.attention_ref(jq, jk, jv, **kw)),
                               **_tol("f32"))


def test_wrapper_counts_no_launch_on_cpu():
    before = fa.launches
    q, k, v = _torch(_qkv_np(4, 1, 16, 16, 2, 2, 16))
    fa.flash_attention(q, k, v)
    assert fa.launches == before


def test_wrapper_rejects_what_kernel_cannot_take():
    q, k, v = _torch(_qkv_np(5, 1, 16, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="right-aligned"):
        fa.flash_attention(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention(k.half(), k.half(), v.half())


@pytest.mark.parametrize("case", ["lengths", "ring"])
def test_attention_decode_vs_jax(J, case):
    rng = np.random.RandomState(6)
    B, S, H, Kh, hd = 3, 24, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, Kh, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, Kh, hd)).astype(np.float32)
    kw = dict(softcap=15.0)
    if case == "lengths":
        lengths = np.array([1, 9, 24], np.int32)
    else:                       # ring of S slots over positions up to 40
        lengths = np.array([5, 30, 41], np.int32)
        sp = np.full((B, S), -1, np.int32)
        for b, n in enumerate(lengths):
            for pos in range(n):
                sp[b, pos % S] = pos
        kw.update(window=S, slot_positions=sp)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw = {k: J.jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = ops.attention_decode(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc),
                               torch.from_numpy(lengths), **tkw)
    want = J.ops.attention_decode(J.jnp.asarray(q), J.jnp.asarray(kc),
                                  J.jnp.asarray(vc), J.jnp.asarray(lengths),
                                  **jkw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("f32"))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Each kernel against the plain version: the sweep's small shapes in
    both dtypes and all variants, the two served prefill shapes in bf16
    (deepseek-7b causal, recurrentgemma-9b MQA windowed at 2176 > 2048),
    the kernel that ran each case counted by its own counter, and a q that
    starts 2 bytes off 16 refused by the tensor-core kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [((1, 128, 128, 4, 4, hd), d, v) for hd in fa.HEAD_DIMS
             for d in ("f32", "bf16") for v in VARIANTS]
    cases += [(s, d, v) for s in [(2, 256, 256, 8, 2, 64),
                                  (1, 192, 192, 6, 1, 16),
                                  (1, 100, 333, 8, 2, 128),
                                  (1, 333, 333, 4, 2, 64)]
              for d in ("f32", "bf16") for v in VARIANTS]
    cases += [((1, 2048, 2048, 32, 32, 128), "bf16", "causal"),
              ((1, 2176, 2176, 16, 1, 256), "bf16", "window2048")]
    for (B, Sq, Sk, H, Kh, hd), dname, variant in cases:
        arrs = _qkv_np(7, B, Sq, Sk, H, Kh, hd)
        tdt = DTYPES[dname][0]
        q, k, v = [torch.from_numpy(a).to("cuda", tdt) for a in arrs]
        kw = (dict(causal=True, window=2048) if variant == "window2048"
              else _kw(variant, Sk))
        route = fa.kernel_for(tdt, hd)
        before = (fa.launches, fa.launches_tc, fa.launches_fma)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.launches == before[0] + 1
        assert (fa.launches_tc - before[1], fa.launches_fma - before[2]) \
            == ((1, 0) if route == "tc" else (0, 1))
        want = fa.attention_plain(q, k, v, **kw)
        np.testing.assert_allclose(
            got.float().cpu().numpy(), want.float().cpu().numpy(),
            **_tol(dname), err_msg=f"{(B, Sq, Sk, H, Kh, hd)} {dname} "
            f"{variant} ({route})")
    flat = torch.zeros(128 * 4 * 128 + 8, dtype=torch.bfloat16,
                       device="cuda")
    q = flat[1:1 + 128 * 4 * 128].view(1, 128, 4, 128)
    k = torch.zeros((1, 128, 4, 128), dtype=torch.bfloat16, device="cuda")
    before = fa.launches
    with pytest.raises(ValueError, match="q does not start on 16 bytes"):
        fa.flash_attention(q, k, k)
    assert fa.launches == before
