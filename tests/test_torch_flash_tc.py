"""The tensor-core flash-attention kernel's wrapper and numerics, on the CPU.

The kernel itself runs only on a card (``test_torch_attention.py``'s ``gpu``
test and ``chip_smoke.py``). Here: the wrapper's choice of kernel by dtype
and head dim, its TMA checks (16-byte aligned start, strides in multiples
of 16 bytes) as pure functions on CPU tensors, and a test-local emulation
of the kernel's arithmetic (fp32 scores and online softmax over its
128-query by 128- or 64-key tiles, P rounded to bf16 before P.v, one
rounding of the output) held against the JAX reference attention at
deepseek-like (MHA, head dim 128), recurrentgemma-like (MQA, head dim
256, sliding window) and deepseek-v2-like (MLA: head dim 192, v
zero-padded from 128) shapes, within chip_smoke.py's bf16 limits:
2e-2 elementwise (rtol and atol) and a relative L2 error of 1e-2.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
REL_L2_BF16 = 1e-2
NEG = -1e30
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ref=jref)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 256, "tc"), (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 192, "tc"), (torch.float32, 192, "fma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 8, "fma")])
def test_kernel_for_routes_by_dtype_and_head_dim(dtype, hd, want):
    assert fa.kernel_for(dtype, hd) == want


def test_kernel_for_rejects_other_head_dims():
    with pytest.raises(ValueError, match="head dim 96"):
        fa.kernel_for(torch.bfloat16, 96)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_check_tma_passes_contiguous_and_sliced_heads():
    q, k = _bf16(2, 33, 4, 128), _bf16(1, 33, 1, 256)
    fa.check_tma(q=q, k=k)
    # a head-dim slice of a wider row keeps 16-byte strides (136 * 2 = 272)
    fa.check_tma(v=_bf16(1, 33, 4, 136)[..., :128])


def test_check_tma_raises_on_misaligned_start():
    flat = _bf16(2 * 33 * 128 + 8)
    k = flat[1:1 + 2 * 33 * 128].view(2, 33, 1, 128)     # 2 bytes off
    assert k.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="k does not start on 16 bytes"):
        fa.check_tma(q=_bf16(2, 33, 4, 128), k=k)


def test_check_tma_raises_on_stride_off_16_bytes():
    v = _bf16(1, 33, 4, 132)[..., :128]                  # 264-byte head stride
    with pytest.raises(ValueError, match="v's stride 132 in dim 2"):
        fa.check_tma(v=v)
    q = _bf16(2, 33, 4, 128).transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="unit stride"):
        fa.check_tma(q=q)


def test_check_tma_at_mla_head_dim_192():
    """MLA's q and k are concatenations and v a zero-padded copy, each
    contiguous at head dim 192 (384-byte rows): TMA reads them in place.
    A head-dim slice of a 196-wide row (392-byte head stride) cannot be."""
    fa.check_tma(q=_bf16(1, 77, 128, 192), k=_bf16(1, 77, 128, 192),
                 v=torch.nn.functional.pad(_bf16(1, 77, 128, 128), (0, 64)))
    with pytest.raises(ValueError, match="v's stride 196 in dim 2"):
        fa.check_tma(v=_bf16(1, 77, 4, 196)[..., :192])


def test_tma_strides_ignore_size_one_dims():
    t = torch.zeros((1, 40, 1, 256), dtype=torch.bfloat16)[:, :, :, :]
    t = t.as_strided(t.shape, (3, 256, 7, 1))            # strides never used
    assert fa.tma_strides(t) == (40 * 256, 256, 256, 1)
    fa.check_tma(k=t)


def _bf16_terms(p, n):
    """p as the sum of n bf16 terms: bf16(p), then bf16 of what is left."""
    out = torch.zeros_like(p)
    for _ in range(n):
        out += (p - out).to(torch.bfloat16).float()
    return out


def emulate_tc(q, k, v, *, causal=True, window=0, softcap=0.0, p_terms=1):
    """The tensor-core kernel's arithmetic in plain torch: per 128-query
    tile, kv tiles of BK keys from the first one any of its queries sees;
    scores in fp32 in the log2 domain, masked to NEG; online softmax with l
    summed over the fp32 p; P as ``p_terms`` bf16 terms for P.v (the
    kernel: 1, P rounded to bf16); acc / max(l, 1e-30) rounded once to q's
    dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    BQ, BK = 128, (64 if hd >= 192 else 128)
    scale = hd ** -0.5
    off = Sk - Sq
    qf = q.float().reshape(B, Sq, Kh, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32)
    for q0 in range(0, Sq, BQ):
        q1 = min(q0 + BQ, Sq)
        qpos = off + torch.arange(q0, q1)
        k_end = min(Sk, off + q1) if causal else Sk
        k_begin = max(0, off + q0 - window + 1) if window > 0 else 0
        m = torch.full((B, Kh, G, q1 - q0), NEG)
        l = torch.zeros((B, Kh, G, q1 - q0))
        acc = torch.zeros((B, Kh, G, q1 - q0, hd))
        for k0 in range(k_begin // BK * BK, k_end, BK):
            k1 = min(k0 + BK, Sk)
            kpos = torch.arange(k0, k1)
            s = torch.einsum("bqkgh,bckh->bkgqc", qf[:, q0:q1], kf[:, k0:k1])
            if softcap > 0:
                x = torch.tanh(s * scale / softcap) * softcap * LOG2E
            else:
                x = s * (scale * LOG2E)
            keep = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                keep &= qpos[:, None] >= kpos[None, :]
            if window > 0:
                keep &= (qpos[:, None] - kpos[None, :]) < window
            x = torch.where(keep, x, torch.full_like(x, NEG))
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])   # keys past Sk: never here
            l = l * alpha + p.sum(-1)
            pb = _bf16_terms(p, p_terms)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckh->bkgqh", pb, vf[:, k0:k1])
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, q1 - q0, H, hd)
    return out.to(q.dtype)


# (B, Sq, Sk, H, Kh, hd): deepseek-like MHA at head dim 128 (ragged S over
# three q tiles), recurrentgemma-like MQA at head dim 256 (Sq < Sk)
EMU_SHAPES = {"deepseek": (1, 300, 300, 4, 4, 128),
              "recurrentgemma": (1, 200, 330, 4, 1, 256)}
VARIANTS = {"causal": lambda S: dict(causal=True),
            "bidir": lambda S: dict(causal=False),
            "window": lambda S: dict(causal=True, window=S // 3),
            "softcap": lambda S: dict(causal=True, softcap=20.0)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shape", list(EMU_SHAPES))
def test_tc_numerics_within_sweep_limits_of_jax_ref(J, shape, variant):
    B, Sq, Sk, H, Kh, hd = EMU_SHAPES[shape]
    rng = np.random.RandomState(11)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, Kh, hd), (B, Sk, Kh, hd))]
    q, k, v = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    kw = VARIANTS[variant](Sk)
    got = emulate_tc(q, k, v, **kw)
    jq, jk, jv = [J.jnp.asarray(a).astype("bfloat16") for a in arrs]
    want = torch.from_numpy(np.asarray(
        J.ref.attention_ref(jq, jk, jv, **kw), dtype=np.float32))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **TOL_BF16)
    rel = ((got.float() - want).norm() / want.norm()).item()
    assert rel <= REL_L2_BF16, rel


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("shape", list(EMU_SHAPES))
def test_p_rounding_sits_inside_the_bf16_limits(shape):
    """P rounded once to bf16 moves the output by about 2e-3 (relative L2)
    from the plain version's fp32 P: five times inside the 1e-2 limit, and
    a second bf16 term (P = hi + lo) would cut it more than tenfold."""
    B, Sq, Sk, H, Kh, hd = EMU_SHAPES[shape]
    rng = np.random.RandomState(13)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in
        ((B, Sq, H, hd), (B, Sk, Kh, hd), (B, Sk, Kh, hd))]
    plain = fa.attention_plain(q, k, v)
    one = _rel(emulate_tc(q, k, v), plain)
    two = _rel(emulate_tc(q, k, v, p_terms=2), plain)
    assert 1e-3 < one < REL_L2_BF16 / 4
    assert two < one / 10


def test_tc_numerics_at_mla_head_dim_192(J):
    """deepseek-v2's MLA prefill at a small size: q and k at head dim 192
    (qk_nope 128 + qk_rope 64), v zero-padded from 128, causal, scale
    192**-0.5; 64-key tiles. Within the bf16 limits of the JAX reference,
    and the padded columns come out 0."""
    B, S, H, hd = 1, 200, 4, 192
    rng = np.random.RandomState(17)
    q, k, v = [rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3)]
    v[..., 128:] = 0.0
    tq, tk, tv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = emulate_tc(tq, tk, tv)
    jq, jk, jv = [J.jnp.asarray(a).astype("bfloat16") for a in (q, k, v)]
    want = torch.from_numpy(np.asarray(
        J.ref.attention_ref(jq, jk, jv, causal=True, scale=hd ** -0.5),
        dtype=np.float32))
    assert bool((got[..., 128:] == 0).all())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **TOL_BF16)
    assert _rel(got, want) <= REL_L2_BF16
