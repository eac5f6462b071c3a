"""The tensor-core flash backward's wrapper and numerics, on the CPU.

The kernels themselves run only on a card (``test_torch_flash_bwd.py``'s
``gpu`` tests and ``chip_smoke.py``). Here: the wrapper's choice of route
by dtype and head dim, its head split, its TMA check, and a test-local
emulation of the tensor-core kernels' arithmetic: fp32 S and dP from bf16
inputs, P and dS rounded to bf16 before the products they feed, dk and dv
summed over 64-query tiles per head split with the splits' fp32 partials
added in split order, dq over key tiles of 64 (32 at head dim 256). It is
held against the gradients of the JAX package's flash custom_vjp
(``repro.kernels.ops.attention(impl="flash")``) at deepseek-like (MHA,
head dim 128, causal), recurrentgemma-like (MQA, head dim 256, sliding
window) and deepseek-v2-like (MLA: MHA at head dim 192, v and do
zero-padded from 128, so dv's padded columns must come out exactly 0)
small shapes and the softcap variant, within
chip_smoke.py's bf16 limits: 2e-2 elementwise (rtol and atol) and a
relative L2 error of 1e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
REL_L2_BF16 = 1e-2
LOG2E = 1.4426950408889634
CHUNK = 32            # the JAX side's chunk_q and chunk_k


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 192, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 16, "fma"), (torch.bfloat16, 32, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"),
    (torch.float32, 192, "fma"), (torch.float32, 256, "fma"),
    (torch.bfloat16, 8, "fma"), (torch.float32, 8, "fma")])
def test_bwd_kernel_for_routes_by_dtype_and_head_dim(dtype, hd, want):
    """The forward's rule, head dim 192 (MLA) included: bf16 at 64 to 256
    on the tensor cores, fp32 (the twins) and the smoke head dims (8 among
    them, internvl2-76b's) on FMA."""
    assert fa.bwd_kernel_for(dtype, hd) == want == fa.kernel_for(dtype, hd)


@pytest.mark.parametrize("hd,want", [(64, 128), (128, 128), (192, 64),
                                     (256, 64)])
def test_bwd_key_tile_by_head_dim(hd, want):
    """The dk/dv kernel's key tile: 128 keys (64 a consumer) at head dims
    64 and 128; one shared 64-key tile at 192 and 256, where dk and dv of
    a consumer's own 64 keys would not fit its registers."""
    assert fa.bwd_key_tile(hd) == want


@pytest.mark.parametrize("B,Sk,Kh,G,hd,want", [
    (1, 2048, 32, 1, 128, 1),      # deepseek-7b's trained shape: 512 CTAs
    (1, 2048, 1, 16, 256, 16),     # recurrentgemma-9b's MQA: 32 key tiles
    (2, 2048, 2, 8, 256, 4),       # 2 x 32 x 2 = 128 CTAs; x2 = 256 < 264
    (1, 2048, 128, 1, 192, 1),     # deepseek-v2's MLA: 32 x 128 CTAs
    (1, 64, 1, 6, 128, 6)])        # never 2 x SMS: G itself
def test_bwd_head_splits_divide_the_group(B, Sk, Kh, G, hd, want):
    d = fa.bwd_head_splits(B, Sk, Kh, G, fa.bwd_key_tile(hd))
    assert d == want and G % d == 0
    if d < G:
        assert B * -(-Sk // fa.bwd_key_tile(hd)) * Kh * d >= 2 * fa.SMS


def test_tc_backward_raises_on_a_layout_tma_cannot_read():
    """bf16 at a tensor-core head dim: a do whose head stride is not a
    multiple of 16 bytes raises before any launch; nothing is copied."""
    q = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    do = torch.zeros((1, 64, 2, 132), dtype=torch.bfloat16)[..., :128]
    lse = torch.zeros((1, 64, 2))
    with pytest.raises(ValueError, match="do's stride 132 in dim 2"):
        fa._launch_bwd(q, q, q, q, lse, do, causal=True, window=0,
                       softcap=0.0, scale=128 ** -0.5)


def _mask(qpos, kpos, causal, window):
    keep = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool)
    if causal:
        keep &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        keep &= (qpos[:, None] - kpos[None, :]) < window
    return keep


def emulate_bwd_tc(q, k, v, o, lse, do, *, causal=True, window=0,
                   softcap=0.0, rounding=True):
    """The tensor-core backward's arithmetic in plain torch, fp32 results
    before the one rounding to the inputs' dtype: delta = rowsum(do o) and
    lse2 = lse log2(e); p = exp2(x - lse2) with x the scaled (soft-capped)
    score in log2 units, 0 where masked; ds = p (dp - delta) (1 - t^2)
    scale. dk and dv: per head split (``fa.bwd_head_splits``), the split's
    heads in order, 64-query tiles in order, p and ds rounded to bf16
    (``rounding``) for p^T.do and ds^T.q; the splits' partials summed in
    order. dq: key tiles of 64 (32 at head dim 256) in order, ds rounded
    for ds.k. Tiles the kernels skip contribute exact zeros here."""
    B, Sq, H, hd = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    scale = hd ** -0.5
    off = Sk - Sq
    rnd = (lambda x: x.to(torch.bfloat16).float()) if rounding else \
        (lambda x: x)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)                       # [B,Sq,H]
    lse2 = lse.float() * LOG2E

    def p_ds(s, dp, keep, l2, dl):
        """s, dp [..., rows, cols]; l2, dl broadcast to them."""
        if softcap > 0:
            t = torch.tanh(s * scale / softcap)
            x, f = t * softcap * LOG2E, scale * (1 - t * t)
        else:
            x, f = s * (scale * LOG2E), scale
        p = torch.where(keep, torch.exp2(x - l2), torch.zeros_like(x))
        return p, p * (dp - dl) * f

    n_split = fa.bwd_head_splits(B, Sk, Kh, G, fa.bwd_key_tile(hd))
    kpos = torch.arange(Sk)
    dk = dv = None
    for sp in range(n_split):
        pk = torch.zeros((B, Sk, Kh, hd))
        pv = torch.zeros((B, Sk, Kh, hd))
        for gi in range(G // n_split):
            hs = [kvh * G + sp * (G // n_split) + gi for kvh in range(Kh)]
            for q0 in range(0, Sq, 64):
                q1 = min(q0 + 64, Sq)
                qt, dt = qf[:, q0:q1, hs], dof[:, q0:q1, hs]  # [B,q,Kh,hd]
                st = torch.einsum("bckd,bqkd->bkcq", kf, qt)  # S^T
                dpt = torch.einsum("bckd,bqkd->bkcq", vf, dt)
                keep = _mask(off + torch.arange(q0, q1), kpos, causal,
                             window).T                          # [keys, q]
                l2 = lse2[:, q0:q1, hs].permute(0, 2, 1)[:, :, None]
                dl = delta[:, q0:q1, hs].permute(0, 2, 1)[:, :, None]
                p, ds = p_ds(st, dpt, keep, l2, dl)
                pv += torch.einsum("bkcq,bqkd->bckd", rnd(p), dt)
                pk += torch.einsum("bkcq,bqkd->bckd", rnd(ds), qt)
        dk, dv = (pk, pv) if dk is None else (dk + pk, dv + pv)

    bk = 32 if hd == 256 else 64           # the dq kernel's key tile
    qh = qf.reshape(B, Sq, Kh, G, hd)
    doh = dof.reshape(B, Sq, Kh, G, hd)
    l2 = lse2.reshape(B, Sq, Kh, G).permute(0, 2, 3, 1)[..., None]
    dl = delta.reshape(B, Sq, Kh, G).permute(0, 2, 3, 1)[..., None]
    qpos = off + torch.arange(Sq)
    dq = torch.zeros((B, Sq, Kh, G, hd))
    for k0 in range(0, Sk, bk):
        k1 = min(k0 + bk, Sk)
        s = torch.einsum("bqkgd,bckd->bkgqc", qh, kf[:, k0:k1])
        dp = torch.einsum("bqkgd,bckd->bkgqc", doh, vf[:, k0:k1])
        keep = _mask(qpos, torch.arange(k0, k1), causal, window)
        _, ds = p_ds(s, dp, keep, l2, dl)
        dq += torch.einsum("bkgqc,bckd->bqkgd", rnd(ds), kf[:, k0:k1])
    return dq.reshape(B, Sq, H, hd), dk, dv


# (B, Sq, Sk, H, Kh, hd): deepseek-like MHA at head dim 128 (Sq ragged in
# 64-query tiles and the dq kernel's 128), recurrentgemma-like MQA at head
# dim 256 (Sq < Sk, Sk ragged in 64-key tiles, four head splits),
# deepseek-v2-like MLA at head dim 192 (ragged in the shared 64-key tile)
SHAPES = {"deepseek": (1, 224, 224, 4, 4, 128),
          "recurrentgemma": (1, 160, 288, 4, 1, 256),
          "mla": (1, 160, 160, 4, 4, 192)}
# MLA's v is zero-padded from 128 to 192 and its output sliced back, so
# the output's gradient do is zero in those columns too
V_HEAD = {"mla": 128}
CASES = {"deepseek-causal": ("deepseek", dict(causal=True)),
         "mla-causal": ("mla", dict(causal=True)),
         "deepseek-softcap": ("deepseek", dict(causal=True, softcap=20.0)),
         "recurrentgemma-window": ("recurrentgemma",
                                   dict(causal=True, window=96)),
         "recurrentgemma-softcap": ("recurrentgemma",
                                    dict(causal=True, softcap=20.0))}


def _inputs(shape, seed, v_head=None):
    """q, k, v, do as numpy fp32 arrays holding bf16 values; v and do zero
    past ``v_head`` columns when it is given (MLA)."""
    B, Sq, Sk, H, Kh, hd = shape
    rng = np.random.RandomState(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in
           ((B, Sq, H, hd), (B, Sk, Kh, hd), (B, Sk, Kh, hd), (B, Sq, H, hd))]
    if v_head is not None:
        out[2][..., v_head:] = 0.0
        out[3][..., v_head:] = 0.0
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in out]


def _jax_grads(q, k, v, do, variant):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops

    def loss(q, k, v):
        o = ops.attention(q, k, v, impl="flash", chunk_q=CHUNK,
                          chunk_k=CHUNK, **variant)
        return jnp.sum(o * do)
    return [torch.from_numpy(np.array(g)) for g in jax.grad(
        loss, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _emulated(shape, variant, seed, rounding=True, v_head=None):
    """The kernel path's inputs in bf16, the plain forward's o (bf16) and
    lse, and the emulated gradients (fp32)."""
    q, k, v, do = [torch.from_numpy(a).bfloat16()
                   for a in _inputs(shape, seed, v_head)]
    kw = {"causal": True, "window": 0, "softcap": 0.0, **variant}
    o, lse = fa.attention_fwd_lse_plain(q, k, v, **kw)
    return (q, k, v, o, lse, do, kw,
            emulate_bwd_tc(q, k, v, o, lse, do, rounding=rounding, **kw))


@pytest.mark.parametrize("case", list(CASES))
def test_tc_backward_numerics_within_sweep_limits_of_jax_flash_vjp(case):
    shape_name, variant = CASES[case]
    shape, v_head = SHAPES[shape_name], V_HEAD.get(shape_name)
    *_, got = _emulated(shape, variant, seed=21, v_head=v_head)
    want = _jax_grads(*_inputs(shape, 21, v_head), variant)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.bfloat16()                       # the kernels' one rounding
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), **TOL_BF16,
                                   err_msg=name)
        assert _rel(g, w) <= REL_L2_BF16, (name, _rel(g, w))
    if v_head is not None:        # p^T.do over do's zero columns: exact 0
        assert bool((got[2][..., v_head:] == 0).all())
        assert bool((want[2][..., v_head:] == 0).all())
        assert bool((got[2][..., :v_head] != 0).any())


@pytest.mark.parametrize("case", ["deepseek-causal", "recurrentgemma-window",
                                  "mla-causal"])
def test_p_and_ds_rounding_sits_inside_the_bf16_limits(case):
    """Rounding P and dS to bf16 moves the gradients by a few 1e-3
    (relative L2) from the fp32 plain backward on the same o and lse, well
    inside the 1e-2 limit; without the roundings the emulation is the
    plain backward up to the order of its sums."""
    shape_name, variant = CASES[case]
    q, k, v, o, lse, do, kw, got = _emulated(SHAPES[shape_name], variant,
                                             seed=23,
                                             v_head=V_HEAD.get(shape_name))
    exact = emulate_bwd_tc(q, k, v, o, lse, do, rounding=False, **kw)
    f32 = [t.float() for t in (q, k, v)]
    want = fa.attention_bwd_plain(*f32, o.float(), lse, do.float(), **kw)
    for name, g, x, w in zip(("dq", "dk", "dv"), got, exact, want):
        assert _rel(x, w) < 1e-5, (name, _rel(x, w))
        assert 5e-4 < _rel(g, w) < REL_L2_BF16 / 2, (name, _rel(g, w))
