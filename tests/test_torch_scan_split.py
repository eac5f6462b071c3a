"""The SSD and RG-LRU kernels' decompositions, emulated on the CPU.

The kernels run only on a card (the ``gpu`` tests of test_torch_ssd.py and
test_torch_rglru.py, and chip_smoke.py). Here, in plain torch at the
kernels' blocking:

* the SSD tensor-core design (``csrc/ssd.cu``): chunks of 128 rows; each
  chunk's state contribution ``(w o x)^T . B`` with ``w o x`` rounded to
  bf16; the state pass in fp32 from h0 with each chunk's entering state
  rounded to bf16; the outputs ``exp(La) C . h_in`` plus the decay-masked
  ``C . B^T`` block rounded to bf16 times x (the decay left of the
  diagonal factored through row 63), plus ``D x``, rounded once.
  Held against the JAX ``ssd_ref`` and the port's ``ssd_plain`` within
  chip_smoke.py's bf16 limits: 3e-2 elementwise (``SSD_TOL``) and a
  relative L2 error of 1e-2 (``REL_L2``);
* the RG-LRU time split (``csrc/rglru.cu``): chunks of T steps, each run
  from h = 0 to its carry ``(prod a, h)``; the carries folded from h0, in
  order or backward from an end state as the kernel's look-back does; each
  chunk rerun from its entering state. Held against the JAX ``rglru_ref``
  (the blocked path with h0) and ``rglru_plain`` in fp32 within a relative
  L2 error of 1e-5;

and the wrappers' routing (``ssd.kernel_for``), chunk sizes
(``rglru.CHUNK_STEPS``) and TMA checks. The JAX side is imported by a
fixture.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru, ssd

SSD_TOL = dict(rtol=3e-2, atol=3e-2)
REL_L2_BF16 = 1e-2
REL_L2_F32 = 1e-5


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref)


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a, np.float32)), \
        torch.as_tensor(np.array(b, np.float32))
    return ((a - b).norm() / b.norm()).item()


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, dtype=np.float32)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,P,N,want", [
    (torch.bfloat16, 64, 128, "tc"), (torch.bfloat16, 32, 16, "tc"),
    (torch.bfloat16, 16, 16, "tc"), (torch.bfloat16, 16, 128, "tc"),
    (torch.bfloat16, 8, 128, "fma"), (torch.bfloat16, 64, 8, "fma"),
    (torch.float32, 64, 128, "fma"), (torch.float32, 16, 16, "fma")])
def test_ssd_kernel_for_routes_by_dtype_p_and_n(dtype, P, N, want):
    assert ssd.kernel_for(dtype, P, N) == want


def test_ssd_kernel_for_rejects_other_sizes():
    with pytest.raises(ValueError, match="P=48"):
        ssd.kernel_for(torch.bfloat16, 48, 128)
    with pytest.raises(ValueError, match="N=64"):
        ssd.kernel_for(torch.bfloat16, 64, 64)


def test_ssd_tma_check_names_the_scan():
    x = torch.zeros((1, 33, 4, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="ssd_scan .*x's stride 68 in dim 2"):
        ssd.check_tma("ssd_scan", x=x)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def emulate_ssd_tc(x, dt, A_log, B, C, *, D=None, h0=None, Q=ssd.TC_CHUNK,
                   rnd=_bf16):
    """The tensor-core design's arithmetic in plain torch (see the module
    docstring); rows past S are zeros, as the kernel's TMA reads them.
    ``rnd`` rounds the three operands that the kernel rounds to bf16."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    nc = -(-S // Q)
    pad = nc * Q - S

    def rows(t):           # [b, S, ...] -> [b, nc, Q, ...], zero rows past S
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, Q, *t.shape[2:])
    xf, dtf = rows(x), rows(dt)
    Bf = rows(B).repeat_interleave(rep, 3)
    Cf = rows(C).repeat_interleave(rep, 3)
    La = torch.cumsum(-torch.exp(A_log.float()) * dtf, 2)      # [b,nc,Q,H]
    # 1. chunk states from (w o x) in bf16, then the state pass in fp32
    w = torch.exp(La[:, :, -1:] - La) * dtf
    Sc = torch.einsum("bcqhp,bcqhn->bchpn", rnd(w[..., None] * xf), Bf)
    dec = torch.exp(La[:, :, -1])
    h = torch.zeros((b, H, P, N)) if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(rnd(h))
        h = dec[:, c, :, None, None] * h + Sc[:, c]
    h_in = torch.stack(h_in, 1)                                 # [b,nc,H,P,N]
    # 2. outputs: the inter term, then the masked block in bf16 times x
    y = torch.einsum("bcqhn,bchpn->bcqhp", Cf, h_in) * \
        torch.exp(La)[..., None]
    s = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)
    decay = torch.exp(torch.clamp(La[:, :, :, None] - La[:, :, None, :],
                                  -60.0, 0.0)).permute(0, 1, 4, 2, 3)
    # left of the diagonal (rows 64.., columns ..63) the kernel factors the
    # decay through row 63: exp(La_i - La_63) exp(La_63 - La_j), clamped
    mid = La[:, :, 63]                                          # [b,nc,H]
    left = torch.exp(La[:, :, 64:] - mid[:, :, None]).permute(0, 1, 3, 2)[
        ..., :, None] * torch.exp(mid[:, :, None] - La[:, :, :64]).permute(
        0, 1, 3, 2)[..., None, :]
    decay[..., 64:, :64] = torch.clamp(left, float(np.exp(-60.0)), 1.0)
    g = s * decay * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]
    g = torch.where(torch.ones(Q, Q, dtype=torch.bool).tril(), g,
                    torch.zeros(()))
    y = y + torch.einsum("bchij,bcjhp->bcihp", rnd(g), xf)
    y = y.reshape(b, nc * Q, H, P)[:, :S]
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), h


def _ssd_np(seed, b, S, H, P, G, N):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, S, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(
                np.float32),
            (rng.standard_normal(H) * 0.5).astype(np.float32),
            (rng.standard_normal((b, S, G, N)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, S, G, N)) * 0.3).astype(np.float32),
            rng.standard_normal(H).astype(np.float32),
            rng.standard_normal((b, H, P, N)).astype(np.float32))


# (b, S, H, P, G, N): mamba-like (ragged S over three chunks), G = 2, one
# chunk with N = 16
SSD_SHAPES = {"mamba": (1, 333, 8, 64, 1, 128),
              "groups": (2, 200, 4, 32, 2, 128),
              "small_n": (1, 100, 4, 16, 1, 16)}
SSD_VARIANTS = {"none": (), "D": ("D",), "h0": ("h0",), "D+h0": ("D", "h0")}


@pytest.mark.parametrize("variant", list(SSD_VARIANTS))
@pytest.mark.parametrize("shape", list(SSD_SHAPES))
def test_ssd_tc_decomposition_within_bf16_limits(J, shape, variant):
    arrs = _ssd_np(21, *SSD_SHAPES[shape])
    x, dt, al, bm, cm, d, h0 = [torch.from_numpy(a) for a in arrs]
    x, bm, cm = (t.to(torch.bfloat16) for t in (x, bm, cm))
    kw = {k: {"D": d, "h0": h0}[k] for k in SSD_VARIANTS[variant]}
    got_y, got_h = emulate_ssd_tc(x, dt, al, bm, cm, **kw)
    assert got_y.dtype == torch.bfloat16 and got_y.shape == x.shape
    f32 = J.jnp.float32
    jkw = {k: J.jnp.asarray(v.numpy()) for k, v in kw.items()}
    ref_y, ref_h = J.ref.ssd_ref(
        J.jnp.asarray(x.float().numpy()), J.jnp.asarray(arrs[1]),
        J.jnp.asarray(arrs[2]), J.jnp.asarray(bm.float().numpy()),
        J.jnp.asarray(cm.float().numpy()), **jkw)
    plain_y, plain_h = ssd.ssd_plain(x, dt, al, bm, cm, **kw)
    for want_y, want_h in ((np.asarray(ref_y, f32), np.asarray(ref_h, f32)),
                           (_np(plain_y), _np(plain_h))):
        np.testing.assert_allclose(_np(got_y), want_y, **SSD_TOL)
        np.testing.assert_allclose(_np(got_h), want_h, **SSD_TOL)
        assert _rel(_np(got_y), want_y) <= REL_L2_BF16
        assert _rel(_np(got_h), want_h) <= REL_L2_BF16


def test_ssd_tc_roundings_are_the_only_difference():
    """With no bf16 rounding of its three operands the decomposition is the
    plain version's function in fp32 (1e-5); the roundings move y by about
    2e-3 (relative L2), five times inside the 1e-2 limit."""
    arrs = _ssd_np(22, *SSD_SHAPES["mamba"])
    x, dt, al, bm, cm, d, h0 = [torch.from_numpy(a) for a in arrs]
    x, bm, cm = (t.to(torch.bfloat16) for t in (x, bm, cm))
    want = ssd.ssd_plain(x.float(), dt, al, bm.float(), cm.float(), D=d,
                         h0=h0)
    exact = emulate_ssd_tc(x.float(), dt, al, bm.float(), cm.float(), D=d,
                           h0=h0, rnd=lambda t: t)
    got = emulate_ssd_tc(x, dt, al, bm, cm, D=d, h0=h0)
    assert _rel(_np(exact[0]), _np(want[0])) <= REL_L2_F32
    assert _rel(_np(exact[1]), _np(want[1])) <= REL_L2_F32
    assert 5e-4 < _rel(_np(got[0]), _np(want[0])) < REL_L2_BF16 / 4


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_chunk_steps_divide_the_served_prompts_into_many_ctas():
    """2048 CTAs of 128 lanes at recurrentgemma-9b's S=2048 prefill."""
    T = rglru.CHUNK_STEPS
    assert (2048 // T) * (4096 // rglru.LANES) == 2048


def emulate_rglru_split(x, a_log, gate_a, gate_x, *, c=8.0, h0=None, T=32,
                        backward=False):
    """The time split in plain torch: per chunk of T steps the carry (prod a,
    h from 0); the state entering each chunk folded from h0 over the
    carries, in order, or (``backward``) as the look-back folds when only
    the first chunk's end state is published: h_in = P I_0 + H, with P and
    H taken back from the chunk before; then each chunk rerun from it."""
    a, bx = rglru.gates(x, a_log, gate_a, gate_x, c)
    Bn, S, Dn = x.shape
    starts = list(range(0, S, T))
    carries = []
    for t0 in starts:
        A, h = torch.ones(Bn, Dn), torch.zeros(Bn, Dn)
        for t in range(t0, min(S, t0 + T)):
            h = a[:, t] * h + bx[:, t]
            A = A * a[:, t]
        carries.append((A, h))
    h_start = torch.zeros(Bn, Dn) if h0 is None else h0.float()
    h_ins = [h_start]
    if not backward:
        for A, h in carries[:-1]:
            h_ins.append(A * h_ins[-1] + h)
    else:
        A0, h_0 = carries[0]
        incl0 = A0 * h_start + h_0
        for k in range(1, len(starts)):
            P, Hh = torch.ones(Bn, Dn), torch.zeros(Bn, Dn)
            for j in range(k - 1, 0, -1):
                A, h = carries[j]
                Hh = P * h + Hh
                P = P * A
            h_ins.append(P * incl0 + Hh)
    ys = []
    for t0, h in zip(starts, h_ins):
        for t in range(t0, min(S, t0 + T)):
            h = a[:, t] * h + bx[:, t]
            ys.append(h)
    return torch.stack(ys, 1).to(x.dtype), h


def _rglru_np(seed, B, S, D):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, D), (D,), (B, S, D), (B, S, D), (B, D))]


# (B, S, D, T): S not a multiple of T over several chunks, and one chunk
RGLRU_CASES = {"ragged": (2, 77, 24, 16), "one_chunk": (1, 20, 40, 32),
               "many": (1, 200, 16, 8)}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("case", list(RGLRU_CASES))
def test_rglru_time_split_matches_references(J, case, with_h0, backward):
    B, S, D, T = RGLRU_CASES[case]
    arrs = _rglru_np(23, B, S, D)
    x, al, ga, gx, h0 = [torch.from_numpy(a) for a in arrs]
    h0 = h0 if with_h0 else None
    y, h = emulate_rglru_split(x, al, ga, gx, h0=h0, T=T, backward=backward)
    jx, jal, jga, jgx, jh0 = [J.jnp.asarray(a) for a in arrs]
    if with_h0:
        ref = J.ops.rglru(jx, jal, jga, jgx, h0=jh0, impl="blocked")
    else:
        ref = J.ref.rglru_ref(jx, jal, jga, jgx)
    plain = rglru.rglru_plain(x, al, ga, gx, h0=h0)
    for want_y, want_h in ((ref[0], ref[1]), plain):
        assert _rel(_np(y), _np(want_y)) <= REL_L2_F32
        assert _rel(_np(h), _np(want_h)) <= REL_L2_F32
