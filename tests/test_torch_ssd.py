"""Port's Mamba-2 SSD vs the JAX package's, and the CUDA kernel vs its plain
version (on a card only).

Inputs are made from a numpy seed and handed to both packages. Tolerances
are those of tests/test_kernels.py: 1e-4 in float32 (the same math summed
in another order), 3e-2 in bfloat16 (x, B, C and y in bf16; the Pallas
kernel rounds y before its D add, the port once after it). The JAX side is
imported by a fixture, so that the card's test run (``-m gpu``, on a host
without JAX) can collect this file.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, ssd

# (B, S, H, P, G, N, chunk): the shapes of tests/test_kernels.py, a ragged S
SSD_SHAPES = [(1, 64, 2, 8, 1, 8, 32), (2, 128, 4, 16, 2, 8, 32),
              (1, 72, 2, 8, 1, 8, 32)]
DTYPES = {"f32": (torch.float32, "float32"),
          "bf16": (torch.bfloat16, "bfloat16")}


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.ssd import ssd_scan
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref, scan=ssd_scan)


def _tol(dname):
    return dict(rtol=3e-2, atol=3e-2) if dname == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)


def _ssd_np(seed, B, S, H, P, G, N):
    """x, dt (softplus'd), A_log, B, C, D as numpy fp32."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    al = (rng.standard_normal(H) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    return x, dt, al, bm, cm, d


def _torch_in(arrs, dname="f32", device="cpu"):
    """x, B, C in the working dtype; dt, A_log, D in fp32."""
    tdt = DTYPES[dname][0]
    x, dt, al, bm, cm, d = [torch.from_numpy(a).to(device) for a in arrs]
    return x.to(tdt), dt, al, bm.to(tdt), cm.to(tdt), d


def _jax_in(J, arrs, dname="f32"):
    jdt = DTYPES[dname][1]
    x, dt, al, bm, cm, d = [J.jnp.asarray(a) for a in arrs]
    return x.astype(jdt), dt, al, bm.astype(jdt), cm.astype(jdt), d


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "ref", "blocked"])
def test_plain_ssd_vs_jax(J, shape, dname, oracle):
    B, S, H, P, G, N, chunk = shape
    arrs = _ssd_np(0, B, S, H, P, G, N)
    x, dt, al, bm, cm, d = _torch_in(arrs, dname)
    y, h = ssd.ssd_scan(x, dt, al, bm, cm, D=d, chunk=chunk)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    jx, jdt, jal, jb, jc, jd = _jax_in(J, arrs, dname)
    if oracle == "pallas_interpret":
        wy, wh = J.scan(jx, jdt, jal, jb, jc, D=jd, chunk=chunk,
                        interpret=True)
    elif oracle == "ref":
        f32 = J.jnp.float32
        wy, wh = J.ref.ssd_ref(jx.astype(f32), jdt, jal, jb.astype(f32),
                               jc.astype(f32), D=jd)
    else:
        wy, wh = J.ops.ssd(jx, jdt, jal, jb, jc, D=jd, chunk=chunk,
                           impl="blocked")
    np.testing.assert_allclose(_f32(y), _f32(wy), **_tol(dname))
    np.testing.assert_allclose(_f32(h), _f32(wh), **_tol(dname))


def test_torch_ssd_ref_matches_jax_ref(J):
    arrs = _ssd_np(1, 2, 40, 4, 8, 2, 16)
    got = ref.ssd_ref(*_torch_in(arrs)[:5], D=_torch_in(arrs)[5])
    jx, jdt, jal, jb, jc, jd = _jax_in(J, arrs)
    want = J.ref.ssd_ref(jx, jdt, jal, jb, jc, D=jd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **_tol("f32"))


@pytest.mark.parametrize("chunk", [8, 32, 256])
def test_plain_ssd_vs_torch_oracle(chunk):
    """Any blocking (the gcd rule included: S=72 with 256 gives one chunk,
    with 32 gives chunks of 8) is the sequential oracle's function."""
    arrs = _ssd_np(2, 2, 72, 4, 16, 2, 8)
    x, dt, al, bm, cm, d = _torch_in(arrs)
    y, h = ops.ssd(x, dt, al, bm, cm, D=d, chunk=chunk, impl="plain")
    yr, hr = ref.ssd_ref(x, dt, al, bm, cm, D=d)
    np.testing.assert_allclose(_f32(y), _f32(yr), **_tol("f32"))
    np.testing.assert_allclose(_f32(h), _f32(hr), **_tol("f32"))


@pytest.mark.parametrize("impl", ["port", "jax_blocked"])
def test_two_halves_carry_state(J, impl):
    """tests/test_kernels.py::test_ssd_chunked_jnp_matches_ref_with_state:
    the chunked path with an h0 carry over two halves equals one pass."""
    B, S, H, P, G, N = 2, 128, 4, 16, 2, 8
    arrs = _ssd_np(3, B, S, H, P, G, N)
    x, dt, al, bm, cm, _ = _torch_in(arrs)
    y_full, h_full = ssd.ssd_scan(x, dt, al, bm, cm, chunk=32)
    h, ys = None, []
    for lo in (0, S // 2):
        hi = lo + S // 2
        y, h = ssd.ssd_scan(x[:, lo:hi], dt[:, lo:hi], al, bm[:, lo:hi],
                            cm[:, lo:hi], h0=h, chunk=32)
        ys.append(y)
    np.testing.assert_allclose(_f32(torch.cat(ys, 1)), _f32(y_full),
                               **_tol("f32"))
    np.testing.assert_allclose(_f32(h), _f32(h_full), **_tol("f32"))
    if impl == "jax_blocked":
        jx, jdt, jal, jb, jc, _ = _jax_in(J, arrs)
        wy, wh = J.ops.ssd(jx, jdt, jal, jb, jc, chunk=32, impl="blocked")
        np.testing.assert_allclose(_f32(torch.cat(ys, 1)), _f32(wy),
                                   **_tol("f32"))
        np.testing.assert_allclose(_f32(h), _f32(wh), **_tol("f32"))


@pytest.mark.parametrize("with_d", [True, False])
def test_ssd_decode_vs_jax(J, with_d):
    rng = np.random.RandomState(4)
    b, H, P, G, N = 3, 4, 8, 2, 16
    h = rng.standard_normal((b, H, P, N)).astype(np.float32)
    x = rng.standard_normal((b, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, H)))).astype(np.float32)
    al = (rng.standard_normal(H) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, G, N)).astype(np.float32)
    cm = rng.standard_normal((b, G, N)).astype(np.float32)
    d = rng.standard_normal(H).astype(np.float32) if with_d else None
    arrs = [h, x, dt, al, bm, cm]
    got = ops.ssd_decode(*[torch.from_numpy(a) for a in arrs],
                         D=None if d is None else torch.from_numpy(d))
    want = J.ops.ssd_decode(*[J.jnp.asarray(a) for a in arrs],
                            D=None if d is None else J.jnp.asarray(d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **_tol("f32"))


def test_decode_steps_continue_the_scan():
    """A scan over S rows, then single steps, equals one scan over all."""
    B, S, H, P, G, N = 2, 40, 4, 8, 1, 16
    arrs = _ssd_np(5, B, S, H, P, G, N)
    x, dt, al, bm, cm, d = _torch_in(arrs)
    y_full, h_full = ssd.ssd_scan(x, dt, al, bm, cm, D=d, chunk=16)
    _, h = ssd.ssd_scan(x[:, :32], dt[:, :32], al, bm[:, :32], cm[:, :32],
                        D=d, chunk=16)
    for t in range(32, S):
        y_t, h = ops.ssd_decode(h, x[:, t], dt[:, t], al, bm[:, t], cm[:, t],
                                D=d)
        np.testing.assert_allclose(_f32(y_t), _f32(y_full[:, t]),
                                   **_tol("f32"))
    np.testing.assert_allclose(_f32(h), _f32(h_full), **_tol("f32"))


def test_wrapper_counts_no_launch_on_cpu():
    before = ssd.launches
    ssd.ssd_scan(*_torch_in(_ssd_np(6, 1, 16, 2, 8, 1, 8))[:5])
    assert ssd.launches == before


def test_wrapper_rejects_what_kernel_cannot_take():
    x, dt, al, bm, cm, d = _torch_in(_ssd_np(7, 1, 16, 2, 8, 1, 8))
    with pytest.raises(TypeError, match="dt"):
        ssd.ssd_scan(x, dt.double(), al, bm, cm)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.half(), dt, al, bm.half(), cm.half())
    with pytest.raises(ValueError, match="h0"):
        ssd.ssd_scan(x, dt, al, bm, cm, h0=torch.zeros(1, 2, 8, 4))
    with pytest.raises(ValueError, match="H % G"):
        ssd.ssd_scan(x, dt, al, torch.zeros(1, 16, 3, 8),
                     torch.zeros(1, 16, 3, 8))
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ops.ssd(x, dt, al, bm, cm, impl="pallas")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """Both routes: bf16 at P in {16, 32, 64} and N in {16, 128} on the
    tensor-core kernels, the rest on the FMA kernel; each launch counted
    under its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cases = [s[:6] for s in SSD_SHAPES] + [(1, 333, 8, 64, 1, 128),
                                           (2, 100, 4, 32, 2, 16),
                                           (3, 1, 4, 16, 1, 16),
                                           (1, 257, 6, 64, 3, 16),
                                           (1, 2048, 80, 64, 1, 128)]
    for B, S, H, P, G, N in cases:
        arrs = _ssd_np(8, B, S, H, P, G, N)
        for dname in ("f32", "bf16"):
            x, dt, al, bm, cm, d = _torch_in(arrs, dname, "cuda")
            h0 = torch.randn((B, H, P, N), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
            route = ssd.kernel_for(x.dtype, P, N)
            assert route == ("tc" if dname == "bf16" and P >= 16 and N >= 16
                             else "fma")
            for kw in (dict(), dict(D=d), dict(D=d, h0=h0)):
                before = ssd.launches
                counted = getattr(ssd, f"launches_{route}")
                y, h = ssd.ssd_scan(x, dt, al, bm, cm, **kw)
                torch.cuda.synchronize()
                assert ssd.launches == before + 1
                assert getattr(ssd, f"launches_{route}") == counted + 1
                wy, wh = ssd.ssd_plain(x, dt, al, bm, cm, **kw)
                msg = f"{(B, S, H, P, G, N)} {dname} {sorted(kw)}"
                np.testing.assert_allclose(_f32(y.cpu()), _f32(wy.cpu()),
                                           **_tol(dname), err_msg=msg)
                np.testing.assert_allclose(_f32(h.cpu()), _f32(wh.cpu()),
                                           **_tol(dname), err_msg=msg)


@pytest.mark.gpu
def test_cuda_tensor_core_route_raises_on_what_tma_cannot_read():
    """No fallback: a bf16 x that TMA cannot read in place (its start 2
    bytes off 16) raises instead of running another kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, dt, al, bm, cm, d = _torch_in(_ssd_np(9, 1, 64, 4, 64, 1, 128), "bf16",
                                     "cuda")
    flat = torch.zeros(x.numel() + 8, dtype=x.dtype, device="cuda")
    xs = flat[1:1 + x.numel()].view(x.shape)
    xs.copy_(x)
    before = (ssd.launches, ssd.launches_tc, ssd.launches_fma)
    with pytest.raises(ValueError, match="x does not start on 16 bytes"):
        ssd.ssd_scan(xs, dt, al, bm, cm, D=d)
    assert (ssd.launches, ssd.launches_tc, ssd.launches_fma) == before
