"""Port's RG-LRU scan vs the JAX package's, and the CUDA kernel vs its plain
version (on a card only).

Inputs are made from a numpy seed and handed to both packages. Tolerances
are ``_tol`` of tests/test_kernels.py: 2e-5 in float32 (the same math, the
recurrence combined in another order), 2e-2 in bfloat16 (x, the gates and
y in bf16). The JAX side is imported by a fixture, so that the card's test
run (``-m gpu``, on a host without JAX) can collect this file.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, rglru

# (B, S, D): the shapes of tests/test_kernels.py, a ragged one
SHAPES = [(1, 64, 16), (2, 128, 48), (2, 100, 24)]
DTYPES = {"f32": (torch.float32, "float32"),
          "bf16": (torch.bfloat16, "bfloat16")}


@pytest.fixture(scope="module")
def J():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.rglru import rglru_scan
    return SimpleNamespace(jnp=jnp, ops=jops, ref=jref, scan=rglru_scan)


def _tol(dname):
    return dict(rtol=2e-2, atol=2e-2) if dname == "bf16" else \
        dict(rtol=2e-5, atol=2e-5)


def _np_in(seed, B, S, D):
    """x, a_log, gate_a, gate_x, h0 as numpy fp32."""
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal(D).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _torch_in(arrs, dname="f32", device="cpu"):
    """x and the gates in the working dtype; a_log and h0 in fp32."""
    tdt = DTYPES[dname][0]
    x, al, ga, gx, h0 = [torch.from_numpy(a).to(device) for a in arrs]
    return x.to(tdt), al, ga.to(tdt), gx.to(tdt), h0


def _jax_in(J, arrs, dname="f32"):
    jdt = DTYPES[dname][1]
    x, al, ga, gx, h0 = [J.jnp.asarray(a) for a in arrs]
    return x.astype(jdt), al, ga.astype(jdt), gx.astype(jdt), h0


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "ref", "blocked",
                                    "blocked_h0"])
def test_plain_rglru_vs_jax(J, shape, dname, oracle):
    arrs = _np_in(0, *shape)
    x, al, ga, gx, h0 = _torch_in(arrs, dname)
    jx, jal, jga, jgx, jh0 = _jax_in(J, arrs, dname)
    with_h0 = oracle == "blocked_h0"
    y, h = ops.rglru(x, al, ga, gx, h0=h0 if with_h0 else None)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (shape[0], shape[2])
    if oracle == "pallas_interpret":
        wy, wh = J.scan(jx, jal, jga, jgx, block_d=16, block_t=32,
                        interpret=True)
    elif oracle == "ref":
        f32 = J.jnp.float32
        wy, wh = J.ref.rglru_ref(jx.astype(f32), jal, jga.astype(f32),
                                 jgx.astype(f32))
    else:
        wy, wh = J.ops.rglru(jx, jal, jga, jgx, h0=jh0 if with_h0 else None,
                             impl="blocked")
    np.testing.assert_allclose(_f32(y), _f32(wy), **_tol(dname))
    np.testing.assert_allclose(_f32(h), _f32(wh), **_tol(dname))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_torch_rglru_ref_matches_jax_ref(J, dname):
    arrs = _np_in(1, 2, 40, 24)
    x, al, ga, gx, _ = _torch_in(arrs, dname)
    got = ref.rglru_ref(x, al, ga, gx, c=6.0)
    jx, jal, jga, jgx, _ = _jax_in(J, arrs, dname)
    want = J.ref.rglru_ref(jx, jal, jga, jgx, c=6.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **_tol(dname))


@pytest.mark.parametrize("S", [1, 2, 33, 64])
def test_plain_rglru_vs_torch_oracle(S):
    """The doubling scan at lengths below, at and off a power of two."""
    x, al, ga, gx, _ = _torch_in(_np_in(2, 2, S, 12))
    y, h = ops.rglru(x, al, ga, gx, impl="plain")
    yr, hr = ref.rglru_ref(x, al, ga, gx)
    np.testing.assert_allclose(_f32(y), _f32(yr), **_tol("f32"))
    np.testing.assert_allclose(_f32(h), _f32(hr), **_tol("f32"))


@pytest.mark.parametrize("impl", ["port", "jax_blocked"])
def test_two_halves_carry_state(J, impl):
    """A scan over [0, S/2), then [S/2, S) from its h_final, equals one
    scan over [0, S)."""
    B, S, D = 2, 128, 48
    arrs = _np_in(3, B, S, D)
    x, al, ga, gx, _ = _torch_in(arrs)
    y_full, h_full = rglru.rglru_scan(x, al, ga, gx)
    h, ys = None, []
    for lo in (0, S // 2):
        hi = lo + S // 2
        y, h = rglru.rglru_scan(x[:, lo:hi], al, ga[:, lo:hi],
                                gx[:, lo:hi], h0=h)
        ys.append(y)
    np.testing.assert_allclose(_f32(torch.cat(ys, 1)), _f32(y_full),
                               **_tol("f32"))
    np.testing.assert_allclose(_f32(h), _f32(h_full), **_tol("f32"))
    if impl == "jax_blocked":
        jx, jal, jga, jgx, _ = _jax_in(J, arrs)
        jh, jys = None, []
        for lo in (0, S // 2):
            hi = lo + S // 2
            jy, jh = J.ops.rglru(jx[:, lo:hi], jal, jga[:, lo:hi],
                                 jgx[:, lo:hi], h0=jh, impl="blocked")
            jys.append(jy)
        np.testing.assert_allclose(_f32(torch.cat(ys, 1)),
                                   _f32(J.jnp.concatenate(jys, 1)),
                                   **_tol("f32"))
        np.testing.assert_allclose(_f32(h), _f32(jh), **_tol("f32"))


def test_rglru_decode_vs_jax(J):
    rng = np.random.RandomState(4)
    B, D = 3, 20
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, D), (B, D), (D,), (B, D), (B, D))]
    got = ops.rglru_decode(*[torch.from_numpy(a) for a in arrs], c=8.0)
    want = J.ops.rglru_decode(*[J.jnp.asarray(a) for a in arrs], c=8.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **_tol("f32"))
    assert got[1].dtype == torch.float32


def test_decode_steps_equal_full_scan():
    """tests/test_kernels.py::test_decode_kernels_match_full_scan, torch
    side: a single step at every position equals the full scan."""
    B, S, D = 2, 16, 12
    x, al, ga, gx, _ = _torch_in(_np_in(5, B, S, D))
    y_full, h_full = ops.rglru(x, al, ga, gx)
    h = torch.zeros((B, D))
    for t in range(S):
        y_t, h = ops.rglru_decode(h, x[:, t], al, ga[:, t], gx[:, t])
        np.testing.assert_allclose(_f32(y_t), _f32(y_full[:, t]),
                                   **_tol("f32"))
    np.testing.assert_allclose(_f32(h), _f32(h_full), **_tol("f32"))


def test_wrapper_counts_no_launch_on_cpu():
    before = rglru.launches
    rglru.rglru_scan(*_torch_in(_np_in(6, 1, 16, 8))[:4])
    assert rglru.launches == before


def test_wrapper_rejects_what_kernel_cannot_take():
    x, al, ga, gx, h0 = _torch_in(_np_in(7, 1, 16, 8))
    with pytest.raises(TypeError, match="gate_a"):
        rglru.rglru_scan(x, al, ga.half(), gx)
    with pytest.raises(TypeError, match="x"):
        rglru.rglru_scan(x.double(), al, ga, gx)
    with pytest.raises(ValueError, match="h0"):
        rglru.rglru_scan(x, al, ga, gx, h0=torch.zeros(1, 4))
    with pytest.raises(ValueError, match="a_log"):
        rglru.rglru_scan(x, torch.zeros(4), ga, gx)
    with pytest.raises(ValueError, match="one shape"):
        rglru.rglru_scan(x, al, ga[:, :8], gx)
    with pytest.raises(ValueError, match="unknown rglru impl"):
        ops.rglru(x, al, ga, gx, impl="pallas")


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # the time split: one chunk, ragged last chunks, many chunks and lane
    # blocks (chunks of rglru.CHUNK_STEPS steps)
    cases = SHAPES + [(1, 333, 100), (3, 1, 48), (1, 2048, 4096),
                      (2, 1000, 300), (1, 2176, 4096)]
    for B, S, D in cases:
        arrs = _np_in(8, B, S, D)
        for dname in ("f32", "bf16"):
            x, al, ga, gx, h0 = _torch_in(arrs, dname, "cuda")
            for kw in (dict(), dict(h0=h0)):
                before = rglru.launches
                y, h = rglru.rglru_scan(x, al, ga, gx, **kw)
                torch.cuda.synchronize()
                assert rglru.launches == before + 1
                wy, wh = rglru.rglru_plain(x, al, ga, gx, **kw)
                msg = f"{(B, S, D)} {dname} {sorted(kw)}"
                np.testing.assert_allclose(_f32(y.cpu()), _f32(wy.cpu()),
                                           **_tol(dname), err_msg=msg)
                np.testing.assert_allclose(_f32(h.cpu()), _f32(wh.cpu()),
                                           **_tol(dname), err_msg=msg)
