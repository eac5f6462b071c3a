"""Mamba-2 chunked SSD scan: wrapper of the CUDA kernel and its plain version.

Replaces the TPU kernel ``src/repro/kernels/ssd.py::_kernel`` (Pallas; grid
(b, head, chunk) with the chunk axis run in order and the ``[P,N]`` state in
VMEM scratch). The kernel is ``csrc/ssd.cu``: one CTA per (b, head, 32-wide
block of P) loops over 64-row chunks itself and carries its rows of the
state in fp32, with B, C, x and the decay-masked ``[64,64]`` score tile in
shared memory. The D skip is added inside the kernel, so y is rounded to
x's dtype once.

What bounds it on an H100: the least arithmetic the function needs, that
of the plain recurrence (about ``4NP`` FLOP per row and head; a chunked
form of Q rows adds about ``Q(N+P)``), is some 117 FLOP per byte moved at
the mamba2-2.7b prefill shape (P=64, N=128), below the card's ~295 ridge,
so bytes set the bound: 46 MB at S=2048. This first kernel does its work
as fp32 FMA loops out of shared memory, not on the tensor cores, and
computes the masked half of each score tile. Its times against the bound
are in PERF.md.

``ssd_scan`` launches the kernel for CUDA tensors and counts the launch in
the module-level integer ``launches``. For CPU tensors it runs
``ssd_plain``, the reference's blocked path (``repro/kernels/ops.py::ssd``)
in plain tensor ops; nothing else chooses between the two.
"""
from __future__ import annotations

import ctypes
import math

import torch

P_SIZES = (8, 16, 32, 64)     # head dims (P) the kernel takes
N_SIZES = (8, 16, 128)        # state sizes (N) the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset by the caller
_fn = None


def _check(x, dt, A_log, B, C, D, h0):
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"want x [b,S,H,P], dt [b,S,H], B/C [b,S,G,N]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, S, H) or tuple(B.shape[:2]) != (b, S) \
            or G == 0 or H % G:
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)} and B "
                         f"{tuple(B.shape)} do not agree (b, S, H % G)")
    if tuple(A_log.shape) != (H,) or (D is not None
                                      and tuple(D.shape) != (H,)):
        raise ValueError(f"A_log and D must be [H={H}]")
    if h0 is not None and tuple(h0.shape) != (b, H, P, N):
        raise ValueError(f"h0 {tuple(h0.shape)} is not [b,H,P,N] = "
                         f"{(b, H, P, N)}")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x, B, C must share float32 or bfloat16; got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32:
        raise TypeError(f"dt must be float32 (softplus'd in fp32), got "
                        f"{dt.dtype}")
    devs = {t.device for t in (x, dt, A_log, B, C, D, h0) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"SSD inputs must lie on one device, got {devs}")


def ssd_scan(x, dt, A_log, B, C, *, D=None, h0=None, chunk=256):
    """x: [b,S,H,P]; dt: [b,S,H] fp32; A_log: [H]; B, C: [b,S,G,N];
    D: [H] or None; h0: [b,H,P,N] or None.
    Returns (y [b,S,H,P] in x's dtype, h_final [b,H,P,N] fp32).

    ``chunk`` blocks only the plain version (CPU tensors). The function is
    the same for any blocking, as the reference's own gcd rule shows; the
    kernel blocks by 64 rows and masks the ragged tail."""
    _check(x, dt, A_log, B, C, D, h0)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A_log, B, C, D=D, h0=h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan for device {x.device}")
    return _launch(x, dt, A_log, B, C, D, h0)


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load("ssd").ssd_scan_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 9 + [I] * 7 + [L] * 15 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def _launch(x, dt, A_log, B, C, D, h0):
    global launches
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if P not in P_SIZES or N not in N_SIZES:
        raise ValueError(f"head dim P={P} / state N={N} not among the "
                         f"kernel's {P_SIZES} / {N_SIZES}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride in its last dim")
    fn = _kernel()
    A_log = A_log.float().contiguous()
    D = D.float().contiguous() if D is not None else None
    h0 = h0.float().contiguous() if h0 is not None else None
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    hT = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
                 C.data_ptr(), D.data_ptr() if D is not None else None,
                 h0.data_ptr() if h0 is not None else None, y.data_ptr(),
                 hT.data_ptr(), _DTYPE_CODE[x.dtype], b, S, H, G, P, N,
                 *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                 *C.stride()[:3], *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: CUDA error {err}")
    launches += 1
    return y, hT


# ---------------------------------------------------------------------------
# Plain version (CPU path; the card's comparison target)
# ---------------------------------------------------------------------------


def _chunk_of(s: int, want: int) -> int:
    """The reference's block size: ``want`` if it divides ``s``, else
    gcd(s, want) (``repro/kernels/ops.py::_chunk_of``)."""
    return want if s % want == 0 else math.gcd(s, want)


def ssd_plain(x, dt, A_log, B, C, *, D=None, h0=None, chunk=256):
    """Chunked SSD in fp32 on any device, the reference's blocked path
    (``repro/kernels/ops.py:511-559``): intra-chunk decay-masked
    ``C.B^T`` products, per-chunk end states, a loop over chunks for the
    carried state, and the inter-chunk ``exp(La).C.h_in`` term. The D skip
    is added in fp32 and y is rounded to x's dtype once."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = _chunk_of(S, chunk)
    nc = S // Q
    rep = H // G
    dev = x.device
    xf = x.float().reshape(b, nc, Q, H, P)
    dtf = dt.float().reshape(b, nc, Q, H)
    Bf = B.float().repeat_interleave(rep, 2).reshape(b, nc, Q, H, N)
    Cf = C.float().repeat_interleave(rep, 2).reshape(b, nc, Q, H, N)
    la = -torch.exp(A_log.float())[None, None, None] * dtf
    La = torch.cumsum(la, 2)                                # [b,nc,Q,H]
    xb = dtf[..., None] * xf                                # dt-weighted x

    # intra-chunk: decay(i, j) = exp(La_i - La_j) for i >= j
    idx = torch.arange(Q, device=dev)
    tri = idx[:, None] >= idx[None, :]
    dec = torch.exp(torch.clamp(La[:, :, :, None] - La[:, :, None, :],
                                -60.0, 0.0))                # [b,nc,i,j,H]
    gsc = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)
    gsc = gsc * dec.permute(0, 1, 4, 2, 3)
    gsc = torch.where(tri, gsc, torch.zeros((), device=dev))
    y_intra = torch.einsum("bchij,bcjhp->bcihp", gsc, xb)

    # per-chunk end states, then the recurrence over chunks
    dec_end = torch.exp(La[:, :, -1:, :] - La)              # [b,nc,Q,H]
    st = torch.einsum("bcqhn,bcqhp->bchpn", Bf * dec_end[..., None], xb)
    A_chunk = torch.exp(La[:, :, -1])                       # [b,nc,H]
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=dev)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)                                      # state ENTERING c
        h = A_chunk[:, c, :, None, None] * h + st[:, c]
    h_in = torch.stack(h_in, 1)                             # [b,nc,H,P,N]

    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Cf * torch.exp(La)[..., None], h_in)
    y = (y_intra + y_inter).reshape(b, S, H, P)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), h
