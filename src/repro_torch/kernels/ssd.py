"""Mamba-2 chunked SSD scan: wrapper of its CUDA kernels and its plain version.

Replaces the TPU kernel ``src/repro/kernels/ssd.py::_kernel`` (Pallas; grid
(b, head, chunk) with the chunk axis run in order and the ``[P,N]`` state in
VMEM scratch). ``csrc/ssd.cu`` holds two designs of the same function,
chosen by dtype, P and N alone (``kernel_for``):

* ``"tc"`` — bf16 at P in {16, 32, 64} and N in {16, 128} (the served
  mamba2-2.7b: P=64, N=128): the chunk-parallel form on the tensor cores,
  two kernels on one stream over chunks of 128 rows. The first walks each
  (b, head, 64-wide block of N) through its chunks with two warpgroups:
  each chunk's own state contribution ``(w o x)^T . B`` is a ``wgmma``,
  the two warpgroups' products run at once, and only the fp32 recurrence
  ``h_in[c+1] = exp(La_last) h_in[c] + S_c`` passes between them; it
  writes every ``h_in[c]`` in bf16. The second runs every (b, head, chunk)
  at once: ``C . h_in^T`` and the decay-masked ``C . B^T`` as SS
  ``wgmma``, the masked block times x as an RS ``wgmma``, blocks above the
  diagonal skipped. x, B, C and h_in come in by TMA, so x, B and C must
  start on 16 bytes and have strides in multiples of 16 bytes
  (``check_tma``); the wrapper raises otherwise and never copies. It
  allocates the kernels' scratch (per chunk its entering state in bf16 and
  its La, dt and decay factors: 23 MB at ``[1,2048,80,64]``, N=128) with
  ``torch.empty``.
* ``"fma"`` — fp32 at every size (the tensor cores would round it to TF32)
  and bf16 at P or N = 8: the first design, one CTA per (b, head, 32-wide
  block of P) looping over 64-row chunks with its state rows in fp32
  registers and fp32 FMA products out of shared memory.

Both add the D skip inside, so y is rounded to x's dtype once.

What bounds it on an H100: the least arithmetic the function needs, that
of the plain recurrence (about ``4NP`` FLOP per row and head), is some 117
FLOP per byte moved at the mamba2-2.7b prefill shape (P=64, N=128), below
the card's ~295 ridge, so bytes set the bound: 46 MB at S=2048. The
tensor-core design moves some 130 MB there (x read by both blocks of N and
by the outputs, h_in written and read in bf16), is bound by latency more
than by either, and rounds ``w o x``, the masked score blocks and h_in to
bf16 for the tensor cores (about 2e-3 relative L2 on y). Its times against
the bound are in PERF.md.

``ssd_scan`` launches a kernel for CUDA tensors and counts the launch in
the module-level integers ``launches_tc`` or ``launches_fma`` and in
``launches``, their sum. For CPU tensors it runs ``ssd_plain``, the
reference's blocked path (``repro/kernels/ops.py::ssd``) in plain tensor
ops; nothing else chooses between the two.

Gradients: the reference has no backward kernel for the SSD (JAX
differentiates its blocked path), so none is owed here. When grad is
enabled and an input requires it, ``ssd_scan`` runs ``SSDScan``, a
``torch.autograd.Function`` whose forward is the same kernel (or the plain
version on CPU tensors) and whose backward recomputes ``ssd_plain`` under
autograd and differentiates it, through y and ``h_final`` alike.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention import check_tma, tma_strides

P_SIZES = (8, 16, 32, 64)     # head dims (P) the kernels take
N_SIZES = (8, 16, 128)        # state sizes (N) the kernels take
TC_P_SIZES = (16, 32, 64)     # ... of them, the tensor-core design's
TC_N_SIZES = (16, 128)
TC_CHUNK = 128                # rows per chunk of the tensor-core design
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset by the caller; launches is the sum
launches = 0
launches_tc = 0
launches_fma = 0
_fns: dict = {}


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


def kernel_for(dtype, P, N):
    """The kernel that runs a CUDA call: "tc" or "fma"."""
    if P not in P_SIZES or N not in N_SIZES:
        raise ValueError(f"head dim P={P} / state N={N} not among the "
                         f"kernels' {P_SIZES} / {N_SIZES}")
    return "tc" if (dtype == torch.bfloat16 and P in TC_P_SIZES
                    and N in TC_N_SIZES) else "fma"


def ssd_scan(x, dt, A_log, B, C, *, D=None, h0=None, chunk=256):
    """x: [b,S,H,P]; dt: [b,S,H] fp32; A_log: [H]; B, C: [b,S,G,N];
    D: [H] or None; h0: [b,H,P,N] or None.
    Returns (y [b,S,H,P] in x's dtype, h_final [b,H,P,N] fp32).

    ``chunk`` blocks only the plain version (CPU tensors). The function is
    the same for any blocking, as the reference's own gcd rule shows; the
    kernels block by 128 (``tc``) or 64 (``fma``) rows and mask the ragged
    tail."""
    _check(x, dt, A_log, B, C, D, h0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SSD scan for device {x.device}")
    ins = (x, dt, A_log, B, C, D, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return SSDScan.apply(*ins, chunk)
    return _forward(*ins, chunk)


def _forward(x, dt, A_log, B, C, D, h0, chunk):
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A_log, B, C, D=D, h0=h0, chunk=chunk)
    return _launch(x, dt, A_log, B, C, D, h0)


def plain_vjp(plain, inputs, needs, grads_out, **kw):
    """Gradients of ``plain(*inputs, **kw)`` (which returns (y, h_final))
    with respect to the inputs flagged in ``needs``, given the gradients
    of its outputs (None for an output with none): the plain version is
    recomputed under autograd. None for the other inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(inputs, needs)]
        outs = plain(*leaves, **kw)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        want = [t for t, n in zip(leaves, needs) if t is not None and n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and want else [None] * len(want))
    return [next(got) if t is not None and n else None
            for t, n in zip(leaves, needs)]


class SSDScan(torch.autograd.Function):
    """The SSD scan with a gradient: forward by the kernel (the plain
    version on CPU tensors), backward through the plain version's
    autograd, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, h0, chunk):
        ctx.save_for_backward(x, dt, A_log, B, C, D, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # None for an unused output
        return _forward(x, dt, A_log, B, C, D, h0, chunk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh):
        grads = plain_vjp(
            lambda x, dt, A_log, B, C, D, h0, chunk: ssd_plain(
                x, dt, A_log, B, C, D=D, h0=h0, chunk=chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:7], (dy, dh),
            chunk=ctx.chunk)
        return (*grads, None)


def _kernel(route):
    fn = _fns.get(route)
    if fn is None:
        from repro_torch.kernels import _build
        lib = _build.load("ssd")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if route == "tc":
            fn = lib.ssd_scan_fwd_tc
            fn.argtypes = [P] * 10 + [I] * 6 + [L] * 15 + [P]
        else:
            fn = lib.ssd_scan_fwd
            fn.argtypes = [P] * 9 + [I] * 7 + [L] * 15 + [P]
        fn.restype = I
        _fns[route] = fn
    return fn


def _launch(x, dt, A_log, B, C, D, h0):
    global launches, launches_tc, launches_fma
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    route = kernel_for(x.dtype, P, N)
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride in its last dim")
    if route == "tc":
        check_tma("ssd_scan", x=x, B=B, C=C)
        strides = [s for t in (x, B, C) for s in tma_strides(t)[:3]]
    else:
        strides = [s for t in (x, B, C) for s in t.stride()[:3]]
    xs, Bs, Cs = strides[:3], strides[3:6], strides[6:]
    fn = _kernel(route)
    A_log = A_log.float().contiguous()
    D = D.float().contiguous() if D is not None else None
    h0 = h0.float().contiguous() if h0 is not None else None
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    hT = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr() if D is not None else None,
            h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            hT.data_ptr())
    rest = (*xs, *dt.stride(), *Bs, *Cs, *y.stride()[:3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "tc":
            # the kernels' scratch: per chunk its entering state in bf16,
            # then its La, dt and decay factors in fp32
            nc = -(-S // TC_CHUNK)
            scratch = torch.empty(b * H * nc * (2 * P * N + 12 * TC_CHUNK),
                                  dtype=torch.uint8, device=x.device)
            err = fn(*ptrs, scratch.data_ptr(), b, S, H, G, P, N, *rest,
                     stream)
        else:
            err = fn(*ptrs, _DTYPE_CODE[x.dtype], b, S, H, G, P, N, *rest,
                     stream)
    if err != 0:
        what = (f"tensor map error {err - 10000}" if err >= 10000 else
                f"CUDA error {err}")
        raise RuntimeError(f"ssd_scan ({route} kernel) launch failed: "
                           f"{what}")
    if route == "tc":
        launches_tc += 1
    else:
        launches_fma += 1
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
