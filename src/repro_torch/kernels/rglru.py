"""Griffin RG-LRU scan: wrapper of the CUDA kernel and its plain version.

Replaces the TPU kernel ``src/repro/kernels/rglru.py::_kernel`` (Pallas;
grid (B, feature block, time chunk) with the time axis run in order and
``h`` carried in VMEM scratch). The kernel is ``csrc/rglru.cu``: the
recurrence is linear, so time is split into chunks of T steps across CTAs,
in one pass with a decoupled look-back. Each CTA computes its chunk's gates
once into shared memory and its carry ``(prod a_t, h)`` from ``h = 0``,
publishes the carry, folds the carries of the chunks before it (from the
nearest one whose end state is published, or from ``h0``), publishes its own
end state and reruns the chunk from shared memory to write y (and, in the
last chunk, ``h_final``). CTAs take their chunks by ticket, in order, so a
wait is always on a CTA that already runs. This wrapper allocates the
scratch: the zeroed tickets and flags, and the carries and end states.

What bounds it on an H100: bytes. x, gate_a and gate_x are read once and y
is written once (67 MB at ``[1,2048,4096]`` in bf16); the gate arithmetic
is some tens of FLOP per lane and step, far below the card's ~295
FLOP/byte ridge. The time split reads them once too, and runs
``B * ceil(D/128) * ceil(S/T)`` CTAs instead of ``B * ceil(D/128)``
(T = ``CHUNK_STEPS``). Its times against the bound are in PERF.md.

``rglru_scan`` launches the kernel for CUDA tensors and counts the call in
the module-level integer ``launches``. For CPU tensors it runs
``rglru_plain``, the reference's blocked path
(``repro/kernels/ops.py::rglru``) in plain tensor ops; nothing else chooses
between the two.

Gradients: the reference has no backward kernel for the RG-LRU (JAX
differentiates its blocked path), so none is owed here. When grad is
enabled and an input requires it, ``rglru_scan`` runs ``RGLRUScan``, a
``torch.autograd.Function`` whose forward is the same kernel (or the plain
version on CPU tensors) and whose backward recomputes ``rglru_plain``
under autograd and differentiates it, through y and ``h_final`` alike.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import plain_vjp

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0          # kernel launches since the last reset by the caller
_fn = None
LANES = 128           # feature lanes per CTA (csrc/rglru.cu NT)
# time steps per chunk: 2048 CTAs of LANES lanes at [1,2048,4096]; on an
# H100, 16 read alike there and 64 slower (PERF.md)
CHUNK_STEPS = 32


def _check(x, a_log, gate_a, gate_x, h0):
    if x.dim() != 3 or gate_a.shape != x.shape or gate_x.shape != x.shape:
        raise ValueError(f"want x, gate_a, gate_x [B,S,D] of one shape; got "
                         f"{tuple(x.shape)}, {tuple(gate_a.shape)}, "
                         f"{tuple(gate_x.shape)}")
    B, S, D = x.shape
    if tuple(a_log.shape) != (D,):
        raise ValueError(f"a_log {tuple(a_log.shape)} is not [D={D}]")
    if h0 is not None and tuple(h0.shape) != (B, D):
        raise ValueError(f"h0 {tuple(h0.shape)} is not [B,D] = {(B, D)}")
    if not (x.dtype == gate_a.dtype == gate_x.dtype) or \
            x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x, gate_a, gate_x must share float32 or bfloat16; "
                        f"got {x.dtype}, {gate_a.dtype}, {gate_x.dtype}")
    devs = {t.device for t in (x, a_log, gate_a, gate_x, h0) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"RG-LRU inputs must lie on one device, got {devs}")


def rglru_scan(x, a_log, gate_a, gate_x, *, c=8.0, h0=None):
    """x, gate_a, gate_x: [B,S,D]; a_log: [D]; h0: [B,D] or None.
    Returns (y [B,S,D] in x's dtype, h_final [B,D] fp32)."""
    _check(x, a_log, gate_a, gate_x, h0)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no RG-LRU scan for device {x.device}")
    ins = (x, a_log, gate_a, gate_x, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return RGLRUScan.apply(*ins, float(c))
    return _forward(*ins, float(c))


def _forward(x, a_log, gate_a, gate_x, h0, c):
    if x.device.type == "cpu":
        return rglru_plain(x, a_log, gate_a, gate_x, c=c, h0=h0)
    return _launch(x, a_log, gate_a, gate_x, c, h0)


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with a gradient: forward by the kernel (the plain
    version on CPU tensors), backward through the plain version's
    autograd, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, a_log, gate_a, gate_x, h0, c):
        ctx.save_for_backward(x, a_log, gate_a, gate_x, h0)
        ctx.c = c
        ctx.set_materialize_grads(False)   # None for an unused output
        return _forward(x, a_log, gate_a, gate_x, h0, c)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh):
        grads = plain_vjp(
            lambda x, a_log, gate_a, gate_x, h0, c: rglru_plain(
                x, a_log, gate_a, gate_x, c=c, h0=h0),
            ctx.saved_tensors, ctx.needs_input_grad[:5], (dy, dh), c=ctx.c)
        return (*grads, None)


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import _build
        fn = _build.load("rglru").rglru_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 9 + [I] * 5 + [L] * 8 + [ctypes.c_float, P]
        fn.restype = I
        _fn = fn
    return _fn


def _launch(x, a_log, gate_a, gate_x, c, h0):
    global launches
    B, S, D = x.shape
    for name, t in (("x", x), ("gate_a", gate_a), ("gate_x", gate_x)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride in its last dim")
    fn = _kernel()
    a_log = a_log.float().contiguous()
    h0 = h0.float().contiguous() if h0 is not None else None
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    hT = torch.empty((B, D), dtype=torch.float32, device=x.device)
    T = CHUNK_STEPS
    chunks = -(-S // T)
    # the kernel's scratch: a ticket and a flag per CTA, zeroed; per chunk
    # and lane its carry (prod a, h) and the state after it
    sync = torch.zeros(1 + B * -(-D // LANES) * chunks, dtype=torch.int32,
                       device=x.device)
    carries = torch.empty(3 * B * chunks * D, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a_log.data_ptr(), gate_a.data_ptr(),
                 gate_x.data_ptr(), h0.data_ptr() if h0 is not None else None,
                 y.data_ptr(), hT.data_ptr(), sync.data_ptr(),
                 carries.data_ptr(), _DTYPE_CODE[x.dtype], B, S, D, T,
                 *x.stride()[:2], *gate_a.stride()[:2],
                 *gate_x.stride()[:2], *y.stride()[:2], c, stream)
    if err != 0:
        raise RuntimeError(f"rglru_fwd launch failed: CUDA error {err}")
    launches += 1
    return y, hT


# ---------------------------------------------------------------------------
# Plain version (CPU path; the card's comparison target)
# ---------------------------------------------------------------------------


def gates(x, a_log, gate_a, gate_x, c):
    """The fused gates in fp32: (a, b) with h_t = a_t h_{t-1} + b_t."""
    log_a = -c * F.softplus(a_log.float()) * torch.sigmoid(gate_a.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * torch.sigmoid(gate_x.float()) * x.float()


def rglru_plain(x, a_log, gate_a, gate_x, *, c=8.0, h0=None):
    """RG-LRU in fp32 on any device, the reference's blocked path
    (``repro/kernels/ops.py:455-483``): the fused gates, h0 folded in as a
    virtual first step with a=0, b=h0, and the linear recurrence as a
    log-depth doubling scan over time (ceil(log2 S) shifted combines of
    (a, b) pairs, no loop over S). y is rounded to x's dtype once."""
    a, b = gates(x, a_log, gate_a, gate_x, c)
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], 1)
        b = torch.cat([h0.float()[:, None], b], 1)
    T = a.shape[1]
    k = 1
    while k < T:
        # (a, b)_t <- (a, b)_{t-k} then (a, b)_t: the prefix over 2k rows
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    ys = b if h0 is None else b[:, 1:]
    return ys.to(x.dtype), b[:, -1]
