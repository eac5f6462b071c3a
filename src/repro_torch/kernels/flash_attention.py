"""Flash attention: wrappers of the CUDA forward and backward kernels, their
plain versions, and the ``FlashAttention`` autograd Function.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::_kernel``
(Pallas). ``csrc/flash_attention.cu`` holds two kernels of the same
function, chosen by dtype and head dim alone (``kernel_for``):

* ``"tc"`` — bf16 at head dims 64, 128, 256 (every full-width config with
  attention): both products on the tensor cores (``wgmma``), k/v fed by TMA
  into a two-stage shared-memory ring, the online softmax in registers,
  P rounded to bf16 for P.v (outputs within about 2e-3, relative L2, of
  the plain version's fp32 P).
  TMA reads q, k and v in place, so each must start on 16 bytes and have
  strides that are multiples of 16 bytes (``check_tma``); the wrapper
  raises otherwise and never copies.
* ``"fma"`` — fp32 at every head dim (the tensor cores would round it to
  TF32) and bf16 at head dims 16 and 32 (only the smoke configs): the
  first design, fp32 FMA loops out of shared memory.

What bounds it on an H100: at long prefill, compute — ``4*B*H*Sq*Sk*hd``
FLOP, about halved under the causal mask — against the bytes of q, k, v
and o read or written once (a few hundred FLOP per byte at S=2048). Both
kernels skip every kv tile that the mask rules out for a whole q tile.
Their times against that bound are in PERF.md.

``flash_attention`` launches a kernel for CUDA tensors and counts the
launch in the module-level integers ``launches_tc`` or ``launches_fma``
and in ``launches``, their sum. For CPU tensors it runs ``attention_plain``,
a blocked online-softmax loop in fp32 that mirrors
``repro/kernels/ops.py::_block``; nothing else chooses between the two.

The backward. The reference's flash backward is the XLA-level
``custom_vjp`` ``repro/kernels/ops.py::_flash_bwd`` (no Pallas kernel):
it saves ``(out, lse)`` and recomputes the scores block by block. Here
``FlashAttention`` (a ``torch.autograd.Function``) does the same: its
forward runs the forward kernel with the log-sum-exp as a second output
(``[B,Sq,H]`` fp32) and saves ``q, k, v, o, lse``; its backward is
``flash_attention_bwd``, kernels of ``csrc/flash_attention.cu`` on one
stream, chosen by dtype and head dim alone (``bwd_kernel_for``, the same
rule as the forward's) and counted once per call in ``launches_bwd_tc`` or
``launches_bwd_fma`` and in ``launches_bwd``, their sum:

* ``"tc"`` — bf16 at head dims 64, 128, 256: ``delta = rowsum(do o)`` and
  ``lse * log2(e)`` into ``[B,H,Sq]`` scratch (a tile's rows contiguous);
  ``flash_bwd_dkdv_tc_kernel``, one CTA per (b, kv head x head split, key
  tile) with a TMA producer warpgroup and two consumer warpgroups on
  ``wgmma``: ``S^T = K.Q^T`` and ``dP^T = V.dO^T`` from shared memory,
  ``P^T`` and ``dS^T`` in registers, rounded to bf16 for
  ``dV += P^T.dO`` and ``dK += dS^T.Q`` (as SDPA's backward rounds them;
  gradients within about 3e-3, relative L2, of the plain version's);
  q and do stream through a two-stage ring. At GQA/MQA the group's heads
  are split across ``bwd_head_splits`` CTAs whose fp32 partials a small
  kernel sums in split order. ``flash_bwd_dq_tc_kernel``, one CTA per (b,
  head, 128-query tile), q and do loaded once and k/v through the ring,
  ``dQ += dS.K`` on the tensor cores. TMA reads q, k, v and do in place
  (``check_tma``); the wrapper raises on a layout it cannot read.
* ``"fma"`` — fp32 at every head dim and bf16 at head dims 16 and 32: the
  first design, fp32 FMA from shared memory; one CTA per (b, kv head, key
  tile) sums dk and dv over the group's heads, one per (b, head, query
  tile) sums dq.

Both compute in fp32 from the inputs and write the gradients in the
inputs' dtype; neither uses atomics: scores and p are computed in both
the dk/dv and the dq kernel, so every sum has one order (seven products'
work where the math needs five). Tiles the mask rules out are skipped.
What bounds it: ``10*B*H*Sq*Sk*hd`` FLOP (about halved under the causal
mask) against the bytes of q, k, v, o, do and the gradients, compute far
above the ridge, so the bf16 tensor cores' rate; the FMA route runs on
the fp32 cores, far from it. Times against the bound are in PERF.md. On
CPU tensors both halves run the plain versions
(``attention_fwd_lse_plain``, ``attention_bwd_plain``).
``flash_attention`` takes the Function when grad is enabled and an input
requires it; otherwise (serving) it launches the forward alone, without
the log-sum-exp.
"""
from __future__ import annotations

import ctypes

import torch

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset by the caller; launches is the sum
launches = 0
launches_tc = 0
launches_fma = 0
launches_bwd = 0      # backward calls (its kernels on one stream each)
launches_bwd_tc = 0
launches_bwd_fma = 0
SMS = 132             # an H100's SMs: the dk/dv grid's target is 2 x SMS CTAs
_fns: dict = {}


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Sq,H,hd], k/v [B,Sk,Kh,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, Kh, hdk = k.shape
    if Bk != B or hdk != hd or Kh == 0 or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"agree (batch, head dim, H % Kh)")
    # queries are right-aligned in the keys (offset Sk - Sq), which only a
    # causal or windowed mask reads: without one, every key is visible to
    # every query and Sq > Sk (a cross-attention over a shorter encoder
    # output) is as good as any other
    if Sq > Sk and (causal or window > 0):
        raise ValueError(f"queries are right-aligned in the keys under a "
                         f"causal or windowed mask: Sq={Sq} > Sk={Sk}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q, k, v must share float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def kernel_for(dtype, hd):
    """The kernel that runs a CUDA call: "tc" or "fma"."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not among the kernel's {HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "fma"


def bwd_kernel_for(dtype, hd):
    """The backward kernels that run a CUDA call: "tc" (bf16 at head dims
    64, 128, 256) or "fma", by the forward's rule."""
    return kernel_for(dtype, hd)


def bwd_key_tile(hd):
    """Keys per CTA of the tensor-core dk/dv kernel."""
    return 64 if hd == 256 else 128


def bwd_head_splits(B, Sk, Kh, G, bk):
    """Head splits of the tensor-core dk/dv kernel: the smallest divisor of
    the group size G that gives at least 2 x SMS CTAs over B x key tiles x
    Kh, or G itself. Each split sums G / splits heads of the group."""
    ctas = B * -(-Sk // bk) * Kh
    for d in range(1, G + 1):
        if G % d == 0 and ctas * d >= 2 * SMS:
            return d
    return G


def tma_strides(t):
    """Element strides of a 4-D tensor ([B,S,H,hd] here, [b,S,H,P] or
    [b,S,G,N] in the SSD scan) for a tensor map: a dimension of size 1 is
    never stepped, so its stride is taken as if the tensor were contiguous
    there."""
    out, inner = [], 1
    for size, stride in zip(reversed(t.shape), reversed(t.stride())):
        out.append(stride if size > 1 else inner)
        inner *= size
    return tuple(reversed(out))


def check_tma(who="flash_attention", /, **tensors):
    """Raise ValueError unless TMA can read every named 4-D tensor in
    place: a 16-byte aligned start and strides that are multiples of 16
    bytes, the last one 1. ``who`` names the caller in the message."""
    bad = []
    for name, t in tensors.items():
        eb = t.element_size()
        if t.data_ptr() % 16:
            bad.append(f"{name} does not start on 16 bytes "
                       f"(address {t.data_ptr():#x})")
        st = tma_strides(t)
        if st[-1] != 1:
            bad.append(f"{name} needs a unit stride in its last dim")
        bad += [f"{name}'s stride {st[d]} in dim {d} is not a multiple of "
                f"16 bytes" for d in range(3) if (st[d] * eb) % 16]
    if bad:
        raise ValueError(f"{who} (tensor-core kernel): " + "; ".join(bad))


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,Kh,hd] -> [B,Sq,H,hd] in q's dtype.
    Differentiable in q, k and v through ``FlashAttention``."""
    _check(q, k, v, causal, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    kw = _options(q, causal, window, softcap, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, kw)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, **kw)
    return _launch(q, k, v, **kw)[0]


def _options(q, causal, window, softcap, scale):
    return dict(causal=bool(causal), window=int(window),
                softcap=float(softcap),
                scale=float(scale) if scale is not None
                else q.shape[-1] ** -0.5)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward (the reference's ``_flash``
    custom_vjp): forward with the log-sum-exp, saving ``q, k, v, o, lse``;
    backward from them, recomputing the scores. Kernels on CUDA tensors,
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        if q.device.type == "cpu":
            o, lse = attention_fwd_lse_plain(q, k, v, **kw)
        else:
            o, lse = _launch(q, k, v, want_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # TMA reads do in place: autograd may hand over a strided view
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                        softcap=0.0, scale=None):
    """dq, dk, dv of attention from the forward's output ``o`` and its
    log-sum-exp ``lse`` [B,Sq,H] (fp32) and the output's gradient ``do``.
    The CUDA kernels for CUDA tensors, ``attention_bwd_plain`` for CPU
    tensors."""
    _check(q, k, v, causal, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse {tuple(lse.shape)} is not [B,Sq,H] = "
                         f"{tuple(q.shape[:3])}")
    kw = _options(q, causal, window, softcap, scale)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention backward for device "
                         f"{q.device}")
    return _launch_bwd(q, k, v, o, lse, do, **kw)


def _kernel(route):
    fn = _fns.get(route)
    if fn is None:
        from repro_torch.kernels import _build
        lib = _build.load("flash_attention")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        if route == "tc":
            fn = lib.flash_attention_fwd_tc
            fn.argtypes = [P] * 5 + [I] * 6 + [L] * 12 + [I, I, F, F, P]
        elif route == "fma":
            fn = lib.flash_attention_fwd
            fn.argtypes = [P] * 5 + [I] * 7 + [L] * 12 + [I, I, F, F, P]
        elif route == "bwd_tc":
            fn = lib.flash_attention_bwd_tc
            fn.argtypes = [P] * 11 + [I] * 7 + [P, I, I, F, F, P]
        else:
            fn = lib.flash_attention_bwd
            fn.argtypes = [P] * 10 + [I] * 7 + [P, I, I, F, F, P]
        fn.restype = I
        _fns[route] = fn
    return fn


def _launch(q, k, v, *, causal, window, softcap, scale, want_lse=False):
    """Launch the forward kernel: (o, lse), lse [B,Sq,H] fp32 when
    ``want_lse``, else None (the kernel then writes no log-sum-exp)."""
    global launches, launches_tc, launches_fma
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    route = kernel_for(q.dtype, hd)
    if route == "tc":
        check_tma(q=q, k=k, v=v)
        strides = [s for t in (q, k, v) for s in tma_strides(t)[:3]]
    else:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name} needs a unit stride in its last "
                                 f"dim")
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    fn = _kernel(route)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
           if want_lse else None)
    args = (*strides, *o.stride()[:3], int(bool(causal)), int(window),
            float(softcap), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if want_lse else None)
        if route == "tc":
            err = fn(*ptrs, B, Sq, Sk, H, Kh, hd, *args, stream)
        else:
            err = fn(*ptrs, _DTYPE_CODE[q.dtype], B, Sq, Sk, H, Kh, hd,
                     *args, stream)
    if err != 0:
        what = (f"tensor map error {err - 10000}" if err >= 10000 else
                f"CUDA error {err}")
        raise RuntimeError(f"flash_attention ({route} kernel) launch "
                           f"failed: {what}")
    if route == "tc":
        launches_tc += 1
    else:
        launches_fma += 1
    launches += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, *, causal, window, softcap, scale):
    global launches_bwd, launches_bwd_tc, launches_bwd_fma
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    route = bwd_kernel_for(q.dtype, hd)
    if not (o.dtype == do.dtype == q.dtype):
        raise TypeError(f"o and do must have q's dtype {q.dtype}; got "
                        f"{o.dtype}, {do.dtype}")
    ins = {"q": q, "k": k, "v": v, "o": o, "do": do}
    for name, t in ins.items():
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride in its last dim")
    if route == "tc":
        check_tma("flash_attention_bwd", q=q, k=k, v=v, do=do)
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    st = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, o, do, dq, dk, dv)
        for s in (tma_strides(t) if route == "tc" else t.stride())[:3]])
    args = (int(causal), int(window), float(softcap), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr())
        outs = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        if route == "tc":
            # lse * log2(e) and delta as [B,H,Sqp], Sqp = Sq rounded up to
            # the dq kernel's 128-query tile; the head split's partials
            sqp = -(-Sq // 128) * 128
            scratch = torch.empty((2, B, H, sqp), dtype=torch.float32,
                                  device=q.device)
            n_split = bwd_head_splits(B, Sk, Kh, H // Kh, bwd_key_tile(hd))
            part = (torch.empty((2, n_split, B, Sk, Kh, hd),
                                dtype=torch.float32, device=q.device)
                    if n_split > 1 else None)
            err = _kernel("bwd_tc")(
                *ptrs, scratch.data_ptr(),
                part.data_ptr() if part is not None else None, *outs,
                B, Sq, Sk, H, Kh, hd, n_split, st, *args, stream)
        else:
            delta = torch.empty((B, Sq, H), dtype=torch.float32,
                                device=q.device)
            err = _kernel("bwd")(*ptrs, delta.data_ptr(), *outs,
                                 _DTYPE_CODE[q.dtype], B, Sq, Sk, H, Kh, hd,
                                 st, *args, stream)
    if err != 0:
        what = (f"tensor map error {err - 10000}" if err >= 10000 else
                f"CUDA error {err}")
        raise RuntimeError(f"flash_attention_bwd ({route} kernels) launch "
                           f"failed: {what}")
    if route == "tc":
        launches_bwd_tc += 1
    else:
        launches_bwd_fma += 1
    launches_bwd += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Plain version (CPU path; the card's comparison target)
# ---------------------------------------------------------------------------


def _block(qc, kc, vc, qpos, kpos, m, l, acc, *, causal, window, softcap,
           scale):
    """One online-softmax block update. qc:[B,cq,Kh,G,hd] kc:[B,ck,Kh,hd]."""
    s = torch.einsum("bqkgh,bckh->bkgqc", qc, kc) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(_mask(qpos, kpos, causal, window), s,
                    torch.full_like(s, NEG))
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgqc,bckh->bkgqh", p, vc)
    return m_new, l, acc


def attention_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, chunk_q=512, chunk_k=512):
    """Blocked online-softmax attention in fp32 on any device; the same
    function as the kernel. Skips kv chunks the mask rules out for a whole
    q chunk; ragged chunk edges are sliced, not padded."""
    return _plain_forward(q, k, v, causal, window, softcap, scale, chunk_q,
                          chunk_k)[0]


def attention_fwd_lse_plain(q, k, v, *, causal=True, window=0, softcap=0.0,
                            scale=None, chunk_q=512, chunk_k=512):
    """``attention_plain`` and the log-sum-exp of each row's scaled,
    masked scores, ``m + log(max(l, 1e-30))`` [B,Sq,H] in fp32 (the
    reference's ``ops.py::_fwd_blocked_lse``)."""
    return _plain_forward(q, k, v, causal, window, softcap, scale, chunk_q,
                          chunk_k)


def _plain_forward(q, k, v, causal, window, softcap, scale, chunk_q,
                   chunk_k):
    B, Sq, H, hd = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    scale = scale if scale is not None else hd ** -0.5
    off = Sk - Sq
    dev = q.device
    qf = q.float().reshape(B, Sq, Kh, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq)
        cq = q1 - q0
        qpos = off + torch.arange(q0, q1, device=dev)
        m = torch.full((B, Kh, G, cq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kh, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kh, G, cq, hd), dtype=torch.float32, device=dev)
        k_lo = max(0, off + q0 - window + 1) if window > 0 else 0
        k_hi = min(Sk, off + q1) if causal else Sk
        for k0 in range(k_lo // chunk_k * chunk_k, k_hi, chunk_k):
            k1 = min(k0 + chunk_k, Sk)
            kpos = torch.arange(k0, k1, device=dev)
            m, l, acc = _block(qf[:, q0:q1], kf[:, k0:k1], vf[:, k0:k1], qpos,
                               kpos, m, l, acc, causal=causal, window=window,
                               softcap=softcap, scale=scale)
        l = torch.clamp_min(l, 1e-30)
        o = acc / l[..., None]                              # [B,Kh,G,cq,hd]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, hd)
        lse[:, q0:q1] = (m + torch.log(l)).permute(0, 3, 1, 2).reshape(
            B, cq, H)
    return out.to(q.dtype), lse


def _mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def attention_bwd_plain(q, k, v, o, lse, do, *, causal=True, window=0,
                        softcap=0.0, scale=None, chunk_q=512, chunk_k=512):
    """dq, dk, dv in fp32 on any device, block for block the reference's
    ``ops.py::_flash_bwd``: ``delta = rowsum(do o)``; per (q chunk, k
    chunk) ``p = exp(s - lse)`` masked, ``dv += p^T do``, ``dp = do v^T``,
    ``ds = p (dp - delta)``, times ``1 - t^2`` under a softcap
    (``t = tanh(s_raw / softcap)``) and the scale, ``dq += ds k``,
    ``dk += ds^T q``. GQA sums dk and dv over a group's heads; queries are
    right-aligned in the keys. The chunks the mask rules out are skipped
    (the windowed band of the reference is the same set of blocks).
    Gradients come back in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    scale = scale if scale is not None else hd ** -0.5
    off = Sk - Sq
    dev = q.device
    qf = q.float().reshape(B, Sq, Kh, G, hd)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, Kh, G, hd)
    delta = (dof * o.float().reshape(B, Sq, Kh, G, hd)).sum(-1)  # [B,Sq,Kh,G]
    lsef = lse.float().reshape(B, Sq, Kh, G)
    dq = torch.zeros((B, Sq, Kh, G, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, Kh, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Sk, Kh, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq)
        qpos = off + torch.arange(q0, q1, device=dev)
        qc, doc = qf[:, q0:q1], dof[:, q0:q1]
        lsec = lsef[:, q0:q1].permute(0, 2, 3, 1)[..., None]   # [B,Kh,G,cq,1]
        dc = delta[:, q0:q1].permute(0, 2, 3, 1)[..., None]
        k_lo = max(0, off + q0 - window + 1) if window > 0 else 0
        k_hi = min(Sk, off + q1) if causal else Sk
        for k0 in range(k_lo // chunk_k * chunk_k, k_hi, chunk_k):
            k1 = min(k0 + chunk_k, Sk)
            kc, vc = kf[:, k0:k1], vf[:, k0:k1]
            mask = _mask(qpos, torch.arange(k0, k1, device=dev), causal,
                         window)
            s = torch.einsum("bqkgh,bckh->bkgqc", qc, kc) * scale
            t = None
            if softcap > 0:
                t = torch.tanh(s / softcap)
                s = t * softcap
            s = torch.where(mask, s, torch.full_like(s, NEG))
            p = torch.where(mask, torch.exp(s - lsec), torch.zeros_like(s))
            dv[:, k0:k1] += torch.einsum("bkgqc,bqkgh->bckh", p, doc)
            dp = torch.einsum("bqkgh,bckh->bkgqc", doc, vc)
            ds = p * (dp - dc)
            if t is not None:
                ds = ds * (1.0 - t * t)
            ds = ds * scale
            dq[:, q0:q1] += torch.einsum("bkgqc,bckh->bqkgh", ds, kc)
            dk[:, k0:k1] += torch.einsum("bkgqc,bqkgh->bckh", ds, qc)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
