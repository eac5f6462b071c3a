"""Flash-attention forward: wrapper of two CUDA kernels, and its plain version.

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
_fns: dict = {}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Sq,H,hd], k/v [B,Sk,Kh,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, Kh, hdk = k.shape
    if Bk != B or hdk != hd or Kh == 0 or H % Kh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"agree (batch, head dim, H % Kh)")
    if Sq > Sk:
        raise ValueError(f"queries are right-aligned in the keys: Sq={Sq} "
                         f"> Sk={Sk}")
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
    """q: [B,Sq,H,hd]; k,v: [B,Sk,Kh,hd] -> [B,Sq,H,hd] in q's dtype."""
    _check(q, k, v)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _launch(q, k, v, causal, window, softcap, scale)


def _kernel(route):
    fn = _fns.get(route)
    if fn is None:
        from repro_torch.kernels import _build
        lib = _build.load("flash_attention")
        P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
        if route == "tc":
            fn = lib.flash_attention_fwd_tc
            fn.argtypes = [P, P, P, P, I, I, I, I, I, I] + [L] * 12 + \
                [I, I, F, F, P]
        else:
            fn = lib.flash_attention_fwd
            fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + \
                [I, I, F, F, P]
        fn.restype = I
        _fns[route] = fn
    return fn


def _launch(q, k, v, causal, window, softcap, scale):
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
    args = (*strides, *o.stride()[:3], int(bool(causal)), int(window),
            float(softcap), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
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
    return o


# ---------------------------------------------------------------------------
# Plain version (CPU path; the card's comparison target)
# ---------------------------------------------------------------------------


def _block(qc, kc, vc, qpos, kpos, m, l, acc, *, causal, window, softcap,
           scale):
    """One online-softmax block update. qc:[B,cq,Kh,G,hd] kc:[B,ck,Kh,hd]."""
    s = torch.einsum("bqkgh,bckh->bkgqc", qc, kc) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qc.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, torch.full_like(s, NEG))
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
    B, Sq, H, hd = q.shape
    _, Sk, Kh, _ = k.shape
    G = H // Kh
    scale = scale if scale is not None else hd ** -0.5
    off = Sk - Sq
    dev = q.device
    qf = q.float().reshape(B, Sq, Kh, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
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
        o = acc / torch.clamp_min(l, 1e-30)[..., None]      # [B,Kh,G,cq,hd]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, hd)
    return out.to(q.dtype)
