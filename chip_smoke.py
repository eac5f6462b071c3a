#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, in order (any failure exits non-zero and prints no result line):
 1. card   — name, ``nvidia-smi`` name and power limit, TF32 off.
 2. build  — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, all started together) with
             ``-Xptxas -v`` (registers, shared memory, spills).
 3. sweep  — each kernel against its plain PyTorch version on the card over
             dtypes, variants, shapes, and at every prompt length the main
             path serves; elementwise tolerances of tests/test_kernels.py
             and a relative L2 error of at most 1e-5 in f32 and 1e-2 in bf16
             per case. ``sweep`` is the flash attention (recurrentgemma's
             windowed MQA head-dim-256 prefills, the later paths' prefill
             shapes, non-causal cases with Sq = Sk, Sq < Sk (seamless-
             m4t's cross-attention over 4096 frames) and Sq > Sk, and head
             dim 192 (deepseek-v2's MLA: causal MHA in both dtypes, and its
             served [1,S,128,192] prefills with v's last 64 columns zero)
             and deepseek-moe-16b's [1,S,16,128] prefills among its
             cases); it logs
             which of its two kernels ran each case (tensor-core ``tc`` or
             FMA ``fma``) and fails if a bf16 case at head dim >= 64 ran
             the FMA kernel,
             ``sweep-ssd`` the SSD scan (y and h_final, with and without D
             and h0, a two-halves state carry; its cases counted by kernel,
             tensor-core ``tc`` or FMA ``fma``, and failing if a case ran
             another kernel than ``ssd.kernel_for`` names, so the served
             bf16 P=64, N=128 shape must run ``tc``), ``sweep-rglru`` the
             RG-LRU scan (the same, ragged D and S among its shapes),
             ``sweep-bwd`` the flash backward (dq, dk, dv and the forward's
             log-sum-exp, over the flash sweep's small shapes, dtypes and
             variants and the trained or served S=2048 prefill shapes
             (deepseek-7b's and deepseek-moe-16b's causal MHA,
             recurrentgemma-9b's windowed MQA), beside the
             plain backward in 64-row chunks as a witness, non-causal
             Sq > Sk cases among them, head dim 192 (deepseek-v2's MLA:
             both dtypes, v and do zero-padded from 128 with dv's padded
             columns exactly 0, and its trained [1,2048,128,192]) too,
             and, at S=2048, SDPA's backward as a second; each case's
             route, tensor-core ``tc`` (bf16 at head dims 64/128/192/256)
             or FMA ``fma``, held by the counters; then the FlashAttention Function against
             autograd through the plain forward, SDPA as a second witness
             in bf16), ``grad-scan`` the
             SSD and RG-LRU Functions' input gradients against autograd
             through their plain versions at the served widths.
 4. timing — each kernel at the main paths' shapes (the device's time:
             CUDA events around calls queued behind a spin kernel), beside
             its plain version, a library yardstick where one PyTorch call
             computes the same function, and the card's bound (``timing``,
             ``timing-ssd``, ``timing-rglru``), with the share of the bound
             and the host's time to issue a call beside the device's time
             for it; ``timing`` also gives the flash kernel's TFLOP/s and
             ratio to SDPA, also at seamless-m4t's non-causal encoder and
             cross shapes and deepseek-v2's MLA prefill [1,2048,128,192],
             and times the fp32 FMA flash kernel at
             deepseek-7b's shape; ``timing-bwd`` the flash backward at the
             two served shapes and deepseek-v2's trained MLA shape
             [1,2048,128,192] with its route, beside SDPA's backward
             (fwd+bwd less fwd).
 5. serve  — a ServingEngine at full width serves six requests (seven for
             recurrentgemma-9b) over four slots; kernel launch counts are
             set to 0 just before and read just after, and must equal one
             launch per layer and prefill of each layer's kernel (every
             flash and SSD launch on the tensor-core kernel, none on the
             FMA one):
             deepseek-7b (30 layers, d_model 4096, 32x128 heads, d_ff
             11008, vocab 102400) through the flash attention, then
             ``serve-mamba``: mamba2-2.7b (64 Mamba-2 layers, d_model 2560,
             80x64 SSD heads, d_state 128, vocab 50280) through the SSD
             scan, then ``serve-rg``:
             recurrentgemma-9b (38 layers, 12 x (rec, rec, local) + 2 rec,
             d_model 4096, RG-LRU width 4096, 16x256 MQA heads with a
             2048-token window, d_ff 12288, vocab 256000) through the RG-LRU
             scan and the windowed flash attention, with a seventh,
             2176-token prompt that makes the window bind in prefill.
             Then ``serve-gemma7b`` (28 layers, d_model 3072, 16x256 MHA,
             GeGLU 24576, vocab 256000), ``serve-stablelm`` (24 layers,
             2048, 32x64 heads, LayerNorm, rope_pct 0.25, vocab 100352) and
             ``serve-gemma3`` (26 layers, 5 local (window 512) : 1 global
             MQA 4x256, 4 core periods over 4 slots) on the engine, and
             the multimodal paths through ``LM.prefill`` and
             ``LM.decode_step`` one request at a time (the engine takes
             tokens alone, as the reference's): ``serve-internvl``
             (internvl2-76b at full width, 8 of its 80 layers, 64x128 GQA
             over 8 kv heads, d_ff 28672; 256 seeded vision embeds ahead
             of prompts {128, 512, 1536}) and ``serve-seamless``
             (seamless-m4t-large-v2, 24 encoder + 24 decoder layers,
             16x64 heads, gelu 8192, vocab 256206; 4096 seeded frames,
             prompts {16, 128, 512}: 72 flash launches per request, 24
             encoder, 24 self, 24 cross). Then the MoE paths on the
             engine: ``serve-moe`` (deepseek-moe-16b, 28 layers: 1 dense
             (d_ff 10944) + 27 MoE of 64 routed experts top-6 plus 2
             shared (1408 each), 16x128 MHA, d_model 2048; 28 flash
             launches per request) and ``serve-v2`` (deepseek-v2-236b at
             4 of its 60 layers: 1 dense (12288) + 3 MoE of 160 experts
             top-6 plus 2 shared (1536 each), MLA with 128 heads,
             kv_lora_rank 512, q_lora_rank 1536, d_model 5120; the flash
             kernel at head dim 192, 4 launches per request, and a cache
             of compressed ckv/kpe rows).
             Random weights from a seeded generator.
    logits — request 0's prefill through the kernel and the plain version,
             beside witnesses (correct codes: the plain code in other
             chunks, and SDPA for the bf16 model) and a control (a plain
             code with a fault): the served bf16 model's hidden state after
             4 layers and its last-logits, an fp32 twin with the same
             weights, and the fp32 twin with its attention on bf16 copies
             of q, k, v (the tensor-core kernel at full depth).
             ``logits-mamba`` holds the bf16 model on its hidden state
             after 4 layers (its last-logits are reported), and checks that
             the kernel's final state carries: a prefill plus decode
             steps gives a forward's next-token logits. ``logits-rg`` does
             the same for the RG-LRU scan (witness: the plain scan in
             64-row pieces carried through h0; control: the carry dropped
             at every step). ``logits-*`` of the later paths gate the bf16
             hidden state after 4 layers and an fp32 twin's last-logits
             (seamless-m4t: 2 encoder layers, 2 decoder layers over one
             encoder output, the fp32 twin's 12 encoder layers and its
             last-logits over one encoder output; its random-init encoder
             carries rounding too far for later gates), with the SDPA
             witness and a mask-fault control. The MoE paths gate the
             hidden state after layer 0 (dense: routing is discontinuous)
             and an fp32 twin of 8 (deepseek-moe-16b) or 2 (deepseek-v2)
             layers' last-logits, and log the share of the first MoE
             layer's (token, expert) assignments and kept copies that
             differ from the plain path's.
 6. migrate — the same requests again with a mid-decode state_dict dump to
             host memory and restore into a fresh engine; the streams must
             equal phase 5's (``migrate``, ``migrate-mamba``,
             ``migrate-rg``, and the later engine paths').
 7. profile — torch.profiler over one S=2048 prefill and 8 decode steps:
             device time by kernel and the device's idle share
             (``profile``, ``profile-mamba``, ``profile-rg``; the later
             paths are not profiled).
 8. train  — deepseek-7b at full width and 12 layers (fp32 params, bf16
             compute, full remat), B=1, S=2048: a step-1 gate of the kernel
             path against the plain path beside witnesses and controls
             (each run also read against the plain path in fp32 compute on
             the same weights), an fp32 twin at 2 layers, then 3 AdamW steps through
             ``optim.adamw.make_train_step`` with the counts set to 0 just
             before (2 x layers flash forwards and layers backwards per
             step, all on the tensor-core kernels; the fp32 twin's backward
             on the FMA ones): ms per step, tokens/s, peak memory, the loss
             of a second seeded batch before and after the steps. Then the
             MoE paths the same way: ``train-moe``, deepseek-moe-16b at 5
             layers (1 dense + 4 MoE; 2.855 B params, fp32 twin at 2), and
             ``train-mla``, deepseek-v2-236b's dense layer 0 (MLA through
             the flash kernels at head dim 192; 1.387 B params, fp32 twin
             at 1), each also taking two steps from one state (the seeded
             initial state, built twice) that must agree bit for bit on
             every leaf of params, m and v (64-bit digests on the card).
 9. ckpt   — deepseek-7b's training state at full width and 2 layers
             ({step, params, m, v}: 1.24 B params, 14.92 GB in 37 leaves),
             batches from the port's TokenPipeline: 2 AdamW steps, an
             async ``checkpoint.ckpt.save``, 2 more steps (the
             uninterrupted run), a simulated failure (LM and state
             deleted), a fresh LM from another seed, ``restore`` of the
             latest checkpoint and the pipeline's cursor, the 2 steps
             again: every restored leaf bit-equal to the saved state, the
             restart equal to the uninterrupted run bit for bit where a
             witness (the restart run again) is, a control (the cursor not
             restored) caught; every flash launch on ``tc``; the stop,
             write and restore times, bytes on disk, the compressor.
10. examples — ``repro_torch.examples``' quickstart, train_e2e
             (``--steps 60``: a failure at 30, a restart from step 25,
             held against the uninterrupted command as in ``ckpt``) and
             serve_batch, each ``main(device="cuda")`` in-process with its
             own checks and its FMA flash launches counted.
The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}   # kernel vs plain, per case
LOGITS_REL_L2 = 5e-2     # served bf16 model, kernel vs plain (phase logits)
LOGITS_REL_L2_FP32 = 1e-2   # fp32 twin, kernel vs plain
# the served bf16 models: random-init layers carry any last-bit flip of a
# layer's output far (on an H100 a correct mamba witness reads 0.52 on the
# last-logits), so each is held at LOGITS_REL_L2 on its hidden state after
# its first layers, before the flips are amplified. recurrentgemma's first
# 4 are rec, rec, local, rec: both of its kernels run before the gate
GATE_LAYERS = 4
# deepseek-7b's bf16 last-logits, kernel vs plain. A code that sums like
# the plain one (the plain code in 64-wide chunks) reads 0.024 on an H100,
# one that sums on the tensor cores 0.096 (SDPA, a second witness) and the
# control 0.35: the limit lies between the tensor-core witness and the
# control. LOGITS_REL_L2 would refuse every tensor-core attention code.
LOGITS_REL_L2_BF16_DEPTH = 0.15
CARRY_REL_L2 = 1e-3      # fp32 twin: prefill + decode steps vs a forward
SSD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
KERNEL_SOURCES = ("flash_attention", "ssd", "rglru")
PROMPT_LENS = (128, 333, 512, 1000, 1536, 2048)
# recurrentgemma-9b also serves a prompt longer than its 2048-token window
RG_PROMPT_LENS = PROMPT_LENS + (2176,)
# the multimodal paths' text prompts: internvl2-76b's follow its 256 vision
# embeds, seamless-m4t's decoder attends to 4096 encoder frames
VLM_PROMPT_LENS = (128, 512, 1536)
ENCDEC_PROMPT_LENS = (16, 128, 512)
MAX_NEW = 16
SLOTS, CAPACITY = 4, 2304
DEVICE = "cuda"


def log(*a):
    print(*a, flush=True)


def nvidia_smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


SPIN_CYCLES = 20_000_000        # about 10 ms of a spin kernel on an H100


def time_ms(fn, iters, warmup=3):
    """The device's time per call of ``fn``: CUDA events around ``iters``
    calls queued behind a spin kernel, so that the host's time to issue
    them does not enter (a host slower than the kernel would otherwise set
    the reading). The spin doubles, up to 16 times, until it outlasts the
    issuing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    while True:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0.record()
        for _ in range(iters):
            fn()
        covered = not t0.query()
        t1.record()
        torch.cuda.synchronize()
        if covered or spin >= 16 * SPIN_CYCLES:
            return t0.elapsed_time(t1) / iters
        spin *= 2


def host_ms(fn, iters):
    """The host's time to issue one call of ``fn``: the wall time of
    ``iters`` calls queued without a sync, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    h1 = time.perf_counter()
    torch.cuda.synchronize()
    return (h1 - h0) / iters * 1e3


def rand_qkv(seed, B, Sq, Sk, H, Kh, hd, dtype):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    return mk(B, Sq, H, hd), mk(B, Sk, Kh, hd), mk(B, Sk, Kh, hd)


VARIANTS = ("causal", "bidir", "window", "softcap")
RG_WINDOW = 2048       # recurrentgemma-9b's local_window


GEMMA3_WINDOW = 512   # gemma3-1b's local_window
MLA_V_HEAD = 128      # deepseek-v2's v_head_dim, zero-padded to head dim 192


def variant_kw(name, Sk):
    """The flash call's keywords of a sweep variant; ``mla`` is causal, its
    v zero-padded from 128 to 192 as MLA gives it (``phase_sweep``)."""
    return {"causal": dict(causal=True), "bidir": dict(causal=False),
            "mla": dict(causal=True),
            "window": dict(causal=True, window=Sk // 3),
            "window2048": dict(causal=True, window=RG_WINDOW),
            "window512": dict(causal=True, window=GEMMA3_WINDOW),
            "softcap": dict(causal=True, softcap=20.0)}[name]


def _rel(a, b):
    """Relative L2 error of ``a`` against ``b``."""
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def one(name):
        t0 = time.perf_counter()
        return _build.build(name, verbose=True), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        done = list(pool.map(one, KERNEL_SOURCES))
    for name, (report, secs) in zip(KERNEL_SOURCES, done):
        log(f"build: {name}.cu in {secs:.1f} s (nvcc runs in parallel) -> "
            f"{_build.library_path(name).relative_to(ROOT)}")
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log("  ptxas:", line.strip().replace("ptxas info    : ", ""))


# the flash sweeps' small shapes (B, Sq, Sk, H, Kh, hd): every head dim the
# kernels take, then
FLASH_SHAPES = [(1, 128, 128, 4, 4, hd) for hd in (16, 32, 64, 128, 256)] + [
    (2, 256, 256, 8, 2, 64),        # GQA
    (1, 192, 192, 6, 1, 16),        # MQA
    (1, 100, 333, 8, 2, 128),       # right-aligned Sq < Sk, ragged
    (1, 333, 333, 4, 2, 64),        # ragged S
    (2, 77, 77, 4, 4, 256)]         # ragged, tiny, largest head dim


def _served_flash_cases():
    """The later paths' prefill shapes in bf16: gemma-7b, stablelm-1.6b,
    gemma3-1b (local and global layers), internvl2-76b (vision embeds and
    text) and seamless-m4t's causal self-attention."""
    import torch
    bf = torch.bfloat16
    return ([((1, S, S, 16, 16, 256), bf, "causal") for S in PROMPT_LENS]
            + [((1, S, S, 32, 32, 64), bf, "causal") for S in PROMPT_LENS]
            + [((1, S, S, 4, 1, 256), bf, v) for S in PROMPT_LENS
               for v in ("window512", "causal")]
            + [((1, 256 + S, 256 + S, 64, 8, 128), bf, "causal")
               for S in VLM_PROMPT_LENS]
            + [((1, S, S, 16, 16, 64), bf, "causal")
               for S in ENCDEC_PROMPT_LENS])


def _mla_cases():
    """Head dim 192 (deepseek-v2's MLA: qk_nope 128 + qk_rope 64): causal
    MHA in both dtypes (bf16 on the tensor-core kernel, fp32 on the FMA
    one) at S = 128, 333, 2048, and the served bf16 prefill shape
    [1,S,128,192] at every prompt length, v's last 64 columns zero."""
    import torch
    return ([((1, S, S, 8, 8, 192), dt, "causal") for S in (128, 333, 2048)
             for dt in (torch.float32, torch.bfloat16)]
            + [((1, S, S, 128, 128, 192), torch.bfloat16, "mla")
               for S in PROMPT_LENS])


def _noncausal_cases():
    """Non-causal cases in both dtypes: Sq = Sk at head dims 64/128/256
    and seamless-m4t's encoder shape; Sq < Sk, its cross shapes; Sq > Sk
    (a decoder longer than its encoder), with Sk on and off the key
    tile."""
    import torch
    dts = (torch.float32, torch.bfloat16)
    shapes = [(1, 256, 256, 8, 8, hd) for hd in (64, 128, 256)] + [
        (1, 4096, 4096, 16, 16, 64),                # the encoder
        (1, 512, 4096, 16, 16, 64),                 # cross, Sq < Sk
        (1, 96, 32, 16, 16, 64),                    # Sq > Sk
        (1, 200, 77, 8, 2, 128),                    # Sq > Sk, ragged Sk
        (1, 300, 100, 4, 1, 256)]                   # Sq > Sk, MQA, hd 256
    cases = [(sh, dt, "bidir") for sh in shapes for dt in dts]
    cases += [((1, S, 4096, 16, 16, 64), torch.bfloat16, "bidir")
              for S in ENCDEC_PROMPT_LENS if S != 512]  # the other crosses
    return cases


def phase_sweep():
    import torch
    from repro_torch.kernels import flash_attention as fa
    cases = [(s, dt, v) for s in FLASH_SHAPES
             for dt in (torch.float32, torch.bfloat16) for v in VARIANTS]
    cases += [((1, S, S, 32, 32, 128), torch.bfloat16, "causal")
              for S in PROMPT_LENS]            # deepseek-7b's prefills
    cases += [((1, S, S, 16, 1, 256), torch.bfloat16, "window2048")
              for S in RG_PROMPT_LENS]         # recurrentgemma-9b's prefills
    cases += [((1, S, S, 16, 16, 128), torch.bfloat16, "causal")
              for S in PROMPT_LENS]            # deepseek-moe-16b's prefills
    cases += _served_flash_cases() + _noncausal_cases() + _mla_cases()
    bad = []
    worst = {}
    ran = {"tc": 0, "fma": 0}
    for seed, (shape, dt, var) in enumerate(cases):
        B, Sq, Sk, H, Kh, hd = shape
        q, k, v = rand_qkv(seed, B, Sq, Sk, H, Kh, hd, dt)
        if var == "mla":
            v[..., 128:] = 0
        kw = variant_kw(var, Sk)
        before = flash_counts()
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        kern = [n for n, c in flash_counts().items() if c > before[n]]
        assert len(kern) == 1, (before, flash_counts())
        kern = kern[0]
        ran[kern] += 1
        want = fa.attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        rtol, atol = TOL[str(dt).split(".")[-1]]
        excess = (diff - atol - rtol * want.float().abs()).max().item()
        err = diff.max().item()
        name = str(dt).split(".")[-1]
        rel = _rel(got, want)
        # the tensor cores must run every bf16 case at head dim >= 64
        right_kernel = kern == ("tc" if dt == torch.bfloat16 and hd >= 64
                                else "fma")
        ok = (excess <= 0 and rel <= REL_L2[name] and right_kernel
              and torch.isfinite(got).all().item()
              and (var != "mla" or not got[..., 128:].any().item()))
        key = f"{name}_{kern}"
        worst[key] = max(worst.get(key, 0.0), err)
        worst[key + "_rel_l2"] = max(worst.get(key + "_rel_l2", 0.0), rel)
        log(f"sweep {shape} {name:8s} {var:10s} {kern:3s} max_abs_err="
            f"{err:.3e} rel_l2={rel:.3e} {'ok' if ok else 'FAIL'}"
            f"{'' if right_kernel else ' (wrong kernel)'}")
        if not ok:
            bad.append((shape, name, var, kern, err))
    log(f"sweep: {len(cases) - len(bad)}/{len(cases)} cases within "
        f"tolerance; cases by kernel {json.dumps(ran)}; worst errors "
        f"{json.dumps(worst)}")
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")


def attention_bound(B, Sq, Sk, H, hd, elem_bytes, causal, Kh=None, window=0,
                    peak=PEAK_BF16_FLOPS):
    """FLOP: 4 B H hd per unmasked query-key pair, at ``peak`` (bf16
    tensor cores by default). Bytes: q and o [B,Sq,H,hd], k and v
    [B,Sk,Kh,hd] once each."""
    Kh = H if Kh is None else Kh

    def keys(i):                      # keys query i sees
        hi = Sk - Sq + i + 1 if causal else Sk
        lo = max(0, Sk - Sq + i - window + 1) if window > 0 else 0
        return min(hi, Sk) - lo
    pairs = sum(keys(i) for i in range(Sq))
    flops = 4 * B * H * hd * pairs
    nbytes = elem_bytes * (2 * B * Sq * H * hd + 2 * B * Sk * Kh * hd)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


# flash timing shapes: (label, Sq, Sk, H, Kh, hd, window, causal); the
# first three are deepseek-7b's prefills, the fourth recurrentgemma-9b's
# windowed MQA one (at S = window the window does not bind, so causal SDPA
# is a fair yardstick), the last two seamless-m4t's encoder and its
# decoder's cross-attention over 4096 frames, both non-causal, the last
# deepseek-v2's MLA prefill at head dim 192 (v zero-padded from 128)
FLASH_TIMING = (("deepseek", 128, 128, 32, 32, 128, 0, True),
                ("deepseek", 512, 512, 32, 32, 128, 0, True),
                ("deepseek", 2048, 2048, 32, 32, 128, 0, True),
                ("recurrentgemma", 2048, 2048, 16, 1, 256, RG_WINDOW, True),
                ("seamless encoder", 4096, 4096, 16, 16, 64, 0, False),
                ("seamless cross", 512, 4096, 16, 16, 64, 0, False),
                ("deepseek-v2 MLA", 2048, 2048, 128, 128, 192, 0, True))


def phase_timing():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for label, S, Sk, H, Kh, hd, window, causal in FLASH_TIMING:
        B = 1
        q, k, v = rand_qkv(100 + S + Sk + hd, B, S, Sk, H, Kh, hd,
                           torch.bfloat16)
        if hd == 192:
            v[..., 128:] = 0
        kw = dict(causal=causal, window=window)
        kern = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: fa.attention_plain(q, k, v, **kw)  # noqa: E731
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=Kh != H)
        err = (kern().float() - plain().float()).abs().max().item()
        lib_err = (kern().float() - lib().transpose(1, 2).float()
                   ).abs().max().item()
        iters = 50 if S <= 512 else 20
        ms = time_ms(kern, iters)
        plain_ms = time_ms(plain, max(iters // 4, 3))
        lib_ms = time_ms(lib, iters)
        ms2 = time_ms(kern, iters)
        host = host_ms(kern, iters)
        bound_ms, bound_by, flops = attention_bound(B, S, Sk, H, hd, 2,
                                                    causal, Kh=Kh,
                                                    window=window)
        shape = f"[1,{S},{H},{hd}]" + (f" Kh={Kh}" if Kh != H else "") + \
            (f" over Sk={Sk}" if Sk != S else "")
        row = dict(path=label, S=S, Sk=Sk, shape=shape, window=window,
                   causal=causal, dtype="bfloat16", ms=ms,
                   ms_repeat=ms2, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                   library_max_abs_diff=lib_err,
                   tflops=flops / (ms * 1e-3) / 1e12)
        row.update(kernel=fa.kernel_for(q.dtype, hd),
                   share_of_bound=bound_ms / ms, vs_sdpa=ms / lib_ms,
                   host_ms_per_call=host)
        rows.append(row)
        log(f"timing {shape} bf16 {'causal' if causal else 'non-causal'} "
            f"window={window} ({row['kernel']} "
            f"kernel): {ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} "
            f"ms, SDPA yardstick {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {row['tflops']:.2f} TFLOP/s, "
            f"{100 * row['share_of_bound']:.2f}% of the bound, "
            f"{row['vs_sdpa']:.3f}x SDPA's time, kernel-plain max abs err "
            f"{err:.3e}, kernel-SDPA {lib_err:.3e}; the host takes "
            f"{host:.4f} ms to issue a call")
    rows.append(timing_fma_fp32())
    return rows


def timing_fma_fp32():
    """The fp32 FMA kernel (the fp32 twin's flash kernel) once, at
    deepseek-7b's S=2048 prefill shape; its bound takes the fp32 rate
    outside the tensor cores, the rate its inputs ask for."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    S, H, hd = 2048, 32, 128
    q, k, v = rand_qkv(7, 1, S, S, H, H, hd, torch.float32)
    kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    plain = lambda: fa.attention_plain(q, k, v, causal=True)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    err = (kern() - plain()).abs().max().item()
    ms, plain_ms, lib_ms = time_ms(kern, 5), time_ms(plain, 3), \
        time_ms(lib, 5)
    bound_ms, bound_by, flops = attention_bound(1, S, S, H, hd, 4, True,
                                                peak=PEAK_F32_FLOPS)
    row = dict(path="deepseek (fp32 twin)", S=S, shape=f"[1,{S},{H},{hd}]",
               window=0, dtype="float32", kernel=fa.kernel_for(q.dtype, hd),
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
               tflops=flops / (ms * 1e-3) / 1e12,
               share_of_bound=bound_ms / ms)
    log(f"timing [1,{S},{H},{hd}] fp32 causal ({row['kernel']} kernel): "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA yardstick "
        f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, fp32 at "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s), {row['tflops']:.2f} "
        f"TFLOP/s, kernel-plain max abs err {err:.3e}")
    return row


def rand_ssd(seed, B, S, H, P, G, N, dtype):
    """x, dt (softplus'd, fp32), A_log, B, C, D, h0 on the card."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * scale
    return (mk(B, S, H, P).to(dtype), F.softplus(mk(B, S, H)),
            mk(H, scale=0.5), mk(B, S, G, N, scale=0.3).to(dtype),
            mk(B, S, G, N, scale=0.3).to(dtype), mk(H), mk(B, H, P, N))


def _pair_ok(name, got, want, tol):
    """Elementwise and relative-L2 agreement of (y, h_final) pairs."""
    import torch
    rtol, atol = tol[name]
    out = {}
    ok = True
    for label, a, b in (("y", got[0], want[0]), ("h", got[1], want[1])):
        diff = (a.float() - b.float()).abs()
        excess = (diff - atol - rtol * b.float().abs()).max().item()
        rel = _rel(a, b)
        out[label] = (diff.max().item(), rel)
        ok = ok and excess <= 0 and rel <= REL_L2[name] and \
            bool(torch.isfinite(a).all())
    return ok, out


def phase_sweep_ssd():
    import torch
    from repro_torch.kernels import ssd
    shapes = [(1, 64, 2, 8, 1, 8), (2, 128, 4, 16, 2, 8),   # test shapes
              (1, 72, 2, 8, 1, 8),                           # ragged S
              (2, 100, 4, 32, 2, 16),                        # ragged, G=2
              (3, 1, 4, 16, 1, 16),                          # one token
              (1, 333, 8, 64, 1, 128),                       # ragged, N=128
              (2, 256, 6, 64, 3, 16),                        # G=3, N=16
              (1, 129, 4, 16, 2, 128)]                       # one row past Q
    variants = {"none": (), "D": ("D",), "h0": ("h0",), "D+h0": ("D", "h0")}
    cases = [(s, dt, v) for s in shapes
             for dt in (torch.float32, torch.bfloat16) for v in variants]
    cases += [((1, S, 80, 64, 1, 128), torch.bfloat16, "D")
              for S in PROMPT_LENS]            # the main path's prefills
    bad, worst = [], {}
    ran = {"tc": 0, "fma": 0}
    for seed, (shape, dt, var) in enumerate(cases):
        x, dtv, al, bm, cm, d, h0 = rand_ssd(seed, *shape, dt)
        kw = {k: {"D": d, "h0": h0}[k] for k in variants[var]}
        before = ssd_counts()
        got = ssd.ssd_scan(x, dtv, al, bm, cm, **kw)
        torch.cuda.synchronize()
        kern = [n for n, c in ssd_counts().items() if c > before[n]]
        assert len(kern) == 1, (before, ssd_counts())
        kern = kern[0]
        ran[kern] += 1
        want = ssd.ssd_plain(x, dtv, al, bm, cm, **kw)
        name = str(dt).split(".")[-1]
        ok, errs = _pair_ok(name, got, want, SSD_TOL)
        # the tensor cores must run the served shape (P=64, N=128, bf16)
        right_kernel = kern == ssd.kernel_for(dt, shape[3], shape[5]) and \
            (kern == "tc" or shape[3:] != (64, 1, 128) or name != "bfloat16")
        ok = ok and right_kernel
        for label, (err, rel) in errs.items():
            key = f"{name}_{kern}_{label}"
            worst[key] = max(worst.get(key, 0.0), err)
            worst[key + "_rel_l2"] = max(worst.get(key + "_rel_l2", 0.0), rel)
        log(f"sweep-ssd {shape} {name:8s} {var:5s} {kern:3s} y max_abs_err="
            f"{errs['y'][0]:.3e} rel_l2={errs['y'][1]:.3e}, h max_abs_err="
            f"{errs['h'][0]:.3e} rel_l2={errs['h'][1]:.3e} "
            f"{'ok' if ok else 'FAIL'}"
            f"{'' if right_kernel else ' (wrong kernel)'}")
        if not ok:
            bad.append((shape, name, var, kern))
    # two halves, the state carried by the kernel across a ragged split
    halves = (torch.float32, torch.bfloat16)
    for dt in halves:
        name = str(dt).split(".")[-1]
        x, dtv, al, bm, cm, d, _ = rand_ssd(99, 1, 333, 80, 64, 1, 128, dt)
        h, ys = None, []
        for lo, hi in ((0, 166), (166, 333)):
            y, h = ssd.ssd_scan(x[:, lo:hi], dtv[:, lo:hi], al, bm[:, lo:hi],
                                cm[:, lo:hi], D=d, h0=h)
            ys.append(y)
        want = ssd.ssd_plain(x, dtv, al, bm, cm, D=d)
        ok, errs = _pair_ok(name, (torch.cat(ys, 1), h), want,
                             SSD_TOL)
        log(f"sweep-ssd two halves (166+167 of [1,333,80,64]) {name}: y "
            f"rel_l2={errs['y'][1]:.3e}, h rel_l2={errs['h'][1]:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(("two halves", name))
    n = len(cases) + len(halves)
    log(f"sweep-ssd: {n - len(bad)}/{n} cases within "
        f"tolerance; cases by kernel {json.dumps(ran)} (two halves not "
        f"counted); worst errors {json.dumps(worst)}")
    if bad:
        raise AssertionError(f"SSD kernel disagrees with its plain version: "
                             f"{bad}")


def ssd_bound(B, S, H, P, G, N, elem_bytes):
    """Least time for the SSD scan plus D skip. FLOP: the least arithmetic
    the function needs, which does not depend on the blocking. Chunked by Q
    rows with the masked upper triangle left out, a row of a head costs
    (Q+1)(N+P) for C.B^T and its product with x, and 4NP for C.h_in and the
    state update; Q = 1, the plain recurrence, needs least: 2(N+P) + 4NP,
    plus 2P for the D skip; at the bf16 peak. Bytes: x and y once, B and C
    once per group, dt, A_log, D and h_final."""
    flops = B * S * H * (2 * (N + P) + 4 * N * P + 2 * P)
    nbytes = (2 * elem_bytes * B * S * H * P + 2 * elem_bytes * B * S * G * N
              + 4 * B * S * H + 4 * 2 * H + 4 * B * H * P * N)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_timing_ssd():
    import torch
    from repro_torch.kernels import ssd
    rows = []
    for S in (512, 2048):
        shape = (1, S, 80, 64, 1, 128)
        x, dtv, al, bm, cm, d, _ = rand_ssd(200 + S, *shape, torch.bfloat16)
        kern = lambda: ssd.ssd_scan(x, dtv, al, bm, cm, D=d)  # noqa: E731
        plain = lambda: ssd.ssd_plain(x, dtv, al, bm, cm, D=d)  # noqa: E731
        err = (kern()[0].float() - plain()[0].float()).abs().max().item()
        iters = 50 if S == 512 else 20
        ms = time_ms(kern, iters)
        plain_ms = time_ms(plain, max(iters // 4, 3))
        ms2 = time_ms(kern, iters)
        host = host_ms(kern, iters)
        bound_ms, bound_by, flops, nbytes = ssd_bound(*shape, 2)
        row = dict(S=S, kernel=ssd.kernel_for(x.dtype, 64, 128), ms=ms,
                   ms_repeat=ms2, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes, max_abs_err=err,
                   tflops=flops / (ms * 1e-3) / 1e12,
                   share_of_bound=bound_ms / ms, host_ms_per_call=host)
        rows.append(row)
        log(f"timing-ssd [1,{S},80,64] bf16 N=128 with D ({row['kernel']} "
            f"kernel): {ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} "
            f"ms, no library call computes SSD, bound {bound_ms:.5f} ms "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
            f"{100 * row['share_of_bound']:.2f}% of the bound, "
            f"{row['tflops']:.2f} TFLOP/s, kernel-plain y max abs err "
            f"{err:.3e}; the host takes {host:.4f} ms to issue a call")
    return rows


def rand_rglru(seed, B, S, D, dtype):
    """x, a_log, gate_a, gate_x, h0 on the card (x and gates in dtype)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)
    return (mk(B, S, D).to(dtype), mk(D), mk(B, S, D).to(dtype),
            mk(B, S, D).to(dtype), mk(B, D))


def phase_sweep_rglru():
    import torch
    from repro_torch.kernels import rglru
    shapes = [(1, 64, 16), (2, 128, 48),          # tests/test_kernels.py
              (2, 100, 24), (1, 333, 100),         # ragged S and D
              (3, 1, 48), (1, 2, 4096)]            # one and two steps
    cases = [(s, dt, v) for s in shapes
             for dt in (torch.float32, torch.bfloat16) for v in ("none",
                                                                 "h0")]
    cases += [((1, S, 4096), torch.bfloat16, "none")
              for S in RG_PROMPT_LENS]     # recurrentgemma-9b's prefills
    bad, worst = [], {}
    for seed, (shape, dt, var) in enumerate(cases):
        x, al, ga, gx, h0 = rand_rglru(seed, *shape, dt)
        kw = {"h0": h0} if var == "h0" else {}
        got = rglru.rglru_scan(x, al, ga, gx, **kw)
        torch.cuda.synchronize()
        want = rglru.rglru_plain(x, al, ga, gx, **kw)
        name = str(dt).split(".")[-1]
        ok, errs = _pair_ok(name, got, want, TOL)
        for label, (err, rel) in errs.items():
            worst[f"{name}_{label}"] = max(worst.get(f"{name}_{label}", 0.0),
                                           err)
            worst[f"{name}_{label}_rel_l2"] = max(
                worst.get(f"{name}_{label}_rel_l2", 0.0), rel)
        log(f"sweep-rglru {shape} {name:8s} {var:4s} y max_abs_err="
            f"{errs['y'][0]:.3e} rel_l2={errs['y'][1]:.3e}, h max_abs_err="
            f"{errs['h'][0]:.3e} rel_l2={errs['h'][1]:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append((shape, name, var))
    # two halves, the state carried by the kernel across a ragged split
    halves = (torch.float32, torch.bfloat16)
    for dt in halves:
        name = str(dt).split(".")[-1]
        x, al, ga, gx, _ = rand_rglru(99, 1, 333, 4096, dt)
        h, ys = None, []
        for lo, hi in ((0, 166), (166, 333)):
            y, h = rglru.rglru_scan(x[:, lo:hi], al, ga[:, lo:hi],
                                    gx[:, lo:hi], h0=h)
            ys.append(y)
        want = rglru.rglru_plain(x, al, ga, gx)
        ok, errs = _pair_ok(name, (torch.cat(ys, 1), h), want, TOL)
        log(f"sweep-rglru two halves (166+167 of [1,333,4096]) {name}: y "
            f"rel_l2={errs['y'][1]:.3e}, h rel_l2={errs['h'][1]:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(("two halves", name))
    n = len(cases) + len(halves)
    log(f"sweep-rglru: {n - len(bad)}/{n} cases within tolerance; worst "
        f"errors {json.dumps(worst)}")
    if bad:
        raise AssertionError(f"RG-LRU kernel disagrees with its plain "
                             f"version: {bad}")


def phase_sweep_bwd():
    """The flash backward kernel against ``attention_bwd_plain`` on dq, dk
    and dv, over the flash sweep's small shapes, dtypes and variants and
    the trained or served prefill shapes at S=2048 (deepseek-7b and
    deepseek-moe-16b causal, recurrentgemma-9b MQA window 2048), and head
    dim 192 (deepseek-v2's
    MLA: the small shape under every variant, causal MHA with v and do
    zero-padded from 128, where dv's padded columns must come out exactly
    0, and the trained shape [1,2048,128,192]). Both backwards get the
    forward kernel's o and log-sum-exp (the lse itself is held against the
    plain forward's); per case the forward's limits (TOL elementwise,
    REL_L2).
    Each case asserts its route by the counters: bf16 at head dims
    64/128/192/256 on the tensor-core kernels (``tc``), the rest on the FMA
    ones. Beside each case a witness, the plain backward in 64-row chunks (a
    correct code that sums in another order), is read against the plain
    one; at the S=2048 shapes SDPA's backward (a correct code on the
    tensor cores, rounding P and dS to bf16) is a second witness. Then
    once: the FlashAttention Function's gradients (forward and backward
    kernels) against autograd through ``attention_plain``, with SDPA's
    autograd as a second witness in bf16."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    cases = [(s, dt, v) for s in FLASH_SHAPES
             for dt in (torch.float32, torch.bfloat16) for v in VARIANTS]
    cases += [((1, 2048, 2048, 32, 32, 128), torch.bfloat16, "causal"),
              ((1, 2048, 2048, 16, 16, 128), torch.bfloat16, "causal"),
              ((1, 2048, 2048, 16, 1, 256), torch.bfloat16, "window2048")]
    # head dim 192 (deepseek-v2's MLA) in both dtypes: the small shape
    # under every variant, then causal MHA with v and do zero-padded from
    # 128 as MLA gives them, and its trained bf16 shape [1,2048,128,192]
    cases += [((1, 128, 128, 4, 4, 192), dt, v)
              for dt in (torch.float32, torch.bfloat16) for v in VARIANTS]
    cases += [((1, S, S, 8, 8, 192), dt, "mla") for S in (128, 333)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [((1, 2048, 2048, 128, 128, 192), torch.bfloat16, "mla")]
    # non-causal with Sq > Sk (a decoder longer than its encoder), Sk on
    # and off the key tiles
    cases += [(s, dt, "bidir") for s in ((1, 96, 32, 16, 16, 64),
                                         (1, 200, 77, 8, 2, 128))
              for dt in (torch.float32, torch.bfloat16)]
    bad, worst, routes = [], {}, {"tc": 0, "fma": 0}
    for seed, (shape, dt, var) in enumerate(cases):
        B, Sq, Sk, H, Kh, hd = shape
        q, k, v = rand_qkv(500 + seed, B, Sq, Sk, H, Kh, hd, dt)
        do = torch.randn(q.shape, device=DEVICE,
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(900 + seed)).to(dt)
        if var == "mla":
            v[..., MLA_V_HEAD:] = 0
            do[..., MLA_V_HEAD:] = 0
        kw = dict(variant_kw(var, Sk), scale=hd ** -0.5)
        kw = {"causal": True, "window": 0, "softcap": 0.0, **kw}
        o, lse = fa._launch(q, k, v, want_lse=True, **kw)
        _, lse_plain = fa.attention_fwd_lse_plain(q, k, v, **kw)
        before = bwd_counts()
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        route = "tc" if dt == torch.bfloat16 and hd >= 64 else "fma"
        after = bwd_counts()
        assert fa.bwd_kernel_for(dt, hd) == route and after == {
            r: before[r] + (r == route) for r in before}, \
            (shape, dt, route, before, after)
        routes[route] += 1
        want = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
        wit = fa.attention_bwd_plain(q, k, v, o, lse, do, chunk_q=64,
                                     chunk_k=64, **kw)
        # at S=2048, recurrentgemma's 2048-token window masks nothing the
        # causal mask keeps, so SDPA's causal backward is a witness there
        sdpa = _sdpa_grads(q, k, v, do, kw["scale"]) if Sq == 2048 else None
        name = str(dt).split(".")[-1]
        rtol, atol = TOL[name]
        ok, errs = True, {}
        for i, (label, a, b, w) in enumerate((
                ("lse", lse, lse_plain, lse_plain),
                *zip(("dq", "dk", "dv"), got, want, wit))):
            diff = (a.float() - b.float()).abs()
            excess = (diff - atol - rtol * b.float().abs()).max().item()
            rel = _rel(a, b)
            errs[label] = (diff.max().item(), rel, _rel(w, b),
                           _rel(sdpa[i - 1], b) if sdpa and i else None)
            ok = ok and excess <= 0 and rel <= REL_L2[name] and \
                bool(torch.isfinite(a).all())
            if var == "mla" and label == "dv":   # p^T.do over zero columns
                ok = ok and bool((a[..., MLA_V_HEAD:] == 0).all())
            key = f"{name}_{label}"
            worst[key] = max(worst.get(key, 0.0), diff.max().item())
            worst[key + "_rel_l2"] = max(worst.get(key + "_rel_l2", 0.0), rel)
            worst[key + "_witness_rel_l2"] = max(
                worst.get(key + "_witness_rel_l2", 0.0), errs[label][2])
            if errs[label][3] is not None:
                worst[key + "_sdpa_rel_l2"] = max(
                    worst.get(key + "_sdpa_rel_l2", 0.0), errs[label][3])
        log(f"sweep-bwd {shape} {name:8s} {var:10s} {route:3s} " + ", ".join(
            f"{lb} max_abs_err={e:.3e} rel_l2={r:.3e} (witness {w:.3e}"
            + (f", SDPA {sd:.3e})" if sd is not None else ")")
            for lb, (e, r, w, sd) in errs.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append((shape, name, var))
    log(f"sweep-bwd: {len(cases) - len(bad)}/{len(cases)} cases within "
        f"tolerance (the backward kernels ran in every case, by route "
        f"{json.dumps(routes)}); worst errors {json.dumps(worst)}")
    # the Function end to end against autograd through the plain forward
    fn_out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        q, k, v = rand_qkv(77, 1, 512, 512, 8, 8, 128, dt)
        do = torch.randn(q.shape, device=DEVICE,
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(78)).to(dt)

        def grads(attn):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attn(*leaves)
            return torch.autograd.grad(out, leaves, do)
        ref = grads(lambda a, b, c: fa.attention_plain(a, b, c, causal=True))
        runs = {"function": grads(lambda a, b, c: fa.flash_attention(
            a, b, c, causal=True))}
        if dt == torch.bfloat16:
            runs["witness_sdpa"] = grads(lambda a, b, c: _sdpa_witness(
                None, a, b, c, causal=True))
        for run, gs in runs.items():
            for label, a, b in zip(("dq", "dk", "dv"), gs, ref):
                fn_out[f"{name}_{run}_{label}_rel_l2"] = _rel(a, b)
    log(f"sweep-bwd: FlashAttention's gradients ([1,512,8,128] causal) vs "
        f"autograd through attention_plain, relative L2 "
        f"{json.dumps(fn_out)}; limits {json.dumps(REL_L2)}")
    for key, val in fn_out.items():
        if val > REL_L2[key.split("_")[0]]:
            bad.append(("function", key, val))
    if bad:
        raise AssertionError(f"the backward kernel disagrees with its plain "
                             f"version: {bad}")


def _sdpa_grads(q, k, v, do, scale):
    """dq, dk, dv of causal attention by SDPA's autograd (a witness)."""
    import torch
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa_witness(None, *leaves, causal=True, scale=scale)
    return torch.autograd.grad(out, leaves, do)


def attention_bwd_bound(B, Sq, Sk, H, hd, elem_bytes, causal, Kh=None,
                        window=0):
    """Least time for the flash backward. FLOP: 5 products (q.k^T, do.v^T,
    p^T.do, ds.k, ds^T.q) of 2 hd FLOP per unmasked query-key pair and
    head, 10 B H hd per pair, at the bf16 tensor-core peak. Bytes: q, o,
    do, dq [B,Sq,H,hd] and k, v, dk, dv [B,Sk,Kh,hd] once each, lse
    [B,Sq,H] fp32."""
    Kh = H if Kh is None else Kh
    _, _, fwd_flops = attention_bound(B, Sq, Sk, H, hd, elem_bytes, causal,
                                      Kh=Kh, window=window)
    flops = fwd_flops // 4 * 10
    nbytes = elem_bytes * (4 * B * Sq * H * hd + 4 * B * Sk * Kh * hd) + \
        4 * B * Sq * H
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


# backward timing shapes: (label, S, H, Kh, hd, window), bf16 causal;
# deepseek-v2's MLA with v and do zero-padded from MLA_V_HEAD
BWD_TIMING = (("deepseek", 2048, 32, 32, 128, 0),
              ("recurrentgemma", 2048, 16, 1, 256, RG_WINDOW),
              ("deepseek-v2", 2048, 128, 128, 192, 0))


def phase_timing_bwd():
    """The flash backward's device time at the two served prefill shapes
    and deepseek-v2's trained MLA shape [1,2048,128,192] (v and do
    zero-padded from 128; the route that ran them, ``tc`` or ``fma``),
    beside the plain
    backward's, a library yardstick (SDPA's backward: SDPA forward plus
    backward by autograd, less SDPA's forward) and the bound; the host's
    time to issue a call beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for label, S, H, Kh, hd, window in BWD_TIMING:
        q, k, v = rand_qkv(600 + hd, 1, S, S, H, Kh, hd, torch.bfloat16)
        do = torch.randn(q.shape, device=DEVICE,
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(601)).to(torch.bfloat16)
        if hd == 192:
            v[..., MLA_V_HEAD:] = 0
            do[..., MLA_V_HEAD:] = 0
        kw = dict(causal=True, window=window, softcap=0.0, scale=hd ** -0.5)
        o, lse = fa._launch(q, k, v, want_lse=True, **kw)
        kern = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, **kw)
        plain = lambda: fa.attention_bwd_plain(  # noqa: E731
            q, k, v, o, lse, do, **kw)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(kern(), plain()))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=Kh != H)
        lib_fwdbwd = lambda: torch.autograd.grad(  # noqa: E731
            sdpa(), (qt, kt, vt), dot)
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 3)
        with torch.no_grad():
            lib_fwd_ms = time_ms(sdpa, 20)
        lib_ms = time_ms(lib_fwdbwd, 20) - lib_fwd_ms
        ms2 = time_ms(kern, 10)
        host = host_ms(kern, 10)
        bound_ms, bound_by, flops = attention_bwd_bound(
            1, S, S, H, hd, 2, True, Kh=Kh, window=window)
        shape = f"[1,{S},{H},{hd}]" + (f" Kh={Kh}" if Kh != H else "")
        row = dict(path=label, S=S, shape=shape, window=window,
                   dtype="bfloat16", route=fa.bwd_kernel_for(q.dtype, hd),
                   ms=ms, ms_repeat=ms2, plain_ms=plain_ms,
                   library_ms=lib_ms, library_fwd_ms=lib_fwd_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                   tflops=flops / (ms * 1e-3) / 1e12,
                   share_of_bound=bound_ms / ms, vs_sdpa=ms / lib_ms,
                   host_ms_per_call=host)
        rows.append(row)
        log(f"timing-bwd {shape} bf16 causal window={window} "
            f"({row['route']} kernels): {ms:.4f} ms "
            f"(again {ms2:.4f}), plain {plain_ms:.4f} ms, SDPA backward "
            f"yardstick {lib_ms:.4f} ms (fwd+bwd less fwd {lib_fwd_ms:.4f}), "
            f"bound {bound_ms:.5f} ms ({bound_by}), {row['tflops']:.2f} "
            f"TFLOP/s, {100 * row['share_of_bound']:.2f}% of the bound, "
            f"{row['vs_sdpa']:.3f}x SDPA's backward, kernel-plain max abs "
            f"err {err:.3e}; the host takes {host:.4f} ms to issue a call")
    return rows


def phase_grad_scan():
    """The SSD and RG-LRU Functions' input gradients on the card (forward
    by the kernel, backward through the plain version's autograd) against
    autograd through the plain versions, at the served widths (mamba2-2.7b:
    80 heads of 64, N=128; recurrentgemma-9b: 4096 lanes) and S=256, with
    h0 and through both y and h_final; the output must carry a grad_fn and
    the forward must have launched the kernel."""
    import torch
    from repro_torch.kernels import rglru, ssd
    out, bad = {}, []
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        runs = (("ssd", ssd, ssd.ssd_scan, ssd.ssd_plain,
                 rand_ssd(31, 1, 256, 80, 64, 1, 128, dt), ("D", "h0")),
                ("rglru", rglru, rglru.rglru_scan, rglru.rglru_plain,
                 rand_rglru(32, 1, 256, 4096, dt), ("h0",)))
        for label, mod, scan, plain, ins, kws in runs:
            ins = [t.detach().requires_grad_() for t in ins]
            args, kw = ins[:-len(kws)], dict(zip(kws, ins[-len(kws):]))
            before = mod.launches
            y, h = scan(*args, **kw)
            launched = mod.launches - before
            g = torch.Generator(device=DEVICE).manual_seed(33)
            gy = torch.randn(y.shape, generator=g, device=DEVICE).to(y.dtype)
            gh = torch.randn(h.shape, generator=g, device=DEVICE)
            got = torch.autograd.grad((y, h), ins, (gy, gh))
            yp, hp = plain(*args, **kw)
            want = torch.autograd.grad((yp, hp), ins, (gy, gh))
            rels = [_rel(a, b) for a, b in zip(got, want)]
            out[f"{name}_{label}"] = max(rels)
            ok = y.grad_fn is not None and launched == 1 and \
                max(rels) <= REL_L2[name]
            log(f"grad-scan {label} {name}: grad_fn "
                f"{type(y.grad_fn).__name__}, kernel launches {launched}, "
                f"worst input-gradient relative L2 {max(rels):.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append((label, name))
    if bad:
        raise AssertionError(f"scan gradients: {bad}")
    return out


RGLRU_OPS = 24     # fp32 operations per lane and step, exp/sqrt as one


def rglru_bound(B, S, D, elem_bytes):
    """Least time for the RG-LRU scan. Bytes: x, gate_a and gate_x read once
    and y written once in their dtype, a_log and h_final in fp32. Operations:
    the gates and the step in fp32 (two sigmoids, two exps, a softplus read
    once per lane, sqrt, max, the products and the FMA: RGLRU_OPS per lane
    and step) at the card's fp32 rate outside the tensor cores."""
    ops = RGLRU_OPS * B * S * D
    nbytes = 4 * elem_bytes * B * S * D + 4 * D + 4 * B * D
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def phase_timing_rglru():
    import torch
    from repro_torch.kernels import rglru
    rows = []
    for S in (512, 2048):
        x, al, ga, gx, _ = rand_rglru(300 + S, 1, S, 4096, torch.bfloat16)
        kern = lambda: rglru.rglru_scan(x, al, ga, gx)  # noqa: E731
        plain = lambda: rglru.rglru_plain(x, al, ga, gx)  # noqa: E731
        err = (kern()[0].float() - plain()[0].float()).abs().max().item()
        iters = 50 if S == 512 else 20
        ms = time_ms(kern, iters)
        plain_ms = time_ms(plain, max(iters // 4, 3))
        ms2 = time_ms(kern, iters)
        host = host_ms(kern, iters)
        bound_ms, bound_by, ops, nbytes = rglru_bound(1, S, 4096, 2)
        T = rglru.CHUNK_STEPS
        row = dict(S=S, chunk_steps=T, ms=ms, ms_repeat=ms2,
                   plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   ops=ops, bytes=nbytes, max_abs_err=err,
                   gb_per_s=nbytes / (ms * 1e-3) / 1e9,
                   share_of_bound=bound_ms / ms, host_ms_per_call=host)
        rows.append(row)
        log(f"timing-rglru [1,{S},4096] bf16 (chunks of {T} steps): kernel "
            f"{ms:.4f} ms (again {ms2:.4f}), plain {plain_ms:.4f} ms, no "
            f"library call computes RG-LRU, bound {bound_ms:.5f} ms "
            f"({bound_by}; {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G fp32 "
            f"ops), {row['gb_per_s']:.1f} GB/s, "
            f"{100 * row['share_of_bound']:.2f}% of the bound, kernel-plain "
            f"y max abs err {err:.3e}; the host takes {host:.4f} ms to issue "
            f"a call")
    return rows


# the served paths and their phase labels
PATHS = {"deepseek-7b": "serve", "mamba2-2.7b": "serve-mamba",
         "recurrentgemma-9b": "serve-rg", "gemma-7b": "serve-gemma7b",
         "stablelm-1.6b": "serve-stablelm", "gemma3-1b": "serve-gemma3",
         "internvl2-76b": "serve-internvl",
         "seamless-m4t-large-v2": "serve-seamless",
         "deepseek-moe-16b": "serve-moe", "deepseek-v2-236b": "serve-v2"}
# depth served where the full one does not fit: internvl2-76b's 80 layers
# hold 76 B params; 8 layers are 8.95 B, 35.8 GB in fp32 at init and 17.9
# GB after cast_weights (16 layers would need some 63 GB in fp32 at init).
# deepseek-v2-236b's 60 layers hold 236 B; 4 layers (1 dense + 3 MoE of
# 160 experts) are 13.3 B, 53 GB in fp32 at init, some 61 GB while
# cast_weights holds the stacked experts' wi_gate [3,160,5120,1536] in both
# dtypes, 26.6 GB after (8 layers: 29 B, 117 GB in fp32 at init).
# deepseek-moe-16b runs all 28 (16.4 B: 65.5 GB at init, some 75 GB at
# the cast's peak beside its [27,64,2048,1408] wi_gate in bf16, 32.7 GB
# after)
PATH_LAYERS = {"internvl2-76b": 8, "deepseek-v2-236b": 4}
PATH_PROMPT_LENS = {"recurrentgemma-9b": RG_PROMPT_LENS,
                    "internvl2-76b": VLM_PROMPT_LENS,
                    "seamless-m4t-large-v2": ENCDEC_PROMPT_LENS}
# the kernel each layer's mixer launches once per prefill
KERNEL_OF_MIXER = {"attn": "flash_attention_fwd",
                   "local": "flash_attention_fwd",
                   "mla": "flash_attention_fwd", "ssm": "ssd_scan",
                   "rec": "rglru_scan"}


def make_prompts(cfg):
    import numpy as np
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in PATH_PROMPT_LENS.get(cfg.name, PROMPT_LENS)]


def request_batch(cfg, prompt, seed):
    """One request's batch on the card: the prompt's tokens [1,S], and the
    frontend stub's seeded embeddings, as ``data.pipeline``'s
    ``frontend_stub_batch`` makes them (normal, std 0.02): internvl2-76b's
    ``vision_embeds`` [1,256,D], seamless-m4t's ``frames`` [1,4096,D]."""
    import torch
    batch = {"tokens": torch.as_tensor(prompt, device=DEVICE)[None]}
    if cfg.frontend != "none":
        g = torch.Generator(device=DEVICE).manual_seed(1000 + seed)
        key = "vision_embeds" if cfg.frontend == "vision" else "frames"
        batch[key] = torch.randn((1, cfg.frontend_tokens, cfg.d_model),
                                 generator=g, device=DEVICE) * 0.02
    return batch


def expected_launches(cfg, n_prefills):
    """One launch of each layer's kernel per layer and prefill; an
    encoder-decoder adds one per encoder layer and one per decoder layer's
    cross-attention (seamless-m4t: 24 + 24 + 24 = 72 per prefill)."""
    want = dict.fromkeys(kernel_counts(), 0)
    for mixer in cfg.layer_kinds:
        want[KERNEL_OF_MIXER[mixer]] += n_prefills
    want["flash_attention_fwd"] += n_prefills * (
        cfg.encoder_layers + (cfg.num_layers if cfg.encoder_layers else 0))
    return want


def kernel_counts():
    """Launches counted by each kernel's wrapper since its last reset."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, ssd
    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd": fa.launches_bwd, "ssd_scan": ssd.launches,
            "rglru_scan": rglru.launches}


def bwd_counts():
    """Flash backward calls by route: tensor-core and FMA kernels."""
    from repro_torch.kernels import flash_attention as fa
    return {"tc": fa.launches_bwd_tc, "fma": fa.launches_bwd_fma}


def flash_counts():
    """Flash launches by kernel: tensor-core and FMA."""
    from repro_torch.kernels import flash_attention as fa
    return {"tc": fa.launches_tc, "fma": fa.launches_fma}


def ssd_counts():
    """SSD launches by kernel: tensor-core and FMA."""
    from repro_torch.kernels import ssd
    return {"tc": ssd.launches_tc, "fma": ssd.launches_fma}


def reset_kernel_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, ssd
    fa.launches = fa.launches_tc = fa.launches_fma = fa.launches_bwd = 0
    fa.launches_bwd_tc = fa.launches_bwd_fma = 0
    ssd.launches = ssd.launches_tc = ssd.launches_fma = 0
    rglru.launches = 0


def serve(eng, reqs, timings=None, hand_off=None):
    """Submit in order as slots free up; step until every request is done.
    ``hand_off(eng)`` runs after the third step and returns the engine that
    carries on. ``timings`` collects prefill and decode times and the
    kernel launches made inside decode steps."""
    import torch
    pending = list(reqs)
    while pending or any(eng.active):
        while pending:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not eng.submit(pending[0]):
                break
            torch.cuda.synchronize()
            if timings is not None:
                timings["prefill"].append(
                    (len(pending[0].prompt), time.perf_counter() - t0))
            pending.pop(0)
        n_active = sum(r is not None for r in eng.active)
        before = sum(kernel_counts().values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if timings is not None:
            timings["decode"].append((n_active, time.perf_counter() - t0))
            timings["decode_launches"] = timings.get("decode_launches", 0) \
                + sum(kernel_counts().values()) - before
        if hand_off is not None and eng.steps == 3:
            eng, hand_off = hand_off(eng), None
    return [list(r.out) for r in reqs]


def build_lm(arch):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import LM
    label = PATHS[arch]
    cfg = get_config(arch)
    if arch in PATH_LAYERS:
        cfg = cfg.replace(num_layers=PATH_LAYERS[arch])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(p.numel() for p in lm.parameters())
    init_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    # the reference casts each fp32 weight matrix to bf16 at every use; one
    # cast at load gives the same numbers and halves the weights' bytes
    lm.cast_weights()
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    peak = torch.cuda.max_memory_allocated()
    depth = (f"{cfg.num_layers} of {get_config(arch).num_layers} layers"
             if arch in PATH_LAYERS else f"{cfg.num_layers} layers")
    if cfg.encoder_layers:
        depth += f" + {cfg.encoder_layers} encoder layers"
    log(f"{label}: {arch} at full width, {depth}, {n_params / 1e9:.3f} B "
        f"params (n_periods={lm.decoder.n_periods}), init+cast "
        f"{time.perf_counter() - t0:.1f} s, weights {init_bytes / 2**30:.2f} "
        f"GiB at init, held in {n_bytes / 2**30:.2f} GiB after the cast "
        f"(matrices bf16, 1-D params and MoE routers fp32); peak allocated "
        f"during init+cast {peak / 2**30:.2f} GiB")
    return lm


def phase_serve(lm):
    """Six (recurrentgemma-9b: seven) requests over four slots. The counts
    are set to 0 just before the run and read just after: each layer's
    kernel launches once per layer and prefill, no other kernel launches,
    and decode launches none."""
    import torch
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = lm.cfg
    label = PATHS[cfg.name]
    prompts = make_prompts(cfg)
    # set-up, not request time: the first products pick their cuBLAS plans
    t0 = time.perf_counter()
    serve(ServingEngine(lm, slots=SLOTS, capacity=256, device=DEVICE),
          [Request(0, prompts[0], max_new=2)])
    log(f"{label}: warm-up (one {len(prompts[0])}-token request, 2 tokens) "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(lm, slots=SLOTS, capacity=CAPACITY, device=DEVICE)
    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    timings = {"prefill": [], "decode": []}
    reset_kernel_counts()
    t0 = time.perf_counter()
    streams = serve(eng, reqs, timings)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    flash = flash_counts()
    ssd_by = ssd_counts()
    peak = torch.cuda.max_memory_allocated()
    assert all(len(s) == MAX_NEW for s in streams), [len(s) for s in streams]
    want = expected_launches(cfg, len(prompts))
    assert launches == want, (launches, want)
    # every served flash launch ran on the tensor cores
    assert flash == {"tc": want["flash_attention_fwd"], "fma": 0}, flash
    # ... and every served SSD launch
    assert ssd_by == {"tc": want["ssd_scan"], "fma": 0}, ssd_by
    assert timings["decode_launches"] == 0, timings["decode_launches"]
    for n, dt in timings["prefill"]:
        log(f"{label}: prefill S={n:5d} {dt * 1e3:.3f} ms")
    dec = timings["decode"]
    dec_s = sum(dt for _, dt in dec)
    dec_tok = sum(n for n, _ in dec)
    log(f"{label}: {len(dec)} decode steps, {dec_s / len(dec) * 1e3:.3f} ms "
        f"per step, {dec_tok / dec_s:.1f} tokens/s decoded; "
        f"{len(prompts)} requests in {wall:.2f} s; peak allocated "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)}, flash "
        f"by kernel {json.dumps(flash)}, SSD by kernel {json.dumps(ssd_by)} "
        f"({timings['decode_launches']} in decode steps)")
    for r in reqs:
        log(f"{label}: request {r.rid} (S={len(r.prompt)}) -> {r.out}")
    summary = dict(
        prefill_ms={str(n): dt * 1e3 for n, dt in timings["prefill"]},
        decode_ms_per_step=dec_s / len(dec) * 1e3, decode_steps=len(dec),
        decode_tokens_per_s=dec_tok / dec_s, wall_s=wall,
        peak_allocated_gib=peak / 2**30, launches=launches,
        flash_launches_by_kernel=flash, ssd_launches_by_kernel=ssd_by)
    return streams, launches, summary


def generate(lm, batch, n_new, timings=None):
    """One request through ``LM.prefill`` and ``n_new - 1`` greedy
    ``LM.decode_step``s (B=1); ``timings`` collects the prefill's and
    each step's time and the kernel launches made inside decode steps."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = lm.prefill(batch, CAPACITY)
    tok = logits.argmax(-1)
    out = [int(tok[0])]
    if timings is not None:
        timings["prefill"].append((batch["tokens"].shape[1],
                                   time.perf_counter() - t0))
    before = sum(kernel_counts().values())
    for _ in range(n_new - 1):
        t0 = time.perf_counter()
        cache, logits = lm.decode_step(cache, tok[:, None])
        tok = logits.argmax(-1)
        out.append(int(tok[0]))
        if timings is not None:
            timings["decode"].append((1, time.perf_counter() - t0))
    if timings is not None:
        timings["decode_launches"] = timings.get("decode_launches", 0) + \
            sum(kernel_counts().values()) - before
    return out


def phase_serve_lm(lm):
    """The multimodal paths (internvl2-76b, seamless-m4t) through
    ``LM.prefill`` and ``LM.decode_step``, as tests/test_archs.py drives
    them: the engine takes tokens alone, as the reference's does. Each
    request alone (B=1): its text prompt with the frontend stub's seeded
    embeddings, MAX_NEW greedy tokens. The counts are set to 0 just before
    the run and read just after: the flash kernel launches once per
    attention layer and prefill (seamless-m4t: and once per encoder layer
    and per decoder layer's cross-attention), all on the tensor-core
    kernel, and decode launches none."""
    import torch
    cfg = lm.cfg
    label = PATHS[cfg.name]
    prompts = make_prompts(cfg)
    batches = [request_batch(cfg, p, i) for i, p in enumerate(prompts)]
    # set-up, not request time: the first products pick their cuBLAS plans
    t0 = time.perf_counter()
    generate(lm, batches[0], 2)
    log(f"{label}: warm-up (one {len(prompts[0])}-token request, 2 tokens) "
        f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    timings = {"prefill": [], "decode": []}
    reset_kernel_counts()
    t0 = time.perf_counter()
    streams = [generate(lm, b, MAX_NEW, timings) for b in batches]
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    flash = flash_counts()
    ssd_by = ssd_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, len(prompts))
    assert launches == want, (launches, want)
    assert flash == {"tc": want["flash_attention_fwd"], "fma": 0}, flash
    assert timings["decode_launches"] == 0, timings["decode_launches"]
    ahead = {"vision": f" after {cfg.frontend_tokens} vision embeds",
             "audio": f" over {cfg.frontend_tokens} encoder frames"}.get(
                 cfg.frontend, "")
    for n, dt in timings["prefill"]:
        log(f"{label}: prefill S={n:5d}{ahead} {dt * 1e3:.3f} ms")
    dec = timings["decode"]
    dec_s = sum(dt for _, dt in dec)
    log(f"{label}: {len(dec)} decode steps (B=1), "
        f"{dec_s / len(dec) * 1e3:.3f} ms per step, "
        f"{len(dec) / dec_s:.1f} tokens/s decoded; {len(prompts)} requests "
        f"in {wall:.2f} s; peak allocated {peak / 2**30:.2f} GiB; launches "
        f"{json.dumps(launches)}, flash by kernel {json.dumps(flash)} "
        f"({timings['decode_launches']} in decode steps)")
    for i, (p, out) in enumerate(zip(prompts, streams)):
        assert len(out) == MAX_NEW, out
        log(f"{label}: request {i} (S={len(p)}) -> {out}")
    summary = dict(
        prefill_ms={str(n): dt * 1e3 for n, dt in timings["prefill"]},
        decode_ms_per_step=dec_s / len(dec) * 1e3, decode_steps=len(dec),
        decode_tokens_per_s=len(dec) / dec_s, decode_batch=1, wall_s=wall,
        peak_allocated_gib=peak / 2**30, launches=launches,
        flash_launches_by_kernel=flash, ssd_launches_by_kernel=ssd_by)
    return streams, launches, summary


@contextmanager
def plain_attention_as(fn):
    """Route the port's ``impl="plain"`` attention through ``fn`` for the
    duration of the block (a witness or a control for phase logits)."""
    from repro_torch.kernels import flash_attention as fa
    orig = fa.attention_plain
    fa.attention_plain = lambda q, k, v, **kw: fn(orig, q, k, v, **kw)
    try:
        yield
    finally:
        fa.attention_plain = orig


def _plain_small_chunks(orig, q, k, v, **kw):
    """Witness: the plain code with 64-query, 64-key chunks instead of 512,
    a second correct attention that sums in another order."""
    return orig(q, k, v, chunk_q=64, chunk_k=64, **kw)


def _sdpa_witness(orig, q, k, v, *, causal=True, window=0, softcap=0.0,
                  scale=None):
    """Witness: PyTorch's own attention (SDPA), a correct code that sums on
    the tensor cores and rounds P to bf16, as the tensor-core kernel does.
    Only for what the gated prefills ask: causal with queries as long as
    the keys, or non-causal at any lengths (an encoder, a cross-attention);
    no window that binds (gemma3-1b's 512 does not at its 128-token gate),
    no softcap."""
    import torch.nn.functional as F
    Sq, Sk = q.shape[1], k.shape[1]
    if (causal and Sq != Sk) or 0 < window < Sk or softcap:
        raise ValueError("the SDPA witness takes causal Sq == Sk or "
                         "non-causal calls, no binding window, no softcap")
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, scale=scale,
        enable_gqa=k.shape[2] != q.shape[2]).transpose(1, 2)


def _plain_drops_diagonal(orig, q, k, v, **kw):
    """Control: a causal mask off by one. Query row i >= 1 sees keys
    0..i-1, missing its own key, as a kernel that mis-masks the diagonal
    tile would."""
    import torch
    head = orig(q[:, :1], k[:, :1], v[:, :1], **kw)
    rest = orig(q[:, 1:], k[:, :-1], v[:, :-1], **kw)
    return torch.cat([head, rest], 1)


def _plain_mask_fault(orig, q, k, v, **kw):
    """Control: a mask fault. A causal call takes the off-by-one diagonal
    (``_plain_drops_diagonal``); a non-causal one (an encoder layer, a
    cross-attention) the causal mask all the same, as a kernel that ignored
    the flag would. The off-by-one mask drops one key in 4096 there, too
    weak a fault to lie clearly over the bf16 limit after 2 encoder
    layers."""
    if kw.get("causal", True):
        return _plain_drops_diagonal(orig, q, k, v, **kw)
    return orig(q, k, v, **dict(kw, causal=True))


@contextmanager
def attention_in_bf16():
    """Both attention codes (kernel and plain, witness and control too) run
    on bf16 copies of their q, k, v and hand back q's dtype: in the fp32
    twin this puts the bf16 tensor-core kernel inside an fp32 model."""
    from repro_torch.kernels import flash_attention as fa
    orig = fa.flash_attention, fa.attention_plain

    def cast(fn):
        return lambda q, k, v, **kw: fn(q.bfloat16(), k.bfloat16(),
                                        v.bfloat16(), **kw).to(q.dtype)
    fa.flash_attention, fa.attention_plain = cast(orig[0]), cast(orig[1])
    try:
        yield
    finally:
        fa.flash_attention, fa.attention_plain = orig


def phase_logits(lm):
    """Request 0's prefill through the flash kernel and through the plain
    attention, each beside a witness (the plain code with 64-query, 64-key
    chunks instead of 512, a correct code that sums in another order) and
    a control (the plain code with an off-by-one causal mask, a fault):
    every witness must lie under the limit, the control over it, and the
    kernel under it. The bf16 model's checks add a second witness, SDPA,
    a correct code that sums on the tensor cores as the kernel does. Four
    gates:
      * the served bf16 model's hidden state after its first GATE_LAYERS
        layers, at LOGITS_REL_L2;
      * the served bf16 model's last-logits at LOGITS_REL_L2_BF16_DEPTH:
        30 random-init bf16 layers carry a last-bit flip of an attention
        output to some 0.09-0.1 of the last-logits for a code that sums on
        the tensor cores (SDPA read 0.0956 on an H100), against 0.024 for
        the chunked plain code and 0.35 for the control;
      * an fp32 twin with the same weights (the same seeded draws before
        the bf16 cast), last-logits at LOGITS_REL_L2_FP32: fp32 attention
        runs the FMA kernel;
      * the same fp32 twin with its attention on bf16 copies of q, k, v,
        last-logits at LOGITS_REL_L2: the bf16 tensor-core kernel at full
        depth. The bf16 attention outputs still flip last bits, and 30 fp32
        layers carry the flips of any tensor-core code to some 0.016-0.028
        (SDPA 0.0276), against the witness's 0.0011 and the control's
        0.355, so the limit is the bf16 one."""
    import torch
    from repro_torch.models.model import LM
    cfg = lm.cfg
    p0 = {"tokens": torch.as_tensor(make_prompts(cfg)[0],
                                    device=DEVICE)[None]}

    def logits(model):
        return lambda impl: model.prefill(p0, CAPACITY, impl=impl)[1]
    def checks():
        return (plain_attention_as(_plain_small_chunks),
                plain_attention_as(_plain_drops_diagonal))
    def sdpa():
        return {"sdpa": plain_attention_as(_sdpa_witness)}
    hidden, _, _ = _kernel_witness_control(
        lambda impl: _hidden_after(lm, p0, GATE_LAYERS, impl), *checks(),
        **sdpa())
    bf16, lk, lp = _kernel_witness_control(logits(lm), *checks(), **sdpa())
    assert lk.shape == (1, cfg.padded_vocab)
    lm32 = LM(cfg.replace(dtype="float32"), device=DEVICE,
              generator=torch.Generator(device=DEVICE).manual_seed(0))
    fp32, _, lp32 = _kernel_witness_control(logits(lm32), *checks())
    with attention_in_bf16():
        before = flash_counts()
        fp32_bf16, _, _ = _kernel_witness_control(logits(lm32), *checks())
        after = flash_counts()
    del lm32
    torch.cuda.empty_cache()
    gate = f"bf16_hidden{GATE_LAYERS}"
    gates = ((gate, LOGITS_REL_L2), ("bf16_logits", LOGITS_REL_L2_BF16_DEPTH),
             ("fp32_logits", LOGITS_REL_L2_FP32),
             ("fp32_bf16attn_logits", LOGITS_REL_L2))
    out = {**{f"{gate}_{k}": v for k, v in hidden.items()},
           **{f"bf16_logits_{k}": v for k, v in bf16.items()},
           **{f"fp32_logits_{k}": v for k, v in fp32.items()},
           **{f"fp32_bf16attn_logits_{k}": v for k, v in fp32_bf16.items()},
           **{f"{pre}_limit": limit for pre, limit in gates},
           "bf16_logits_kernel_vs_fp32": _rel(lk, lp32),
           "bf16_logits_plain_vs_fp32": _rel(lp, lp32)}
    log("logits: request 0 prefill, relative L2 " + json.dumps(out))
    _assert_gates(out, gates)
    # the bf16-attention twin went through the tensor-core kernel
    assert after["tc"] - before["tc"] == cfg.num_layers, (before, after)
    return out


@contextmanager
def plain_scan_as(scan, fn):
    """Route the port's ``impl="plain"`` SSD (``scan="ssd"``) or RG-LRU
    (``"rglru"``) through ``fn`` for the duration of the block (a witness
    or a control for phases logits-mamba and logits-rg)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{scan}")
    name = f"{scan}_plain"
    orig = getattr(mod, name)
    setattr(mod, name, lambda *a, **kw: fn(orig, *a, **kw))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _ssd_other_chunks(orig, *a, **kw):
    """Witness: the plain code blocked by 64 rows instead of 256, a second
    correct SSD that sums in another order."""
    return orig(*a, **dict(kw, chunk=64))


def _ssd_drops_carry(orig, x, dt, A_log, B, C, *, D=None, h0=None,
                     chunk=256):
    """Control: the state carried into each 32-row chunk is dropped (no
    inter-chunk C.h_in term), as a kernel that loses its carry would."""
    import torch
    S = x.shape[1]
    ys = [orig(x[:, i:i + 32], dt[:, i:i + 32], A_log, B[:, i:i + 32],
               C[:, i:i + 32], D=D, chunk=32)[0] for i in range(0, S, 32)]
    _, hT = orig(x, dt, A_log, B, C, D=D, h0=h0, chunk=chunk)
    return torch.cat(ys, 1), hT


def _rglru_pieces(orig, x, a_log, gate_a, gate_x, *, c=8.0, h0=None):
    """Witness: the plain RG-LRU in 64-row pieces, each started from the
    previous piece's final state, a second correct scan that combines in
    another order."""
    import torch
    S, h, ys = x.shape[1], h0, []
    for i in range(0, S, 64):
        y, h = orig(x[:, i:i + 64], a_log, gate_a[:, i:i + 64],
                    gate_x[:, i:i + 64], c=c, h0=h)
        ys.append(y)
    return torch.cat(ys, 1), h


def _rglru_drops_carry(orig, x, a_log, gate_a, gate_x, *, c=8.0, h0=None):
    """Control: the state carried into each step is dropped (h_t = b_t), as
    a kernel that loses its carry would. (Dropping it only every 64 rows is
    too weak a fault here: with the reference's init, a = exp(-8
    softplus(1) sigmoid(r)) is about 0.005 in most lanes, so h forgets
    within a few steps.) The final state is the whole scan's."""
    from repro_torch.kernels.rglru import gates
    _, b = gates(x, a_log, gate_a, gate_x, c)
    return b.to(x.dtype), orig(x, a_log, gate_a, gate_x, c=c, h0=h0)[1]


# per scan: (witness, control), both run in place of the plain version
SCAN_CHECKS = {"ssd": (_ssd_other_chunks, _ssd_drops_carry),
               "rglru": (_rglru_pieces, _rglru_drops_carry)}
SCAN_OF_PATH = {"mamba2-2.7b": "ssd", "recurrentgemma-9b": "rglru"}


def _kernel_witness_control(run, as_witness, as_control, **more):
    """``run(impl)`` -> a tensor, through the kernels (``impl=None``) and
    the plain code, then the plain code inside the ``as_witness`` and the
    ``as_control`` context (a second correct code, a fault) and inside
    each further witness context of ``more``. Returns their relative L2
    errors against the plain code's output (``witness_<name>_vs_plain``
    for those of ``more``), and the kernels' and the plain code's
    outputs."""
    k, p = run(None), run("plain")
    assert k.isfinite().all() and k.shape == p.shape
    with as_witness:
        w = run("plain")
    with as_control:
        c = run("plain")
    errs = dict(kernel_vs_plain=_rel(k, p), witness_vs_plain=_rel(w, p),
                control_vs_plain=_rel(c, p))
    for name, ctx in more.items():
        with ctx:
            errs[f"witness_{name}_vs_plain"] = _rel(run("plain"), p)
    return errs, k, p


def _assert_gates(out, gates):
    """For each (prefix, limit): every witness under the limit, the control
    over it, the kernel under it."""
    for pre, limit in gates:
        witnesses = [k for k in out if k.startswith(f"{pre}_witness")]
        assert witnesses, (pre, out)
        for key in witnesses:
            assert out[key] <= limit, (key, out)
        assert out[f"{pre}_control_vs_plain"] > limit, out
        assert out[f"{pre}_kernel_vs_plain"] <= limit, out


def _hidden_after(lm, batch, n_layers, impl, stack="decoder",
                  enc_out=None):
    """The residual stream after the first ``n_layers`` layers of a
    prefill, walking head, stacked core periods and tail in order: of the
    decoder (an encoder-decoder runs its whole encoder first, through
    ``LM._inputs``, unless ``enc_out`` is given), or of the encoder over the
    batch's frames (``stack="encoder"``)."""
    import torch
    from repro_torch.models.model import layer_prefill, params_tree, periods
    st = getattr(lm, stack)
    params = params_tree(st)
    layers = list(zip(st.head_kinds, params["head"]))
    for core in periods(params["core"], st.n_periods):
        layers += list(zip(st.period_kinds, core))
    layers += list(zip(st.tail_kinds, params["tail"]))
    with torch.no_grad():
        if stack == "encoder":
            x = batch["frames"].to(lm.compute_dtype)
        elif enc_out is not None:
            x = lm._embed(batch["tokens"])
        else:
            x, enc_out, _ = lm._inputs(batch, impl)
        ctx = {"positions": lm._positions(*x.shape[:2]), "enc_out": enc_out,
               "impl": impl}
        for k, p in layers[:n_layers]:
            x, _, _ = layer_prefill(lm.cfg, k, p, x, ctx)
    return x


def phase_logits_scan(lm):
    """Request 0's prefill through the kernels and through the plain code,
    for a path whose state carries through a scan (mamba2-2.7b: the SSD;
    recurrentgemma-9b: the RG-LRU, its local layers through the flash
    attention or its plain version alike). Beside them run a witness (the
    plain scan blocked by 64 rows, a correct code) and a control (the
    carried state dropped, between 32-row chunks of the SSD or at every
    step of the RG-LRU, a fault): the witness must lie
    under the limit, the control over it, and the kernels under it. In the
    served bf16 model the gate is the hidden state after its first
    GATE_LAYERS layers at LOGITS_REL_L2, since random-init bf16 layers carry
    any last-bit flip far; its last-logits are reported. In an fp32 twin
    with the same weights (the same seeded draws before the bf16 cast) the
    gate is the last-logits at LOGITS_REL_L2_FP32.

    In the fp32 twin the kernel's final state must also carry: request 1's
    prompt prefilled, then 4 decode steps, gives the next-token logits of
    a forward over all S+4 tokens within a relative L2 error of 1e-3."""
    import torch
    from repro_torch.models.model import LM
    cfg = lm.cfg
    scan = SCAN_OF_PATH[cfg.name]
    label = PATHS[cfg.name].replace("serve", "logits")
    prompts = make_prompts(cfg)
    p0 = {"tokens": torch.as_tensor(prompts[0], device=DEVICE)[None]}

    def logits(model):
        return lambda impl: model.prefill(p0, CAPACITY, impl=impl)[1]

    def checks():
        return tuple(plain_scan_as(scan, fn) for fn in SCAN_CHECKS[scan])
    hidden, _, _ = _kernel_witness_control(
        lambda impl: _hidden_after(lm, p0, GATE_LAYERS, impl), *checks())
    bf16, lk, lp = _kernel_witness_control(logits(lm), *checks())
    assert lk.shape == (1, cfg.padded_vocab)
    lm32 = LM(cfg.replace(dtype="float32"), device=DEVICE,
              generator=torch.Generator(device=DEVICE).manual_seed(0))
    fp32, _, lp32 = _kernel_witness_control(logits(lm32), *checks())
    # the kernel's h_final carries into decode
    rng = torch.Generator().manual_seed(7)
    extra = torch.randint(0, cfg.vocab_size, (1, 4), generator=rng)
    seq = torch.cat([torch.as_tensor(prompts[1])[None].long(), extra], 1) \
        .to(DEVICE)
    S = len(prompts[1])
    cache, _ = lm32.prefill({"tokens": seq[:, :S]}, CAPACITY)
    for t in range(S, S + 4):
        cache, dec = lm32.decode_step(cache, seq[:, t:t + 1])
    with torch.no_grad():
        full, _, _ = lm32({"tokens": seq})
    carry = _rel(dec, full[:, -1])
    del lm32, cache, full
    torch.cuda.empty_cache()
    gate = f"bf16_hidden{GATE_LAYERS}"
    out = {**{f"{gate}_{k}": v for k, v in hidden.items()},
           f"{gate}_limit": LOGITS_REL_L2,
           **{f"bf16_logits_{k}": v for k, v in bf16.items()},
           **{f"fp32_logits_{k}": v for k, v in fp32.items()},
           "fp32_logits_limit": LOGITS_REL_L2_FP32,
           "bf16_logits_kernel_vs_fp32": _rel(lk, lp32),
           "bf16_logits_plain_vs_fp32": _rel(lp, lp32),
           f"fp32_prefill{S}_decode4_vs_forward{S + 4}": carry,
           "carry_limit": CARRY_REL_L2}
    log(f"{label}: request 0 prefill, relative L2 " + json.dumps(out))
    _assert_gates(out, ((gate, LOGITS_REL_L2),
                        ("fp32_logits", LOGITS_REL_L2_FP32)))
    assert carry <= CARRY_REL_L2, out
    return out


# seamless-m4t's gates. Its random-init encoder runs the residual stream
# to an rms of 470 over 24 non-causal layers over 4096 frames, and carries
# any rounding far (tools/seamless_depth_probe.py, on an H100 80GB HBM3 at
# 700 W): two correct fp32 codes (the plain one in 512- and 64-wide chunks)
# differ by 1.1e-2 on its output and by 0.40 on the last-logits; in bf16
# the hidden state after 4 encoder layers reads 0.084 for SDPA (a correct
# code), and after the encoder and 4 decoder layers 0.63 for the chunked
# plain code. The gates sit where correct codes read under the limits: 2
# encoder layers, and 2 decoder layers (fp32: the whole decoder) over one
# encoder output, the plain code's, given to every run; the fp32 encoder
# after 12 of its layers
ENC_GATE_LAYERS, ENC_GATE_LAYERS_FP32, DEC_GATE_LAYERS_ENCDEC = 2, 12, 2
# the MoE paths' gates. Routing is discontinuous: a last-bit difference in
# a layer's output can change a token's top-k experts or push a copy past
# its expert's capacity, which moves that token by a whole expert's share.
# So the bf16 model is gated on its hidden state after layer 0, the dense
# layer before any router, and the first MoE layer's routing is reported:
# the share of (token, expert) assignments and of kept copies that differ
# from the plain path's, for the kernel and for the witnesses. A
# full-depth fp32 twin does not fit the card beside the served bf16 model
# (deepseek-moe-16b: 61 GiB more), so the twin is cut to TWIN_LAYERS
# (its own seeded draws) and gated on its last-logits
HIDDEN_GATE_LAYERS = {"deepseek-moe-16b": 1, "deepseek-v2-236b": 1}
TWIN_LAYERS = {"deepseek-moe-16b": 8, "deepseek-v2-236b": 2}


def _first_moe_routing(lm, batch, impl):
    """The first MoE layer's routing in a prefill of ``batch`` through
    ``impl``: the sets of (token, expert) assignments and of kept
    (token, expert) copies, each pair as ``token * E + expert``."""
    import torch
    from repro_torch.models import moe as MOE
    seen = []
    orig = MOE.moe_apply

    def record(cfg, p, x):
        seen.append((cfg, p, x))
        return orig(cfg, p, x)
    MOE.moe_apply = record
    try:
        _hidden_after(lm, batch, lm.cfg.moe.first_k_dense + 1, impl)
    finally:
        MOE.moe_apply = orig
    cfg, p, x = seen[0]
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    T = x.shape[0] * x.shape[1]
    with torch.no_grad():
        _, _, eidx = MOE.route(cfg, p, x.reshape(T, -1))
        order, keep, _ = MOE.dispatch(eidx, E, MOE._capacity(T, cfg))
    e_flat = eidx.reshape(-1)
    pairs = torch.arange(T * K, device=x.device) // K * E + e_flat
    return set(pairs.tolist()), set(pairs[order[keep]].tolist())


def _routing_shares(lm, batch):
    """The share of the first MoE layer's assignments and kept copies that
    differ from the plain path's (``|A ^ B| / (|A| + |B|)``): through the
    kernel, and through the plain code inside each witness context."""
    from contextlib import nullcontext
    assign, kept = _first_moe_routing(lm, batch, "plain")
    runs = {"kernel": (None, nullcontext()),
            "witness": ("plain", plain_attention_as(_plain_small_chunks)),
            "witness_sdpa": ("plain", plain_attention_as(_sdpa_witness))}
    out = {"moe1_assignments": len(assign), "moe1_kept": len(kept)}
    for name, (impl, ctx) in runs.items():
        with ctx:
            a, k = _first_moe_routing(lm, batch, impl)
        out[f"moe1_{name}_assign_diff_share"] = len(a ^ assign) / (
            len(a) + len(assign))
        out[f"moe1_{name}_kept_diff_share"] = len(k ^ kept) / (
            len(k) + len(kept))
    return out


def phase_logits_attn(lm):
    """The later attention-only paths (gemma-7b, stablelm-1.6b, gemma3-1b,
    internvl2-76b, seamless-m4t): request 0's prefill, with its frontend
    embeddings, through the flash kernel and through the plain attention,
    beside witnesses (the plain code in 64-wide chunks; SDPA, a correct
    code on the tensor cores, in bf16) and a control (``_plain_mask_fault``:
    the off-by-one causal mask, or the causal mask on a non-causal call).
    Each gate has every witness under its limit, the control over it, the
    kernel under it, and counts the kernel run's flash launches (bf16 on
    the tensor-core kernel, fp32 on the FMA one):
      * decoder-only paths: the served bf16 model's hidden state after its
        first GATE_LAYERS layers (the MoE paths: HIDDEN_GATE_LAYERS, the
        dense layer, with the first MoE layer's routing shares logged) at
        LOGITS_REL_L2; an fp32 twin with the same weights (the same seeded
        draws before the bf16 cast; the MoE paths: a twin of TWIN_LAYERS
        layers), last-logits at LOGITS_REL_L2_FP32;
      * seamless-m4t: the bf16 hidden state after ENC_GATE_LAYERS encoder
        layers and after DEC_GATE_LAYERS_ENCDEC decoder layers over one
        encoder output, at LOGITS_REL_L2; the fp32 twin's after
        ENC_GATE_LAYERS_FP32 encoder layers, and its last-logits over one
        encoder output, at LOGITS_REL_L2_FP32.
    The bf16 model's last-logits through the whole model are reported."""
    import torch
    from repro_torch.models.model import LM
    cfg = lm.cfg
    label = PATHS[cfg.name].replace("serve", "logits")
    p0 = request_batch(cfg, make_prompts(cfg)[0], 0)
    out = {}

    gates = []

    def gate(name, run, n_launches, limit, sdpa):
        more = {"sdpa": plain_attention_as(_sdpa_witness)} if sdpa else {}
        before = flash_counts()
        errs, k, p = _kernel_witness_control(
            run, plain_attention_as(_plain_small_chunks),
            plain_attention_as(_plain_mask_fault), **more)
        ran = {r: flash_counts()[r] - before[r] for r in before}
        route = "tc" if sdpa else "fma"
        out.update({f"{name}_{e}": v for e, v in errs.items()})
        out[f"{name}_flash_launches_by_kernel"] = ran
        if limit is not None:
            out[f"{name}_limit"] = limit
            gates.append((name, limit))
            assert ran == {"tc": 0, "fma": 0, route: n_launches}, (name, ran)
        return k, p

    def last_logits(model, enc=None):
        if enc is None:
            return lambda impl: model.prefill(p0, CAPACITY, impl=impl)[1]
        return lambda impl: model._logits(_hidden_after(
            model, p0, model.cfg.num_layers, impl, enc_out=enc)[:, -1:])[:, 0]

    encdec = cfg.encoder_layers > 0
    if encdec:
        enc = lm._inputs(p0, "plain")[1]
        gate(f"bf16_enc{ENC_GATE_LAYERS}", lambda impl: _hidden_after(
            lm, p0, ENC_GATE_LAYERS, impl, stack="encoder"),
            ENC_GATE_LAYERS, LOGITS_REL_L2, True)
        n = DEC_GATE_LAYERS_ENCDEC
        gate(f"bf16_dec{n}_shared_enc", lambda impl: _hidden_after(
            lm, p0, n, impl, enc_out=enc), 2 * n, LOGITS_REL_L2, True)
        del enc
    else:
        n = HIDDEN_GATE_LAYERS.get(cfg.name, GATE_LAYERS)
        gate(f"bf16_hidden{n}", lambda impl: _hidden_after(lm, p0, n, impl),
             n, LOGITS_REL_L2, True)
    lk, lp = gate("bf16_logits", last_logits(lm), None, None, True)
    assert lk.shape == (1, cfg.padded_vocab)
    if cfg.moe is not None:
        out.update(_routing_shares(lm, p0))
    twin = cfg.replace(dtype="float32",
                       num_layers=TWIN_LAYERS.get(cfg.name, cfg.num_layers))
    out["fp32_twin_layers"] = twin.num_layers
    lm32 = LM(twin, device=DEVICE,
              generator=torch.Generator(device=DEVICE).manual_seed(0))
    if encdec:
        n = min(ENC_GATE_LAYERS_FP32, cfg.encoder_layers)
        gate(f"fp32_enc{n}", lambda impl: _hidden_after(
            lm32, p0, n, impl, stack="encoder"), n, LOGITS_REL_L2_FP32,
            False)
        enc = lm32._inputs(p0, "plain")[1]
        _, lp32 = gate("fp32_logits_shared_enc", last_logits(lm32, enc),
                       2 * cfg.num_layers, LOGITS_REL_L2_FP32, False)
        del enc
    else:
        _, lp32 = gate("fp32_logits", last_logits(lm32), twin.num_layers,
                       LOGITS_REL_L2_FP32, False)
    del lm32
    gc.collect()
    torch.cuda.empty_cache()
    if twin.num_layers == cfg.num_layers:       # the same weights
        out["bf16_logits_kernel_vs_fp32"] = _rel(lk, lp32)
        out["bf16_logits_plain_vs_fp32"] = _rel(lp, lp32)
    log(f"{label}: request 0 prefill, relative L2 " + json.dumps(out))
    _assert_gates(out, gates)
    return out


# training: deepseek-7b at full width and cut depth (fp32 params, grads, m
# and v take 16 B/param: 30 layers need 103 GiB, 12 layers 48.7 GiB)
TRAIN_ARCH, TRAIN_LABEL = "deepseek-7b", "train-deepseek"
TRAIN_LAYERS = 12
TRAIN_TWIN_LAYERS = 2          # the fp32 twin
TRAIN_S = 2048
TRAIN_STEPS = 3
TRAIN_PEAK_GIB = 75            # above it, the depth is too large for the card
TRAIN_REL = 1e-2               # step 1, kernel vs plain: loss and grad_norm
# step-1 gradients, kernel vs plain, relative L2: wq/wk/wv of layer 0
# ("l0") and of the last layer ("last"), and the head. Each limit lies
# between the witnesses (correct codes) and the controls (faults). A leaf
# names its path and its index into a stacked leaf (None: not stacked)
GRAD_LEAVES = {f"{at}.{w}": (f"decoder.core.0.mixer.{w}", i)
               for at, i in (("l0", 0), ("last", -1))
               for w in ("wq", "wk", "wv")}
GRAD_LEAVES["head"] = ("head", None)
# fp32 twin: every leaf. wq and wk get their gradient only through the
# softmax's ds = p (dp - delta), which cancels: two correct fp32 codes (the
# plain code in 512- and 64-row chunks) differ by up to 6.8e-4 there at
# full width and S=2048 on an H100, so 1e-4 would refuse a correct kernel;
# the controls read 0.135 and more
GRAD_REL_L2_FP32 = 5e-3
# bf16 model, 12 layers: only the head is gated. In bf16 that cancellation
# leaves no digit of wq's and wk's gradients: SDPA, a correct code, reads
# 1.28-1.34 on them, as far as the off-by-one control (1.32-1.37); the
# gradients of layer 0 and the last layer are reported
GRAD_REL_L2_BF16 = 0.1
BF16_GATED = ("head",)
# bf16 grad_norm: the witnesses read 0.033 (plain code, 64-row chunks),
# 0.00094 (the plain flash VJP) and 0.038 (SDPA), the off-by-one control
# 0.077; against the fp32 code's, the correct codes 0.0072-0.046, the
# control 0.084 (on an H100)
GRAD_NORM_REL_BF16 = 0.05
# the MoE paths: layer 0 is dense (attention, or MLA, and a dense MLP).
# deepseek-moe-16b's first MoE layer is the stacked core's period 0 at 5
# layers, the unstacked tail's layer 0 in the 2-layer twin
MOE_GRAD_LEAVES = {"l0.wq": ("decoder.head.0.mixer.wq", None),
                   "l0.wk": ("decoder.head.0.mixer.wk", None),
                   "moe.router": ("decoder.core.0.mlp.router", 0),
                   "moe.e0.wi_gate": ("decoder.core.0.mlp.wi_gate", (0, 0)),
                   "head": ("head", None)}
MOE_TWIN_LEAVES = dict(MOE_GRAD_LEAVES,
                       **{"moe.router": ("decoder.tail.0.mlp.router", None),
                          "moe.e0.wi_gate": ("decoder.tail.0.mlp.wi_gate",
                                             0)})
MLA_GRAD_LEAVES = {f"l0.{w}": (f"decoder.head.0.mixer.{w}", None)
                   for w in ("wq_a", "wq_b", "wkv_a", "wkv_b")}
MLA_GRAD_LEAVES["head"] = ("head", None)
# leaves whose gradient comes only through ds (q, and k alone): the
# dropped-delta control gates them, the off-by-one mask the rest
DS_ONLY = (".wq", ".wk", ".wq_a", ".wq_b")
# grad_norm of the MoE paths' fp32 twins and of deepseek-v2's bf16 layer 0:
# the off-by-one mask moves it by 5.5e-5 (v2's twin) to 1.2e-3 (moe-16b's)
# only, the dropped delta by 6.07e-3 and 1.70e-2; the witnesses read 0 to
# 2.4e-5. v2's bf16 layer 0 against the fp32 code's: the correct codes
# 5.4e-4 to 5.7e-4, the dropped delta 5.5e-3 (on an H100)
MOE_NORM_REL = 1e-3
# deepseek-v2's bf16 layer 0, every leaf: the witnesses read at most 8.3e-3
# (SDPA, wkv_a), the controls at least 7.4e-2 (the off-by-one mask, wq_a)
MLA_GRAD_REL_L2_BF16 = 3e-2
# deepseek-moe-16b's bf16 model at 5 layers, routing pinned to the plain
# run's (``pinned_routing``): its random-init MoE layers carry the
# roundings further than deepseek-7b's 12 (grad_norm 1392 against 608).
# The head: SDPA, a correct tensor-core code, reads 0.376 (the chunked
# plain code 0.144), the off-by-one control 1.01. grad_norm is layer 0's
# and the embedding's (all of the fp32 squared norm), each leaf of them
# scaled by one factor a code: the witnesses read 0.036, 0.00047 (the
# plain flash VJP) and 0.128, the control 0.49; against the fp32 code's,
# the correct codes 0.065-0.153 (the kernel the most), the control 0.589
# (on an H100)
MOE_GRAD_REL_L2_BF16 = 0.6
MOE_GRAD_NORM_REL_BF16 = 0.3
# the train paths, run in this order: arch, depth, the fp32 twin's depth
# (routing is discontinuous, so the MoE twins are cut to their first MoE
# layer), the gradient leaves of the model and of the twin (the same
# labels), the limits of the twin's grad_norm, the bf16 model's gated
# leaves and its limits
TRAIN_PATHS = {
    "train": dict(arch=TRAIN_ARCH, label=TRAIN_LABEL, layers=TRAIN_LAYERS,
                  twin_layers=TRAIN_TWIN_LAYERS, leaves=GRAD_LEAVES,
                  twin_leaves=GRAD_LEAVES,
                  twin_norm=(TRAIN_REL, "drops_diagonal"),
                  bf16_gated=BF16_GATED, grad_bf16=GRAD_REL_L2_BF16,
                  bf16_norm=(GRAD_NORM_REL_BF16, "drops_diagonal")),
    # deepseek-moe-16b: 5 layers (1 dense + 4 MoE), 2.855 B params, 42.5
    # GiB at 16 B/param; 6 layers would take 51.3 GiB before activations
    "train-moe": dict(arch="deepseek-moe-16b", label="train-moe", layers=5,
                      twin_layers=2, leaves=MOE_GRAD_LEAVES,
                      twin_leaves=MOE_TWIN_LEAVES,
                      twin_norm=(MOE_NORM_REL, "drops_delta"),
                      bf16_gated=BF16_GATED, grad_bf16=MOE_GRAD_REL_L2_BF16,
                      bf16_norm=(MOE_GRAD_NORM_REL_BF16, "drops_diagonal")),
    # deepseek-v2-236b: its dense layer 0 alone (MLA and a 12288-wide MLP),
    # 1.387 B params, 20.7 GiB; with its first MoE layer 5.359 B, 79.9 GiB
    "train-mla": dict(arch="deepseek-v2-236b", label="train-mla", layers=1,
                      twin_layers=1, leaves=MLA_GRAD_LEAVES,
                      twin_leaves=MLA_GRAD_LEAVES,
                      twin_norm=(MOE_NORM_REL, "drops_delta"),
                      bf16_gated=tuple(MLA_GRAD_LEAVES),
                      grad_bf16=MLA_GRAD_REL_L2_BF16,
                      bf16_norm=(MOE_NORM_REL, "drops_delta")),
}


def _plain_vjp(q, k, v, kw, keep_delta):
    """The plain forward and the plain flash backward
    (``attention_bwd_plain``), which takes delta = rowsum(do o) from the
    rounded output o, as the reference's ``_flash_bwd`` and both
    tensor-core backwards do; without ``keep_delta`` it gets o = 0, so
    delta drops out of ds = p (dp - delta)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    class PlainVJP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = fa.attention_fwd_lse_plain(q, k, v, **kw)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return fa.attention_bwd_plain(
                q, k, v, o if keep_delta else torch.zeros_like(do), lse, do,
                **kw)
    return PlainVJP.apply(q, k, v)


def _plain_flash_vjp(orig, q, k, v, **kw):
    """Witness: the reference's flash VJP in plain code, delta from the
    rounded output (autograd through the plain forward sums p dp in
    fp32 instead)."""
    return _plain_vjp(q, k, v, kw, keep_delta=True)


def _plain_drops_delta(orig, q, k, v, **kw):
    """Control: the plain forward with a backward that drops delta =
    rowsum(do o) from ds = p (dp - delta), as a backward kernel that lost
    that term would (dv is untouched)."""
    return _plain_vjp(q, k, v, kw, keep_delta=False)


def _step1_grads(lm, batch, impl, leaves):
    """Loss, global gradient norm, the gradients of ``leaves`` (label ->
    path and index into a stacked leaf; a path the model lacks raises) and
    every parameter's squared gradient norm (a stacked core leaf's by
    period, ``path[i]``) of one forward and backward; the gradients are
    dropped after."""
    import torch
    for p in lm.parameters():
        p.grad = None
    loss, _ = lm.loss(batch, impl=impl)
    loss.backward()
    params = dict(lm.named_parameters())
    sq = {}
    for n, p in params.items():
        g = p.grad.float()
        if n.startswith("decoder.core."):
            sq.update((f"{n}[{i}]", s) for i, s in
                      enumerate(g.square().flatten(1).sum(1).tolist()))
        else:
            sq[n] = g.square().sum().item()
    picked = {}
    for label, (path, i) in leaves.items():
        if path not in params:
            raise KeyError(f"leaf {label}: the model has no {path}")
        g = params[path].grad
        picked[label] = (g if i is None else g[i]).detach().clone()
    for p in lm.parameters():
        p.grad = None
    return loss.item(), math.sqrt(sum(sq.values())), picked, sq


@contextmanager
def pinned_routing(record):
    """The MoE layers' expert choices recorded, or replayed. While
    ``record`` (a list) is empty, each ``moe.route`` call appends its
    ``eidx``; else each call takes the next recorded one (in call order:
    the forward's layers, then their recompute under remat) and its gates
    at those experts from its own probabilities, renormalised as
    ``route`` does, so the router's gradient still flows. Every recorded
    choice must be taken once."""
    import torch
    from repro_torch.models import moe as MOE
    orig, replay = MOE.route, bool(record)
    todo = list(record)

    def route(cfg, p, xf):
        probs, gates, eidx = orig(cfg, p, xf)
        if not replay:
            record.append(eidx)
            return probs, gates, eidx
        eidx = todo.pop(0)
        top = torch.gather(probs, 1, eidx)
        return probs, top / torch.clamp_min(top.sum(-1, keepdim=True),
                                            1e-9), eidx
    MOE.route = route
    try:
        yield
    finally:
        MOE.route = orig
    assert not todo, f"{len(todo)} recorded routings not replayed"


def _train_gate(lm, batch, leaves):
    """Step 1 through the kernels (``impl=None``) and through the plain
    code, beside witnesses (the plain code in 64-row chunks; the plain
    flash VJP, delta from the rounded output; SDPA in bf16) and controls
    (a backward that drops delta; an off-by-one causal mask): relative
    errors of loss, grad_norm and each leaf's gradient against the plain
    code's. A model with MoE layers replays the plain run's routing in
    every other run (``pinned_routing``): routing is discontinuous, and in
    bf16 a correct attention code otherwise moves copies to other experts,
    which moves the gradients as far as a fault does (PERF.md). The bf16
    model also runs the plain code in fp32 compute on the same weights and
    routing; each run's grad_norm (gated) and leaves (read) are held
    against that too (``fp32_*``), and where the squared norm lies by
    leaf (``_norm_by_leaf``): how far bf16 carries every code, the plain
    one included, from the fp32 gradient."""
    moe = lm.cfg.moe
    has_moe = moe is not None and lm.cfg.num_layers > moe.first_k_dense
    record = []

    def pin():
        return pinned_routing(record) if has_moe else nullcontext()

    with pin():
        ref_loss, ref_gn, ref, ref_sq = _step1_grads(lm, batch, "plain",
                                                     leaves)
    runs = {"kernel": None,
            "witness_chunks": plain_attention_as(_plain_small_chunks),
            "witness_flash_vjp": plain_attention_as(_plain_flash_vjp),
            "control_drops_delta": plain_attention_as(_plain_drops_delta),
            "control_drops_diagonal": plain_attention_as(
                _plain_drops_diagonal)}
    out = {"plain_loss": ref_loss, "plain_grad_norm": ref_gn,
           "routings_pinned": len(record)}
    f32, sqs = None, {"plain": ref_sq}
    if lm.compute_dtype != lm.param_dtype:         # the bf16 model
        runs["witness_sdpa"] = plain_attention_as(_sdpa_witness)
        dt, lm.compute_dtype = lm.compute_dtype, lm.param_dtype
        try:
            with pin():
                _, f32_gn, f32, f32_sq = _step1_grads(lm, batch, "plain",
                                                      leaves)
        finally:
            lm.compute_dtype = dt
        out["fp32_grad_norm"] = f32_gn
        out["fp32_plain_grad_norm_rel"] = abs(ref_gn - f32_gn) / f32_gn
        for n in leaves:
            out[f"fp32_plain_{n}_rel_l2"] = _rel(ref[n], f32[n])
    for run, ctx in runs.items():
        with ctx or nullcontext(), pin():
            loss, gn, got, sq = _step1_grads(
                lm, batch, None if ctx is None else "plain", leaves)
        sqs[run] = sq
        out[f"{run}_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        out[f"{run}_grad_norm_rel"] = abs(gn - ref_gn) / ref_gn
        for n in leaves:
            out[f"{run}_{n}_rel_l2"] = _rel(got[n], ref[n])
        if f32 is not None:
            out[f"fp32_{run}_grad_norm_rel"] = abs(gn - f32_gn) / f32_gn
            for n in leaves:
                out[f"fp32_{run}_{n}_rel_l2"] = _rel(got[n], f32[n])
        if run == "kernel":
            out["kernel_loss"], out["kernel_grad_norm"] = loss, gn
    if f32 is not None:
        out["fp32_norm_by_leaf"] = _norm_by_leaf(f32_sq, sqs)
    return out


def _norm_by_leaf(f32_sq, sqs):
    """Where each run's squared gradient norm departs from the fp32
    code's: the leaves (a stacked leaf by period) that carry at least 1% of
    the fp32 squared norm, or whose squared norm some run moves by that
    much (a correct code: the controls' are reported, not chosen by),
    each with its share of the fp32 squared norm and each run's norm of
    that leaf over the fp32 code's."""
    tot = sum(f32_sq.values())
    keep = [n for n in f32_sq if f32_sq[n] >= 0.01 * tot or any(
        abs(sq[n] - f32_sq[n]) >= 0.01 * tot for run, sq in sqs.items()
        if not run.startswith("control"))]
    keep.sort(key=lambda n: -f32_sq[n])
    return {n: {"fp32_share": f32_sq[n] / tot,
                **{run: math.sqrt(sq[n] / f32_sq[n]) if f32_sq[n] else None
                   for run, sq in sqs.items()}} for n in keep}


def _assert_train_gate(out, grad_limit, norm, leaves):
    """The kernel's loss within TRAIN_REL of the plain code's. For the
    grad_norm (at ``norm = (limit, control)``) and each leaf of ``leaves``
    (at ``grad_limit``): every witness under the limit, the control over
    it, the kernel under it; the bf16 model's grad_norm likewise against
    the fp32 code's (``fp32_*``). A leaf's control is the dropped delta
    when its gradient comes only through ds (``DS_ONLY``: q's projections,
    k's alone), the off-by-one mask for the rest (delta does not reach the
    head, nor a v projection)."""
    assert out["kernel_loss_rel"] <= TRAIN_REL, out
    checks = [("grad_norm_rel", *norm)] + [
        (f"{n}_rel_l2", grad_limit,
         "drops_delta" if n.endswith(DS_ONLY) else "drops_diagonal")
        for n in leaves]
    for suffix, limit, control in checks:
        for key in out:
            if key.startswith("witness") and key.endswith(suffix):
                assert out[key] <= limit, (key, limit, out)
        assert out[f"control_{control}_{suffix}"] > limit, (suffix, out)
        assert out[f"kernel_{suffix}"] <= limit, (suffix, limit, out)
    if "fp32_grad_norm" in out:
        # the bf16 model's grad_norm against the fp32 code's, at the same
        # limit: every correct bf16 code under it (the plain one too), the
        # control over it
        limit, control = norm
        for key, val in out.items():
            if key.startswith("fp32_") and key.endswith("_grad_norm_rel") \
                    and not key.startswith("fp32_control_"):
                assert val <= limit, (key, limit, out)
        assert out[f"fp32_control_{control}_grad_norm_rel"] > limit, out


def _train_lm(layers, dtype, arch=TRAIN_ARCH):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import LM
    cfg = get_config(arch).replace(num_layers=layers, dtype=dtype)
    lm = LM(cfg, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(0))
    g = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_S), generator=g,
                           device=DEVICE)
    return lm, {"tokens": tokens}


DIGEST_CHUNK = 1 << 24
# two odd 64-bit multipliers (as signed int64) of the digests' weights
_DIGEST_MULS = (-7046029254386353131, 0x2545F4914F6CDD1D)


def digest(t):
    """Two 64-bit digests of a tensor's bits: the sums, mod 2^64, of each
    word of its storage (32-bit, or 16-bit for a 2-byte dtype) times one of
    two odd weights of its position. One changed word always changes both
    (an odd weight times a nonzero difference under 2^33 is not 0 mod
    2^64); several changed words leave them unchanged only if their
    weighted differences cancel in both. Held on the card, chunk by chunk,
    so a full-width train state needs no second copy."""
    import torch
    flat = t.detach().reshape(-1)
    words = flat.view(torch.int32 if flat.element_size() == 4
                      else torch.int16)
    acc = torch.zeros(2, dtype=torch.int64, device=t.device)
    for s0 in range(0, words.numel(), DIGEST_CHUNK):
        w = words[s0:s0 + DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(s0 + 1, s0 + 1 + w.numel(), dtype=torch.int64,
                           device=t.device)
        for j, mul in enumerate(_DIGEST_MULS):
            acc[j] += torch.sum(w * ((pos * mul) | 1))
    return tuple(acc.tolist())


def state_digests(state):
    """Digests of every leaf of a train state's params, m and v, and its
    step."""
    out = {"step": int(state["step"])}
    for part in ("params", "m", "v"):
        out.update({f"{part}.{n}": digest(t) for n, t in state[part].items()})
    return out


def _digest_control(state):
    """Control: one bit of one word of the smallest parameter flipped in a
    copy changes its digest."""
    import torch
    t = min(state["params"].values(), key=lambda x: x.numel()).detach()
    bad = t.clone()
    bad.view(-1).view(torch.int32)[0] ^= 1
    return digest(bad) != digest(t)


def phase_train(name="train"):
    """One train path of ``TRAIN_PATHS``: its arch at full width and cut
    depth, fp32 params, bf16 compute, full remat; B=1, S=2048 seeded
    tokens (``train``: deepseek-7b at 12 layers; ``train-moe``:
    deepseek-moe-16b at 5, the flash kernels at head dim 128; ``train-mla``:
    deepseek-v2-236b's dense layer 0, MLA through the flash kernels at head
    dim 192 with v zero-padded from 128).
      * Step-1 gate: the kernel path against ``impl="plain"`` from the same
        initial weights (gradients only, so the weights need no restore),
        beside witnesses (the plain code in 64-row chunks, the plain flash
        VJP, SDPA) and controls (a backward that drops delta; an
        off-by-one causal mask):
        the loss within TRAIN_REL, grad_norm and the gated leaves' gradients
        (the head; every leaf of deepseek-v2's layer 0) at the path's bf16
        limits, each limit between the witnesses and the control; the
        other leaves' gradients are reported. The MoE layers replay the
        plain run's routing (``pinned_routing``). Every run is also read
        against the plain code in fp32 compute on the same weights.
      * An fp32 twin (FMA forward and the FMA backward kernels) at the
        path's twin depth: the loss within TRAIN_REL, grad_norm at the
        path's twin limit, and every leaf of the path (q/k(/v)
        projections, MLA's low-rank ones, for deepseek-moe-16b the first
        MoE layer's router and expert 0's ``wi_gate``, the head) at
        GRAD_REL_L2_FP32. Each gate's kernel run is counted by backward
        route: the twin's on ``fma``, the bf16 model's on ``tc``.
      * TRAIN_STEPS AdamW steps on the same batch through
        ``make_train_step``: the loss falls (the loss of a second seeded
        batch, not trained on, is read before and after); the counts, set
        to 0 just
        before, read 2 x layers forward launches per step (remat runs each
        layer's forward twice), all on the tensor-core kernel, and layers
        backward launches, all on the tensor-core route; ms per step (CUDA
        events), tokens/s and the peak allocated memory, which must stay
        under TRAIN_PEAK_GIB; then a fourth step under ``torch.profiler``
        (device time by kernel, the device's idle share).
      * Two steps from one state, bit for bit. The digests (``digest``) of
        every leaf of params, m and v after the first step are kept; the
        LM is then rebuilt from its seed (its initial state's digests equal
        the first build's) and steps once more: every digest must equal
        the first step's. A control flips one bit of a copy. (A copy of
        the state kept on the card would not fit beside deepseek-moe-16b's
        step; one in host memory would take some 15 s each way.)"""
    import torch
    from repro_torch.optim import adamw
    spec = TRAIN_PATHS[name]
    arch, layers, leaves = spec["arch"], spec["layers"], spec["leaves"]
    out = {"arch": arch, "layers": layers, "seq": TRAIN_S, "batch": 1}

    lm, batch = _train_lm(spec["twin_layers"], "float32", arch)
    reset_kernel_counts()
    twin = _train_gate(lm, batch, spec["twin_leaves"])
    twin_bwd = bwd_counts()
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name}: fp32 twin ({spec['twin_layers']} layers) step 1, relative "
        f"to the plain path {json.dumps(twin)}")

    lm, batch = _train_lm(layers, "bfloat16", arch)
    n_params = sum(p.numel() for p in lm.parameters())
    reset_kernel_counts()
    gate = _train_gate(lm, batch, leaves)
    gate_bwd = bwd_counts()
    log(f"{name}: {arch} at full width, {layers} layers, "
        f"{n_params / 1e9:.3f} B params; bf16 step 1, relative to the plain "
        f"path {json.dumps(gate)}")

    # a second seeded batch, never trained on: its loss before the steps
    # and after them tells learning from memorising the one batch
    g = torch.Generator(device=DEVICE).manual_seed(2)
    unseen = {"tokens": torch.randint(0, lm.cfg.vocab_size, (1, TRAIN_S),
                                      generator=g, device=DEVICE)}

    def unseen_loss():
        with torch.no_grad():
            return lm.loss(unseen)[0].item()
    unseen_losses = [unseen_loss()]
    cfg = adamw.OptConfig(lr=3e-4, warmup_steps=0, total_steps=100)
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, cfg)
    digests = [state_digests(state)]     # the initial state, after step 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        state, met = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        steps.append(dict(step=int(state["step"]), loss=met["loss"].item(),
                          grad_norm=met["grad_norm"].item(),
                          aux=met["aux"].item(),
                          lr=met["lr"].item(), ms=e0.elapsed_time(e1),
                          host_ms=(time.perf_counter() - h0) * 1e3))
        log(f"{name}: step {steps[-1]['step']}: loss "
            f"{steps[-1]['loss']:.6f} (aux {steps[-1]['aux']:.6f}), "
            f"grad_norm {steps[-1]['grad_norm']:.6f}, lr "
            f"{steps[-1]['lr']:.3e}, {steps[-1]['ms']:.3f} ms (CUDA events; "
            f"host clock {steps[-1]['host_ms']:.3f} ms)")
        if i == 0:                      # outside the timed steps
            digests.append(state_digests(state))
    launches = kernel_counts()
    flash = flash_counts()
    flash_bwd = bwd_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    unseen_losses.append(unseen_loss())    # after the counts are read
    log(f"{name}: loss on a second seeded batch, not trained on: "
        f"{unseen_losses[0]:.6f} before the steps, {unseen_losses[1]:.6f} "
        f"after {TRAIN_STEPS}")
    # one more step under the profiler, after the counts are read
    prof = log_profile(f"{name}: profiled step 4", profiled(
        lambda: step(state, batch), top_n=12))
    want_fwd = TRAIN_STEPS * 2 * layers
    want_bwd = TRAIN_STEPS * layers
    ms = [r["ms"] for r in steps[1:]]
    out.update(n_params=n_params, steps=steps, launches=launches,
               flash_launches_by_kernel=flash,
               flash_bwd_launches_by_route=flash_bwd,
               gate_bwd_launches_by_route={"twin_fp32": twin_bwd,
                                           "bf16": gate_bwd},
               peak_allocated_gib=peak,
               ms_per_step=sum(ms) / len(ms),
               tokens_per_s=TRAIN_S / (sum(ms) / len(ms) / 1e3),
               unseen_batch_loss=unseen_losses,
               gate=gate, twin=twin, twin_layers=spec["twin_layers"],
               profile=prof)
    log(f"{name}: {TRAIN_STEPS} steps, {out['ms_per_step']:.3f} ms per step "
        f"after the first (CUDA events), {out['tokens_per_s']:.1f} tokens/s; "
        f"peak allocated {peak:.2f} GiB; launches {json.dumps(launches)}, "
        f"flash forward by kernel {json.dumps(flash)}, backward by route "
        f"{json.dumps(flash_bwd)} (want {want_fwd} forward, {want_bwd} "
        f"backward); the gates' backward by route: fp32 twin "
        f"{json.dumps(twin_bwd)}, bf16 {json.dumps(gate_bwd)}")
    control = _digest_control(state)
    del state, step, lm
    gc.collect()
    torch.cuda.empty_cache()
    lm, _ = _train_lm(layers, "bfloat16", arch)
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, cfg)
    initial = state_digests(state)
    state, _ = step(state, batch)
    again = state_digests(state)
    differ = [k for k, d in again.items() if digests[1][k] != d]
    bit_equal = dict(leaves=len(again) - 1,
                     initial_equal=initial == digests[0],
                     differing=differ[:10], n_differing=len(differ),
                     control_caught=control)
    out["two_steps_from_one_state"] = bit_equal
    log(f"{name}: two steps from one state (the seeded initial state, "
        f"built twice): {json.dumps(bit_equal)}")
    del state, step, lm
    gc.collect()
    torch.cuda.empty_cache()
    assert steps[-1]["loss"] < steps[0]["loss"], steps
    assert all(torch.isfinite(torch.tensor(r["loss"])) for r in steps)
    assert launches["flash_attention_fwd"] == want_fwd, launches
    assert flash == {"tc": want_fwd, "fma": 0}, flash
    assert launches["flash_attention_bwd"] == want_bwd, launches
    assert flash_bwd == {"tc": want_bwd, "fma": 0}, flash_bwd
    assert twin_bwd == {"tc": 0, "fma": spec["twin_layers"]}, twin_bwd
    assert gate_bwd == {"tc": layers, "fma": 0}, gate_bwd
    assert launches["ssd_scan"] == launches["rglru_scan"] == 0, launches
    assert peak <= TRAIN_PEAK_GIB, peak
    assert bit_equal["initial_equal"] and bit_equal["control_caught"] \
        and not bit_equal["n_differing"], bit_equal
    _assert_train_gate(twin, GRAD_REL_L2_FP32, spec["twin_norm"], leaves)
    _assert_train_gate(gate, spec["grad_bf16"], spec["bf16_norm"],
                       spec["bf16_gated"])
    return out


# checkpoint: deepseek-7b at full width and the fp32 twin's depth. Its
# {step, params, m, v} takes 12 B/param: 14.92 GB at 2 layers, 39.2 GB at
# 12, which the save holds in host memory once more and the restore reads
# back; 2 layers keep the phase inside the run's time limit (zlib at level
# 1 writes some 200 MB/s on 8 cores where zstandard is absent)
CKPT_LAYERS = TRAIN_TWIN_LAYERS
CKPT_LABEL = "ckpt-deepseek"
CKPT_STEPS = 2                 # before the save, and again after it
# a restart against the uninterrupted run where the card does not repeat
# a step bit for bit (the witness reads above 0): the largest relative
# difference of a loss and the relative L2 difference of the final
# params over the two steps' update. A restart from the wrong batches (the
# control) differs by O(1); last-bit noise through two steps by far less
RESTART_REL = 1e-3


def _meminfo(key):
    """A /proc/meminfo field in bytes (MemAvailable, Cached, ...)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"no {key} in /proc/meminfo")


def _mem_available():
    return _meminfo("MemAvailable")


def _fsync_dir(d):
    """fsync every file of ``d``, then ``d``: the checkpoint then survives
    a failure of the host, not only of the process (``save`` does not
    fsync, as the reference's does not)."""
    import os
    for f in sorted(Path(d).iterdir()) + [Path(d)]:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def _evict(d):
    """Drop the pages of ``d``'s files (clean once fsynced) from this
    host's page cache, so that a restore cannot read them from there, as a
    migration's destination could not. Returns the page cache's size
    (Cached) before and after: what it dropped. A file system that keeps
    no pages in this host's cache (a 9p mount) has none to drop; its
    server's cache lies out of reach."""
    import os
    before = _meminfo("Cached")
    for f in Path(d).iterdir():
        fd = os.open(f, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return before, _meminfo("Cached")


def _filesystem(path):
    """The type and device of the mount that holds ``path``."""
    best = ("", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, kind = line.split()[:3]
            if str(path).startswith(mnt) and len(mnt) >= len(best[0]):
                best = (mnt, kind, dev)
    return {"mount": best[0], "type": best[1], "device": best[2]}


def _module_version(name):
    """The installed version of ``name``, or None (not imported here)."""
    from importlib import metadata
    try:
        return metadata.version(name)
    except metadata.PackageNotFoundError:
        return None


def _restart_gate(label, restart, witness, control):
    """The rule for a restarted run against the uninterrupted one. Each
    argument is a distance {"bit_equal", "loss_rel", ...} from the
    uninterrupted run; ``witness`` (the restart run again) and ``control``
    (a restart that replays the wrong batches) may be None when the
    restart is bit-equal. Where the witness is bit-equal, or absent, the
    card repeats a step bit for bit and the restart must be bit-equal;
    otherwise every witness and the restart must be within RESTART_REL on
    each measure and the control over it on one."""
    out = {"restart": restart, "witness": witness, "control": control,
           "limit": RESTART_REL}
    log(f"{label}: restart against the uninterrupted run "
        f"{json.dumps(out)}")
    if control is not None:
        assert not control["bit_equal"], out
        assert max(v for k, v in control.items() if k != "bit_equal") \
            > RESTART_REL, out
    if witness is None or witness["bit_equal"]:
        assert restart["bit_equal"], out
        return out
    for run in (restart, witness):
        assert all(v <= RESTART_REL for k, v in run.items()
                   if k != "bit_equal"), out
    return out


def _loss_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_ckpt():
    """deepseek-7b at full width and CKPT_LAYERS layers (fp32 params, bf16
    compute, full remat: the tensor-core flash forward and backward), B=1,
    S=2048 from ``TokenPipeline(DataConfig(102400, 2048, 1, seed=0))``:
    CKPT_STEPS AdamW steps; ``ckpt.save`` of ``adamw.state_tree`` with
    ``async_write`` and the pipeline's cursor in ``extra``; CKPT_STEPS more
    steps while it writes (the uninterrupted run: losses, and a host copy of
    the final params); the failure (LM and state deleted, the cache
    emptied); a fresh LM from another seed; ``restore(latest(...))`` into
    its state and the cursor into a fresh pipeline; the CKPT_STEPS steps
    again. Gates: every restored leaf bit-equal to the saved state; the
    restart held to the uninterrupted run by ``_restart_gate``, beside a
    witness (the restart run again from the restored state) and a control
    (a restart that skips the cursor and replays batch 0); each step
    2 x layers flash forwards and layers backwards, all on ``tc``. Logs the
    bytes on disk, the compressor, and the stop (``save`` until it returns:
    the device-to-host copy), write (until the writer is joined), fsync
    (of every file after that: the write made durable), and restore (until
    the tensors are on the card, synchronised) times; the restore reads
    the files after their pages were dropped from the page cache
    (``_evict``), then once more."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    cfg = get_config(TRAIN_ARCH).replace(num_layers=CKPT_LAYERS)
    opt = adamw.OptConfig(lr=3e-4, warmup_steps=0, total_steps=100)
    data = DataConfig(cfg.vocab_size, TRAIN_S, 1, seed=0)
    per_step = ({"tc": 2 * CKPT_LAYERS, "fma": 0},
                {"tc": CKPT_LAYERS, "fma": 0})

    def build(seed):
        lm = LM(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
        state = adamw.init_state(lm)
        return lm, state, adamw.make_train_step(lm, opt)

    def steps(state, step, pipe):
        losses = []
        for _ in range(CKPT_STEPS):
            f0, b0 = flash_counts(), bwd_counts()
            batch = {k: torch.as_tensor(v, device=DEVICE)
                     for k, v in pipe.next().items()}
            state, met = step(state, batch)
            losses.append(met["loss"].item())
            got = ({k: flash_counts()[k] - f0[k] for k in f0},
                   {k: bwd_counts()[k] - b0[k] for k in b0})
            assert got == per_step, (got, per_step)
        return state, losses

    def distance(losses, params, want_losses, want, saved):
        """Bit-equality, loss and params (over the update) distances."""
        bit = losses == want_losses
        num = den = 0.0
        for n, p in params.items():
            w = want[n].to(DEVICE)
            bit = bit and torch.equal(p, w)
            num += torch.sum(torch.square(p - w)).item()
            den += torch.sum(torch.square(w - saved[f"params.{n}"])).item()
        return {"bit_equal": bool(bit),
                "loss_rel": _loss_rel(losses, want_losses),
                "params_rel": (num / den) ** 0.5}

    out = {"layers": CKPT_LAYERS, "seq": TRAIN_S, "batch": 1,
           "compressor": ckpt.compressor(),
           "host_packages": {m: _module_version(m)
                             for m in ("msgpack", "zstandard")}}
    t_phase = time.perf_counter()
    reset_kernel_counts()
    lm, state, step = build(0)
    out["n_params"] = sum(p.numel() for p in lm.parameters())
    n_param_leaves = len(list(lm.parameters()))
    pipe = TokenPipeline(data)
    state, out["losses_before"] = steps(state, step, pipe)
    tree = adamw.state_tree(state, lm)
    leaves = list(ckpt.flatten(tree))
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    out.update(n_leaves=len(leaves), state_bytes=n_bytes,
               largest_leaf_bytes=max(t.numel() * t.element_size()
                                      for _, t in leaves))
    # the oracle: the saved state, on the card (checks only)
    saved = {p: t.detach().clone() for p, t in leaves}

    base = ROOT / "build"
    base.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=base)
    try:
        disk, mem = shutil.disk_usage(tmp).free, _mem_available()
        # zlib stores what it cannot shrink at a few bytes per 16 KB; the
        # save's host copy and the restore's leaves are each the state
        need_disk, need_mem = n_bytes * 1.01 + 2**30, 2 * n_bytes + 2**33
        out.update(disk_free_bytes=disk, mem_available_bytes=mem,
                   filesystem=_filesystem(tmp))
        log(f"ckpt: {TRAIN_ARCH} at full width, {CKPT_LAYERS} layers, "
            f"{out['n_params']:,} params; state {n_bytes:,} bytes "
            f"({n_bytes / 2**30:.2f} GiB) in {len(leaves)} leaves; "
            f"{disk / 2**30:.1f} GiB free on disk under {tmp}, "
            f"{mem / 2**30:.1f} GiB host memory available")
        if disk < need_disk or mem < need_mem:
            raise RuntimeError(
                f"ckpt: too little room: {disk:,} bytes free on disk for "
                f"{need_disk:,.0f}, {mem:,} bytes of host memory available "
                f"for {need_mem:,}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, writer = ckpt.save(
            tmp, tree, step=int(state["step"]), async_write=True,
            extra={"step": int(state["step"]), "data": pipe.state_dict()})
        out["stop_s"] = time.perf_counter() - t0
        state, out["losses_uninterrupted"] = steps(state, step, pipe)
        writer.join()
        out["write_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        _fsync_dir(d)
        out["fsync_s"] = time.perf_counter() - t1
        final = {n: p.detach().to("cpu", copy=True)
                 for n, p in state["params"].items()}

        # the failure
        del lm, state, step, tree, leaves
        gc.collect()
        torch.cuda.empty_cache()
        lm, state, step = build(1)
        like = adamw.state_tree(state, lm)
        assert not torch.equal(lm.embed, saved["params.embed"])
        latest = ckpt.latest(tmp)
        assert latest == d, (latest, d)
        out["disk_bytes"] = sum(f.stat().st_size
                                for f in Path(latest).iterdir())
        out["cached_before_evict"], out["cached_after_evict"] = \
            _evict(latest)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(latest, like)
        out["restore_s"] = time.perf_counter() - t0
        out["restored_bit_equal"] = all(
            torch.equal(t, saved[p]) for p, t in ckpt.flatten(like))
        # once more, with whatever the first restore left cached
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.restore(latest, like)
        out["restore_warm_s"] = time.perf_counter() - t0
        out["restored_bit_equal"] = out["restored_bit_equal"] and all(
            torch.equal(t, saved[p]) for p, t in ckpt.flatten(like))
        extra = ckpt.manifest_extra(latest)

        def restart(load_cursor):
            """From the restored state (reset from the oracle after the
            first run), the CKPT_STEPS steps again."""
            with torch.no_grad():
                for p, t in ckpt.flatten(adamw.state_tree(state, lm)):
                    t.copy_(saved[p])
            pipe = TokenPipeline(data)
            if load_cursor:
                pipe.load_state_dict(extra["data"])
            _, losses = steps(state, step, pipe)
            return distance(losses, state["params"],
                            out["losses_uninterrupted"], final, saved)

        pipe = TokenPipeline(data)
        pipe.load_state_dict(extra["data"])
        _, out["losses_restarted"] = steps(state, step, pipe)
        dist = distance(out["losses_restarted"], state["params"],
                        out["losses_uninterrupted"], final, saved)
        gate = _restart_gate("ckpt", dist, restart(True), restart(False))
        out["gate"] = gate
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = kernel_counts()
    out["flash_launches_by_kernel"] = flash_counts()
    out["flash_bwd_launches_by_route"] = bwd_counts()
    gb = n_bytes / 1e9
    out.update(stop_gb_s=gb / out["stop_s"], write_gb_s=gb / out["write_s"],
               restore_gb_s=gb / out["restore_s"],
               restore_warm_gb_s=gb / out["restore_warm_s"],
               phase_s=time.perf_counter() - t_phase)
    log(f"ckpt: {out['compressor']} (host packages "
        f"{json.dumps(out['host_packages'])}), {out['disk_bytes']:,} bytes "
        f"on disk ({out['disk_bytes'] / n_bytes:.4f} of the state) on "
        f"{json.dumps(out['filesystem'])}; stop "
        f"{out['stop_s']:.3f} s ({out['stop_gb_s']:.3f} GB/s), write "
        f"{out['write_s']:.3f} s ({out['write_gb_s']:.3f} GB/s), fsync "
        f"after it {out['fsync_s']:.3f} s; page cache "
        f"{out['cached_before_evict']:,} -> {out['cached_after_evict']:,} "
        f"bytes by the eviction; restore after it "
        f"{out['restore_s']:.3f} s ({out['restore_gb_s']:.3f} GB/s), once "
        f"more {out['restore_warm_s']:.3f} s "
        f"({out['restore_warm_gb_s']:.3f} GB/s); "
        f"restored bit-equal {out['restored_bit_equal']}; losses before "
        f"{out['losses_before']}, uninterrupted "
        f"{out['losses_uninterrupted']}, restarted "
        f"{out['losses_restarted']}; launches {json.dumps(out['launches'])}"
        f", by kernel {json.dumps(out['flash_launches_by_kernel'])}, "
        f"backward by route {json.dumps(out['flash_bwd_launches_by_route'])}"
        f"; phase {out['phase_s']:.1f} s")
    del lm, state, step, like, saved, final
    gc.collect()
    torch.cuda.empty_cache()
    assert out["n_leaves"] == 1 + 3 * n_param_leaves, out["n_leaves"]
    assert out["restored_bit_equal"]
    n_steps = 5 * CKPT_STEPS       # before, uninterrupted, restart, witness,
    assert out["flash_launches_by_kernel"] == {                 # control
        "tc": n_steps * 2 * CKPT_LAYERS, "fma": 0}, out
    assert out["flash_bwd_launches_by_route"] == {
        "tc": n_steps * CKPT_LAYERS, "fma": 0}, out
    return out


EXAMPLES = ("quickstart", "train_e2e", "serve_batch")
E2E_ARGS = ["--steps", "60"]           # fails at 30, restarts from step 25


@contextmanager
def _cursor_not_restored():
    """The control of a restart: ``TokenPipeline.load_state_dict`` does
    nothing, so the restarted run replays the batches from 0."""
    from repro_torch.data.pipeline import TokenPipeline
    orig = TokenPipeline.load_state_dict
    TokenPipeline.load_state_dict = lambda self, d: None
    try:
        yield
    finally:
        TokenPipeline.load_state_dict = orig


def _losses_distance(got, want):
    """A run's losses against the uninterrupted run's, by state step."""
    steps = sorted(want)
    return {"bit_equal": all(got[s] == want[s] for s in steps),
            "loss_rel": _loss_rel([got[s] for s in steps],
                                  [want[s] for s in steps])}


@contextmanager
def _flash_inputs(calls):
    """Record into ``calls`` the inputs of the first flash forward and
    backward launch of each set of shapes, strides, dtype and options while
    the block runs; the launches and their counts are those of the run."""
    from repro_torch.kernels import flash_attention as fa
    fwd, bwd = fa._launch, fa._launch_bwd

    def key(kind, ts, kw):
        return (kind, tuple((tuple(t.shape), t.stride(), str(t.dtype))
                            for t in ts), tuple(sorted(kw.items())))

    def launch(q, k, v, **kw):
        calls.setdefault(key("fwd", (q, k, v), kw), ((q, k, v), kw))
        return fwd(q, k, v, **kw)

    def launch_bwd(q, k, v, o, lse, do, **kw):
        calls.setdefault(key("bwd", (q, k, v, o, do), kw),
                         ((q, k, v, o, lse, do), kw))
        return bwd(q, k, v, o, lse, do, **kw)

    fa._launch, fa._launch_bwd = launch, launch_bwd
    try:
        yield calls
    finally:
        fa._launch, fa._launch_bwd = fwd, bwd


def _hold_recorded(label, calls):
    """Each recorded flash launch again on its own inputs, the kernel
    against its plain version at the sweeps' limits (TOL per element,
    REL_L2): the forward's o (and lse where the path asked for it) against
    ``attention_fwd_lse_plain``, the backward's dq, dk, dv against
    ``attention_bwd_plain``, beside a witness (the plain code in 64-wide
    chunks). These launches come after the path's counts were read."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    rows, bad = [], []
    for (kind, _, _), (ts, kw) in calls.items():
        kw = dict(kw)
        name = str(ts[0].dtype).split(".")[-1]
        with torch.no_grad():
            if kind == "fwd":
                want_lse = kw.pop("want_lse", False)
                o, lse = fa._launch(*ts, want_lse=want_lse, **kw)
                o_p, lse_p = fa.attention_fwd_lse_plain(*ts, **kw)
                o_w, lse_w = fa.attention_fwd_lse_plain(
                    *ts, chunk_q=64, chunk_k=64, **kw)
                pairs = [("o", o, o_p, o_w)]
                if want_lse:
                    pairs.append(("lse", lse, lse_p, lse_w))
            else:
                got = fa.flash_attention_bwd(*ts, **kw)
                want = fa.attention_bwd_plain(*ts, **kw)
                wit = fa.attention_bwd_plain(*ts, chunk_q=64, chunk_k=64,
                                             **kw)
                pairs = list(zip(("dq", "dk", "dv"), got, want, wit))
        torch.cuda.synchronize()
        rtol, atol = TOL[name]
        errs, ok = {}, True
        for lb, a, b, w in pairs:
            diff = (a.float() - b.float()).abs()
            excess = (diff - atol - rtol * b.float().abs()).max().item()
            errs[lb] = {"max_abs_err": diff.max().item(), "rel_l2": _rel(a, b),
                        "witness_rel_l2": _rel(w, b)}
            ok = ok and excess <= 0 and errs[lb]["rel_l2"] <= REL_L2[name] \
                and bool(torch.isfinite(a).all())
        row = {"kind": kind, "q": list(ts[0].shape), "k": list(ts[1].shape),
               "dtype": name, "options": kw, "errors": errs, "ok": ok}
        rows.append(row)
        log(f"examples: {label} holds {json.dumps(row)}")
        if not ok:
            bad.append(row)
    if bad:
        raise AssertionError(f"{label}: a flash kernel disagrees with its "
                             f"plain version at the path's shapes: {bad}")
    return rows


def phase_examples():
    """The three examples' ``main(device="cuda")`` in-process, each asserting
    its own checks, with the counts set to 0 before each run and read
    after: quickstart (deepseek-7b smoke, 2 layers, fp32: 22 steps of
    2 x 2 FMA flash forwards and 2 FMA backwards), train_e2e (lm-100m,
    12 x 768, fp32, ``--steps 60``: fails at 30, restarts from the
    checkpoint of step 25, 65 steps; then the same command uninterrupted,
    60 steps; the losses by state["step"] held by ``_restart_gate``, the
    witness (the uninterrupted command again) and the control (a restart
    that replays batch 0) run only where the restart is not bit-equal),
    serve_batch (gemma3-1b smoke, 6 requests over 4 slots, a migration at
    step 3: one FMA flash forward per layer and prefill, windowed on the
    local layers). After each example's first run, its flash launches are
    held against their plain versions at the shapes, strides and options
    the example gave them (``_hold_recorded``)."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.examples import quickstart, serve_batch, train_e2e
    out = {}

    def counted(label, fn, hold=False):
        """Run ``fn`` with the counts set to 0 before and read after; with
        ``hold``, every flash launch's shape is then held by
        ``_hold_recorded``."""
        calls = {}
        reset_kernel_counts()
        with _flash_inputs(calls):
            res = fn()
        torch.cuda.synchronize()
        out[label] = {"flash": flash_counts(), "bwd": bwd_counts(),
                      "launches": kernel_counts()}
        log(f"examples: {label} launches {json.dumps(out[label])}")
        if hold:
            out[label]["held"] = _hold_recorded(label, calls)
        return res

    t0 = time.perf_counter()
    q = counted("quickstart", lambda: quickstart.main([], device=DEVICE),
                hold=True)
    out["quickstart_s"] = time.perf_counter() - t0
    out["quickstart_result"] = q
    n = (quickstart.STEPS + 2) * 2
    assert q["equal"], q
    assert out["quickstart"]["flash"] == {"tc": 0, "fma": 2 * n}, out
    assert out["quickstart"]["bwd"] == {"tc": 0, "fma": n}, out

    t0 = time.perf_counter()
    failed = counted("train_e2e", lambda: train_e2e.main(
        E2E_ARGS, device=DEVICE), hold=True)
    clean = counted("train_e2e_uninterrupted", lambda: train_e2e.main(
        E2E_ARGS + ["--fail-at", "1000"], device=DEVICE))
    layers = train_e2e.CFG.num_layers
    for label, n_steps in (("train_e2e", 65), ("train_e2e_uninterrupted",
                                                60)):
        assert out[label]["flash"] == {"tc": 0,
                                       "fma": 2 * layers * n_steps}, out
        assert out[label]["bwd"] == {"tc": 0, "fma": layers * n_steps}, out
    assert failed["restarted"] == train_e2e.CKPT_EVERY, failed
    assert failed["final_step"] == 61 and clean["final_step"] == 60
    dist = _losses_distance(failed["losses"], clean["losses"])
    witness = control = None
    if not dist["bit_equal"]:
        witness = _losses_distance(counted("train_e2e_witness", lambda:
                                           train_e2e.main(E2E_ARGS + [
                                               "--fail-at", "1000"],
                                               device=DEVICE))["losses"],
                                   clean["losses"])
        with _cursor_not_restored():
            control = _losses_distance(counted(
                "train_e2e_control", lambda: train_e2e.main(
                    E2E_ARGS, device=DEVICE))["losses"], clean["losses"])
    out["train_e2e_gate"] = _restart_gate("examples: train_e2e", dist,
                                          witness, control)
    out["train_e2e_s"] = time.perf_counter() - t0
    out["train_e2e_losses"] = {s: clean["losses"][s] for s in (1, 26, 30,
                                                                60)}

    t0 = time.perf_counter()
    streams = counted("serve_batch", lambda: serve_batch.main(
        [], device=DEVICE), hold=True)
    out["serve_batch_s"] = time.perf_counter() - t0
    cfg = get_smoke_config("gemma3-1b")
    assert all(len(s) >= 8 for s in streams), streams
    n = expected_launches(cfg, 6)["flash_attention_fwd"]
    assert out["serve_batch"]["flash"] == {"tc": 0, "fma": n}, out
    assert out["serve_batch"]["bwd"] == {"tc": 0, "fma": 0}, out
    log(f"examples: quickstart {out['quickstart_s']:.1f} s, restored step "
        f"bit-equal {q['equal']}; train_e2e {out['train_e2e_s']:.1f} s, "
        f"losses at state steps 1, 26, 30, 60 "
        f"{json.dumps(out['train_e2e_losses'])}; serve_batch "
        f"{out['serve_batch_s']:.1f} s, {len(streams)} requests served")
    return out


PORT_KERNELS = re.compile(
    r"(flash_fwd|flash_bwd|ssd_fwd|rglru_fwd)\w*kernel(<[^>]*>)?")


def profiled(fn, top_n=8):
    """Run ``fn`` once under ``torch.profiler``: wall time, the device's
    busy time and idle share, the ``top_n`` kernels by device time and the
    port's own kernels (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:top_n]
    ours = {}
    for k, t in dev.items():
        m = PORT_KERNELS.search(k)
        if m:
            ours[m.group(0)] = ours.get(m.group(0), 0.0) + t / 1e3
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                idle_share=(1 - busy / wall_us) if busy else None,
                top=[(k[:80], t / 1e3) for k, t in top],
                port_kernels_ms=ours)


def phase_profile(lm):
    """Device time by kernel and the device's idle share under
    ``torch.profiler``: one S=2048 prefill, then 8 decode steps."""
    from repro_torch.serving.engine import Request, ServingEngine
    name = PATHS[lm.cfg.name].replace("serve", "profile")
    eng = ServingEngine(lm, slots=SLOTS, capacity=CAPACITY, device=DEVICE)
    prompt = make_prompts(lm.cfg)[len(PROMPT_LENS) - 1]     # S = 2048
    work = {"prefill": lambda: eng.submit(Request(0, prompt, max_new=64)),
            "decode": lambda: [eng.step() for _ in range(8)]}
    out = {}
    for label, fn in work.items():
        out[label] = log_profile(f"{name} {label}", profiled(fn))
    return out


def log_profile(label, prof):
    log(f"{label}: wall {prof['wall_ms']:.3f} ms under the profiler, device "
        f"busy {prof['device_busy_ms']:.3f} ms, idle share "
        f"{prof['idle_share']}; the port's kernels "
        f"{json.dumps(prof['port_kernels_ms'])}")
    for k, t in prof["top"]:
        log(f"  {t:9.3f} ms  {k}")
    return prof


def phase_migrate(lm, streams):
    import torch
    from repro_torch.models.layers import flatten_paths
    from repro_torch.serving.engine import Request, ServingEngine, state_to
    label = PATHS[lm.cfg.name].replace("serve", "migrate")
    prompts = make_prompts(lm.cfg)
    reqs = [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    info = {}

    def hand_off(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = state_to(eng.state_dict(), "cpu")      # dump to host memory
        fresh = ServingEngine(lm, slots=SLOTS, capacity=CAPACITY,
                              device=DEVICE)
        fresh.load_state_dict(blob)                   # restore onto the card
        fresh.active = eng.active
        torch.cuda.synchronize()
        info["s"] = time.perf_counter() - t0
        info["bytes"] = sum(t.numel() * t.element_size() for _, t in
                            flatten_paths(blob["cache"]))
        return fresh

    got = serve(ServingEngine(lm, slots=SLOTS, capacity=CAPACITY,
                              device=DEVICE), reqs, hand_off=hand_off)
    log(f"{label}: state of {info['bytes'] / 2**30:.3f} GiB dumped to host "
        f"and restored in {info['s']:.3f} s; streams "
        f"{'equal' if got == streams else 'DIFFER'}")
    assert got == streams, (got, streams)
    return info


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "card", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {name}; nvidia-smi: {smi}; python {sys.version.split()[0]}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    failed = []

    def run(label, fn, *a):
        t0 = time.perf_counter()
        try:
            out = fn(*a)
        except Exception:                       # report, then fail at exit
            log(f"PHASE {label} FAILED:\n{traceback.format_exc()}")
            failed.append(label)
            return None
        log(f"phase {label}: ok in {time.perf_counter() - t0:.1f} s")
        return out

    run("build", phase_build)
    if failed:
        return 1
    run("sweep", phase_sweep)
    timing = run("timing", phase_timing)
    run("sweep-ssd", phase_sweep_ssd)
    timing_ssd = run("timing-ssd", phase_timing_ssd)
    run("sweep-rglru", phase_sweep_rglru)
    timing_rglru = run("timing-rglru", phase_timing_rglru)
    run("sweep-bwd", phase_sweep_bwd)
    timing_bwd = run("timing-bwd", phase_timing_bwd)
    run("grad-scan", phase_grad_scan)
    paths = {}
    logits_of = {"deepseek-7b": phase_logits,
                 "mamba2-2.7b": phase_logits_scan,
                 "recurrentgemma-9b": phase_logits_scan}
    for arch in PATHS:
        label = PATHS[arch]
        sfx = label[len("serve"):]
        # the multimodal paths run without the engine, which takes tokens
        # alone; the later paths are not profiled (time on the card)
        engine = arch not in ("internvl2-76b", "seamless-m4t-large-v2")
        lm = run("load" + sfx, build_lm, arch)
        served = run(label, phase_serve if engine else phase_serve_lm,
                     lm) if lm is not None else None
        if served is not None:
            logits = run("logits" + sfx,
                         logits_of.get(arch, phase_logits_attn), lm)
            if engine:
                run("migrate" + sfx, phase_migrate, lm, served[0])
            profiled = (run("profile" + sfx, phase_profile, lm)
                        if arch in logits_of else None)
            served[2].update(logits_rel_l2=logits, profile=profiled)
            paths[arch] = served
        del lm                  # free the card for the next path
        gc.collect()
        torch.cuda.empty_cache()
    trains = {t: run(t, phase_train, t) for t in TRAIN_PATHS}
    saved = run("ckpt", phase_ckpt)
    examples = run("examples", phase_examples)
    timings = (timing, timing_ssd, timing_rglru, timing_bwd)
    if failed or any(t is None for t in timings) or len(paths) < len(PATHS) \
            or None in trains.values() or saved is None or examples is None:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    # each kernel's row at its first path's S=2048 shape
    rows = {"flash_attention_fwd": next(
                r for r in timing if r["path"] == "deepseek"
                and r["S"] == 2048 and r["dtype"] == "bfloat16"),
            "flash_attention_bwd": timing_bwd[0],
            "ssd_scan": timing_ssd[1],
            "rglru_scan": timing_rglru[1]}
    meta = {"flash_attention_fwd": ("flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:30"),
            "flash_attention_bwd": (
                "flash_attention.cu",
                "src/repro/kernels/ops.py:328 (_flash_bwd, XLA-level "
                "custom_vjp)"),
            "ssd_scan": ("ssd.cu", "src/repro/kernels/ssd.py:24"),
            "rglru_scan": ("rglru.cu", "src/repro/kernels/rglru.py:26")}
    kernels = []
    for kname, (src, replaces) in meta.items():
        row = rows[kname]
        by_path = {a: p[1][kname] for a, p in paths.items() if p[1][kname]}
        for tname, train in trains.items():
            if train["launches"][kname]:
                by_path[TRAIN_PATHS[tname]["label"]] = \
                    train["launches"][kname]
        if saved["launches"][kname]:
            by_path[CKPT_LABEL] = saved["launches"][kname]
        for ex in EXAMPLES:
            if examples[ex]["launches"][kname]:
                by_path[f"examples-{ex}"] = examples[ex]["launches"][kname]
        entry = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        if kname == "flash_attention_fwd":
            entry["design"] = (
                "bf16 at head dims 64/128/192/256: flash_fwd_tc_kernel, "
                "wgmma for q.k^T and P.v, TMA into a two-stage k/v ring "
                "(128-key tiles, 64 at head dims 192 and 256; 192 is "
                "deepseek-v2's MLA with v zero-padded from 128), online "
                "softmax in registers; fp32 at every head dim and bf16 at "
                "16/32: flash_fwd_kernel, fp32 FMA")
            entry["launches_by_kernel"] = {
                k: sum(p[2]["flash_launches_by_kernel"][k]
                       for p in paths.values())
                + sum(t["flash_launches_by_kernel"][k]
                      for t in trains.values())
                + saved["flash_launches_by_kernel"][k]
                + sum(examples[ex]["flash"][k] for ex in EXAMPLES)
                for k in ("tc", "fma")}
            entry["at_shapes"] = [
                {k: r[k] for k in ("path", "shape", "window", "kernel",
                                   "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")}
                for r in timing]
        if kname == "flash_attention_bwd":
            entry["design"] = (
                "bf16 at head dims 64/128/192/256 (route tc): delta and "
                "lse*log2(e) into [B,H,Sq] scratch; "
                "flash_bwd_dkdv_tc_kernel, one CTA per (b, kv head x head "
                "split, key tile), a TMA producer warpgroup and two wgmma "
                "consumers, S^T = K.Q^T and dP^T = V.dO^T from shared "
                "memory, P^T and dS^T rounded to bf16 as register operands "
                "of dV += P^T.dO and dK += dS^T.Q, q/do through a two-stage "
                "ring; 128-key tiles (each consumer 64 keys, dk and dv) at "
                "64/128, one shared 64-key tile at 192 (deepseek-v2's MLA, "
                "v zero-padded from 128; m64n192k16 over three 64-wide "
                "chunks) and 256, one consumer holding dv, the other dk; "
                "at GQA/MQA the group's heads split across CTAs and "
                "flash_bwd_reduce_kernel sums the fp32 partials in order; "
                "flash_bwd_dq_tc_kernel, one CTA per (b, head, 128 queries), "
                "k/v through the ring, dQ += dS.K by wgmma. fp32 and bf16 at "
                "16/32 (route fma): flash_bwd_{delta,dkdv,dq}_kernel, fp32 "
                "FMA. No atomics; masked tiles skipped")
            entry["launches_by_kernel"] = {
                k: sum(t["flash_bwd_launches_by_route"][k]
                       for t in trains.values())
                + saved["flash_bwd_launches_by_route"][k]
                + sum(examples[ex]["bwd"][k] for ex in EXAMPLES)
                for k in ("tc", "fma")}
            entry["at_shapes"] = [
                {k: r[k] for k in ("path", "shape", "window", "route", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err",
                                   "host_ms_per_call")}
                for r in timing_bwd]
        if kname == "ssd_scan":
            entry["design"] = (
                "bf16 at P 16/32/64, N 16/128: two tensor-core kernels over "
                "128-row chunks: ssd_fwd_state_kernel walks each (b, head, "
                "64-wide block of N) through its chunks, the chunk states "
                "(w o x)^T.B by wgmma and the fp32 recurrence passed "
                "between two warpgroups, writing each chunk's entering "
                "state in bf16; ssd_fwd_out_kernel runs every (b, head, "
                "chunk) at once, C.h_in and the decay-masked C.B^T times x "
                "by wgmma, blocks above the diagonal skipped; TMA tiles; "
                "fp32 and bf16 at P or N = 8: ssd_fwd_kernel, fp32 FMA, "
                "chunks in order")
            entry["launches_by_kernel"] = {
                k: sum(p[2]["ssd_launches_by_kernel"][k]
                       for p in paths.values()) for k in ("tc", "fma")}
        if kname == "rglru_scan":
            entry["design"] = (
                "time split across CTAs in one pass: chunks of 32 steps "
                "taken by ticket compute their gates once into shared "
                "memory and their carry (prod a, h) from h=0, publish it, "
                "fold the carries before them by a decoupled look-back and "
                "rerun from shared memory, writing y; fp32 throughout")
        kernels.append(entry)
    log(json.dumps({"timing": timing, "timing_ssd": timing_ssd,
                    "timing_rglru": timing_rglru, "timing_bwd": timing_bwd,
                    "serving": {a: p[2] for a, p in paths.items()},
                    "train": trains, "ckpt": saved, "examples": examples}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
