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
             (``profile``, deepseek-7b's; the other paths are not
             profiled, PROFILED).
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
             Then the scan models, each through its scan kernel's forward
             (2 x its scan layers a step, SSD on ``tc``; backward by plain
             recompute, timed on its own), with its scan's witness (the
             plain scan in other chunks, or in pieces carried through h0)
             and control (the carry dropped) in the step-1 gate:
             ``train-mamba`` (mamba2-2.7b at 16 of its 64 layers, fp32 twin
             at 2) and ``train-rg`` (recurrentgemma-9b at 2 of its (rec,
             rec, local) periods, 6 layers, the windowed flash kernels too;
             fp32 twin one period).
             Then the other attention archs, with their flash backwards at
             head dims 256 and 64 and the non-causal ones: ``train-gemma``
             (gemma-7b at 9 of 28 layers, 3.278 B params, tied 256000-wide
             head; twin 2), ``train-stablelm`` (stablelm-1.6b at 6 of 24
             layers; twin 2), ``train-gemma3`` (gemma3-1b at 13 of 26
             layers: windowed MQA at head dim 256, window 512; twin one
             period of 6), ``train-vlm`` (internvl2-76b at 1 of 80 layers,
             256 seeded vision embeds ahead of 1792 tokens; twin 1) and
             ``train-encdec`` (seamless-m4t-large-v2 at 6 of 24 encoder
             and 6 of 24 decoder layers over 2048 seeded frames, 18 flash
             forwards a forward; its bf16 gate at 2 + 2 layers, twin 1 +
             1).
  roofline — per train path: the reference's model FLOPs (6 N D) at the
             path's depth, B=1 and S=2048, the FLOPs and bytes of a
             world-1 trace of the same step on meta tensors
             (``repro_torch.launch.dryrun``, the plain path; host
             processes trace them while the kernels build), the ms per
             step measured above, MFU = model FLOPs / (step s x 989e12)
             and on matmuls alone (6 N D less an untied embedding table),
             and the trace's predicted peak beside the measured one, with
             the card's name and power limit.
    dist   — ``dist-train``: a world-1 NCCL process group in this process
             and the ("data", "model") = (1, 1) mesh; deepseek-moe-16b at
             full width and 4 layers takes 3 AdamW steps through the
             mesh-aware ``make_train_step`` from a state placed by
             ``remesh_state(state, logical, None, mesh)``, every leaf of
             params, m and v bit-equal to the same steps without a mesh
             (64-bit digests), ms per step and peak beside the unsharded
             steps'. ``dist-tp``: four gloo ranks on the card, a (1, 4)
             mesh, in two spawns. First the tensor-parallel train step
             (heads, ffn and vocabulary split over "model") of deepseek-7b
             at full width and 4 layers and gemma3-1b at one period (6
             layers), B=1, S=2048, from the seeded weights of an unsharded
             step on rank 0: fp32 (FMA flash) loss, grad_norm and every
             updated leaf, bf16 (``tc``) step 1 against the fp32 step
             between witnesses and a control; each rank's flash launches
             counted and held against the plain versions at their local
             head counts; ms per step, peak per rank, gloo's host-staged
             all-reduce. Then each path serves on the same ranks through
             ``launch.specs.build_fn``: 4 prompts (2048 down to 256)
             prefilled into caches of 2304 slots kept at their storage
             shards (deepseek-7b's by kv heads, gemma3-1b's MQA cache and
             ring by sequence), 4 decode steps; fp32 greedy tokens equal
             to the unsharded run's, logits of every call within a limit
             between a witness and (bf16) a control; prefill and decode
             ms, peak and cache GiB per rank, the collectives a decode
             step. Then the scan mixers split over "model":
             recurrentgemma-9b at one period (rec, rec, local; the RG-LRU
             at [1,S,1024] a rank) and mamba2-2.7b at 4 layers (the SSD at
             [1,S,20,64] a rank), trained in fp32 with the same gates but
             their own controls (the RG-LRU block's all-reduce dropped; the
             gated norm's sum over heads dropped), then served in bf16
             teacher-forced over 4 decode steps with the bf16 serving gate
             and the same controls, their caches at the reference's specs
             (the RG-LRU's by channels, Mamba-2's state by heads and its
             conv window's flat shard). Then the MoE families with EP and
             TP both over "model"
             (capacity factor 8, each code replaying the unsharded run's
             routing): deepseek-moe-16b at 4 layers (1 dense + 3 MoE) and
             deepseek-v2-236b at its layer 0 (MLA at [1,S,32,192] a rank)
             trained in fp32 with the same gates (the control also summing
             MLA's q_norm and kv_norm again), then served in bf16,
             deepseek-moe-16b at 4 layers (its cache by kv heads) and
             deepseek-v2-236b at 2 (its ckv/kpe cache by sequence), 4
             decode steps, with the bf16 serving gate; and the former
             ``dist-ep``'s checks of one deepseek-moe-16b MoE layer over
             2048 tokens through ``moe._moe_ep`` against the local path (y,
             aux, every gradient; fp32), its drops at capacity factor 0.5
             against the same EP on CPU copies, the share of routings that
             differ and, in bf16 at capacity factor 1.25, of copies
             dropped, and gloo's host-staged times.
 9. ckpt   — deepseek-7b's training state at full width and 1 layer
             ({step, params, m, v}: 1.04 B params, 12.50 GB in 37 leaves),
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
             (``--steps 30``: a failure at 28, a restart from step 25,
             held against the uninterrupted command as in ``ckpt``) and
             serve_batch, each ``main(device="cuda")`` in-process with its
             own checks and its FMA flash launches counted.
The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
import traceback
import types
from contextlib import contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's figures, from the port's roofline (NVIDIA H100 SXM data sheet)
from repro_torch.roofline import analysis as ROOF  # noqa: E402

PEAK_BF16_FLOPS = ROOF.PEAK_FLOPS   # dense bf16 tensor-core peak, 989e12
PEAK_BYTES = ROOF.HBM_BW            # HBM3, 3.35e12 B/s
PEAK_F32_FLOPS = ROOF.PEAK_F32_FLOPS   # fp32 outside the tensor cores
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
REL_L2 = {"float32": 1e-5, "bfloat16": 1e-2}   # kernel vs plain, per case
# a bf16 flash launch on a model's activations (``_hold_recorded``): each
# element outside TOL within this many times the larger of TOL and SDPA's
# error on it
SDPA_ERR_MULT = 2.0
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
    # dist-tp's: a rank's 20 of 80 heads, trained in fp32, served in bf16
    cases += [((1, 2048, 20, 64, 1, 128), dt, "D")
              for dt in (torch.float32, torch.bfloat16)]
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
    # the served 80 heads at two lengths, then dist-tp's rank's 20
    for S, H in ((512, 80), (2048, 80), (2048, 20)):
        shape = (1, S, H, 64, 1, 128)
        x, dtv, al, bm, cm, d, _ = rand_ssd(200 + S + H, *shape,
                                            torch.bfloat16)
        kern = lambda: ssd.ssd_scan(x, dtv, al, bm, cm, D=d)  # noqa: E731
        plain = lambda: ssd.ssd_plain(x, dtv, al, bm, cm, D=d)  # noqa: E731
        err = (kern()[0].float() - plain()[0].float()).abs().max().item()
        iters = 50 if S == 512 else 20
        ms = time_ms(kern, iters)
        plain_ms = time_ms(plain, max(iters // 4, 3))
        ms2 = time_ms(kern, iters)
        host = host_ms(kern, iters)
        bound_ms, bound_by, flops, nbytes = ssd_bound(*shape, 2)
        row = dict(S=S, H=H, kernel=ssd.kernel_for(x.dtype, 64, 128), ms=ms,
                   ms_repeat=ms2, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes, max_abs_err=err,
                   tflops=flops / (ms * 1e-3) / 1e12,
                   share_of_bound=bound_ms / ms, host_ms_per_call=host)
        rows.append(row)
        log(f"timing-ssd [1,{S},{H},64] bf16 N=128 with D ({row['kernel']} "
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
    # dist-tp's: a rank's 1024 of 4096 channels, trained in fp32, served
    # in bf16
    cases += [((1, 2048, 1024), dt, "none")
              for dt in (torch.float32, torch.bfloat16)]
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
    # the other attention archs' train paths: gemma-7b's MHA at head dim 256,
    # stablelm-1.6b's 32x64, gemma3-1b's MQA at window 512, internvl2-76b's
    # GQA over 256 vision embeds and 1792 tokens, seamless-m4t's
    # non-causal encoder (its cross-attention over 2048 frames has the
    # same shape)
    cases += [((1, 2048, 2048, 16, 16, 256), torch.bfloat16, "causal"),
              ((1, 2048, 2048, 32, 32, 64), torch.bfloat16, "causal"),
              ((1, 2048, 2048, 4, 1, 256), torch.bfloat16, "window512"),
              ((1, 2048, 2048, 64, 8, 128), torch.bfloat16, "causal"),
              ((1, 2048, 2048, 16, 16, 64), torch.bfloat16, "bidir")]
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
        # at S=2048, SDPA's backward under the case's mask is a witness
        # (recurrentgemma's 2048-token window masks nothing the causal mask
        # keeps; gemma3's 512 binds)
        sdpa = _sdpa_grads(q, k, v, do, kw["scale"], kw["causal"],
                           kw["window"]) if Sq == 2048 else None
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


def _sdpa_grads(q, k, v, do, scale, causal=True, window=0):
    """dq, dk, dv of attention by SDPA's autograd (a witness)."""
    import torch
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa_witness(None, *leaves, causal=causal, window=window,
                        scale=scale)
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
    # the served width at two lengths, then dist-tp's rank's 1024 channels
    for S, D in ((512, 4096), (2048, 4096), (2048, 1024)):
        x, al, ga, gx, _ = rand_rglru(300 + S + D, 1, S, D, torch.bfloat16)
        kern = lambda: rglru.rglru_scan(x, al, ga, gx)  # noqa: E731
        plain = lambda: rglru.rglru_plain(x, al, ga, gx)  # noqa: E731
        err = (kern()[0].float() - plain()[0].float()).abs().max().item()
        iters = 50 if S == 512 else 20
        ms = time_ms(kern, iters)
        plain_ms = time_ms(plain, max(iters // 4, 3))
        ms2 = time_ms(kern, iters)
        host = host_ms(kern, iters)
        bound_ms, bound_by, ops, nbytes = rglru_bound(1, S, D, 2)
        T = rglru.CHUNK_STEPS
        row = dict(S=S, D=D, chunk_steps=T, ms=ms, ms_repeat=ms2,
                   plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   ops=ops, bytes=nbytes, max_abs_err=err,
                   gb_per_s=nbytes / (ms * 1e-3) / 1e9,
                   share_of_bound=bound_ms / ms, host_ms_per_call=host)
        rows.append(row)
        log(f"timing-rglru [1,{S},{D}] bf16 (chunks of {T} steps): kernel "
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
# the served paths profiled each run: deepseek-7b's. mamba2-2.7b's and
# recurrentgemma-9b's profiles (their readings in PERF.md §5) are not
# repeated: 47 s of a slow host's run, which dist-tp's serving needs
PROFILED = ("deepseek-7b",)


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
    Only for what the gated prefills and train steps ask: causal with
    queries as long as the keys, or non-causal at any lengths (an encoder,
    a cross-attention); no softcap. A causal window that binds (gemma3-1b's
    512 in its S=2048 train step) goes in as a boolean mask."""
    import torch
    import torch.nn.functional as F
    Sq, Sk = q.shape[1], k.shape[1]
    if (causal and Sq != Sk) or (0 < window < Sk and not causal) or softcap:
        raise ValueError("the SDPA witness takes causal Sq == Sk or "
                         "non-causal calls, no softcap")
    mask = None
    if 0 < window < Sk:
        i = torch.arange(Sq, device=q.device)[:, None]
        j = torch.arange(Sk, device=q.device)[None]
        mask, causal = (j <= i) & (i - j < window), False
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal, scale=scale,
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
    the plain code, then the plain code inside the ``as_witness`` (None:
    none) and the ``as_control`` context (a second correct code, a fault)
    and inside each further witness context of ``more``. Returns their
    relative L2 errors against the plain code's output
    (``witness_<name>_vs_plain`` for those of ``more``), and the kernels'
    and the plain code's outputs."""
    k, p = run(None), run("plain")
    assert k.isfinite().all() and k.shape == p.shape
    errs = dict(kernel_vs_plain=_rel(k, p))
    if as_witness is not None:
        with as_witness:
            errs["witness_vs_plain"] = _rel(run("plain"), p)
    with as_control:
        errs["control_vs_plain"] = _rel(run("plain"), p)
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
# after 6 of its layers (12 until dist-tp's scan paths took their time: at
# 12 the kernel read 1.0e-3, the witness 9.9e-4, the control 0.86)
ENC_GATE_LAYERS, ENC_GATE_LAYERS_FP32, DEC_GATE_LAYERS_ENCDEC = 2, 6, 2
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

    def record(cfg, p, x, *ep):
        seen.append((cfg, p, x))
        return orig(cfg, p, x, *ep)
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

    def gate(name, run, n_launches, limit, sdpa, chunks=True):
        more = {"sdpa": plain_attention_as(_sdpa_witness)} if sdpa else {}
        before = flash_counts()
        errs, k, p = _kernel_witness_control(
            run, plain_attention_as(_plain_small_chunks) if chunks else None,
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
    # the whole model's bf16 logits, not gated (random init keeps no
    # digit there); seamless-m4t's without the 64-row witness, which took
    # 33 of the phase's 62 s over its 24 encoder layers at 4096 frames
    # (PERF.md §4), beside SDPA's
    lk, lp = gate("bf16_logits", last_logits(lm), None, None, True,
                  chunks=not encdec)
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
# the scan models: mamba2-2.7b's layers are all SSD (a stacked core of 32
# periods, the twin's of 2), recurrentgemma-9b's (rec, rec, local)
# periods (a stacked core of 2 at 6 layers; the twin's one period is
# unstacked, in the tail). Each leaf is one matrix; tied embeddings: the
# embedding's gradient carries the head's
SCAN_GRAD_LEAVES = {f"{at}.{w}": (f"decoder.core.0.mixer.{w}", i)
                    for at, i in (("l0", 0), ("last", -1))
                    for w in ("in_proj", "out_proj")}
SCAN_GRAD_LEAVES["embed"] = ("embed", None)
RG_GRAD_LEAVES = {f"l{j}.{w}": (f"decoder.core.{j}.mixer.{w}", 0)
                  for j, ws in ((0, ("wx", "wg", "wo")), (2, ("wq", "wk")))
                  for w in ws}
RG_GRAD_LEAVES["embed"] = ("embed", None)
RG_TWIN_LEAVES = {k: (p.replace("core", "tail"), None)
                  for k, (p, _) in RG_GRAD_LEAVES.items() if k != "embed"}
RG_TWIN_LEAVES["embed"] = ("embed", None)
# the leaves that feed a scan: their control is the scan that drops its
# carry (the attention controls leave them nearly alone)
SCAN_FED = (".in_proj", ".out_proj", ".wx", ".wg", ".wo", "embed")
# the scan paths' limits (on an H100). The fp32 twins' grad_norm: the
# witnesses read at most 1.2e-5 (mamba2's plain SSD in 64-row chunks) and
# 1.5e-8 (recurrentgemma's), the kernels 2.9e-5 and 1.8e-8, the dropped
# carry 0.078 and 0.038; their leaves keep GRAD_REL_L2_FP32 (the kernels at
# most 4.9e-4, the witnesses 4.3e-4, the controls 0.36 and more)
SCAN_NORM_REL = 1e-2
# the bf16 models: no code keeps a digit of any leaf's gradient (0.79 to
# 1.50, the plain code's own witnesses aside), so no leaf is gated.
# recurrentgemma-9b's grad_norm (read at 9 layers, held at 6 since the
# depth was cut for time): the witnesses read 4.3e-5
# (scan pieces) to 0.066 (SDPA), the kernel 0.070, the dropped carry 0.92;
# against the fp32 code's, the correct codes 0.086-0.185, the control 0.93
RG_NORM_REL_BF16 = 0.3
# mamba2-2.7b's grad_norm (read at 64 layers, held at 32 since the depth
# was cut for time; 95% of it the embedding's) cannot tell the dropped
# carry (6.4e-3) from the kernel (0.014): its loss can, the witness
# 2.0e-4, the kernel 1.4e-4, the dropped carry 1.6e-3
SCAN_LOSS_REL_BF16 = 5e-4
# the other attention-only archs. Tied embeddings (gemma-7b, gemma3-1b,
# seamless-m4t): the embedding's gradient carries the head's, labelled
# "head" so that it keeps the head's control (the off-by-one mask).
# gemma-7b at 9 layers and stablelm-1.6b at 6 stack one core of 9 and 6
# periods; the twins' 2 layers a core of 2, so GRAD_LEAVES' paths hold
TIED_GRAD_LEAVES = dict(GRAD_LEAVES, head=("embed", None))
# gemma3-1b: 2 core periods of (local x 5, attn) and a tail of 1 local
# layer at 13; its twin is one period (6 layers: the reference stacks no
# single period, so all 6 sit in the tail)
GEMMA3_GRAD_LEAVES = {f"{at}.{w}": (f"decoder.core.{j}.mixer.{w}", 0)
                      for at, j in (("l0", 0), ("global", 5))
                      for w in ("wq", "wk", "wv")}
GEMMA3_GRAD_LEAVES["head"] = ("embed", None)
GEMMA3_TWIN_LEAVES = {k: (p.replace("core", "tail"), None)
                      for k, (p, _) in GEMMA3_GRAD_LEAVES.items()
                      if k != "head"}
GEMMA3_TWIN_LEAVES["head"] = ("embed", None)
# internvl2-76b: one layer, in the tail (the model's and the twin's);
# untied head
VLM_GRAD_LEAVES = {f"l0.{w}": (f"decoder.tail.0.mixer.{w}", None)
                   for w in ("wq", "wk", "wv")}
VLM_GRAD_LEAVES["head"] = ("head", None)
# seamless-m4t: the encoder's layer 0 (non-causal), the decoder's layer 0
# self-attention (causal) and cross-attention (non-causal over the
# frames); 6 + 6 layers stack two cores, the twin's 1 + 1 two tails
ENCDEC_GRAD_LEAVES = {f"{at}.{w}": (f"{stack}.core.0.{m}.{w}", 0)
                      for at, stack, m in (("enc0", "encoder", "mixer"),
                                           ("l0", "decoder", "mixer"),
                                           ("x0", "decoder", "cross"))
                      for w in ("wq", "wk", "wv")}
ENCDEC_GRAD_LEAVES["head"] = ("embed", None)
ENCDEC_TWIN_LEAVES = {k: (p.replace("core", "tail"), None)
                      for k, (p, _) in ENCDEC_GRAD_LEAVES.items()
                      if k != "head"}
ENCDEC_TWIN_LEAVES["head"] = ("embed", None)
# their limits, each between the witnesses and the control named beside
# it (on an H100). The twins' grad_norm: the witnesses read at most 6.2e-6
# (stablelm-1.6b, 2 layers), 4.7e-9 (gemma3-1b, 6), 7.0e-9 (internvl2-76b,
# 1) and 2.1e-8 (seamless-m4t, 1 + 1), the controls
# 8.6e-3, 1.8e-3 (off-by-one mask), 3.8e-3 and 0.19 (dropped delta)
TWIN_NORM_REL_ATTN = 1e-4
# gemma-7b's bf16 grad_norm (9 layers): the witnesses 0.023 (chunks),
# 7.5e-4 (flash VJP), 0.061 (SDPA), the kernel 0.021, the control 0.124
GEMMA_NORM_REL_BF16 = 0.09
# stablelm-1.6b's gate at 6 of its 24 layers: the head, witnesses 0.0020
# and 0.020 (SDPA), the kernel 0.020, the control 0.19; the loss,
# witnesses 7.8e-6 and 3.6e-5, the kernel 2.1e-5, the control 5.0e-4
STABLELM_HEAD_REL_L2_BF16 = 0.06
STABLELM_LOSS_REL_BF16 = 1.5e-4
# gemma3-1b's gate at 12 of its 26 layers (two periods): the head,
# witnesses 0.042 and 0.077 (SDPA), the kernel 0.077, the control 0.446;
# grad_norm, witnesses 1.1e-4 to 3.6e-4, the kernel 1.0e-4, the dropped
# delta 8.1e-3 (against the fp32 code's: the correct codes 4.1e-5 to
# 4.3e-4, the control 7.8e-3)
GEMMA3_HEAD_REL_L2_BF16 = 0.2
GEMMA3_NORM_REL_BF16 = 2e-3
# internvl2-76b (1 layer): every leaf, the witnesses at most 8.4e-3
# (SDPA, wk), the kernel 8.3e-3, the controls 0.046 (the head) to 0.107;
# grad_norm, witnesses 1.8e-7 to 2.7e-5, the kernel 3.1e-5, the dropped
# delta 3.8e-3 (the off-by-one mask 1.1e-5: one key in 2048 moves little
# in one layer; against the fp32 code's every bf16 code reads 2.6e-3, the
# dropped delta 1.2e-3, so that reading is reported); the loss, witnesses
# 1.9e-6 and 9.8e-6, the kernel 8.4e-6, the control 6.6e-5
VLM_REL_L2_BF16 = 0.02
VLM_NORM_REL_BF16 = 1e-3
VLM_LOSS_REL_BF16 = 3e-5
# seamless-m4t's bf16 model at 2 + 2 layers: no leaf keeps a digit (every
# code 1.1 to 2.3, the chunked plain code's own witness aside) and
# grad_norm scatters (the kernel 0.58, SDPA 0.062-0.076, the control 0.23;
# 77% of it the tied embedding's); the loss tells: witnesses 0 and 2.0e-4
# (SDPA), the kernel 1.8e-4, the control 8.2e-4
ENCDEC_LOSS_REL_BF16 = 4e-4
# the train paths, run in this order: arch, depth, the fp32 twin's depth
# (routing is discontinuous, so the MoE twins are cut to their first MoE
# layer), the gradient leaves of the model and of the twin (the same
# labels), the limits of the twin's grad_norm, the bf16 model's gated
# leaves and its limits (grad_norm's None where it cannot tell the control;
# then a limit of the loss, ``bf16_loss``), and the scan (``scan``) whose
# witness and control join the gates. Optional: ``fp32_norm`` False holds
# the bf16 grad_norm to the plain code's only, not to the fp32 code's;
# ``gate_layers`` cuts the bf16 gate's model (the steps keep ``layers``);
# ``opt`` overrides fields of the steps' ``OptConfig``
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
    # mamba2-2.7b at 16 of its 64 layers (all 64 until dist-tp's MoE
    # paths took their time, 32 until its scan paths did; 2.703 B params,
    # 40.3 GiB at 16 B/param at 64); the SSD forward on the kernels, its
    # backward by plain recompute
    "train-mamba": dict(arch="mamba2-2.7b", label="train-mamba", layers=16,
                        twin_layers=2, leaves=SCAN_GRAD_LEAVES,
                        twin_leaves=SCAN_GRAD_LEAVES, scan="ssd",
                        twin_norm=(SCAN_NORM_REL, "drops_carry"),
                        bf16_gated=(), grad_bf16=None, bf16_norm=None,
                        bf16_loss=(SCAN_LOSS_REL_BF16, "drops_carry")),
    # recurrentgemma-9b: 2 of its 12 (rec, rec, local) periods, 6 layers (3
    # periods, 2.829 B params, 42.2 GiB, until dist-tp's MoE paths took
    # their time), beside a 256000-wide head whose fp32 logits and gradient
    # take 2 GiB each
    "train-rg": dict(arch="recurrentgemma-9b", label="train-rg", layers=6,
                     twin_layers=3, leaves=RG_GRAD_LEAVES,
                     twin_leaves=RG_TWIN_LEAVES, scan="rglru",
                     twin_norm=(SCAN_NORM_REL, "drops_carry"),
                     bf16_gated=(), grad_bf16=None,
                     bf16_norm=(RG_NORM_REL_BF16, "drops_carry")),
    # the other attention archs (an encoder-decoder cuts both stacks to
    # ``layers``).
    # Their limits (above) come from witness and control
    # readings on an H100. gemma-7b: 9 of 28 layers, 3.278 B params, 48.8
    # GiB at 16 B/param (10 layers 53.0), beside a 256000-wide tied head.
    # No bf16 leaf is gated (the tied head: SDPA 1.03, the control 1.13),
    # and its grad_norm is not held against the fp32 code's
    # (``fp32_norm``): there the control lies nearest (GEMMA_NORM_REL_BF16)
    "train-gemma": dict(arch="gemma-7b", label="train-gemma", layers=9,
                        twin_layers=2, leaves=TIED_GRAD_LEAVES,
                        twin_leaves=TIED_GRAD_LEAVES,
                        twin_norm=(TRAIN_REL, "drops_diagonal"),
                        bf16_gated=(), grad_bf16=None,
                        bf16_norm=(GEMMA_NORM_REL_BF16, "drops_diagonal"),
                        fp32_norm=False),
    # stablelm-1.6b at 6 of its 24 layers (all 24 until dist-tp's MoE
    # paths took their time, 12 until its scan paths did); its bf16
    # gate at 6 layers (at 24 its grad_norm could not tell: the kernel
    # 0.044, the control 0.049; at 6 SDPA 0.043, the control 0.059): the
    # head and the loss
    "train-stablelm": dict(arch="stablelm-1.6b", label="train-stablelm",
                           layers=6, twin_layers=2, gate_layers=6,
                           leaves=GRAD_LEAVES,
                           twin_leaves=GRAD_LEAVES,
                           twin_norm=(TWIN_NORM_REL_ATTN, "drops_diagonal"),
                           bf16_gated=BF16_GATED,
                           grad_bf16=STABLELM_HEAD_REL_L2_BF16, bf16_norm=None,
                           bf16_loss=(STABLELM_LOSS_REL_BF16,
                                      "drops_diagonal")),
    # gemma3-1b at 13 of its 26 layers (two periods of 5 local, window 512
    # : 1 global MQA, head dim 256, and a local layer; all 26 until
    # dist-tp's MoE paths took their time) and a 262144-wide tied head; its
    # bf16 gate at two periods, 12 layers
    "train-gemma3": dict(arch="gemma3-1b", label="train-gemma3", layers=13,
                         twin_layers=6, gate_layers=12,
                         leaves=GEMMA3_GRAD_LEAVES,
                         twin_leaves=GEMMA3_TWIN_LEAVES,
                         twin_norm=(TWIN_NORM_REL_ATTN, "drops_diagonal"),
                         bf16_gated=BF16_GATED,
                         grad_bf16=GEMMA3_HEAD_REL_L2_BF16,
                         bf16_norm=(GEMMA3_NORM_REL_BF16, "drops_delta")),
    # internvl2-76b: 1 of 80 layers, 2.957 B params, 44.1 GiB, 256 seeded
    # vision embeds ahead of 1792 tokens (2 layers, 3.813 B params, ran out
    # of the card's 80 GB in AdamW); its one layer sits in the tail, as
    # the twin's
    "train-vlm": dict(arch="internvl2-76b", label="train-vlm", layers=1,
                      twin_layers=1, leaves=VLM_GRAD_LEAVES,
                      twin_leaves=VLM_GRAD_LEAVES,
                      twin_norm=(TWIN_NORM_REL_ATTN, "drops_delta"),
                      bf16_gated=tuple(VLM_GRAD_LEAVES),
                      grad_bf16=VLM_REL_L2_BF16,
                      bf16_norm=(VLM_NORM_REL_BF16, "drops_delta"),
                      fp32_norm=False,
                      bf16_loss=(VLM_LOSS_REL_BF16, "drops_diagonal")),
    # seamless-m4t-large-v2 at 6 of its 24 encoder and 6 of its 24
    # decoder layers (24 + 24 until dist-tp's MoE paths took their time,
    # 12 + 12 until its scan paths did);
    # 2048 seeded frames (the reference's train batch
    # sizes them by S), so the cross-attention's shape is the encoder's.
    # Its random-init encoder carries bf16 roundings so far that at 24 + 24
    # no reading tells a correct code from the controls (as in serving,
    # PERF.md): the bf16 gate runs on the model cut to 2 + 2 layers
    # (``gate_layers``), on its loss. The step has no clipping (``opt``):
    # the encoder makes grad_norm 8.7e7 (1.01e8 in float64 on these
    # weights and batch, the decoder's part 6.1e3:
    # tests/encdec_grad_norm.py), and clipping to 1 puts the decoder's
    # gradients under Adam's eps, so the decoder takes no step and the
    # loss does not fall (12.655, 12.667, 12.661 with clipping)
    "train-encdec": dict(arch="seamless-m4t-large-v2", label="train-encdec",
                         layers=6, twin_layers=1, gate_layers=2,
                         leaves=ENCDEC_GRAD_LEAVES,
                         twin_leaves=ENCDEC_TWIN_LEAVES,
                         twin_norm=(TWIN_NORM_REL_ATTN, "drops_delta"),
                         bf16_gated=(), grad_bf16=None, bf16_norm=None,
                         bf16_loss=(ENCDEC_LOSS_REL_BF16, "drops_diagonal"),
                         opt=dict(clip_norm=0.0)),
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
        if n.startswith(("decoder.core.", "encoder.core.")):
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
def pinned_routing(record, seen=None):
    """The MoE layers' expert choices recorded, or replayed. While
    ``record`` (a list) is empty, each ``moe.route`` call appends its
    ``eidx``; else each call takes the next recorded one (in call order:
    the forward's layers, then their recompute under remat) and its gates
    at those experts from its own probabilities, renormalised as
    ``route`` does, so the router's gradient still flows; a replaying
    call appends its own choice to ``seen`` (a list) where given. Every
    recorded choice must be taken once."""
    import torch
    from repro_torch.models import moe as MOE
    orig, replay = MOE.route, bool(record)
    todo = list(record)

    def route(cfg, p, xf):
        probs, gates, eidx = orig(cfg, p, xf)
        if not replay:
            record.append(eidx)
            return probs, gates, eidx
        if seen is not None:
            seen.append(eidx)
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


def _train_gate(lm, batch, leaves, scan=None):
    """Step 1 through the kernels (``impl=None``) and through the plain
    code, beside witnesses (the plain code in 64-row chunks; the plain
    flash VJP, delta from the rounded output; SDPA in bf16) and controls
    (a backward that drops delta; an off-by-one causal mask): relative
    errors of loss, grad_norm and each leaf's gradient against the plain
    code's. A model with a ``scan`` (``"ssd"``, ``"rglru"``) adds its
    scan's witness (``SCAN_CHECKS``: the plain scan in other chunks, or
    in pieces carried through h0) and control (the carry dropped,
    ``drops_carry``); one without attention layers runs only those. A model with MoE layers replays the plain run's routing in
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
    attn = any(k in ("attn", "local", "mla") for k in lm.cfg.layer_kinds)
    runs = {"kernel": None}
    if attn:
        runs.update({
            "witness_chunks": plain_attention_as(_plain_small_chunks),
            "witness_flash_vjp": plain_attention_as(_plain_flash_vjp),
            "control_drops_delta": plain_attention_as(_plain_drops_delta),
            "control_drops_diagonal": plain_attention_as(
                _plain_drops_diagonal)})
    if scan is not None:
        witness, control = SCAN_CHECKS[scan]
        runs.update({"witness_scan": plain_scan_as(scan, witness),
                     "control_drops_carry": plain_scan_as(scan, control)})
    out = {"plain_loss": ref_loss, "plain_grad_norm": ref_gn,
           "routings_pinned": len(record)}
    f32, sqs = None, {"plain": ref_sq}
    if lm.compute_dtype != lm.param_dtype and attn:   # the bf16 model
        runs["witness_sdpa"] = plain_attention_as(_sdpa_witness)
    if lm.compute_dtype != lm.param_dtype:
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


def _leaf_control(n):
    """A gated leaf's control: the dropped delta when its gradient comes
    only through ds (``DS_ONLY``: q's projections, k's alone), the dropped
    scan carry for a leaf that feeds a scan (``SCAN_FED``; an attention
    layer's q/k aside), the off-by-one mask for the rest (delta does not
    reach the head, nor a v projection)."""
    if n.endswith(DS_ONLY):
        return "drops_delta"
    return "drops_carry" if n.endswith(SCAN_FED) else "drops_diagonal"


def _assert_train_gate(out, grad_limit, norm, leaves, loss=None,
                       fp32=True):
    """The kernel's loss within TRAIN_REL of the plain code's. For the
    grad_norm (at ``norm = (limit, control)``, unless None), each leaf of
    ``leaves`` (at ``grad_limit``) and the loss (at ``loss``, a (limit,
    control) pair, if given): every witness under the limit, the control
    over it, the kernel under it; the bf16 model's grad_norm likewise
    against the fp32 code's (``fp32_*``), unless ``fp32`` is False. Each
    leaf's control: ``_leaf_control``."""
    assert out["kernel_loss_rel"] <= TRAIN_REL, out
    checks = ([("grad_norm_rel", *norm)] if norm else []) + [
        (f"{n}_rel_l2", grad_limit, _leaf_control(n)) for n in leaves] + (
        [("loss_rel", *loss)] if loss else [])
    for suffix, limit, control in checks:
        for key in out:
            if key.startswith("witness") and key.endswith(suffix):
                assert out[key] <= limit, (key, limit, out)
        assert out[f"control_{control}_{suffix}"] > limit, (suffix, out)
        assert out[f"kernel_{suffix}"] <= limit, (suffix, limit, out)
    if "fp32_grad_norm" in out and norm and fp32:
        # the bf16 model's grad_norm against the fp32 code's, at the same
        # limit: every correct bf16 code under it (the plain one too), the
        # control over it
        limit, control = norm
        for key, val in out.items():
            if key.startswith("fp32_") and key.endswith("_grad_norm_rel") \
                    and not key.startswith("fp32_control_"):
                assert val <= limit, (key, limit, out)
        assert out[f"fp32_control_{control}_grad_norm_rel"] > limit, out


def _flash_layers(cfg):
    """The flash calls of one forward: each layer whose mixer runs the
    flash kernels, and an encoder-decoder's encoder layers and decoder
    cross-attentions."""
    return sum(k in ("attn", "local", "mla") for k in cfg.layer_kinds) + \
        cfg.encoder_layers + (cfg.num_layers if cfg.encoder_layers else 0)


def _scan_bwd_times(lm, scan):
    """The scan's Function at the model's width, B=1, S=TRAIN_S, bf16
    seeded inputs: ms of its forward (the kernel) and of forward plus
    backward (the plain version recomputed under autograd), CUDA events,
    the median of 3 after a warm-up. -> {fwd_ms, fwd_bwd_ms, bwd_ms}."""
    import torch
    from repro_torch.kernels import rglru, ssd
    cfg, dt = lm.cfg, torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale) \
            .to(dt).requires_grad_()
    if scan == "ssd":
        sc = cfg.ssm
        P = sc.head_dim
        H = sc.expand * cfg.d_model // P
        G, N = sc.ngroups, sc.d_state
        dt = torch.rand((1, TRAIN_S, H), generator=g, device=DEVICE) * 0.1
        args = (rnd(1, TRAIN_S, H, P), dt.requires_grad_(),
                torch.zeros(H, device=DEVICE), rnd(1, TRAIN_S, G, N),
                rnd(1, TRAIN_S, G, N))
        fn = functools.partial(ssd.ssd_scan, D=torch.ones(H, device=DEVICE),
                               chunk=sc.chunk_size)
    else:
        D = cfg.rnn_width or cfg.d_model
        args = (rnd(1, TRAIN_S, D), torch.zeros(D, device=DEVICE),
                rnd(1, TRAIN_S, D), rnd(1, TRAIN_S, D))
        fn = functools.partial(rglru.rglru_scan, c=cfg.rglru_c)

    def fwd():
        with torch.no_grad():
            fn(*args)

    def fwd_bwd():
        y, _ = fn(*args)
        y.float().sum().backward()

    out = {}
    for key, f in (("fwd_ms", fwd), ("fwd_bwd_ms", fwd_bwd)):
        f()
        ts = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            f()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        out[key] = sorted(ts)[1]
    out["bwd_ms"] = out["fwd_bwd_ms"] - out["fwd_ms"]
    return out


def _train_batch(cfg, seed):
    """B=1 and TRAIN_S positions of seeded inputs, as the reference's
    train batch (``launch/specs.py`` ``batch_specs``): tokens; a vision
    model's ``vision_embeds`` [1,Nv,D] ahead of TRAIN_S - Nv tokens; an
    encoder-decoder's ``frames`` [1,TRAIN_S,D] beside TRAIN_S tokens (the
    frontend stubs' normal draws, std 0.02)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    nv = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, TRAIN_S - nv),
                                     generator=g, device=DEVICE)}
    if cfg.frontend != "none":
        key, n = ("vision_embeds", nv) if nv else ("frames", TRAIN_S)
        batch[key] = torch.randn((1, n, cfg.d_model), generator=g,
                                 device=DEVICE) * 0.02
    return batch


def _train_cfg(arch, layers, dtype):
    """The arch at full width and ``layers`` deep (an encoder-decoder's
    encoder too)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=layers, dtype=dtype, **(
        {"encoder_layers": layers} if cfg.encoder_layers else {}))


def _train_lm(layers, dtype, arch=TRAIN_ARCH):
    import torch
    from repro_torch.models.model import LM
    cfg = _train_cfg(arch, layers, dtype)
    lm = LM(cfg, device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(0))
    return lm, _train_batch(cfg, 1)


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
    """Digests of every leaf of a train state's params, m and v (a
    DTensor's local shard), and its step."""
    out = {"step": int(state["step"])}
    for part in ("params", "m", "v"):
        out.update({f"{part}.{n}": digest(getattr(t, "to_local", lambda: t)())
                    for n, t in state[part].items()})
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

    scan = spec.get("scan")
    lm, batch = _train_lm(spec["twin_layers"], "float32", arch)
    twin_attn = _flash_layers(lm.cfg)
    reset_kernel_counts()
    twin = _train_gate(lm, batch, spec["twin_leaves"], scan)
    twin_bwd = bwd_counts()
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name}: fp32 twin ({spec['twin_layers']} layers) step 1, relative "
        f"to the plain path {json.dumps(twin)}")

    gate_layers = spec.get("gate_layers", layers)
    lm, batch = _train_lm(gate_layers, "bfloat16", arch)
    gate_attn = _flash_layers(lm.cfg)
    reset_kernel_counts()
    gate = _train_gate(lm, batch, leaves, scan)
    gate_bwd = bwd_counts()
    if gate_layers != layers:
        del lm
        gc.collect()
        torch.cuda.empty_cache()
        lm, batch = _train_lm(layers, "bfloat16", arch)
    n_params = sum(p.numel() for p in lm.parameters())
    n_attn = _flash_layers(lm.cfg)
    log(f"{name}: {arch} at full width, {layers} layers, "
        f"{n_params / 1e9:.3f} B params; bf16 step 1 ({gate_layers} "
        f"layers), relative to the plain path {json.dumps(gate)}")

    # a second seeded batch, never trained on: its loss before the steps
    # and after them tells learning from memorising the one batch
    unseen = _train_batch(lm.cfg, 2)

    def unseen_loss():
        with torch.no_grad():
            return lm.loss(unseen)[0].item()
    unseen_losses = [unseen_loss()]
    cfg = _train_opt(spec)
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, cfg)
    digests = [state_digests(state)]     # the initial state, after step 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    state, steps = _timed_steps(name, step, state, batch, 1)
    digests.append(state_digests(state))    # outside the timed steps
    state, more = _timed_steps(name, step, state, batch, TRAIN_STEPS - 1)
    steps += more
    launches = kernel_counts()
    flash = flash_counts()
    flash_bwd = bwd_counts()
    ssd_kernels = ssd_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    unseen_losses.append(unseen_loss())    # after the counts are read
    log(f"{name}: loss on a second seeded batch, not trained on: "
        f"{unseen_losses[0]:.6f} before the steps, {unseen_losses[1]:.6f} "
        f"after {TRAIN_STEPS}")
    # one more step under the profiler, after the counts are read
    prof = log_profile(f"{name}: profiled step 4", profiled(
        lambda: step(state, batch), top_n=12))
    # remat runs each layer's forward twice a step, its kernel with it
    want = {"flash_attention_fwd": TRAIN_STEPS * 2 * n_attn,
            "flash_attention_bwd": TRAIN_STEPS * n_attn,
            "ssd_scan": TRAIN_STEPS * 2 * lm.cfg.layer_kinds.count("ssm"),
            "rglru_scan": TRAIN_STEPS * 2 * lm.cfg.layer_kinds.count("rec")}
    want_fwd, want_bwd = want["flash_attention_fwd"], \
        want["flash_attention_bwd"]
    ms = [r["ms"] for r in steps[1:]]
    if scan is not None:
        out["scan_bwd"] = _scan_bwd_times(lm, scan)
        log(f"{name}: the {scan} Function at the model's width, forward "
            f"and its plain-recompute backward {json.dumps(out['scan_bwd'])}")
    out.update(n_params=n_params, gate_layers=gate_layers, steps=steps,
               launches=launches,
               flash_launches_by_kernel=flash,
               flash_bwd_launches_by_route=flash_bwd,
               ssd_launches_by_kernel=ssd_kernels,
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
    assert launches == want, (launches, want)
    assert flash == {"tc": want_fwd, "fma": 0}, flash
    assert flash_bwd == {"tc": want_bwd, "fma": 0}, flash_bwd
    assert ssd_kernels == {"tc": want["ssd_scan"], "fma": 0}, ssd_kernels
    assert twin_bwd == {"tc": 0, "fma": twin_attn}, twin_bwd
    assert gate_bwd == {"tc": gate_attn, "fma": 0}, gate_bwd
    assert peak <= TRAIN_PEAK_GIB, peak
    assert bit_equal["initial_equal"] and bit_equal["control_caught"] \
        and not bit_equal["n_differing"], bit_equal
    _assert_train_gate(twin, GRAD_REL_L2_FP32, spec["twin_norm"], leaves)
    _assert_train_gate(gate, spec["grad_bf16"], spec["bf16_norm"],
                       spec["bf16_gated"], spec.get("bf16_loss"),
                       spec.get("fp32_norm", True))
    return out


ROOFLINE_WORKERS = 5     # host processes tracing the train paths' steps


def _train_opt(spec):
    """The ``OptConfig`` of a train path's measured steps (and of its
    ``roofline`` trace): the path's ``opt`` over lr 3e-4, no warmup."""
    from repro_torch.optim import adamw
    return adamw.OptConfig(lr=3e-4, warmup_steps=0, total_steps=100,
                           **spec.get("opt", {}))


def _embed_lookup_params(cfg):
    """The parameters of an untied embedding table: 6ND counts them, but
    looking rows up does no matmul (a tied table is the head too)."""
    return 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model


def start_roofline_traces():
    """Start the ``roofline`` phase's traces: ROOFLINE_WORKERS spawned host
    processes trace each train path's step on meta tensors
    (``launch.dryrun.run_cell``, world 1, the plain path, the path's
    ``OptConfig``) while the kernels build; they never touch the card. ->
    (pool, {path: future}); the caller shuts the pool down."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    shape = ShapeConfig("train-chip", TRAIN_S, 1, "train")
    pool = cf.ProcessPoolExecutor(ROOFLINE_WORKERS,
                                  mp_context=mp.get_context("spawn"))
    return pool, {n: pool.submit(dryrun.run_cell,
                                 _train_cfg(spec["arch"], spec["layers"],
                                            "bfloat16"),
                                 shape, mesh_shape=(1,), verbose=False,
                                 opt_cfg=_train_opt(spec))
                  for n, spec in TRAIN_PATHS.items()}


def phase_roofline(trains, traces):
    """For every train path: the reference's model FLOPs (6 N D, N from
    ``roofline.analysis.count_params``) at the depth, batch (B=1) and S
    that ``phase_train`` trained, the counter's FLOPs and bytes from a
    world-1 trace of the same step on meta tensors (``traces``, from
    ``start_roofline_traces``), the measured ms per step, MFU = model
    FLOPs / (step s x PEAK_BF16_FLOPS) and the same share of the matmul
    FLOPs (``mfu_matmul``: 6 N D less an untied embedding table's
    lookups, which 6 N D counts but no matmul does; the MFU to compare
    across paths, as deepseek-v2's layer 0 and internvl2-76b's one layer
    are 37% and 35% table), and the trace's predicted peak
    memory (arguments plus the peak of live temporaries) beside
    ``torch.cuda.max_memory_allocated``, with the card's name and power
    limit. Gates: both MFUs in (0, 1]; the counter sees at least the
    model's matmul FLOPs (deepseek-v2's layer 0 and internvl2-76b's one
    layer read a ``useful_ratio`` over 1 for their tables); the
    reference's ``useful_ratio`` (model FLOPs over the counter's) and the
    predicted peak beside the measured one are reported."""
    smi = nvidia_smi()
    out = {}
    bad = [(n, "the train phase failed") for n in TRAIN_PATHS
           if n not in trains]
    t0 = time.perf_counter()
    recs = {n: f.result() for n, f in traces.items() if n in trains}
    log(f"roofline: {len(recs)} traces read after a wait of "
        f"{time.perf_counter() - t0:.1f} s (traced on {ROOFLINE_WORKERS} host "
        f"processes from the start of the run)")
    for name, rec in recs.items():
        spec, tr = TRAIN_PATHS[name], trains[name]
        cfg = _train_cfg(spec["arch"], spec["layers"], "bfloat16")
        rl = rec["roofline"]
        mf = rl["model_flops_total"]
        n = rec["params"]["active" if cfg.moe is not None else "total"]
        matmul = mf * (1 - _embed_lookup_params(cfg) / n)
        step_s = tr["ms_per_step"] / 1e3
        row = dict(
            arch=spec["arch"], layers=spec["layers"], batch=1, seq=TRAIN_S,
            params=rec["params"], model_flops=mf,
            counter_flops=rec["cost"]["flops_per_dev"],
            counter_bytes=rec["cost"]["bytes_per_dev"],
            useful_ratio=rl["useful_ratio"],
            matmul_useful_ratio=matmul / rec["cost"]["flops_per_dev"],
            ms_per_step=tr["ms_per_step"],
            mfu=mf / (step_s * PEAK_BF16_FLOPS),
            mfu_matmul=matmul / (step_s * PEAK_BF16_FLOPS),
            bound_ms=dict(compute=rl["compute_s"] * 1e3,
                          memory=rl["memory_s"] * 1e3),
            predicted_peak_gib=rec["memory"]["per_device_total"] / 2**30,
            measured_peak_gib=tr["peak_allocated_gib"],
            trace_s=rec["trace_s"], card=smi)
        out[name] = row
        log(f"roofline {name}: {spec['arch']} at {spec['layers']} layers, "
            f"B=1, S={TRAIN_S}: model FLOPs {mf:.4e}, the counter's "
            f"{row['counter_flops']:.4e} FLOPs and {row['counter_bytes']:.4e}"
            f" bytes (useful_ratio {row['useful_ratio']:.4f}, on matmuls "
            f"{row['matmul_useful_ratio']:.4f}), {row['ms_per_step']:.3f} ms "
            f"per step, MFU {row['mfu']:.4f} (on matmuls "
            f"{row['mfu_matmul']:.4f}); peak predicted "
            f"{row['predicted_peak_gib']:.2f} GiB, measured "
            f"{row['measured_peak_gib']:.2f} GiB; trace "
            f"{row['trace_s']:.1f} s; {smi}")
        if not (0 < row["mfu"] <= 1 and 0 < row["mfu_matmul"] <= 1) \
                or row["matmul_useful_ratio"] > 1:
            bad.append((name, row))
    if bad:
        raise AssertionError(f"roofline: {bad}")
    return out


# dist-train: deepseek-moe-16b at full width on a world-1 ("data",
# "model") = (1, 1) mesh, 4 layers (1 dense + 3 MoE): 2.267 B params, 33.8
# GiB of state at 16 B/param, 8.4 GiB more if the gather to the LM's
# compute tensors copied at world 1 (it aliases the state's storage)
DIST_ARCH, DIST_LAYERS = "deepseek-moe-16b", 4
DIST_TIMEOUT_S = 300     # a collective's longest wait; a spawned rank's join
# dist-ep's checks (``_dist_ep_rank``, in dist-tp's spawn): the four ranks'
# (1, 4) mesh, one MoE layer of deepseek-moe-16b at full width over 2048
# seeded tokens
DIST_EP_TOKENS = 2048
DIST_EP_REL_L2 = 1e-5    # fp32, no drops: EP against the local path
# fp32 at a capacity factor where EP drops copies at both of its capacities
# (C_send and C_loc): the card's EP against the same EP on CPU copies
DIST_EP_LOW_CF = 0.5
DROP_KEYS = ("copies", "dropped_send", "dropped")


@contextmanager
def process_group(backend):
    """A world-1 process group in this process, its rendezvous a file
    under build/, a collective's wait bounded by DIST_TIMEOUT_S."""
    import datetime
    import os
    import torch.distributed as dist
    path = ROOT / "build" / f"pg_{backend}_{os.getpid()}"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    dist.init_process_group(
        backend, init_method=f"file://{path}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()
        path.unlink(missing_ok=True)


def _timed_steps(name, step, state, batch, n=TRAIN_STEPS, quiet=False):
    """``n`` steps of ``step`` -> (state, one record a step: loss, aux,
    grad_norm, lr, ms by CUDA events and by the host clock), each logged
    unless ``quiet``."""
    import torch
    rows = []
    # a CPU rehearsal in spawned ranks (which see no patches) has no events
    on_card = next(iter(batch.values())).is_cuda
    for _ in range(n):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        if on_card:
            e0.record()
        state, met = step(state, batch)
        if on_card:
            e1.record()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3
        rows.append(dict(step=int(state["step"]), loss=met["loss"].item(),
                         grad_norm=met["grad_norm"].item(),
                         aux=met["aux"].item(), lr=met["lr"].item(),
                         ms=e0.elapsed_time(e1) if on_card else host_ms,
                         host_ms=host_ms))
        r = rows[-1]
        if quiet:
            continue
        log(f"{name}: step {r['step']}: loss {r['loss']:.6f} (aux "
            f"{r['aux']:.6f}), grad_norm {r['grad_norm']:.6f}, lr "
            f"{r['lr']:.3e}, {r['ms']:.3f} ms (CUDA events; host clock "
            f"{r['host_ms']:.3f} ms)")
    return state, rows


def phase_dist_train():
    """The train step on a mesh at world size 1: deepseek-moe-16b at full
    width and DIST_LAYERS layers (fp32 params, bf16 compute, full remat),
    B=1, S=TRAIN_S. TRAIN_STEPS AdamW steps without a mesh from the seeded
    state; then, from the same state built again, a world-1 NCCL process
    group, the ("data", "model") = (1, 1) mesh, ``remesh_state(state,
    logical, None, mesh)`` and the same steps through the mesh-aware
    ``make_train_step`` under ``partition.activate(mesh)``, the counts set
    to 0 just before. Every leaf of params, m and v after the steps must
    equal the unsharded run's bit for bit (64-bit digests), the losses
    too; every flash launch on ``tc``. Reports ms per step and the peak
    of both runs, and whether the LM's compute tensors alias the state's
    storage."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import remesh_state
    from repro_torch.sharding import partition as part
    opt = adamw.OptConfig(lr=3e-4, warmup_steps=0, total_steps=100)
    out = {"arch": DIST_ARCH, "layers": DIST_LAYERS, "seq": TRAIN_S,
           "batch": 1, "mesh": [1, 1]}

    lm, batch = _train_lm(DIST_LAYERS, "bfloat16", DIST_ARCH)
    out["n_params"] = sum(p.numel() for p in lm.parameters())
    state = adamw.init_state(lm)
    initial = state_digests(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, plain = _timed_steps("dist-train: unsharded", adamw.make_train_step(
        lm, opt), state, batch)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    want = state_digests(state)
    del state, lm
    gc.collect()
    torch.cuda.empty_cache()

    with process_group("nccl" if DEVICE == "cuda" else "gloo"):
        mesh = make_mesh((1, 1), ("data", "model"), device=DEVICE)
        lm, batch = _train_lm(DIST_LAYERS, "bfloat16", DIST_ARCH)
        with part.activate(mesh):
            state = remesh_state(adamw.init_state(lm),
                                 adamw.state_logical(lm), None, mesh)
            again = state_digests(state)
            step = adamw.make_train_step(lm, opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_counts()
            state, meshed = _timed_steps("dist-train: on the mesh", step,
                                         state, batch)
            launches = kernel_counts()
            flash, flash_bwd = flash_counts(), bwd_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            aliased = all(
                p.data_ptr() == state["params"][n].to_local().data_ptr()
                for n, p in lm.named_parameters())
            got = state_digests(state)
        del state, step, lm
        gc.collect()
        torch.cuda.empty_cache()
    differ = [k for k, d in want.items() if got[k] != d]
    ms = [r["ms"] for r in meshed[1:]]
    ms_plain = [r["ms"] for r in plain[1:]]
    out.update(unsharded_steps=plain, mesh_steps=meshed,
               ms_per_step=sum(ms) / len(ms),
               unsharded_ms_per_step=sum(ms_plain) / len(ms_plain),
               peak_allocated_gib=peak,
               unsharded_peak_allocated_gib=plain_peak,
               compute_tensors_alias_state=aliased, launches=launches,
               flash_launches_by_kernel=flash,
               flash_bwd_launches_by_route=flash_bwd,
               bit_equal=dict(leaves=len(want) - 1, n_differing=len(differ),
                              differing=differ[:10],
                              initial_equal=initial == again))
    log(f"dist-train: {DIST_ARCH} at {DIST_LAYERS} layers, "
        f"{out['n_params'] / 1e9:.3f} B params: {out['ms_per_step']:.3f} ms "
        f"per step on the (1, 1) mesh against "
        f"{out['unsharded_ms_per_step']:.3f} unsharded (steps 2-3, CUDA "
        f"events); peak {peak:.2f} GiB against "
        f"{plain_peak:.2f}; compute tensors alias the state: {aliased}; "
        f"launches {json.dumps(launches)}, flash by kernel "
        f"{json.dumps(flash)}, backward by route {json.dumps(flash_bwd)}; "
        f"every leaf against the unsharded run: "
        f"{json.dumps(out['bit_equal'])}")
    n_fwd, n_bwd = TRAIN_STEPS * 2 * DIST_LAYERS, TRAIN_STEPS * DIST_LAYERS
    assert out["bit_equal"]["initial_equal"] and not differ, out["bit_equal"]
    assert [r["loss"] for r in meshed] == [r["loss"] for r in plain]
    assert flash == {"tc": n_fwd, "fma": 0}, flash
    assert flash_bwd == {"tc": n_bwd, "fma": 0}, flash_bwd
    assert launches["flash_attention_fwd"] == n_fwd, launches
    assert peak <= TRAIN_PEAK_GIB, peak
    return out


def _dist_ep_rank(rank, world, device, base, T):
    """One of the ranks sharing the card through gloo: one MoE
    layer of deepseek-moe-16b at full width on a (1, world) mesh.
    fp32 at capacity factor 8 (no drops): the local path on rank 0 (y,
    aux, every gradient under one seeded cotangent; aux also per token
    slice, as EP defines it); EP as it routes (y, aux, its routing); EP
    replaying the local run's routing (y, aux, every gradient summed over
    the mesh). fp32 at DIST_EP_LOW_CF, where EP drops copies: EP as it
    routes, then on CPU copies of its inputs replaying that routing through
    the same group (y, aux, the drop counts). bf16 at 1.25: the share of
    copies dropped on both paths. Rank 0 returns the readings; the timings are every rank's, of a
    second call after a first that warms up (host clock after a
    synchronise; the exchange goes through the host)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import flatten_paths, init_params, \
        tree_map
    from repro_torch.sharding import partition as part
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh((1, world), ("data", "model"), device=device)
    group = mesh.get_group("model")
    K, E = base.moe.top_k, base.moe.num_experts
    Ts = T // world
    out = {"rank": rank, "timing": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def clock(key, fn, reset):
        """``fn`` once to warm up, ``reset()``, then ``fn`` timed."""
        fn()
        reset()
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        out["timing"][key] = (time.perf_counter() - t0) * 1e3
        return r

    def setup(dtype, cf):
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=cf))
        g = torch.Generator(device=dev).manual_seed(0)
        p = init_params(MOE.moe_def(cfg), g, torch.float32, dev)
        x = torch.randn((1, T, cfg.d_model), generator=g, device=dev).to(dtype)
        dy = torch.randn((1, T, cfg.d_model), generator=g,
                         device=dev).to(dtype)
        return cfg, p, x, dy

    def leaves(p):
        return dict(flatten_paths(p))

    def with_grad(p):
        for t in leaves(p).values():
            t.requires_grad_(True)
            t.grad = None
        return p

    # ---- fp32, capacity factor 8 -----------------------------------------
    cfg, p, x, dy = setup(torch.float32, 8.0)
    eidx_loc = torch.empty((T, K), dtype=torch.int64, device=dev)
    if rank == 0:
        rec = []
        with_grad(p)
        xg = x.clone().requires_grad_()

        def local():
            with pinned_routing(rec):
                y, aux = MOE.moe_apply(cfg, p, xg)
            (y * dy).sum().backward()
            return y.detach(), aux.detach()
        def reset():
            with_grad(p)
            xg.grad = None
            rec.clear()
        y_loc, aux_loc = clock("local_fwd_bwd_ms", local, reset)
        g_loc = {n: t.grad.clone() for n, t in leaves(p).items()}
        g_loc["x"] = xg.grad.clone()
        eidx_loc.copy_(rec[0])
        with torch.no_grad():
            aux_slices = torch.stack([MOE.moe_apply(
                cfg, p, x[:, i * Ts:(i + 1) * Ts])[1] for i in range(world)])
    dist.broadcast(eidx_loc, src=0)

    with part.activate(mesh):
        rec = []
        with torch.no_grad(), pinned_routing(rec):
            y_ep, aux_ep = clock("ep_fwd_ms",
                                 lambda: MOE.moe_apply(cfg, p, x), rec.clear)
        slices = [torch.empty_like(rec[0]) for _ in range(world)]
        dist.all_gather(slices, rec[0].contiguous(), group=group)
        eidx_ep = torch.cat(slices)[:T]
        with_grad(p)
        xg = x.clone().requires_grad_()

        idx = mesh.get_local_rank("model")

        def pinned():           # the local run's rows of this token slice
            with pinned_routing([eidx_loc[idx * Ts:(idx + 1) * Ts]]):
                y, aux = MOE.moe_apply(cfg, p, xg)
            (y * dy).sum().backward()
            return y.detach(), aux.detach()
        def reset():
            with_grad(p)
            xg.grad = None
        y_pin, aux_pin = clock("ep_fwd_bwd_ms", pinned, reset)
        g_ep = {}
        for n, t in leaves(p).items():
            g = t.grad.clone()
            dist.all_reduce(g, group=group)
            g_ep[n] = g
        g_ep["x"] = xg.grad
    if rank == 0:
        pairs = torch.arange(T * K, device=dev) // K * E
        a = set((pairs + eidx_loc.reshape(-1)).tolist())
        b = set((pairs + eidx_ep.reshape(-1)).tolist())
        agree = (eidx_ep == eidx_loc).all(1)
        out.update(
            assign_diff_share=len(a ^ b) / (len(a) + len(b)),
            rows_routed_alike=int(agree.sum()),
            y_rel_l2_rows_alike=_rel(y_ep[0][agree], y_loc[0][agree]),
            aux_ep=float(aux_ep), aux_local_per_slice=float(
                aux_slices.mean()), aux_local_whole=float(aux_loc),
            aux_rel=abs(float(aux_ep) - float(aux_slices.mean())) /
            float(aux_slices.mean()),
            pinned_y_rel_l2=_rel(y_pin, y_loc),
            pinned_aux_rel_to_whole=abs(float(aux_pin) - float(
                aux_slices.mean())) / float(aux_slices.mean()),
            pinned_grad_rel_l2={n: _rel(g_ep[n], g_loc[n]) for n in g_loc})
        del g_loc
    del g_ep, p

    def drops(c):
        """EP's drop counts summed over the ranks."""
        v = torch.stack([torch.as_tensor(c.get(k, 0), device=dev)
                         for k in DROP_KEYS]).float()
        dist.all_reduce(v, group=group)
        return dict(zip(DROP_KEYS, v.tolist()))

    # ---- fp32 at DIST_EP_LOW_CF: the drop path, the card against the CPU --
    cfg, p, x, _ = setup(torch.float32, DIST_EP_LOW_CF)
    with torch.no_grad(), part.activate(mesh):
        rec = []
        with pinned_routing(rec), MOE.drop_counts() as c:
            y_card, aux_card = MOE.moe_apply(cfg, p, x)
        card = drops(c)
        # the same routing replayed on CPU copies, through the same group
        with pinned_routing([rec[0].cpu()]), MOE.drop_counts() as c:
            y_cpu, aux_cpu = MOE.moe_apply(cfg, tree_map(
                lambda t: t.cpu(), p), x.cpu())
        cpu = drops(c)
    if rank == 0:
        out["low_cf"] = dict(
            capacity_factor=DIST_EP_LOW_CF, drops_card=card, drops_cpu=cpu,
            y_finite=bool(torch.isfinite(y_card).all()),
            y_rel_l2_to_cpu=_rel(y_card.cpu(), y_cpu),
            aux_rel_to_cpu=abs(float(aux_card) - float(aux_cpu)) /
            abs(float(aux_cpu)))
    del p, y_card, y_cpu

    # ---- bf16, capacity factor 1.25: the copies each path drops ------------
    cfg, p, x, _ = setup(torch.bfloat16, 1.25)
    with torch.no_grad():
        if rank == 0:
            with MOE.drop_counts() as c:
                MOE.moe_apply(cfg, p, x)
            out["local_drop_share"] = float(c["dropped"]) / (T * K)
        with part.activate(mesh):
            def ep():
                with MOE.drop_counts() as c:
                    MOE.moe_apply(cfg, p, x)
                return c
            c = drops(clock("ep_fwd_bf16_ms", ep, lambda: None))
    if rank == 0:
        out["ep_send_drop_share"] = c["dropped_send"] / (T * K)
        out["ep_drop_share"] = (c["dropped_send"] + c["dropped"]) / (T * K)
    return out


# dist-tp: tensor-parallel train steps (``sharding/tp.py``) on DIST_TP_WORLD
# gloo ranks sharing the card, a (1, 4) ("data", "model") mesh, B=1,
# S=TRAIN_S. deepseek-7b at full width, 4 of its 30 layers: 8 of 32 heads,
# 2752 of 11008 ffn columns and 25600 of 102400 vocabulary rows a rank;
# 1.65 B params (the two vocabulary tables 0.84 B), some 20 GB of fp32
# state (params, m, v) over the four ranks. gemma3-1b at full width, one
# period (6 layers, 5 local + 1 global): one of 4 q heads a rank beside its
# one kv head, gathered; the tied 262144-row table 65536 a rank
DIST_TP_WORLD = 4
DIST_TP_PATHS = (("deepseek-7b", 4), ("gemma3-1b", 6))
DIST_TP_STEPS = {"float32": 2, "bfloat16": 2}
DIST_TP_LOSS_REL = 1e-4  # fp32 step 1's loss: the forward keeps its digits
# step 1's loss and grad_norm (and, in fp32, each later step's loss) of each
# code against the fp32 unsharded step on the same weights and batch, by
# path and dtype. At full width and random init deepseek-7b's gradient
# keeps few digits: its sums taken in parts (a witness) move its norm 1.7%
# in fp32, 27% in bf16; gemma3-1b's keeps them, and so does
# deepseek-v2-236b's layer 0; deepseek-moe-16b's (4 layers, the routing
# replayed) keeps fewer: 8.4% in fp32 under the witness, 7.0% split;
# recurrentgemma-9b's (one period) keeps its digits (the witness moves the
# loss 1.3e-7, grad_norm not at all), mamba2-2.7b's (4 layers) most (its
# grad_norm 1.6e-5 under the witness, 7.3e-6 split); seamless-m4t-large-v2's
# at 1 + 1 layers, without clipping (no grad_norm), all of its loss: 0
# under the witness and split, and its ``m`` 0.062 of its limit where the
# control's is 17761 times over (an H100).
# Each limit sits between
# the witnesses and the control as read on an H100 (PERF.md §6), and each
# run reads them again
DIST_TP_REL = {("deepseek-7b", "float32"): 0.1,
               ("deepseek-7b", "bfloat16"): 0.5,
               ("gemma3-1b", "float32"): 1e-3,
               ("gemma3-1b", "bfloat16"): 1e-2,
               ("deepseek-moe-16b", "float32"): 0.1,
               ("deepseek-v2-236b", "float32"): 1e-3,
               ("recurrentgemma-9b", "float32"): 1e-3,
               ("mamba2-2.7b", "float32"): 1e-3,
               ("seamless-m4t-large-v2", "float32"): 1e-3}
# the fp32 gradient, leaf by leaf: ``m`` after step 1 is (1 - b1) x the
# gradient, and each rank's shard of each leaf is held against the same cut
# of the unsharded step's ``m`` by relative L2 (the worst shard). Each
# leaf's distance must stay within DIST_TP_M_MULT times the witness's on
# that leaf (the unsharded step with the split step's sums in parts: a
# correct code that differs in order alone, which reads how many digits
# that leaf's gradient keeps) plus DIST_TP_M_FLOOR of the path; the control
# (the norms ahead of the split blocks summed again over "model", which
# multiplies their gradients by the model axis) must not. Both are read
# each run (PERF.md §6)
DIST_TP_M_MULT = 1.25
DIST_TP_M_FLOOR = {"deepseek-7b": 1e-2, "gemma3-1b": 1e-4,
                   "deepseek-moe-16b": 1e-2, "deepseek-v2-236b": 1e-4,
                   "recurrentgemma-9b": 1e-4, "mamba2-2.7b": 1e-4,
                   "seamless-m4t-large-v2": 1e-4}


# dist-tp serving, after each path's train steps in each dtype, on the same
# (1, 4) mesh through ``launch.specs.build_fn``: DIST_TP_PROMPTS prompts
# (B=1 each) prefilled into caches of DIST_TP_CAPACITY slots, stacked into
# one batch of 4, then DIST_TP_DECODE decode steps; deepseek-7b's cache
# splits its 32 kv heads over "model" (8 a rank), gemma3-1b's MQA cache and
# 512-slot ring their slots over ("data", "model"). Against the unsharded
# prefill and decode on the same weights: in fp32 (the FMA flash kernels)
# greedy, every token equal and every call's logits within
# DIST_TP_SERVE_REL; in bf16 teacher-forced on the unsharded bf16 run's
# tokens, every call's logits within DIST_TP_SERVE_REL, a limit between the
# witness (the unsharded run with the split run's sums in parts) and the
# control (gemma3-1b: the combine's all-reduce dropped; deepseek-7b, whose
# cache combines nothing: the attention's all-reduce dropped; it decodes
# DIST_TP_CONTROL_DECODE steps), both read each run. Random-init
# deepseek-7b keeps few fp32 digits in its logits as in its gradient: the
# witness moves them 8.5e-4 (PERF.md §6). Random-init deepseek-moe-16b
# keeps fewer in bf16: with the routing replayed its teacher-forced decode
# logits move 0.56 under the witness, 0.64 split, 1.42 under the control
# (an H100), so its bf16 limit is 1.0; its fp32 witness moves them 3.7e-4.
# The scan paths' bf16 logits: recurrentgemma-9b's move 8.0e-3 under the
# witness, 0.46 under its control (the RG-LRU block's all-reduce dropped);
# mamba2-2.7b's 5.0e-2 and 0.71 (the gated norm's sum over heads dropped),
# so its limit is 0.2. Random-init seamless-m4t-large-v2's bf16 logits
# keep no digit (``logits-seamless`` reads its whole model's at 0.69 under
# the witness): at 2 + 2 layers the witness moves them 0.5635, the split
# run as much (it matches the witness's sums), and the control (the
# cross-attention's all-reduce dropped) 0.7846 (an H100), so its limit is
# 0.7
DIST_TP_PROMPTS = (2048, 1024, 512, 256)
DIST_TP_CAPACITY = 2304
DIST_TP_DECODE = 4       # 8 until dist-tp's scan paths took their time
DIST_TP_CONTROL_DECODE = 2
DIST_TP_SERVE_REL = {("deepseek-7b", "float32"): 2e-3,
                     ("deepseek-7b", "bfloat16"): 0.1,
                     ("gemma3-1b", "float32"): 1e-4,
                     ("gemma3-1b", "bfloat16"): 0.1,
                     ("deepseek-moe-16b", "float32"): 2e-3,
                     ("deepseek-moe-16b", "bfloat16"): 1.0,
                     ("deepseek-v2-236b", "bfloat16"): 0.1,
                     ("recurrentgemma-9b", "bfloat16"): 0.1,
                     ("mamba2-2.7b", "bfloat16"): 0.2,
                     ("seamless-m4t-large-v2", "bfloat16"): 0.7}
# dist-tp's MoE paths, a second spawn of the four ranks on the same (1, 4)
# mesh, EP and TP both over "model", at full width. deepseek-moe-16b at 4 of
# its 28 layers (1 dense + 3 MoE), trained and served: a rank holds 4 of 16
# heads (and kv heads: its cache's heads over "model"), 16 of 64 experts,
# 2736 of 10944 dense and 704 of 2816 shared columns and 25600 of 102400
# vocabulary rows; 2.3 B params, some 36 GB of fp32 state over the ranks.
# deepseek-v2-236b trained at its layer 0 alone (MLA + dense, 1.39 B: two
# layers with an MoE one would take 86 GB of fp32 state) and served at 2 of
# 60 (5.36 B params, some 21 GB of fp32 weights over the ranks): 32 of 128
# MLA heads (the flash kernels at [1,S,32,192]) and 40 of 160 experts a
# rank, its ckv/kpe cache split by sequence. Trained in fp32 with the dense
# paths' fp32 gates (the control also sums MLA's q_norm and kv_norm again),
# served in bf16 teacher-forced with their bf16 gate (the control: an
# all-reduce dropped, or the combine's) over DIST_TP_MOE_DECODE steps. Each
# code replays the unsharded run's routing (``pinned_routing``), and the
# share of step 1's (or a serving run's) rows its own router would have
# routed otherwise is recorded. At a capacity factor DIST_TP_MOE_CF of the
# model axis or more, EP drops no copy before its exchange, and a local
# expert's capacity (C_loc) is the local path's (C) up to their rounding
# to 4 rows (equal at every deepseek-v2-236b prompt here), both keeping an
# expert's first copies in token order: where they agree, the two paths
# drop the same copies. Each run counts its drops, and the split run must
# drop as many as the unsharded one (random-init deepseek-v2-236b routes
# enough of a long prompt's tokens to a few experts that both drop
# copies; dist-ep's checks hold EP's drops). deepseek-moe-16b also serves
# in fp32 (greedy tokens equal):
# its random-init bf16 decode keeps few digits. dist-ep's checks of one MoE
# layer (``_dist_ep_rank``) run after the paths, in the same spawn, whose
# join waits DIST_TP_JOIN_S
DIST_TP_MOE_PATHS = (("deepseek-moe-16b", 4, 4, ("float32", "bfloat16")),
                     ("deepseek-v2-236b", 1, 2, ("bfloat16",)))
DIST_TP_MOE_CF = 4.0
DIST_TP_MOE_STEPS = {"float32": 2}
DIST_TP_MOE_DECODE = 4
DIST_TP_JOIN_S = 2 * DIST_TIMEOUT_S
# dist-tp's scan paths, in the same spawn after the dense ones, at full
# width: recurrentgemma-9b at one period (rec, rec, local: 3 of 38
# layers), a rank holding 1024 of 4096 RNN channels (the RG-LRU kernel at
# [1,S,1024]), 4 of 16 RNN heads, 4 of 16 q heads beside its one kv head
# (gathered), 3072 of 12288 ffn columns and 64000 of 256000 vocabulary
# rows (1.64 B params in all); mamba2-2.7b at 4 of 64 layers, a rank
# holding 20 of 80 SSD heads (the SSD kernels at [1,S,20,64], N=128) and
# 12608 of 50432 vocabulary rows. Each trained in fp32 with the dense
# paths' fp32 gates, whose control is the path's own (its key): the RG-LRU
# block's wo all-reduce dropped, or the gated norm's sum of squares taken
# over this rank's heads alone (``_scan_unsummed``); served in bf16,
# teacher-forced, over DIST_TP_SCAN_DECODE steps with the same control
DIST_TP_SCAN_PATHS = (("recurrentgemma-9b", 3, "rec"),
                      ("mamba2-2.7b", 4, "ssm"))
DIST_TP_SCAN_DECODE = 4
# dist-tp's encoder-decoder path, in the same spawn after the scan ones, at
# full width: seamless-m4t-large-v2 trained at 1 + 1 layers (encoder,
# decoder) in fp32 without clipping, as train-encdec steps, on
# TRAIN_S frames and tokens, and served in bf16 at 2 + 2 layers over
# frontend_tokens (4096) seeded frames a prompt. A rank holds 4 of the 16
# heads and kv heads of the encoder's self-attention, the decoder's
# self-attention and its cross-attention (the flash kernels at
# [1,S,4,64], the cross-attention over the frames), 2048 of 8192 ffn
# columns and a quarter of the tied vocabulary; its self and cross caches
# keep their kv heads over "model". The control, trained and served: the
# cross-attention's all-reduce dropped (``_cross_unsummed``)
DIST_TP_ENCDEC_PATHS = (("seamless-m4t-large-v2", 1, 2, "cross"),)


def _stack_caches(caches, axes):
    """Caches of B=1 (plain tensors, or DTensors whose batch dim is not
    split) stacked along each leaf's batch dim."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding import partition as part

    def cat(ax, *ts):
        d = list(ax).index("batch")
        if isinstance(ts[0], DTensor):
            return DTensor.from_local(
                torch.cat([t.to_local() for t in ts], d), ts[0].device_mesh,
                ts[0].placements, run_check=False)
        return torch.cat(ts, d)
    return part.map_specs(cat, axes, *caches)


def _cache_gib(cache):
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layers import flatten_paths
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for _, t in flatten_paths(cache)) / 2**30


@contextmanager
def _decode_in_parts(n):
    """``ops.attention_decode`` over the cache's slots in ``n`` parts,
    each part's partial softmax combined in order: the combine's sums of
    the split decode, taken in one process. With ``_sums_in_parts`` the
    serving witness."""
    import torch
    from repro_torch.kernels import ops
    real = ops.attention_decode

    def parted(q, k, v, lengths, *, window=0, softcap=0.0, scale=None,
               slot_positions=None):
        B, S = k.shape[:2]
        pos = (torch.arange(S, device=q.device)[None].expand(B, S)
               if slot_positions is None else slot_positions)
        step = S // n
        parts = [ops.attention_decode_partial(
            q, k[:, i:i + step], v[:, i:i + step], lengths, window=window,
            softcap=softcap, scale=scale, slot_positions=pos[:, i:i + step])
            for i in range(0, S, step)]
        top = torch.stack([p[1] for p in parts]).amax(0)
        c = [torch.exp(p[1] - top) for p in parts]
        o = sum(p[0] * ci[:, None, :, None] for p, ci in zip(parts, c))
        lsum = sum(p[2] * ci for p, ci in zip(parts, c))
        return (o / lsum[:, None, :, None]).to(q.dtype)
    ops.attention_decode = parted
    try:
        yield
    finally:
        ops.attention_decode = real


def _norms_summed_again(partial_over_model):
    """``partition.partial_over_model`` that also names the norms ahead of
    a split block (``ln1``, ``ln2``, ``final_norm``, and MLA's ``q_norm``
    and ``kv_norm``, ahead of its copy-to-region): their whole gradients
    summed over "model" once more. The fp32 gradient's control."""
    def rule(plan, block, leaf):
        return partial_over_model(plan, block, leaf) or (
            plan is not None and block is None and leaf in ("scale", "bias")
        ) or (plan is not None and block == "mla" and
              leaf in ("q_norm", "kv_norm"))
    return rule


@contextmanager
def _sums_in_parts(n):
    """The unsharded step with the split step's order of sums, in one
    process: each column-parallel product (q, k and v where the kv heads
    split, MLA's wq_b and wkv_b, the MLPs' and the shared experts' wi*,
    the logits, the RG-LRU block's wx and wg, Mamba-2's in_proj, the
    cross-attention's wq, and its wk and wv of the encoder output) taken as
    ``n`` column groups, so that the backward sums ``n`` partial input
    gradients, and each row-parallel one (attention's, MLA's, the MLPs',
    the shared experts', the RG-LRU block's and the cross-attention's wo,
    Mamba-2's out_proj) as
    ``n`` partial products summed in fp32, each rounded to the compute
    dtype first; Mamba-2's gated norm sums its squares in ``n`` parts. A
    correct code that differs from the unsharded one in order alone: the
    witness of the split step's gates."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import rglru as REC
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import apply_norm, apply_rope, \
        conv_history

    def cols(x, w, split=True):
        k = w.shape[-1] // n if split else w.shape[-1]
        return torch.cat([x @ w[..., i:i + k].to(x.dtype)
                          for i in range(0, w.shape[-1], k)], -1)

    def rows(o, w):
        k = o.shape[-1] // n
        ys = [o[..., i * k:(i + 1) * k] @ w[i * k:(i + 1) * k].to(o.dtype)
              for i in range(n)]
        return torch.stack(ys).float().sum(0).to(o.dtype)

    def qkv(cfg, p, x, positions, rope=True, tp=None):
        B, S, _ = x.shape
        H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kv = Kh % n == 0
        q = cols(x, p["wq"]).reshape(B, S, H, hd)
        k = cols(x, p["wk"], kv).reshape(B, S, Kh, hd)
        v = cols(x, p["wv"], kv).reshape(B, S, Kh, hd)
        if cfg.qk_norm:
            q = A._rms_head(q, p["q_norm"], cfg.norm_eps)
            k = A._rms_head(k, p["k_norm"], cfg.norm_eps)
        if rope:
            q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
        return q, k, v

    def attn_core(cfg, p, q, k, v, *, kind="attn", causal=True, impl=None,
                  tp=None):
        B, S, H, hd = q.shape
        o = ops.attention(q, k, v, causal=causal, window=A._window(cfg, kind),
                          softcap=cfg.attn_logit_softcap, impl=impl)
        return rows(o.reshape(B, S, H * hd), p["wo"])

    def apply_mlp(cfg, p, x, tp=None):
        if "wi" in p:       # the plain gelu MLP (seamless-m4t's)
            return rows(F.gelu(cols(x, p["wi"]), approximate="tanh"),
                        p["wo"])
        g = cols(x, p["wi_gate"])
        g = F.silu(g) if cfg.mlp_kind == "swiglu" else \
            F.gelu(g, approximate="tanh")
        return rows(g * cols(x, p["wi_up"]), p["wo"])

    def logits(self, x, tp=None):
        cfg = self.cfg
        x = apply_norm(cfg, M.params_tree(self.final_norm), x)
        w = self.embed.T if cfg.tie_embeddings else self.head
        out = cols(x, w.to(self.compute_dtype))
        if cfg.logits_softcap > 0:
            out = torch.tanh(out / cfg.logits_softcap) * cfg.logits_softcap
        return out

    def shared(p, xf, tp=None):
        sp = p["shared"]
        return rows(F.silu(cols(xf, sp["wi_gate"])) * cols(xf, sp["wi_up"]),
                    sp["wo"])

    def mla_prefill(cfg, p, x, positions, *, capacity=None, impl=None,
                    tp=None):
        m = cfg.mla
        B, S, _ = x.shape
        H, nope, v = cfg.num_heads, m.qk_nope_head_dim, m.v_head_dim
        qk_head = nope + m.qk_rope_head_dim
        if m.q_lora_rank:
            qa = A._rms_head(x @ p["wq_a"].to(x.dtype), p["q_norm"],
                             cfg.norm_eps)
            q = cols(qa, p["wq_b"])
        else:
            q = cols(x, p["wq"])
        q = q.reshape(B, S, H, qk_head)
        q_pe = apply_rope(q[..., nope:], positions, 1.0, cfg.rope_theta)
        c, kpe = A._mla_ckv(cfg, p, x, positions)
        kv = cols(c, p["wkv_b"]).reshape(B, S, H, nope + v)
        q = torch.cat([q[..., :nope], q_pe], -1)
        k = torch.cat([kv[..., :nope], kpe[:, :, None].expand(q_pe.shape)],
                      -1)
        vp = F.pad(kv[..., nope:], (0, qk_head - v))
        o = ops.attention(q, k, vp, causal=True, scale=qk_head ** -0.5,
                          impl=impl)[..., :v]
        y = rows(o.reshape(B, S, H * v), p["wo"])
        return y, (A.mla_prefill_cache(c, kpe, capacity)
                   if capacity is not None else None)

    def xattn_kv(cfg, p, enc_out, tp=None):
        B, Se, _ = enc_out.shape
        kv = cfg.num_kv_heads % n == 0
        shape = (B, Se, cfg.num_kv_heads, cfg.head_dim)
        return (cols(enc_out, p["wk"], kv).reshape(shape),
                cols(enc_out, p["wv"], kv).reshape(shape))

    def xattn_forward(cfg, p, x, k, v, *, impl=None, tp=None):
        B, S, _ = x.shape
        q = cols(x, p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
        o = ops.attention(q, k, v, causal=False, impl=impl)
        return rows(o.reshape(B, S, cfg.q_dim), p["wo"])

    def xattn_decode(cfg, p, x, cache, tp=None):
        B = x.shape[0]
        q = cols(x, p["wq"]).reshape(B, 1, cfg.num_heads, cfg.head_dim)
        Se = cache["xk"].shape[1]
        lengths = torch.full((B,), Se, dtype=torch.int32, device=x.device)
        o = ops.attention_decode(q, cache["xk"], cache["xv"], lengths)
        return rows(o.reshape(B, 1, cfg.q_dim), p["wo"])

    def gated_norm(y, z, scale, eps, tp=None, width=None):
        yf = (y * F.silu(z)).float()
        k = yf.shape[-1] // n
        ss = torch.stack([yf[..., i * k:(i + 1) * k].square().sum(
            -1, keepdim=True) for i in range(n)]).sum(0)
        o = yf * torch.rsqrt(ss / yf.shape[-1] + eps)
        return (o * (1.0 + scale.float())).to(y.dtype)

    def rec_gates(cfg, p, u):
        nh, bh = p["w_ga"].shape[:2]
        return (REC._block_gate(u, p["w_ga"], p["b_ga"], nh, bh),
                REC._block_gate(u, p["w_gx"], p["b_gx"], nh, bh))

    def rec_prefill(cfg, p, x, *, impl=None, tp=None, with_cache=True):
        u = cols(x, p["wx"])
        g = F.gelu(cols(x, p["wg"]), approximate="tanh")
        uc = REC._conv_full(u, p["conv_w"].to(x.dtype))
        y, hT = ops.rglru(uc, p["a_log"], *rec_gates(cfg, p, uc),
                          c=cfg.rglru_c, impl=impl)
        return rows(y * g, p["wo"]), ({
            "conv": conv_history(u, cfg.rnn_conv), "h": hT}
            if with_cache else None)

    def rec_decode(cfg, p, x, cache, tp=None):
        u = cols(x[:, 0], p["wx"])
        g = F.gelu(cols(x[:, 0], p["wg"]), approximate="tanh")
        hist = torch.cat([cache["conv"], u[:, None]], 1)
        conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"].to(x.dtype))
        y, h = ops.rglru_decode(cache["h"], conv, p["a_log"],
                                *rec_gates(cfg, p, conv), c=cfg.rglru_c)
        cache["conv"].copy_(hist[:, 1:])
        cache["h"].copy_(h)
        return rows(y * g, p["wo"])[:, None], cache

    def ssm_sections(cfg, xc):
        s, d_inner, H, _ = SSM._dims(cfg)
        gn = s.ngroups * s.d_state
        lead = xc.shape[:-1]
        return (xc[..., :d_inner].reshape(*lead, H, s.head_dim),
                xc[..., d_inner:d_inner + gn].reshape(*lead, s.ngroups,
                                                      s.d_state),
                xc[..., d_inner + gn:].reshape(*lead, s.ngroups, s.d_state))

    def ssm_prefill(cfg, p, x, *, impl=None, tp=None, with_cache=True):
        B, S, _ = x.shape
        z, xBC, dt, (s, d_inner, H, gn) = SSM._split(cfg,
                                                     cols(x, p["in_proj"]))
        xc = SSM._conv_full(xBC, p["conv_w"].to(x.dtype))
        dt = F.softplus(dt.float() + p["dt_bias"].float())
        xs, Bm, Cm = ssm_sections(cfg, xc)
        y, hT = ops.ssd(xs, dt, p["A_log"], Bm, Cm, D=p["D"],
                        chunk=s.chunk_size, impl=impl)
        y = gated_norm(y.reshape(B, S, d_inner), z, p["norm"], cfg.norm_eps)
        return rows(y, p["out_proj"]), ({
            "conv": conv_history(xBC, s.d_conv), "h": hT}
            if with_cache else None)

    def ssm_decode(cfg, p, x, cache, tp=None):
        B = x.shape[0]
        z, xBC, dt, (s, d_inner, H, gn) = SSM._split(
            cfg, cols(x[:, 0], p["in_proj"]))
        hist = torch.cat([cache["conv"], xBC[:, None]], 1)
        conv = F.silu(torch.einsum("bkc,kc->bc", hist,
                                   p["conv_w"].to(x.dtype)))
        xs, Bm, Cm = ssm_sections(cfg, conv)
        dtv = F.softplus(dt.float() + p["dt_bias"].float())
        y, h = ops.ssd_decode(cache["h"], xs, dtv, p["A_log"], Bm, Cm,
                              D=p["D"])
        y = gated_norm(y.reshape(B, 1, d_inner), z[:, None], p["norm"],
                       cfg.norm_eps)
        cache["conv"].copy_(hist[:, 1:])
        cache["h"].copy_(h)
        return rows(y, p["out_proj"]), cache
    fns = ((A, "_qkv", qkv), (A, "attn_core", attn_core),
           (M, "apply_mlp", apply_mlp), (M.LM, "_logits", logits),
           (MOE, "_shared", shared), (A, "mla_prefill", mla_prefill),
           (REC, "rec_prefill", rec_prefill),
           (REC, "rec_decode", rec_decode),
           (SSM, "ssm_prefill", ssm_prefill),
           (SSM, "ssm_decode", ssm_decode), (A, "xattn_kv", xattn_kv),
           (A, "xattn_forward", xattn_forward),
           (A, "xattn_decode", xattn_decode))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in fns]
    for mod, name, fn in fns:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextmanager
def _scan_unsummed(kind):
    """The control of a scan path (``DIST_TP_SCAN_PATHS``): the RG-LRU
    block's output left unsummed over "model" (``rec``: each rank's share
    of ``wo`` taken as the whole), or Mamba-2's gated norm taking the sum
    of squares of this rank's heads alone (``ssm``)."""
    from repro_torch.models import rglru as REC
    from repro_torch.models import ssm as SSM
    from repro_torch.sharding import tp as TP
    mod = REC if kind == "rec" else SSM
    shim = types.SimpleNamespace(copy_to=TP.copy_to,
                                 reduce_from=TP.reduce_from,
                                 sum_over=TP.sum_over,
                                 all_gather=TP.all_gather)
    if kind == "rec":
        shim.reduce_from = lambda y, tp: y
    else:
        shim.sum_over = lambda x, tp: x
    real, mod.TP = mod.TP, shim
    try:
        yield
    finally:
        mod.TP = real


@contextmanager
def _cross_unsummed():
    """The encoder-decoder path's control (``DIST_TP_ENCDEC_PATHS``): the
    cross-attention's output left unsummed over "model", each rank's share
    of its ``wo`` taken as the whole, in the prefill and the decode (the
    backward of that all-reduce is the identity either way)."""
    from repro_torch.models import attention as A
    from repro_torch.sharding import tp as TP
    shim = types.SimpleNamespace(copy_to=TP.copy_to,
                                 reduce_from=lambda y, tp: y)
    real = {k: getattr(A, k) for k in ("xattn_forward", "xattn_decode")}

    def unsummed(fn):
        def run(*a, **kw):
            A.TP = shim
            try:
                return fn(*a, **kw)
            finally:
                A.TP = TP
        return run
    for k, fn in real.items():
        setattr(A, k, unsummed(fn))
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(A, k, fn)


# a path's own control (``control`` in ``_dist_tp_paths``) and its name
PATH_CONTROLS = {"rec": ("the RG-LRU block's all-reduce dropped",
                         lambda: _scan_unsummed("rec")),
                 "ssm": ("the gated norm's sum over heads dropped",
                         lambda: _scan_unsummed("ssm")),
                 "cross": ("the cross-attention's all-reduce dropped",
                           _cross_unsummed)}


@contextmanager
def _norms_summed(partial_over_model_rule):
    """``partition.partial_over_model`` replaced by
    ``partial_over_model_rule(the real one)`` for the block."""
    from repro_torch.sharding import partition as part
    real = part.partial_over_model
    part.partial_over_model = partial_over_model_rule(real)
    try:
        yield
    finally:
        part.partial_over_model = real


def _tp_placements(lm, mesh):
    """Each of ``lm``'s leaves -> its storage placements on ``mesh``
    (``state_logical``'s specs, resolved)."""
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition as part
    logical = adamw.state_logical(lm)["params"]
    return {n: part.placements(part.resolve(logical[n], p.shape, mesh), mesh)
            for n, p in lm.named_parameters()}


def _tp_cut(full, placements, world):
    """``full`` cut as each rank of a (1, ``world``) ("data", "model") mesh
    holds it at ``placements``: a list of ``world`` views."""
    pl = placements[1]
    return list(full.chunk(world, pl.dim)) if pl.is_shard() else [full] * world


def _m_rel(got, want):
    """Relative L2 of ``got`` against ``want`` (0 where both are 0)."""
    d, r = (got - want).float().norm(), want.float().norm()
    return float(d / r) if r > 0 else (0.0 if d == 0 else math.inf)


def _tp_params(lm, mesh):
    """``lm``'s parameters as DTensors at ``state_logical``'s specs on
    ``mesh``, each rank keeping its shard of its own copy (every rank
    builds the same seeded weights): no collective; each whole weight is
    freed as it is placed."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = _tp_placements(lm, mesh)
    params = {}
    with torch.no_grad():
        for n, p in lm.named_parameters():
            pl = placements[n]
            local = distribute_tensor(p.detach(), mesh, pl,
                                      src_data_rank=None).to_local().clone()
            params[n] = DTensor.from_local(local, mesh, pl, run_check=False)
            p.data = p.data.new_empty(0)
    return params


def _tp_place(lm, mesh):
    """``lm``'s train state on ``mesh`` at ``state_logical``'s specs, each
    rank keeping its shard of its own copy (every rank builds the same
    seeded weights): no collective; each whole weight is freed as it is
    placed (the step points the LM at its compute copies), and ``m`` and
    ``v`` are made as shards."""
    import torch
    from torch.distributed.tensor import DTensor
    params = _tp_params(lm, mesh)

    def zeros():
        return {n: DTensor.from_local(torch.zeros_like(t.to_local()), mesh,
                                      t.placements, run_check=False)
                for n, t in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32), "params": params,
            "m": zeros(), "v": zeros()}


def _dist_tp_paths():
    """dist-tp's paths (``_dist_tp_rank``): the dense ones, trained and
    served in both dtypes at one depth, the scan ones and the
    encoder-decoder, then the MoE ones; ``control`` names a path's own
    control (``PATH_CONTROLS``), ``opt`` its ``OptConfig`` fields beside
    the default."""
    dense = [dict(label=a, train=_train_cfg(a, n, "bfloat16"),
                  serve=_train_cfg(a, n, "bfloat16"), steps=DIST_TP_STEPS,
                  serve_dtypes=tuple(DIST_TP_STEPS), decode=DIST_TP_DECODE)
             for a, n in DIST_TP_PATHS]
    dense += [dict(label=a, train=_train_cfg(a, n, "bfloat16"),
                   serve=_train_cfg(a, n, "bfloat16"),
                   steps={"float32": 2}, serve_dtypes=("bfloat16",),
                   decode=DIST_TP_SCAN_DECODE, control=kind)
              for a, n, kind in DIST_TP_SCAN_PATHS]
    dense += [dict(label=a, train=_train_cfg(a, nt, "bfloat16"),
                   serve=_train_cfg(a, ns, "bfloat16"),
                   steps={"float32": 2}, serve_dtypes=("bfloat16",),
                   decode=DIST_TP_DECODE, control=kind,
                   opt={"clip_norm": 0.0})
              for a, nt, ns, kind in DIST_TP_ENCDEC_PATHS]
    import dataclasses

    def no_drops(cfg):
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=DIST_TP_MOE_CF))
    moe = [dict(label=a, train=no_drops(_train_cfg(a, nt, "bfloat16")),
                serve=no_drops(_train_cfg(a, ns, "bfloat16")),
                steps=DIST_TP_MOE_STEPS, serve_dtypes=dts,
                decode=DIST_TP_MOE_DECODE)
           for a, nt, ns, dts in DIST_TP_MOE_PATHS]
    return dense + moe


def _dist_tp_rank(rank, world, device, paths, seq, ep=None):
    """One of DIST_TP_WORLD ranks sharing the card through gloo: for each
    path of ``paths`` (``_dist_tp_paths``: a label, the full-width configs
    it trains and serves, cut in depth, the dtypes it trains in with their
    step counts, those it serves in, its decode steps) and each dtype,
    rank 0 takes the path's steps without a mesh from the seeded weights,
    and step 1 again with the split step's sums in parts
    (``_sums_in_parts``, the witness); then every rank takes the same
    steps from the same weights through the tensor-parallel
    ``make_train_step`` on a (1, world) mesh (EP beside it for the MoE
    families, every code replaying the unsharded run's routing), each
    rank building its weights in turn, the kernel counts set to 0 just
    before and read just after, every flash launch's shapes recorded and
    held against the plain versions after. fp32, after step 1: each
    rank's shard of ``m`` against rank 0's unsharded step 1 (scattered
    leaf by leaf), rank 0's shards of the params too, then step 1 again
    with the norms' gradients summed over "model" once more
    (``_norms_summed_again``, the control) against the same shards of
    ``m``. bf16: step 1 again with the attention's all-reduce over "model"
    dropped, the control. Then the path serves in each of its serving
    dtypes (``serve_case``: rank 0 unsharded and its witness, then every
    rank through ``launch.specs.build_fn`` on the mesh, counted and
    recorded as the steps, and in bf16 the control). Then one all-reduce
    of a layer's activations timed in each dtype, and with ``ep`` (an MoE
    config and a token count) dist-ep's checks of one MoE layer
    (``_dist_ep_rank``). Each rank returns its readings; rank 0's carry
    the unsharded runs and the witnesses."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition as part
    from repro_torch.sharding import tp as TP
    global DEVICE, TRAIN_S
    DEVICE, TRAIN_S = device, seq
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    mesh = make_mesh((1, world), ("data", "model"), device=device)
    opt = None       # each path's (its ``opt`` fields beside these)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    def build(cfg, dtype):
        cfg = cfg.replace(dtype=dtype)
        lm = LM(cfg, device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(0))
        return lm, _train_batch(cfg, 1)

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def placed(cfg, dtype, place):
        """Every rank's LM and batch built in turn, each placed by
        ``place(lm)`` (its whole weights freed as they are placed) before
        the next rank builds: one whole copy on the card at a time."""
        got = None
        for i in range(world):
            if rank == i:
                lm, batch = build(cfg, dtype)
                got = lm, batch, place(lm)
                free()
            dist.barrier()
        return got

    def shared_record(rec):
        """Rank 0's recorded routing (``pinned_routing``), on every rank."""
        obj = [[t.cpu() for t in rec] if rank == 0 else None]
        dist.broadcast_object_list(obj, src=0)
        return obj[0]

    def pins(rec, seen=None):
        """Replay ``rec``'s routing on this rank: under EP each call
        routes this rank's slice of the tokens (``moe._moe_ep``), the
        rows of the unsharded call's choices it owns."""
        if not rec:
            return nullcontext()
        own = []
        for t in rec:
            n = -(-t.shape[0] // world)
            own.append(t[rank * n:(rank + 1) * n].to(DEVICE))
        return pinned_routing(own, seen)

    def dropped(counts, over_ranks=True):
        """The copies a run's MoE layers dropped (``moe.drop_counts``),
        summed over the ranks."""
        v = torch.tensor([sum(float(counts.get(k, 0)) for k in (
            "dropped", "dropped_send"))], dtype=torch.float64)
        if over_ranks:
            dist.all_reduce(v)
        return float(v)

    def otherwise(seen, rec):
        """The rows the split run's own router would have routed to other
        experts than the replayed ones, and the rows, over every rank."""
        n = torch.zeros(2, dtype=torch.float64)
        for t, want in zip(seen, rec):
            k = -(-want.shape[0] // world)
            w = want[rank * k:(rank + 1) * k].to(t.device)
            n[0] += float((t.sort(-1).values != w.sort(-1).values).any(-1)
                          .sum())
            n[1] += w.shape[0]
        dist.all_reduce(n)
        return n.tolist()

    def steps_in_two(name, step, state, batch, n, quiet=False,
                     after_first=None):
        """``n`` steps; after step 1 the peak is read and ``after_first``
        called on the state (outside the timed steps)."""
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        state, rows = _timed_steps(name, step, state, batch, 1, quiet=quiet)
        first_peak = peak()
        if after_first is not None:
            after_first(state, rows[0])
        state, more = _timed_steps(name, step, state, batch, n - 1,
                                   quiet=quiet)
        return state, rows + more, first_peak

    def tp_run(name, cfg, dtype, n, quiet=True, after_first=None):
        lm, batch, state = placed(cfg, dtype, lambda lm: _tp_place(lm, mesh))
        with part.activate(mesh):
            state, rows, first_peak = steps_in_two(
                name, adamw.make_train_step(lm, opt), state, batch, n,
                quiet, after_first)
        return lm, state, rows, first_peak

    mine = {}     # this rank's shards of the unsharded step 1's m

    def m_rels(state):
        """Per leaf, the worst rank's relative L2 of its shard of
        ``state``'s m against the same shard of the unsharded m."""
        names = list(mine)
        rel = torch.tensor([_m_rel(state["m"][k].to_local(), mine[k])
                            for k in names], dtype=torch.float64)
        dist.all_reduce(rel, op=dist.ReduceOp.MAX)
        return dict(zip(names, rel.tolist()))

    def timed(fn, *a):
        """``fn(*a)`` -> (its result, ms: CUDA events on the card, the
        host clock on the CPU)."""
        sync()
        h0 = time.perf_counter()
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            e0.record()
        got = fn(*a)
        if cuda:
            e1.record()
        sync()
        return got, (e0.elapsed_time(e1) if cuda else
                     (time.perf_counter() - h0) * 1e3)

    def serve_run(prefill, decode, axes, prompts, forced=None,
                  steps=DIST_TP_DECODE):
        """Each prompt prefilled (B=1), the caches stacked, then ``steps``
        decode steps, greedy or on ``forced`` [4, steps]
        -> the calls' logits (fp32, on the host), the decode's input
        tokens and last greedy one [4, steps + 1], ms per prefill and per
        decode step, and the stacked cache's GiB on this rank."""
        caches, logits, pre_ms = [], [], []
        for t in prompts:
            (c, lg), ms = timed(prefill, t)
            caches.append(c)
            logits.append(lg)
            pre_ms.append(ms)
        cache = _stack_caches(caches, axes)
        del caches
        gib = _cache_gib(cache)
        tok = torch.cat([lg.argmax(-1, keepdim=True) for lg in logits], 0)
        toks, dec_ms = [tok], []
        for i in range(steps):
            if forced is not None:
                tok = forced[:, i:i + 1].to(tok.device)
                toks[-1] = tok
            (cache, lg), ms = timed(decode, cache, tok)
            logits.append(lg)
            dec_ms.append(ms)
            tok = lg.argmax(-1, keepdim=True)
            toks.append(tok)
        del cache
        return {"logits": [lg.float().cpu() for lg in logits],
                "tokens": torch.cat(toks, 1).cpu(), "prefill_ms": pre_ms,
                "decode_ms": dec_ms, "cache_gib": gib}

    def calls_rel(got, want):
        """Each call's relative L2 of the logits (inf where not finite)."""
        out = []
        for a, b in zip(got, want):
            r = _m_rel(a, b)
            out.append(r if math.isfinite(r) else math.inf)
        return out

    def serve_case(key, cfg, dtype, decode_steps, control=None):
        """The serving half of a path in one dtype (``phase_dist_tp``);
        ``control`` a path's own (``PATH_CONTROLS``). A prompt is a batch
        of B=1: its tokens, and an encoder-decoder's seeded frames
        (``cfg.frontend_tokens`` of them, normal, std 0.02)."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import specs
        fp32 = dtype == "float32"
        g = torch.Generator(device=DEVICE).manual_seed(2)
        prompts = []
        for s_ in DIST_TP_PROMPTS:
            b = {"tokens": torch.randint(0, cfg.vocab_size, (1, s_),
                                         generator=g, device=DEVICE)}
            if cfg.encoder_layers:
                b["frames"] = torch.randn(
                    (1, cfg.frontend_tokens, cfg.d_model), generator=g,
                    device=DEVICE) * 0.02
            prompts.append(b)
        res, want, t0 = {"s": {}}, [None], time.perf_counter()
        rec = []          # the unsharded run's routing, replayed by each code
        moe_layers = cfg.num_layers - cfg.moe.first_k_dense if cfg.moe \
            else 0

        def lap(name):
            nonlocal t0
            res["s"][name] = time.perf_counter() - t0
            t0 = time.perf_counter()
        if rank == 0:      # the unsharded prefill and decode, the witness
            lm, _ = build(cfg, dtype)
            axes = lm.cache_logical()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with pinned_routing(rec), MOE.drop_counts() as drops:
                ref = serve_run(lambda b: lm.prefill(b, cap),
                                lm.decode_step, axes, prompts,
                                steps=decode_steps)
            res["unsharded_peak_gib"] = peak()
            res["unsharded_dropped"] = dropped(drops, False)
            with _sums_in_parts(world), _decode_in_parts(world), \
                    (pinned_routing(list(rec)) if rec else nullcontext()):
                wit = serve_run(lambda b: lm.prefill(b, cap),
                                lm.decode_step, axes, prompts,
                                forced=ref["tokens"][:, :-1],
                                steps=decode_steps)
            res.update(unsharded={k: ref[k] for k in (
                "prefill_ms", "decode_ms", "cache_gib")},
                tokens=ref["tokens"].tolist(),
                witness_rel=calls_rel(wit["logits"], ref["logits"]))
            want[0] = ref
            del lm, wit
            free()
        forced = torch.zeros((len(prompts), decode_steps + 1),
                             dtype=torch.int64)
        if rank == 0:
            forced.copy_(want[0]["tokens"])
        dist.broadcast(forced, src=0)
        rec = shared_record(rec) if moe_layers else []
        lap("unsharded")
        forced = None if fp32 else forced[:, :-1]

        def sharded(lm, params):
            with part.activate(mesh):
                sp = specs.input_specs(cfg, ShapeConfig(
                    "serve", cap, 1, "prefill"), mesh)
                sd = specs.input_specs(cfg, ShapeConfig(
                    "serve", cap, len(prompts), "decode"), mesh)
                pre = specs.build_fn(dict(sp, lm=lm))
                dec = specs.build_fn(dict(sd, lm=lm))

            def prefill(b):
                with part.activate(mesh):
                    c, lg = pre(params, b)
                return c, lg.to_local()

            def decode(c, t):
                with part.activate(mesh):
                    c, lg = dec(params, c, t)
                return c, lg.to_local()
            return prefill, decode, lm.cache_logical()

        lm, _, params = placed(cfg, dtype, lambda lm: _tp_params(lm, mesh))
        layouts = lm.cache_layouts(mesh, len(prompts), cap)
        prefill, decode, axes = sharded(lm, params)
        lap("build")
        counted = {"all_reduce": 0, "all_gather_into_tensor": 0,
                   "all_gather": 0}
        real = {k: getattr(dist, k) for k in counted}
        in_decode = [False]

        def counting(k):
            def fn(*a, **kw):
                if in_decode[0]:
                    counted[k] += 1
                return real[k](*a, **kw)
            return fn

        def decode_counted(c, t):
            in_decode[0] = True
            try:
                return decode(c, t)
            finally:
                in_decode[0] = False
        calls = {}
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        seen = []
        for k in counted:
            setattr(dist, k, counting(k))
        try:
            with _flash_inputs(calls), pins(rec, seen), \
                    MOE.drop_counts() as drops:
                got = serve_run(prefill, decode_counted, axes, prompts,
                                forced, decode_steps)
        finally:
            for k in counted:
                setattr(dist, k, real[k])
        sync()
        res["dropped"] = dropped(drops)
        res.update(launches=kernel_counts(), flash=flash_counts(),
                   ssd=ssd_counts(),
                   peak_gib=peak(), prefill_ms=got["prefill_ms"],
                   decode_ms=got["decode_ms"], cache_gib=got["cache_gib"],
                   collectives_per_decode_step={
                       k: v / decode_steps for k, v in counted.items()},
                   layouts={k: v._asdict() for k, v in layouts.items()})
        if rec:
            res["rows_routed_otherwise"] = otherwise(seen, rec)
        lap("sharded")
        res["held"] = _hold_recorded(f"dist-tp: {key} serving rank {rank}",
                                     calls)
        lap("hold")
        # every rank holds the same logits (all-gathered over "model")
        digest = torch.tensor([float(lg.double().sum()) for lg in
                               got["logits"]], dtype=torch.float64)
        lo, hi = digest.clone(), digest.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        res["ranks_agree"] = bool(torch.equal(lo, hi))
        if rank == 0:
            ref = want[0]
            res.update(rel=calls_rel(got["logits"], ref["logits"]),
                       tokens_equal=bool(torch.equal(got["tokens"],
                                                     ref["tokens"])))
        del calls
        if not fp32:       # the control
            combines = control is None and any(
                v.seq for v in layouts.values())
            if control is not None:
                name, ctl = PATH_CONTROLS[control]
                ctl_ctx = ctl()
            elif combines:
                def uncombined(o, m, l, groups):
                    return o / l[:, None, :, None]
                real_c, TP.combine_partial = TP.combine_partial, uncombined
                ctl_ctx, name = nullcontext(), "combine dropped"
            else:
                shim = types.SimpleNamespace(
                    copy_to=TP.copy_to, reduce_from=lambda y, tp: y,
                    all_gather=TP.all_gather,
                    combine_partial=TP.combine_partial)
                real_c, A.TP = A.TP, shim
                ctl_ctx, name = nullcontext(), \
                    "attention's all-reduce dropped"
            try:
                with ctl_ctx, pins(rec[:(len(prompts) +
                                         DIST_TP_CONTROL_DECODE) *
                                       moe_layers]):
                    ctl = serve_run(prefill, decode, axes, prompts, forced,
                                    DIST_TP_CONTROL_DECODE)
            finally:
                if combines:
                    TP.combine_partial = real_c
                elif control is None:
                    A.TP = real_c
            if rank == 0:
                res["control"] = name
                res["control_rel"] = calls_rel(ctl["logits"],
                                               want[0]["logits"])
            del ctl
            lap("control")
        # one decode step's activations all-reduced and its logits
        # all-gathered over the four ranks, staged through the host by gloo
        x = torch.ones((len(prompts), 1, cfg.d_model),
                       dtype=getattr(torch, dtype), device=DEVICE)
        v = torch.ones((len(prompts), cfg.padded_vocab // world),
                       dtype=getattr(torch, dtype), device=DEVICE)
        grp = mesh.get_group("model")
        ms = {"all_reduce": [], "all_gather": []}
        for _ in range(6):
            ms["all_reduce"].append(timed(
                lambda: dist.all_reduce(x, group=grp))[1])
            ms["all_gather"].append(timed(
                lambda: TP.all_gather(v, grp, -1))[1])
        res["collective_ms"] = {k: sorted(t[1:])[2] for k, t in ms.items()}
        lap("collectives")
        del lm, params, prefill, decode, got, want
        free()
        return res

    def train_case(res, key, cfg, dtype, n, control=None):
        """The train half of a path in one dtype (``phase_dist_tp``);
        ``control`` a path's own (``PATH_CONTROLS``)."""
        fp32 = dtype == "float32"
        want, rec = None, []
        if rank == 0:
            lm, batch = build(cfg, dtype)
            res["n_params"] = sum(p.numel() for p in lm.parameters())

            def keep(state, _):
                nonlocal want
                want = {k: {m: t.detach().to("cpu", copy=True)
                            for m, t in state[k].items()}
                        for k in ("m", "params")}
            with pinned_routing(rec), MOE.drop_counts() as drops:
                state, res["unsharded_steps"], res["unsharded_peak_gib"] = \
                    steps_in_two(f"dist-tp: {key} unsharded",
                                 adamw.make_train_step(lm, opt),
                                 adamw.init_state(lm), batch, n,
                                 after_first=keep if fp32 else None)
            res["unsharded_dropped"] = dropped(drops, False)
            del state, lm, batch
            free()
            lm, batch = build(cfg, dtype)
            with _sums_in_parts(world), \
                    (pinned_routing(rec[:len(rec) // n]) if rec
                     else nullcontext()):
                state, res["witness_steps"] = _timed_steps(
                    f"dist-tp: {key} unsharded, sums in {world} parts",
                    adamw.make_train_step(lm, opt), adamw.init_state(lm),
                    batch, 1)
            if fp32:     # the witness's m, cut as the ranks hold it
                pls = _tp_placements(lm, mesh)
                res["m_rel_witness"] = {
                    k: max(_m_rel(a, b) for a, b in zip(
                        _tp_cut(state["m"][k], pls[k], world),
                        _tp_cut(want["m"][k].to(DEVICE), pls[k], world)))
                    for k in pls}
            del state, lm, batch
            free()
        rec = shared_record(rec) if cfg.moe is not None else []
        dist.barrier()

        def hold_step1(state, row):
            """Each rank's shard of m after step 1 against the same cut
            of rank 0's unsharded m, scattered leaf by leaf from the
            host, by relative L2 (``m_rels``); and, a sanity check on
            rank 0's shards, the params within 2 x lr of the unsharded
            ones, plus the one fp32 rounding each weight takes after its
            update (an ulp, at most 2^-23 of the weight)."""
            t0 = time.perf_counter()
            for k, local in state["m"].items():
                cut = torch.empty(local.to_local().shape,
                                  dtype=local.dtype)
                pl = local.placements
                if pl[1].is_shard():
                    dist.scatter(cut, [c.contiguous() for c in _tp_cut(
                        want["m"][k], pl, world)] if rank == 0 else None,
                        src=0)
                else:
                    if rank == 0:
                        cut.copy_(want["m"][k])
                    dist.broadcast(cut, src=0)
                mine[k] = cut.to(DEVICE)
            res["m_rel"] = m_rels(state)
            if rank == 0:
                lim, worst, beyond = 2 * row["lr"], 0.0, -math.inf
                for k, local in state["params"].items():
                    cut = _tp_cut(want["params"][k], local.placements,
                                  world)[0].to(DEVICE)
                    d = (local.to_local() - cut).abs()
                    worst = max(worst, float(d.max()))
                    beyond = max(beyond, float(
                        (d - lim - cut.abs() * 2.0**-23).max()))
                    del d, cut
                res.update(params_max_abs_err=worst, params_limit=lim,
                           params_max_beyond_limit=beyond)
            res["hold_s"] = time.perf_counter() - t0

        # the tensor-parallel steps, counted and recorded
        calls, n_reduce, seen = {}, [0], []
        reduce = TP._all_reduce

        def counted(t, group, op=None):
            n_reduce[0] += 1
            return reduce(t, group, op)
        sync()
        reset_kernel_counts()
        TP._all_reduce = counted
        try:
            with _flash_inputs(calls), pins(rec, seen), \
                    MOE.drop_counts() as drops:
                lm, state, rows, res["peak_gib"] = tp_run(
                    f"dist-tp: {key} on (1, 4)", cfg, dtype, n,
                    quiet=rank != 0,
                    after_first=hold_step1 if fp32 else None)
        finally:
            TP._all_reduce = reduce
        sync()
        res["dropped"] = dropped(drops)
        res.update(steps=rows, launches=kernel_counts(),
                   flash=flash_counts(), flash_bwd=bwd_counts(),
                   ssd=ssd_counts(),
                   all_reduces_per_step=n_reduce[0] / n,
                   plan=adamw.tp_plan(lm, mesh)._asdict())
        if rec:         # step 1's calls
            res["rows_routed_otherwise"] = otherwise(
                seen[:len(rec) // n], rec[:len(rec) // n])
        res["held"] = _hold_recorded(f"dist-tp: {key} rank {rank}", calls)
        del calls, state, lm
        want = None
        free()
        if fp32:      # the control: the norms' gradients summed again,
            # or a scan path's own
            with (PATH_CONTROLS[control][1]() if control else
                  _norms_summed(_norms_summed_again)), \
                    pins(rec[:len(rec) // n]):
                lm, state, rows, _ = tp_run(
                    f"dist-tp: {key} control", cfg, dtype, 1)
            res["control_steps"] = rows
            res["m_rel_control"] = m_rels(state)
        else:         # the control: attention not summed
            shim = types.SimpleNamespace(copy_to=TP.copy_to,
                                         reduce_from=lambda y, tp: y)
            real, A.TP = A.TP, shim
            try:
                with pins(rec[:len(rec) // n]):
                    lm, state, rows, _ = tp_run(f"dist-tp: {key} control",
                                                cfg, dtype, 1)
            finally:
                A.TP = real
            res["control_steps"] = rows
        del lm, state
        mine.clear()
        free()

    cap = DIST_TP_CAPACITY
    out = {"rank": rank, "cases": {}, "seconds": {}}
    for path in paths:
        opt = adamw.OptConfig(lr=3e-4, warmup_steps=0, total_steps=100,
                              **path.get("opt", {}))
        for dtype in dict.fromkeys(tuple(path["steps"]) +
                                   tuple(path["serve_dtypes"])):
            key = f"{path['label']} {dtype}"
            res = out["cases"][key] = {}
            t0 = time.perf_counter()
            if dtype in path["steps"]:
                train_case(res, key, path["train"], dtype,
                           path["steps"][dtype], path.get("control"))
            t1 = time.perf_counter()
            if dtype in path["serve_dtypes"]:
                res["serve"] = serve_case(key, path["serve"], dtype,
                                          path["decode"], path.get("control"))
            out["seconds"][key] = {"train": t1 - t0,
                                   "serve": time.perf_counter() - t1}

    # one layer's activations all-reduced over the four ranks, staged
    # through the host by gloo
    out["all_reduce_ms"] = {}
    d = max((p["train"].d_model for p in paths), default=0)
    for dtype in dict.fromkeys(dt for p in paths for dt in p["steps"]):
        x = torch.ones((1, seq, d), dtype=getattr(torch, dtype),
                       device=DEVICE)
        ts = []
        for i in range(6):
            sync()
            t0 = time.perf_counter()
            dist.all_reduce(x, group=mesh.get_group("model"))
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_ms"][dtype] = {"shape": [1, seq, d],
                                       "median_ms": sorted(ts[1:])[2]}
    if ep is not None:       # dist-ep's checks of one MoE layer
        free()
        t0 = time.perf_counter()
        out["ep"] = _dist_ep_rank(rank, world, device, *ep)
        out["seconds"]["dist-ep checks"] = time.perf_counter() - t0
    return out


def _path_launches(cfg, n, train):
    """Each kernel's launches on a rank in ``n`` train steps of ``cfg``'s
    layers (each layer's forward and remat's recompute, a flash backward
    per attention layer; the scans' gradients recompute their plain
    versions) or in ``n`` prefills (one per layer; a decode step is plain
    for every mixer); an encoder-decoder's encoder layers and decoder
    cross-attentions launch the flash kernels too."""
    want = dict.fromkeys(kernel_counts(), 0)
    kinds = list(cfg.layer_kinds) + ["attn"] * (
        cfg.encoder_layers + (cfg.num_layers if cfg.encoder_layers else 0))
    for mixer in kinds:
        kname = KERNEL_OF_MIXER[mixer]
        want[kname] += (2 if train else 1) * n
        if train and kname == "flash_attention_fwd":
            want["flash_attention_bwd"] += n
    return want


def _serve_report(arch, cfg, key, route, res, bad, decode):
    """The serving half of ``phase_dist_tp`` for one path and dtype
    (``cfg``'s layers, ``decode`` steps): its gates (appended to ``bad``)
    and its record."""
    dtype = key.rsplit(" ", 1)[1]
    r0 = res[0]["cases"][key]["serve"]
    ranks = [r["cases"][key]["serve"] for r in res]
    lim = DIST_TP_SERVE_REL[arch, dtype]
    n_pre = len(DIST_TP_PROMPTS)

    def med(xs):
        return sorted(xs)[len(xs) // 2]
    sv = {"prompts": list(DIST_TP_PROMPTS), "capacity": DIST_TP_CAPACITY,
          "decode_steps": decode, "layouts": r0["layouts"],
          "limit": lim, "rel_max": max(r0["rel"]),
          "rel_prefill_max": max(r0["rel"][:n_pre]),
          "witness_rel_max": max(r0["witness_rel"]),
          "tokens_equal": r0["tokens_equal"],
          "ranks_agree": all(r["ranks_agree"] for r in ranks),
          "prefill_ms_by_rank": [r["prefill_ms"] for r in ranks],
          "unsharded_prefill_ms": r0["unsharded"]["prefill_ms"],
          "decode_ms_median_by_rank": [med(r["decode_ms"][1:])
                                       for r in ranks],
          "unsharded_decode_ms_median": med(
              r0["unsharded"]["decode_ms"][1:]),
          "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
          "unsharded_peak_gib": r0["unsharded_peak_gib"],
          "cache_gib_by_rank": [r["cache_gib"] for r in ranks],
          "unsharded_cache_gib": r0["unsharded"]["cache_gib"],
          "collectives_per_decode_step": r0["collectives_per_decode_step"],
          "collective_ms": r0["collective_ms"],
          "launches_by_rank": [r["launches"] for r in ranks],
          "seconds_rank0": r0["s"],
          "held_shapes": [[h["q"], h["k"], h["dtype"],
                           h["options"].get("window", 0)]
                          for h in r0["held"]],
          "tokens": r0["tokens"]}
    if "rows_routed_otherwise" in r0:
        n, rows = r0["rows_routed_otherwise"]
        sv["routing_rows_otherwise_share"] = n / rows
    sv["copies_dropped"] = [r0["unsharded_dropped"], r0["dropped"]]
    if sv["copies_dropped"][0] != sv["copies_dropped"][1]:
        bad.append(f"{key} serving: copies dropped {sv['copies_dropped']}")
    if dtype == "float32":
        if not sv["tokens_equal"]:
            bad.append(f"{key} serving: greedy tokens differ")
    else:
        sv["control"] = r0["control"]
        sv["control_rel_max"] = max(r0["control_rel"])
        if sv["control_rel_max"] <= lim:
            bad.append(f"{key} serving: the control within {lim}")
    if sv["rel_max"] > lim or sv["witness_rel_max"] > lim:
        bad.append(f"{key} serving: logits {sv['rel_max']}, witness "
                   f"{sv['witness_rel_max']}, limit {lim}")
    if not sv["ranks_agree"]:
        bad.append(f"{key} serving: the ranks' logits differ")
    want = _path_launches(cfg, n_pre, train=False)
    for r in ranks:
        if r["launches"] != want or \
                r["flash"][route] != want["flash_attention_fwd"] or \
                r["ssd"][route] != want["ssd_scan"]:
            bad.append(f"{key} serving: launches {r['launches']} "
                       f"{r['flash']} {r['ssd']}, want {want}")
    return sv


def _train_report(arch, cfg, key, n, res, bad, out, path_control=None):
    """The train half of ``phase_dist_tp`` for one path and dtype
    (``cfg``'s layers, ``n`` steps; ``path_control`` a path's own
    control): its gates
    (appended to ``bad``), its launches added to ``out``'s, and its
    record."""
    layers = cfg.num_layers
    dtype = key.rsplit(" ", 1)[1]
    label = key.rsplit(" ", 1)[0]
    r0 = res[0]["cases"][key]
    ranks = [r["cases"][key] for r in res]
    route = "tc" if dtype == "bfloat16" else "fma"

    def rel(a, b):
        return abs(a - b) / abs(b)
    c = {"layers": layers, "steps": n, "n_params": r0["n_params"],
         "plan": r0["plan"],
         "unsharded_steps": r0["unsharded_steps"],
         "unsharded_peak_gib": r0.get("unsharded_peak_gib"),
         "tp_steps_rank0": r0["steps"],
         "ms_per_step_by_rank": [
             sum(s["ms"] for s in r["steps"][1:]) / (n - 1)
             for r in ranks],
         "unsharded_ms_per_step": sum(
             s["ms"] for s in r0["unsharded_steps"][1:]) / (n - 1),
         "peak_gib_by_rank": [r.get("peak_gib") for r in ranks],
         "all_reduces_per_step": r0["all_reduces_per_step"],
         "launches_by_rank": [r["launches"] for r in ranks],
         "flash_by_rank": [r["flash"] for r in ranks],
         "flash_bwd_by_rank": [r["flash_bwd"] for r in ranks],
         "held_shapes": [[h["kind"], h["q"], h["k"], h["dtype"],
                          h["options"].get("window", 0)]
                         for h in r0["held"]]}
    if "rows_routed_otherwise" in r0:
        k, rows = r0["rows_routed_otherwise"]
        c["routing_rows_otherwise_share_step1"] = k / rows
    c["copies_dropped"] = [r0["unsharded_dropped"], r0["dropped"]]
    if c["copies_dropped"][0] != c["copies_dropped"][1]:
        bad.append(f"{key}: copies dropped {c['copies_dropped']}")
    # step 1 of each code (and each later step's loss) against the fp32
    # unsharded step on the same weights and batch
    f32 = res[0]["cases"][f"{label} float32"]["unsharded_steps"]
    codes = {"tp": r0["steps"], "witness_sums_in_parts": r0["witness_steps"]}
    if dtype == "bfloat16":
        codes.update(control_attention_not_summed=r0["control_steps"],
                     witness_unsharded_bf16=r0["unsharded_steps"])
    # (a step without clipping reports no grad_norm: its loss alone)
    c["rel_to_fp32"] = {
        k: dict({"loss": [rel(a["loss"], b["loss"]) for a, b in zip(
            v if dtype == "float32" else v[:1], f32)]}, **(
            {"grad_norm": rel(v[0]["grad_norm"], f32[0]["grad_norm"])}
            if f32[0]["grad_norm"] else {}))
        for k, v in codes.items()}
    c["limit"] = lim = DIST_TP_REL[arch, dtype]
    worst = {k: max(v["loss"] + [v.get("grad_norm", 0.0)])
             for k, v in c["rel_to_fp32"].items()}
    control = worst.pop("control_attention_not_summed", math.inf)
    if max(worst.values()) > lim or control <= lim:
        bad.append(f"{key}: {worst}, control {control}")
    if dtype == "float32":
        c["control"] = (PATH_CONTROLS[path_control][0] if path_control
                        else "the norms ahead of split blocks summed again")
        c["loss_rel_step1"] = c["rel_to_fp32"]["tp"]["loss"][0]
        c.update({k: r0[k] for k in (
            "m_rel", "m_rel_witness", "m_rel_control",
            "params_max_abs_err", "params_limit",
            "params_max_beyond_limit", "hold_s")})
        # each leaf's distance over its limit: at most 1 for the
        # tensor-parallel step, over 1 somewhere for the control
        lim = {k: DIST_TP_M_MULT * w + DIST_TP_M_FLOOR[arch]
               for k, w in c["m_rel_witness"].items()}
        c["m_over_limit"], c["m_over_limit_control"] = (
            max((v[k] / lim[k], k) for k in lim)
            for v in (c["m_rel"], c["m_rel_control"]))
        if c["loss_rel_step1"] > DIST_TP_LOSS_REL:
            bad.append(f"{key}: step 1's loss")
        if c["m_over_limit"][0] > 1 or c["m_over_limit_control"][0] <= 1:
            bad.append(f"{key}: m after step 1 over its limit, TP "
                       f"{c['m_over_limit']}, control "
                       f"{c['m_over_limit_control']}")
        if c["params_max_beyond_limit"] > 0:
            bad.append(f"{key}: params beyond 2 x lr")
    want = _path_launches(cfg, n, train=True)
    for r in ranks:
        if r["launches"] != want:
            bad.append(f"{key}: launches {r['launches']}, want {want}")
        if r["flash"][route] != want["flash_attention_fwd"] or \
                r["flash_bwd"][route] != want["flash_attention_bwd"] or \
                r["ssd"][route] != want["ssd_scan"]:
            bad.append(f"{key}: route {r['flash']} {r['flash_bwd']} "
                       f"{r['ssd']}")
        _add_launches(out, r)
    return c


def _add_launches(out, r):
    """One rank's kernel launches (a train or serving record) added to
    ``phase_dist_tp``'s totals."""
    for kname, v in r["launches"].items():
        out["launches"][kname] = out["launches"].get(kname, 0) + v
    for k in ("tc", "fma"):
        out["flash_launches_by_kernel"][k] += r["flash"][k]
        out["ssd_launches_by_kernel"][k] += r["ssd"][k]
        if "flash_bwd" in r:
            out["flash_bwd_launches_by_route"][k] += r["flash_bwd"][k]


def _ep_report(res, bad):
    """dist-ep's checks of one MoE layer (``_dist_ep_rank``, run in
    ``phase_dist_tp``'s MoE spawn): its gates (appended to ``bad``) and
    its record. fp32 at capacity factor 8 (no drops), against the local
    path on rank 0: y on the rows whose routing agrees, EP's aux against
    the local path's per token slice (EP's definition, as the
    reference's), and, replaying the local run's routing, y and every
    gradient (the input's too) under one seeded cotangent, all at
    DIST_EP_REL_L2. The drop path, fp32 at DIST_EP_LOW_CF: copies dropped
    at both of EP's capacities, the same counts on the card and on the CPU
    under the same routing, and y and aux against the CPU's at
    DIST_EP_REL_L2 (the tests hold the CPU's EP at such factors against
    the reference's). Reported: the share of (token, expert) assignments
    that differ (routing on 512-token slices), bf16 at 1.25 the share of
    copies each path drops, the times (the exchange staged through the
    host by gloo; not EP on NVLink)."""
    out = dict(res[0]["ep"], timing_by_rank=[r["ep"]["timing"] for r in res])
    out.pop("timing")
    checks = {
        "y on rows routed alike": out["y_rel_l2_rows_alike"] <= DIST_EP_REL_L2,
        "aux": out["aux_rel"] <= DIST_EP_REL_L2,
        "pinned y": out["pinned_y_rel_l2"] <= DIST_EP_REL_L2,
        "pinned gradients": max(out["pinned_grad_rel_l2"].values()) <=
        DIST_EP_REL_L2,
        "rows routed alike": out["rows_routed_alike"] > 0}
    low = out["low_cf"]
    checks.update({
        "drops card = cpu": low["drops_card"] == low["drops_cpu"],
        "drops at C_send": low["drops_card"]["dropped_send"] > 0,
        "drops at C_loc": low["drops_card"]["dropped"] > 0,
        "low-cf y finite": low["y_finite"],
        "low-cf y": low["y_rel_l2_to_cpu"] <= DIST_EP_REL_L2,
        "low-cf aux": low["aux_rel_to_cpu"] <= DIST_EP_REL_L2})
    bad.extend(f"dist-ep: {k}" for k, ok in checks.items() if not ok)
    return out


def phase_dist_tp():
    """Tensor-parallel compute on the card: DIST_TP_WORLD spawned processes
    share it through gloo (NCCL refuses two ranks on one card) on a (1, 4)
    ("data", "model") mesh, at full width, B=1, S=TRAIN_S
    (``_dist_tp_rank``), in one spawn: DIST_TP_PATHS, the scan paths
    (DIST_TP_SCAN_PATHS) and the encoder-decoder (DIST_TP_ENCDEC_PATHS),
    each with its own control (``PATH_CONTROLS``), then the MoE families'
    DIST_TP_MOE_PATHS with EP beside TP and dist-ep's checks of one MoE
    layer (``_ep_report``). Gates, against the unsharded step on
    the same weights and batch (the MoE paths replaying its routing): in
    fp32 (the FMA flash kernels)
    step 1's loss within
    DIST_TP_LOSS_REL, the gradient leaf by leaf (each rank's shard of ``m``
    after step 1) within DIST_TP_M_MULT times the witness's distance on
    that leaf plus DIST_TP_M_FLOOR, the control (the norms summed again)
    outside, and rank 0's updated weights within 2 x lr of the unsharded
    ones (a sanity check: any gradient moves a weight by at most lr at
    step 1, and fp32 rounds it once more); in each dtype step 1's loss and
    grad_norm (fp32: every step's loss) within DIST_TP_REL of the fp32
    unsharded step's, the witnesses (the unsharded step with the split
    step's sums taken in parts, ``_sums_in_parts``, and in bf16 the
    unsharded bf16 step) inside and in bf16 the control (the attention's
    all-reduce over "model" dropped) outside; on each rank every flash
    launch on the dtype's route, 2 x layers forwards (remat) and layers
    backwards a step, each launch's shapes held against the plain versions
    (``_hold_recorded``). Reports ms per step and peak GiB per rank (of
    step 1), the all-reduces a step and one's host-staged time (gloo, not
    NVLink). Then the serving gates of each path and dtype
    (``_serve_report``, DIST_TP_PROMPTS): fp32 greedy tokens equal to the
    unsharded run's, every call's logits within DIST_TP_SERVE_REL, the
    witness inside and in bf16 the control outside, every rank's logits
    the same, layers x prompts flash launches a rank, all on the dtype's
    route and each held against the plain version; its prefill ms per
    prompt, decode ms per step, peak and cache GiB per rank beside the
    unsharded run's, the collectives a decode step and one's host-staged
    ms."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    paths = _dist_tp_paths()
    t0 = time.perf_counter()
    res = run_ranks(_dist_tp_rank, DIST_TP_WORLD,
                    (DEVICE, paths, TRAIN_S,
                     (get_config(DIST_ARCH), DIST_EP_TOKENS)),
                    backend="gloo", device=DEVICE, timeout_s=DIST_TP_JOIN_S)
    out = {"spawn_and_run_s": time.perf_counter() - t0, "cases": {},
           "all_reduce_ms": res[0]["all_reduce_ms"], "launches": {},
           "flash_launches_by_kernel": {"tc": 0, "fma": 0},
           "flash_bwd_launches_by_route": {"tc": 0, "fma": 0},
           "ssd_launches_by_kernel": {"tc": 0, "fma": 0},
           "seconds_by_case_rank0": res[0]["seconds"]}
    bad = []
    for path in paths:
        arch = path["label"]
        for dtype in dict.fromkeys(tuple(path["steps"]) +
                                   tuple(path["serve_dtypes"])):
            key = f"{arch} {dtype}"
            c = {}
            if dtype in path["steps"]:
                c = _train_report(arch, path["train"], key,
                                  path["steps"][dtype], res, bad, out,
                                  path.get("control"))
                log(f"dist-tp: {key}: {json.dumps(c)}")
            if dtype in path["serve_dtypes"]:
                route = "tc" if dtype == "bfloat16" else "fma"
                c["serve"] = sv = _serve_report(
                    arch, path["serve"], key, route, res, bad,
                    path["decode"])
                for r in res:
                    _add_launches(out, r["cases"][key]["serve"])
                log(f"dist-tp: {key} serving: {json.dumps(sv)}")
            out["cases"][key] = c
    out["ep"] = _ep_report(res, bad)
    log(f"dist-tp: dist-ep's checks of one MoE layer: "
        f"{json.dumps(out['ep'])}")
    log(f"dist-tp: {DIST_TP_WORLD} gloo ranks on one card, launches "
        f"{json.dumps(out['launches'])}, all-reduce of a layer's activations"
        f" (host-staged by gloo) {json.dumps(out['all_reduce_ms'])}, "
        f"{out['spawn_and_run_s']:.1f} s; by case (rank 0) "
        f"{json.dumps(out['seconds_by_case_rank0'])}")
    assert not bad, bad
    return out


# checkpoint: deepseek-7b at full width and one layer. Its {step, params,
# m, v} takes 12 B/param: 12.50 GB at 1 layer (the two vocabulary tables
# hold 0.84 of its 1.04 B params), 14.92 GB at 2, 39.2 GB at 12, which the
# save holds in host memory once more and the restore reads back; one
# layer keeps the run inside its time limit beside dist-tp's serving
# (zlib at level 1 writes some 180 MB/s on 8 cores where zstandard is
# absent: 2.4 GB less is some 20 s less of write and restore)
CKPT_LAYERS = 1
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
    (``_evict``; the guest does not cache the 9p mount's files, and a
    second restore read the same rate)."""
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
        f"{out['restore_s']:.3f} s ({out['restore_gb_s']:.3f} GB/s); "
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
# fails at 28, restarts from step 25 (60 steps, a failure at 30, until
# dist-tp's scan paths took their time)
E2E_ARGS = ["--steps", "30", "--fail-at", "28"]


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
    chunks). A bf16 launch's o, dq, dk and dv also beside SDPA (a correct
    code that rounds P to bf16, as the tensor-core kernel does), where it
    takes the call: on a model's activations, whose outputs can be large
    sums that cancel, P's rounding can put a few elements outside TOL.
    Then the kernel may put no larger a share of elements outside it than
    SDPA does, and each of its elements outside TOL must lie within
    SDPA_ERR_MULT times the larger of TOL and SDPA's own error on that
    element. These launches come after the path's counts were read."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    rows, bad = [], []
    for (kind, _, _), (ts, kw) in calls.items():
        kw = dict(kw)
        name = str(ts[0].dtype).split(".")[-1]
        sdpa = name == "bfloat16" and not kw["softcap"] and (
            not kw["causal"] or ts[0].shape[1] == ts[1].shape[1])
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
                lib = {"o": _sdpa_witness(
                    None, *ts, causal=kw["causal"], window=kw["window"],
                    scale=kw["scale"])} if sdpa else {}
            else:
                got = fa.flash_attention_bwd(*ts, **kw)
                want = fa.attention_bwd_plain(*ts, **kw)
                wit = fa.attention_bwd_plain(*ts, chunk_q=64, chunk_k=64,
                                             **kw)
                pairs = list(zip(("dq", "dk", "dv"), got, want, wit))
        if kind == "bwd" and sdpa:
            q, k, v, _, _, do = ts
            lib = dict(zip(("dq", "dk", "dv"), _sdpa_grads(
                q, k, v, do, kw["scale"], kw["causal"], kw["window"])))
        elif kind == "bwd":
            lib = {}
        torch.cuda.synchronize()
        rtol, atol = TOL[name]

        def outside(a, b):
            diff = (a.float() - b.float()).abs()
            tol = atol + rtol * b.float().abs()
            return diff, tol, diff > tol
        errs, ok = {}, True
        for lb, a, b, w in pairs:
            diff, tol, out = outside(a, b)
            errs[lb] = {"max_abs_err": diff.max().item(), "rel_l2": _rel(a, b),
                        "witness_rel_l2": _rel(w, b),
                        "share_outside_tol": out.float().mean().item()}
            within = errs[lb]["share_outside_tol"] == 0
            if lb in lib:
                ldiff, _, lout = outside(lib[lb], b)
                # each element outside TOL against the larger of TOL and
                # SDPA's error on it
                over = (diff / torch.maximum(ldiff, tol))[out]
                errs[lb].update(
                    sdpa_max_abs_err=ldiff.max().item(),
                    sdpa_rel_l2=_rel(lib[lb], b),
                    sdpa_share_outside_tol=lout.float().mean().item(),
                    outside_err_over_sdpa=over.max().item() if over.numel()
                    else 0.0)
                within = within or (
                    errs[lb]["share_outside_tol"] <=
                    errs[lb]["sdpa_share_outside_tol"] and
                    errs[lb]["outside_err_over_sdpa"] <= SDPA_ERR_MULT)
            ok = ok and within and errs[lb]["rel_l2"] <= REL_L2[name] \
                and bool(torch.isfinite(a).all())
        row = {"kind": kind, "q": list(ts[0].shape), "k": list(ts[1].shape),
               "dtype": name, "options": kw, "errors": errs, "ok": ok}
        rows.append(row)
        log(f"{label} holds {json.dumps(row)}")
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
    12 x 768, fp32, ``--steps 30 --fail-at 28``: fails at 28, restarts
    from the checkpoint of step 25, 33 steps; then the same command
    uninterrupted, 30 steps; the losses by state["step"] held by
    ``_restart_gate``, the
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
            out[label]["held"] = _hold_recorded(f"examples: {label}", calls)
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
    for label, n_steps in (("train_e2e", 33), ("train_e2e_uninterrupted",
                                                30)):
        assert out[label]["flash"] == {"tc": 0,
                                       "fma": 2 * layers * n_steps}, out
        assert out[label]["bwd"] == {"tc": 0, "fma": layers * n_steps}, out
    assert failed["restarted"] == train_e2e.CKPT_EVERY, failed
    assert failed["final_step"] == 31 and clean["final_step"] == 30
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
    out["train_e2e_losses"] = {s: clean["losses"][s] for s in (1, 26, 28,
                                                                30)}

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
        f"losses at state steps 1, 26, 28, 30 "
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

    # the roofline phase's traces are host work: they run beside the build
    pool, traces = start_roofline_traces()
    try:
        return _phases(run, failed, name, smi, traces)
    finally:
        pool.shutdown(cancel_futures=True)


def _phases(run, failed, name, smi, traces):
    """Every phase after the card check, in order (the module's
    docstring)."""
    import torch
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
        # alone; only PROFILED paths are profiled (time on the card)
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
                        if arch in PROFILED else None)
            served[2].update(logits_rel_l2=logits, profile=profiled)
            paths[arch] = served
        del lm                  # free the card for the next path
        gc.collect()
        torch.cuda.empty_cache()
    trains = {t: run(t, phase_train, t) for t in TRAIN_PATHS}
    roofline = run("roofline", phase_roofline,
                   {t: r for t, r in trains.items() if r is not None},
                   traces)
    dist_train = run("dist-train", phase_dist_train)
    dist_tp = run("dist-tp", phase_dist_tp)
    saved = run("ckpt", phase_ckpt)
    examples = run("examples", phase_examples)
    timings = (timing, timing_ssd, timing_rglru, timing_bwd)
    if failed or any(t is None for t in timings) or len(paths) < len(PATHS) \
            or None in trains.values() or saved is None or examples is None \
            or dist_train is None or dist_tp is None \
            or roofline is None:
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
        if dist_train["launches"][kname]:
            by_path["dist-train"] = dist_train["launches"][kname]
        if dist_tp["launches"][kname]:       # the four ranks' together
            by_path["dist-tp"] = dist_tp["launches"][kname]
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
                + dist_train["flash_launches_by_kernel"][k]
                + dist_tp["flash_launches_by_kernel"][k]
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
                + dist_train["flash_bwd_launches_by_route"][k]
                + dist_tp["flash_bwd_launches_by_route"][k]
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
                       for p in paths.values())
                + sum(t["ssd_launches_by_kernel"][k]
                      for t in trains.values())
                + dist_tp["ssd_launches_by_kernel"][k]
                for k in ("tc", "fma")}
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
                    "train": trains, "roofline": roofline,
                    "dist_train": dist_train, "dist_tp": dist_tp,
                    "ckpt": saved,
                    "examples": examples}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
