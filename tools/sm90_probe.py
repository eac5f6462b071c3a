#!/usr/bin/env python3
"""Short first chip call for a tensor-core kernel of the port.

    python3 tools/sm90_probe.py          # one CUDA card, nvcc; about 30 s

1. versions, and the card's name and power limit;
2. builds ``tools/sm90_probe.cu`` and ``csrc/flash_attention.cu`` with
   ``-Xptxas -v`` and prints registers, spills and warnings per kernel;
3. one m64n64k16 wgmma with both operands in shared memory (TMA-loaded,
   128-byte swizzle) against ``torch.matmul``, and one m64n128k16 wgmma
   with A in registers and B MN-major, for both orders of the descriptor's
   two strides (only LBO = the 64-column step, SBO = the 8-row step
   agrees).
Exits non-zero if a build fails or a product disagrees. The flash
kernel's cases and times are ``chip_smoke.py``'s (phases ``sweep`` and
``timing``).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

REPORT = ("Compiling entry", "registers", "spill", "arning", "rror")


def main():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("sm90_probe: needs a CUDA card", file=sys.stderr)
        return 1
    nvcc = _build.nvcc_path()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), "|", cs.nvidia_smi())
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    lib_path = ROOT / "build" / "sm90_probe.so"
    lib_path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(lib_path), str(ROOT / "tools/sm90_probe.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        print(res.stderr)
        return 1
    t1 = time.perf_counter()
    report = _build.build("flash_attention", verbose=True)
    print(f"built sm90_probe.cu in {t1 - t0:.1f} s, flash_attention.cu in "
          f"{time.perf_counter() - t1:.1f} s")
    for line in (res.stdout + res.stderr + report).splitlines():
        if any(w in line for w in REPORT):
            print("  ", line.strip().replace("ptxas info    : ", ""))

    bad = []
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.run_ss.argtypes = [P, P, P]
    lib.run_rs.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    a, b = rand(64, 64), rand(64, 64)
    out = torch.zeros(64, 64, device="cuda")
    err = lib.run_ss(a.data_ptr(), b.data_ptr(), out.data_ptr())
    diff = (out - a.float() @ b.float().T).abs().max().item()
    print(f"wgmma SS m64n64k16 x4: code {err}, max abs diff {diff:.3e}")
    if err or diff > 1e-3:
        bad.append("ss")
    p, v = rand(64, 64), rand(64, 128)
    for lbo, sbo, want in ((64 * 128, 1024, True), (1024, 64 * 128, False)):
        out = torch.zeros(64, 128, device="cuda")
        err = lib.run_rs(p.data_ptr(), v.data_ptr(), out.data_ptr(), lbo,
                         sbo)
        diff = (out - p.float() @ v.float()).abs().max().item()
        print(f"wgmma RS m64n128k16 x4, LBO {lbo} SBO {sbo}: code {err}, "
              f"max abs diff {diff:.3e}")
        if err or (diff <= 1e-3) != want:
            bad.append(f"rs {lbo}/{sbo}")
    if bad:
        print("sm90_probe: FAILED", bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
