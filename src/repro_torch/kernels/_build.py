"""Build a CUDA source of ``csrc/`` with ``nvcc`` and load it with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled at first
use into ``build/repro_torch_kernels/`` at the root of the checkout, under a
file name that carries a hash of the source, of every ``csrc/`` header it
includes (``#include "name.cuh"``, followed recursively) and of the flags,
so an edited source, header or flag rebuilds. There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of repro_torch are built from source")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, in the
    order first met."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, *, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing (always, when
    ``verbose``) and return the compiler's report (``-Xptxas -v`` when
    ``verbose``: registers, shared memory and spills per kernel)."""
    out = library_path(name)
    if out.exists() and not verbose:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builds race benignly
    return res.stdout + res.stderr


def load(name: str) -> ctypes.CDLL:
    """Build on first use, then load the library once per process."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
