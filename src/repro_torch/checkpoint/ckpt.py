"""Checkpoints: msgpack + zstd (zlib where ``zstandard`` is absent), one
file per leaf, async writer (mirrors ``repro/checkpoint/ckpt.py``).

The reference's layout: ``<dir>/step_<N:08d>/{manifest.msgpack,
leaf_<i:05d>.bin}``. A leaf file is one zstd frame that records its content
size, or one zlib stream, holding ``msgpack({"dtype", "shape"})`` and then
the array's raw bytes in C order. The manifest is ``{n_leaves, step,
treedef, extra}``; ``treedef`` is a fixed string here, since neither side
ever reads it. Either side restores the other's checkpoints.

A tree is nested dicts and lists of tensors. Its leaves are numbered in
``jax.tree.flatten``'s order, dict keys sorted and lists in index order,
which is what the reference's ``restore`` expects; ``optim.adamw.
state_tree`` nests the port's AdamW state that way.

``restore(ckpt_dir, like)`` differs from the reference on purpose: it
copies each leaf into the tensor of ``like`` (on that tensor's device,
after checking its dtype and shape) and returns ``like``, because the AdamW
state's params are the LM's own parameters, which a restore into new
tensors would leave behind. Leaves are compressed and decompressed on a
thread pool (``zlib`` and ``zstandard`` release the interpreter lock).
"""
from __future__ import annotations

import math
import os
import shutil
import threading
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.checkpoint import _msgpack

try:
    import zstandard
except ImportError:          # zlib fallback keeps checkpoints working
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# the manifest's "treedef": the reference writes str(treedef) and never
# parses it; the leaves' order is jax.tree.flatten's (``flatten``)
TREEDEF = "repro_torch: leaves in jax.tree.flatten order"
# the numpy dtype names the reference writes, for the dtypes a state holds
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)}
_NAMES = {d: n for n, d in _DTYPES.items()}


def compressor() -> str:
    """The codec ``save`` writes with: "zstd" or "zlib"."""
    return "zstd" if zstandard is not None else "zlib"


def flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(dotted path, leaf)`` in ``jax.tree.flatten``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _tensor_leaves(tree):
    leaves = list(flatten(tree))
    for path, x in leaves:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"leaf {path}: {type(x).__name__}, not a tensor")
        if x.dtype not in _NAMES:
            raise TypeError(f"leaf {path}: dtype {x.dtype} is not saved")
    return leaves


def _write_leaf(fname: str, t: torch.Tensor):
    head = _msgpack.packb({"dtype": _NAMES[t.dtype],
                           "shape": list(t.shape)})
    data = t.reshape(-1).view(torch.uint8).numpy()
    with open(fname, "wb") as f:
        if zstandard is not None:
            # size= puts the content size in the frame header, which the
            # reference's one-shot ZstdDecompressor().decompress needs
            with zstandard.ZstdCompressor(level=1).stream_writer(
                    f, size=len(head) + data.nbytes, closefd=False) as w:
                w.write(head)
                w.write(data)
        else:
            z = zlib.compressobj(1)
            f.write(z.compress(head))
            f.write(z.compress(data))
            f.write(z.flush())


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard module is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _read_leaf(fname: str):
    with open(fname, "rb") as f:
        raw = _decompress(f.read())
    meta, off = _msgpack.unpack(raw, 0)
    return meta, raw, off


def _leaf_tensor(path: str, meta, raw: bytes, off: int, like: torch.Tensor):
    """The leaf's bytes as a CPU tensor (a view of ``raw``), checked
    against ``like``'s dtype and shape."""
    shape = tuple(meta["shape"])
    if meta["dtype"] != _NAMES[like.dtype] or shape != tuple(like.shape):
        raise ValueError(f"leaf {path}: checkpoint holds {meta['dtype']} "
                         f"{list(shape)}, the target {_NAMES[like.dtype]} "
                         f"{list(like.shape)}")
    dtype = _DTYPES[meta["dtype"]]
    n = math.prod(shape)
    if len(raw) - off != n * dtype.itemsize:
        raise ValueError(f"leaf {path}: {len(raw) - off} bytes of data for "
                         f"{n} x {dtype}")
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():      # read-only bytes; only read here
        warnings.filterwarnings("ignore", "The given buffer is not writable")
        return torch.frombuffer(raw, dtype=dtype, count=n,
                                offset=off).reshape(shape)


class _Writer(threading.Thread):
    """The async writer; ``join`` re-raises what the write raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self.error: Optional[Exception] = None

    def run(self):
        try:
            self._fn()
        except Exception as e:        # handed to the caller by join()
            self.error = e
        finally:
            self._fn = None           # drops the host copy it holds

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


def save(path: str, tree: Any, *, step: int, extra: Optional[Dict] = None,
         async_write: bool = False):
    """Save a tree of tensors. Returns the checkpoint directory, or
    ``(directory, thread)`` with ``async_write``. Every leaf is copied to
    host memory before ``save`` returns, so the caller may update the
    tensors in place at once; the thread compresses and writes, and
    publishes the directory by ``os.replace`` when every file is written.
    """
    d = os.path.join(path, f"step_{step:08d}")
    tmp = d + ".tmp"
    leaves = _tensor_leaves(tree)
    manifest = _msgpack.packb({"n_leaves": len(leaves), "step": step,
                               "treedef": TREEDEF,
                               "extra": extra or {}})
    if os.path.isdir(tmp):                   # left by a crashed save
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # device -> host before any async write, into fresh memory: on the CPU
    # .cpu() and .numpy() would alias the live tensors
    host = [torch.empty(x.shape, dtype=x.dtype).copy_(x.detach())
            for _, x in leaves]

    def write():
        # largest leaves first: the pool's last leaf to finish is a small one
        order = sorted(range(len(host)), key=lambda i: -host[i].nbytes)
        with ThreadPoolExecutor(_workers()) as pool:
            futures = [pool.submit(_write_leaf,
                                   os.path.join(tmp, f"leaf_{i:05d}.bin"),
                                   host[i]) for i in order]
            for f in futures:
                f.result()
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(manifest)
        if os.path.isdir(d):                 # re-save after restart
            shutil.rmtree(d)
        os.replace(tmp, d)                   # atomic publish

    if async_write:
        t = _Writer(write)
        t.start()
        return d, t
    write()
    return d


@torch.no_grad()
def restore(ckpt_dir: str, like: Any) -> Any:
    """Copy the checkpoint's leaves into the tensors of ``like``, a tree of
    the saved structure, in place and on their devices; returns ``like``
    once every copy has completed. Raises on a leaf count, dtype or shape
    that differs, before writing any."""
    with open(os.path.join(ckpt_dir, "manifest.msgpack"), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    leaves = _tensor_leaves(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"structure mismatch: the checkpoint holds "
                         f"{manifest['n_leaves']} leaves, the target "
                         f"{len(leaves)}")
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i][1].nbytes)
    with ThreadPoolExecutor(_workers()) as pool:
        futures = {i: pool.submit(_read_leaf, os.path.join(
            ckpt_dir, f"leaf_{i:05d}.bin")) for i in order}
        read = [futures[i].result() for i in range(len(leaves))]
    # every leaf checked before any is written: a mismatch leaves `like` as
    # it was
    srcs = [_leaf_tensor(path, *read[i], dst)
            for i, (path, dst) in enumerate(leaves)]
    for (_, dst), src in zip(leaves, srcs):
        dst.copy_(src)
    if any(t.is_cuda for _, t in leaves):
        torch.cuda.synchronize()
    return like


def latest(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    return os.path.join(path, steps[-1]) if steps else None


def manifest_extra(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, "manifest.msgpack"), "rb") as f:
        return _msgpack.unpackb(f.read())["extra"]
