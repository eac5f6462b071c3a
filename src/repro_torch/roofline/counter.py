"""FLOPs, bytes, collectives and peak memory of one step, counted on fake
tensors (the counterpart of ``repro/roofline/hlo.py``, which parses the
post-SPMD XLA HLO text of a compiled step; a torch step has no such text).

``Counter`` is a ``TorchDispatchMode``. Run the step on ``meta`` tensors
(or on fake ones inside a ``torch._subclasses.fake_tensor.FakeTensorMode``:
the same counts, some 3 times slower, as its ops dispatch in Python) and
inside a ``Counter``: every aten op then runs on shapes alone (no memory
is allocated, no device is touched) and the counter sees it once, on one
rank's local tensors (a DTensor op is handed back to DTensor, whose local
ops the counter then sees). It keeps, as ``hlo.analyze_text`` does:

  * ``flops``  — matmul and convolution FLOPs, by the formulas of
                 ``torch.utils.flop_counter`` (the reference counts dot
                 and convolution FLOPs only);
  * ``bytes``  — operand plus output bytes of each op that touches memory
                 (views, ``detach`` and allocations without a write are
                 free). Eager ops are not fused, so this is an upper bound
                 on the reference's fusion-aware count;
  * ``collective_bytes`` and ``by_op`` — the input bytes of each c10d
                 collective, by the reference's names (``all-gather``,
                 ``all-reduce``, ``reduce-scatter``, ``all-to-all``;
                 ``broadcast``), with counts;
  * ``op_histogram`` — op frequency (the reference's opcode histogram);
  * ``peak_bytes`` — the peak of the bytes of storages created inside the
                 counter and still alive (the reference's temp size: live
                 memory above the arguments).

Remat recompute is counted as it runs (the counterpart of the reference's
loop-trip scaling): a checkpointed layer's forward shows twice.
"""
from __future__ import annotations

import functools
import weakref
from collections import Counter as _Tally
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ops that allocate without writing, or only relabel memory
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "wait_tensor", "set_",
         "_wrap_tensor_autograd"}

# the collectives the port issues (c10d's, and the functional ones DTensor
# redistributes with), by overload packet name -> the reference's name;
# the c10d ops that take their output first read their input from args[1]
_COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_OUTPUT_FIRST = {"allgather_", "_allgather_base_", "reduce_scatter_",
                 "_reduce_scatter_base_", "alltoall_base_"}


def _tensors(tree):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, dict):
            stack.extend(t.values())
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _describe(func):
    """What the counter does with ``func``: (histogram name or None,
    whether its bytes count, its FLOP formula or None, its collective's
    name or None and whether its input is args[1], whether its results are
    new storage)."""
    from torch.utils.flop_counter import flop_registry
    name = func.overloadpacket.__name__
    ns = func.namespace
    if ns == "prim" or name.startswith("sym_"):
        return None, False, None, None, False, False
    coll = _COLLECTIVES.get(name) if ns in ("c10d", "_c10d_functional") \
        else None
    fresh = all(r.alias_info is None for r in func._schema.returns)
    return (f"{ns}.{name}", not (name in _FREE or func.is_view),
            flop_registry.get(func.overloadpacket), coll,
            name in _OUTPUT_FIRST, fresh)


class Counter(TorchDispatchMode):
    """Counts the ops run under it (the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, dict] = defaultdict(
            lambda: {"bytes": 0.0, "count": 0})
        self.histogram: _Tally = _Tally()
        self.live = 0
        self.peak_bytes = 0
        self._live: Dict[int, object] = {}
        self._info = {}

    # -- memory ---------------------------------------------------------------
    def _freed(self, key, n, _ref):
        if self._live.pop(key, None) is not None:
            self.live -= n

    def _track(self, out):
        """Count each result's storage that is new (a result that aliases
        an input, a view or an in-place one, is not)."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = weakref.ref(
                st, functools.partial(self._freed, key, n))
            self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if DTensor in types or any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor runs its local ops under us
        out = func(*args, **kwargs)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _describe(func)
        name, counts_bytes, flop, coll, out_first, fresh = info
        if name is None:
            return out
        self.histogram[name] += 1
        if fresh:
            self._track(out)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        if coll is not None:
            src = args[1] if out_first else args[0]
            self.by_op[coll]["bytes"] += _nbytes(src)
            self.by_op[coll]["count"] += 1
        if counts_bytes:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    # -- results -------------------------------------------------------------
    def totals(self) -> dict:
        """The keys of ``hlo.analyze_text``."""
        by_op = {k: dict(v) for k, v in self.by_op.items()}
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": sum(v["bytes"] for v in by_op.values()),
                "by_op": by_op}

    def op_histogram(self, top: int = 12) -> Dict[str, int]:
        """Op frequency, the ``top`` most frequent (``hlo.op_histogram``)."""
        return dict(self.histogram.most_common(top))

