"""Logical-axis sharding on ``torch.distributed`` (mirrors
``repro/sharding/partition.py``): rules mapping logical names to mesh
axes, spec resolution with divisibility checks, and the DTensor placements
a resolved spec stands for.

Parameters and activations carry *logical* axis names (``vocab``,
``embed``, ``ffn``, ``heads``, ``experts``, ``batch`` ...). ``resolve()``
turns them into a spec ``P`` for a mesh, dropping any assignment that does
not divide the dimension (a single KV head cannot shard 16 ways).
``activate(mesh, rules)`` installs a mesh for ``constrain``, ``moe_apply``
and the train step; without an active mesh ``constrain`` is the identity.

Storage is not compute. ``resolve`` checks divisibility on a flattened
dimension, so gemma3-1b's ``wk`` (one kv head of 256) is stored split
inside its head on a model axis of 4. How the train step *computes* a
leaf over ``TP_AXIS`` is decided by whole units instead (``tp_plan`` and
``compute_axis``), where the active rules put the unit's logical axis on
``TP_AXIS``: attention (the encoder-decoder's ``enc`` and ``xdec``
self-attention and its cross-attention too) and MLA by heads, the dense
MLP and an MoE layer's shared experts by ffn columns, the RG-LRU block by
RNN channels (its block-diagonal gates by RNN heads), the Mamba-2 block by
SSD heads, the embedding, head and cross-entropy by vocabulary rows; the
routed experts keep their EP shard and every other leaf is gathered
whole. A leaf stored whole (the RG-LRU's ``a_log`` and gate biases,
Mamba-2's ``dt_bias``, ``A_log``, ``D`` and ``norm``) is cut on its last dim
(``compute_dim``), and Mamba-2's ``in_proj`` and ``conv_w`` by sections
(``SECTIONS``): this rank's z, x and dt columns and every B and C column.
A split block's decode cache is the other way round: it
stays at its storage spec, and ``cache_layout`` says which mesh axes that
puts on its sequence and its kv heads (or a scan cache's channels).

A mesh is anything with named axes and sizes: a ``DeviceMesh`` built with
``mesh_dim_names`` (``launch.mesh``), or an ``AbstractMesh`` for resolving
specs without devices. ``placements(spec, mesh)`` gives one DTensor
placement per mesh dimension. A tensor dim sharded over several axes
(``("pod", "data")``) takes them major to minor in the order of the mesh's
dimensions, which is DTensor's order for several ``Shard(i)`` of one dim
and the order of the reference's ``PartitionSpec`` entries.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]

# Default rules: FSDP over "data" (weights' embed dim), TP/EP over "model".
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "embed": "data",          # FSDP shard dim of 2-D weights
    "ffn": "model",           # TP shard dim (mlp hidden, heads*hd, rnn width)
    "heads": "model",
    "experts": "model",       # EP
    "lora": None,
    "norm": None,
    "layers": None,
    "stage": None,
    # decode-cache axes
    "seq_kv": ("data", "model"),   # falls back to unused subset
    "seq_data": "data",
}


class P(tuple):
    """A partition spec: per tensor dim, None, a mesh axis, or a tuple of
    mesh axes (major to minor); trailing Nones are stripped by ``resolve``."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """Named axis sizes without devices, for resolving specs."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)}")
        self.shape = dict(zip(axes, (int(s) for s in shape)))
        self.axis_names = tuple(axes)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


class NamedSharding(NamedTuple):
    """A resolved spec on a mesh; ``placements`` is its DTensor layout."""
    mesh: object
    spec: P

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


# the mesh axis tensor-parallel compute splits over, the mixers it splits
# by heads (the encoder's "enc" and the decoder's "xdec" self-attention
# among them; an xdec layer's cross-attention is the block "cross", split
# with them), and the scan mixers it splits by RNN channels (rec) or SSD
# heads (ssm)
TP_AXIS = "model"
TP_MIXERS = ("attn", "local", "mla", "enc", "xdec")
SCAN_MIXERS = ("rec", "ssm")
# the blocks that split wq/wo (and wk/wv) by heads as attention does
ATTN_BLOCKS = ("attn", "local", "enc", "xdec", "cross")
# compute_axis of a leaf taken by sections of its last dim (Mamba-2's
# in_proj and conv_w: this rank's z, x and dt columns and every B and C one)
SECTIONS = "sections"


class TPPlan(NamedTuple):
    """Which blocks of a model compute split over ``TP_AXIS`` of ``size``
    ranks (``tp_plan``)."""
    size: int
    heads: bool     # attn/local/enc/xdec/cross: wq and wo by heads;
    #                 mla: wq_b/wq, wkv_b, wo
    kv: bool        # wk/wv by kv heads too (else gathered)
    ffn: bool       # dense MLPs by ffn columns (wi*) and rows (wo)
    vocab: bool     # embed and head by vocabulary rows
    shared: bool    # MoE shared experts by ffn columns (wi*) and rows (wo)
    rec: bool       # RG-LRU blocks by RNN channels and heads
    ssm: bool       # Mamba-2 blocks by SSD heads


def _on_model(rules, logical: str) -> bool:
    """Whether ``rules`` put the logical axis on ``TP_AXIS``."""
    axis = rules.get(logical)
    return axis == TP_AXIS or (isinstance(axis, tuple) and TP_AXIS in axis)


def tp_plan(cfg, mixers: Sequence[str], dense_width: int, tp: int,
            rules: Optional[Dict[str, Axis]] = None) -> TPPlan:
    """The compute plan of a model with layer ``mixers`` and dense MLPs of
    ``dense_width`` (0: none) on a model axis of ``tp`` ranks, under
    ``rules`` (default: the active ones). A block splits only where the
    rules put its logical axis on ``TP_AXIS`` ("heads" for the mixers,
    "ffn" for the MLPs, "vocab" for the embedding and head), as the
    reference's GSPMD splits a leaf only there, and only where its unit
    divides the axis: attention (an encoder-decoder's ``enc`` and
    ``xdec`` self-attention and its cross-attention with them) when
    ``num_heads % tp == 0`` (wk/wv only when ``num_kv_heads % tp == 0``,
    else each rank projects the kv heads
    its q heads read from the whole wk/wv), the MLP when ``dense_width %
    tp == 0``, an MoE layer's shared experts when ``num_shared *
    d_ff_expert % tp == 0`` (the routed experts stay on EP), the RG-LRU
    block ("ffn") when ``rnn_width`` and ``rnn_heads`` divide by ``tp``,
    the Mamba-2 block ("ffn") when its SSD heads do, the vocabulary when
    ``padded_vocab % tp == 0`` and some layer block splits (a model none
    of whose layers split computes wholly gathered)."""
    rules = _active()[1] if rules is None else dict(DEFAULT_RULES, **rules)
    tp = int(tp)
    heads = tp > 1 and _on_model(rules, "heads") and \
        any(m in TP_MIXERS for m in mixers) and cfg.num_heads % tp == 0
    kv = heads and cfg.num_kv_heads % tp == 0
    ffn_on = tp > 1 and _on_model(rules, "ffn")
    ffn = ffn_on and dense_width > 0 and dense_width % tp == 0
    moe = cfg.moe
    shared = ffn_on and moe is not None and moe.num_shared > 0 and \
        (moe.num_shared * moe.d_ff_expert) % tp == 0
    rec = ffn_on and "rec" in mixers and \
        (cfg.rnn_width or cfg.d_model) % tp == 0 and cfg.rnn_heads % tp == 0
    ssm = ffn_on and "ssm" in mixers and cfg.ssm is not None and \
        (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim) % tp == 0
    vocab = (heads or ffn or shared or rec or ssm) and \
        _on_model(rules, "vocab") and cfg.padded_vocab % tp == 0
    return TPPlan(tp, heads, kv, ffn, vocab, shared, rec, ssm)


_MLA_SPLIT = ("wq", "wq_b", "wkv_b", "wo")
# the scan blocks' leaves -> the logical axis each is split on; a leaf
# stored whole (logical axes None or "norm") is cut on its last dim
_REC_SPLIT = {"wx": "ffn", "wg": "ffn", "conv_w": "ffn", "wo": "ffn",
              "a_log": "ffn", "b_ga": "ffn", "b_gx": "ffn",
              "w_ga": "heads", "w_gx": "heads"}
_SSM_SPLIT = {"in_proj": SECTIONS, "conv_w": SECTIONS, "out_proj": "ffn",
              "norm": "ffn", "dt_bias": "heads", "A_log": "heads",
              "D": "heads"}


def compute_axis(plan: Optional[TPPlan], block: Optional[str],
                 leaf: str) -> Optional[str]:
    """How the train step computes a leaf: the logical axis it is split on
    over ``TP_AXIS`` ("heads", "ffn" or "vocab"), or None for gathered.
    ``block`` is the leaf's block: a mixer kind, "dense" or "moe" (the
    routed experts and router, never split) for an MLP, "shared" for an
    MoE layer's shared experts, "vocab" for ``embed``/``head``, "cross"
    for an ``xdec`` layer's cross-attention (split as attention is: its
    ``wq``, ``wo``, and ``wk``/``wv`` where the kv heads divide the axis),
    None for the rest (norms). MLA splits ``wq_b`` (or ``wq``),
    ``wkv_b`` and ``wo`` by heads; its ``wq_a``, ``wkv_a`` and norms act
    ahead of the split and are gathered. A split ``rec`` block takes
    every leaf at this rank's RNN channels ("ffn") or heads, a split
    ``ssm`` block at its SSD heads ("heads", or "ffn" for the channels of
    those heads), ``in_proj`` and ``conv_w`` by ``SECTIONS``."""
    if plan is None:
        return None
    if block == "rec":
        return _REC_SPLIT.get(leaf) if plan.rec else None
    if block == "ssm":
        return _SSM_SPLIT.get(leaf) if plan.ssm else None
    if block == "mla" and plan.heads:
        if leaf in _MLA_SPLIT:
            return "heads"
    elif block in ATTN_BLOCKS and plan.heads:
        if leaf in ("wq", "wo") or (leaf in ("wk", "wv") and plan.kv):
            return "heads"
    elif (block == "dense" and plan.ffn) or (block == "shared" and
                                             plan.shared):
        if leaf in ("wi_gate", "wi_up", "wi", "wo"):
            return "ffn"
    elif block == "vocab" and plan.vocab:
        return "vocab"
    return None


def compute_dim(axes: Sequence[Optional[str]], ax: str) -> int:
    """The tensor dim a leaf of logical ``axes`` is split on for
    ``compute_axis`` ``ax``: the dim that names ``ax``, else (a leaf stored
    whole) its last."""
    return axes.index(ax) if ax in axes else len(axes) - 1


def partial_over_model(plan: Optional[TPPlan], block: Optional[str],
                       leaf: str) -> bool:
    """Whether a gathered leaf's gradient is partial over ``TP_AXIS``: it
    is used by this rank's heads only (``q_norm``/``k_norm`` of an
    attention block, and ``wk``/``wv`` when gathered: an ``attn``,
    ``local``, ``enc`` or ``xdec`` mixer's or the ``cross`` block's, whose
    ranks each project the kv heads their q heads read), so the train step
    sums it over the axis. The norms ahead of a split block get whole
    gradients (the copy-to-region's all-reduce) and are not summed; so do
    MLA's ``wq_a``, ``q_norm``, ``wkv_a`` and ``kv_norm``, which act ahead
    of its copy-to-region, and an ``xdec`` layer's ``ln_x`` and the
    encoder's ``enc_norm``, ahead of the cross-attention's."""
    return (plan is not None and block in ATTN_BLOCKS and plan.heads
            and (leaf in ("q_norm", "k_norm") or
                 (leaf in ("wk", "wv") and not plan.kv)))


class CacheLayout(NamedTuple):
    """The mesh axes a decode-cache leaf's resolved spec puts on its batch,
    sequence (or ring-slot) and kv-heads dims, major to minor (() where a
    dim is whole). A scan cache has no sequence; its ``heads`` are its
    channel dim ("ffn": the RG-LRU's window and state, Mamba-2's flat conv
    window) or its SSD heads (Mamba-2's state)."""
    batch: Tuple[str, ...]
    seq: Tuple[str, ...]
    heads: Tuple[str, ...]


def cache_layout(logical: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: Optional[Dict[str, Axis]] = None
                 ) -> CacheLayout:
    """Where a cache leaf of a split block is stored: the cache
    counterpart of ``compute_axis``, and storage, not compute. The
    reference's ``attn_cache_axes`` resolve to heads over "model" with the
    sequence on "data" where the batch leaves it (a kv-head-rich cache), or
    the sequence over ("data", "model") less the axes the batch takes (any
    other), or over no axis where the dim does not divide; a scan cache's
    ``rec_cache_axes``/``ssm_cache_axes`` resolve its channels or heads
    over "model". A split block's decode reads and writes this shard in
    place (``sharding.tp``), so no relayout meets two mesh axes on one
    tensor dim."""
    spec = resolve(logical, shape, mesh, rules)

    def axes(names):
        for i, name in enumerate(logical):
            if name in names and i < len(spec) and spec[i] is not None:
                e = spec[i]
                return (e,) if isinstance(e, str) else tuple(e)
        return ()
    return CacheLayout(axes(("batch",)), axes(("seq_kv", "seq_data")),
                       axes(("heads", "ffn")))


def axis_sizes(mesh) -> Dict[str, int]:
    """The mesh's axis name -> size, in the order of its dimensions."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


_state = threading.local()


def _active():
    return (getattr(_state, "mesh", None),
            getattr(_state, "rules", DEFAULT_RULES))


@contextlib.contextmanager
def activate(mesh, rules: Optional[Dict[str, Axis]] = None):
    prev = _active()
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _axis_size(mesh, axis: Axis) -> int:
    sizes = axis_sizes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, str):
        return sizes.get(axis, 0)
    n = 1
    for a in axis:
        s = sizes.get(a, 0)
        if s == 0:
            return 0
        n *= s
    return n


def resolve(logical: Sequence[Optional[str]],
            shape: Optional[Sequence[int]] = None,
            mesh=None,
            rules: Optional[Dict[str, Axis]] = None) -> P:
    """Logical axes (+ concrete shape for divisibility checks) -> spec."""
    m, r = _active()
    mesh = mesh if mesh is not None else m
    rules = dict(DEFAULT_RULES, **(rules or {})) if rules else r
    sizes = axis_sizes(mesh) if mesh is not None else None
    out, used = [], set()
    for i, name in enumerate(logical):
        axis = rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        flat = (axis,) if isinstance(axis, str) else tuple(axis)
        # keep only axes that exist in the mesh and are not already used
        flat = tuple(a for a in flat if a not in used and
                     (sizes is None or a in sizes))
        if not flat:
            out.append(None)
            continue
        if mesh is not None:
            sz = _axis_size(mesh, flat)
            if sz <= 1 or (shape is not None and shape[i] % max(sz, 1)):
                out.append(None)
                continue
        used.update(flat)
        out.append(flat[0] if len(flat) == 1 else flat)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def placements(spec: Sequence[Axis], mesh):
    """One DTensor placement per mesh dimension: ``Shard(i)`` where tensor
    dim ``i`` names that mesh axis, else ``Replicate()``. A dim over
    several axes must list them in the mesh's order (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} shards over {axes}, not in the "
                             f"mesh's order {tuple(names)}")
        for j in idx:
            out[j] = Shard(dim)
    return tuple(out)


def constrain(x, logical: Sequence[Optional[str]]):
    """Redistribute a DTensor to ``logical``'s spec on the active mesh;
    a plain tensor, or any tensor without an active mesh, is returned as
    it is."""
    mesh, rules = _active()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = resolve(logical, x.shape, mesh, rules)
    return x.redistribute(mesh, placements(spec, mesh))


def _is_axes(t) -> bool:
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


def map_specs(fn, spec_tree, *trees):
    """``fn(axes, *leaves)`` over a tree of dicts and lists whose leaves
    are logical-axes tuples, with trees of the same structure beside it.
    A dict comes out in the key order of the first tree beside it (a
    state's order, which ``apply_updates`` follows), else of ``spec_tree``."""
    if _is_axes(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        keys = trees[0].keys() if trees else spec_tree.keys()
        return {k: map_specs(fn, spec_tree[k], *(t[k] for t in trees))
                for k in keys}
    return [map_specs(fn, v, *(t[i] for t in trees))
            for i, v in enumerate(spec_tree)]


def param_shardings(spec_tree, shape_tree, mesh,
                    rules: Optional[Dict[str, Axis]] = None):
    """Tree of logical-axes tuples + tensors (or shapes) -> tree of
    ``NamedSharding``s."""
    return map_specs(
        lambda axes, arr: NamedSharding(
            mesh, resolve(axes, getattr(arr, "shape", arr), mesh, rules)),
        spec_tree, shape_tree)


def batch_spec(mesh, ndim: int, rules: Optional[Dict[str, Axis]] = None) -> P:
    axes = ["batch"] + [None] * (ndim - 1)
    return resolve(axes, None, mesh, rules)
