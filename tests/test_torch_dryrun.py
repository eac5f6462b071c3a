"""``repro_torch.launch.specs`` and ``dryrun`` held against the JAX
reference on a mesh of 8 host devices (``tests/jax_mesh_ref.py``, in a
subprocess, as the other multi-device files): every argument leaf's shape,
dtype and resolved spec for one train, one prefill and one decode cell per
family, and per-device FLOPs of three smoke cells per kind on the (8, 1)
mesh against ``roofline.hlo.analyze_text`` of the compiled step.

The FLOPs gap, term by term (the port runs ``impl="plain"``, the
reference its CPU default ``"blocked"``, both at remat "full"):
* deepseek-7b: none. The blocked attention's "full" schedule computes
  every block, the plain one skips the blocks the mask rules out, but at
  S=128 both are one 128-row block; torch's checkpoint skips the MLP down
  projection in its recompute and XLA's remat the same product.
* mamba2-2.7b: prefill and decode none; train 262144 FLOPs (0.15%) fewer
  than the reference's: XLA lowers the backward of the SSD's in-chunk
  cumulative log-decay (``cumsum`` over Q rows) to a dot against a Q x Q
  triangular matrix, 2 (S/Q) Q H Q FLOPs a layer and sequence (S=128,
  Q=32, H=8: 65536); the port's ``cumsum`` backward is a reversed cumsum,
  no product. The test holds the gap to that count exactly.
* deepseek-moe-16b: the expert buffers only. Each rank sizes its capacity
  from its own tokens, C = ceil4(int(T K cf / E) + 1) at T = its batch
  slice, the reference's GSPMD from the global batch and splits the buffer
  over the 8 devices: the port computes E (C_rank - C_global / 8) more
  rows in each MoE layer, 3 products of 2 D F FLOPs a row, once per
  forward (4 times in a train step: forward, recompute, two backward
  products). The test holds the gap to that count exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import base as TB
from repro_torch.launch import dryrun, specs
from repro_torch.models.layers import flatten_paths

ROOT = Path(__file__).resolve().parent.parent
MESH = (2, 4)
FAMILY_ARCH = {}
for _a in TB.ARCH_IDS:
    FAMILY_ARCH.setdefault(TB.get_config(_a).family, _a)
SPEC_CELLS = [(a, s) for a in FAMILY_ARCH.values()
              for s in ("train_4k", "prefill_32k", "decode_32k")]
FLOP_ARCHS = ("deepseek-7b", "deepseek-moe-16b", "mamba2-2.7b")
KINDS = ("train", "prefill", "decode")
FLOP_CELLS = [(a, k) for a in FLOP_ARCHS for k in KINDS]
B, S = 8, 128


def _start_job(job, cases, tmp):
    d = tmp / job
    d.mkdir()
    (d / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    return d, subprocess.Popen(
        [sys.executable, str(ROOT / "tests/jax_mesh_ref.py"), job, str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(job, started):
    d, proc = started
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads((d / f"{job}.json").read_text())


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Both jobs in two subprocesses at once."""
    tmp = tmp_path_factory.mktemp("jax_dryrun")
    specs_job = _start_job("specs", [[a, s, list(MESH)]
                                     for a, s in SPEC_CELLS], tmp)
    flops_job = _start_job("flops", [[a, k, B, S, [8, 1]]
                                     for a, k in FLOP_CELLS], tmp)
    spec_out = _result("specs", specs_job)
    flop_out = _result("flops", flops_job)
    return dict(zip(SPEC_CELLS, spec_out)), dict(zip(FLOP_CELLS, flop_out))


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _port_leaves(spec):
    """Dotted path -> [shape, dtype, spec] of every argument leaf, keyed as
    the reference's pytree paths."""
    out = {}
    for i, (args, shs) in enumerate(zip(spec["args"],
                                        spec["in_shardings"])):
        if not isinstance(args, dict):
            args, shs = {"": args}, {"": shs}
        flat = dict(flatten_paths(args))
        flat_sh = dict(_flat_shardings(shs))
        for path, t in flat.items():
            key = f"{i}.{path}" if path else str(i)
            out[key] = [list(t.shape), str(t.dtype).split(".")[-1],
                        [_entry(e) for e in flat_sh[path].spec]]
    return out


def _flat_shardings(tree, prefix=""):
    from repro_torch.sharding.partition import NamedSharding
    if isinstance(tree, NamedSharding):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_shardings(v, f"{prefix}{k}.")
    else:
        for j, v in enumerate(tree):
            yield from _flat_shardings(v, f"{prefix}{j}.")


@pytest.mark.parametrize("arch,shape", SPEC_CELLS)
def test_input_specs_match_jax(jax_side, arch, shape):
    """Shapes, dtypes and resolved specs of every argument leaf: the train
    state and batch, a prefill's weights and batch, a decode's weights,
    cache and tokens (the encoder-decoder's frontend sized to the shape)."""
    from repro_torch.sharding.partition import AbstractMesh
    mesh = AbstractMesh(MESH, ("data", "model"))
    spec = specs.input_specs(arch, TB.SHAPES[shape], mesh)
    got = _port_leaves(spec)
    want = jax_side[0][(arch, shape)]
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())[:10]
    diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not diff, list(diff.items())[:5]


def _expert_rows_gap(cfg, kind):
    """FLOPs of the rows the port's expert buffers add over the
    reference's per-device share (the module's docstring)."""
    from repro_torch.models.moe import _capacity
    m = cfg.moe
    T_rank = (B // 8) * (S if kind != "decode" else 1)
    rows = m.num_experts * (_capacity(T_rank, cfg) -
                            _capacity(T_rank * 8, cfg) / 8)
    n_moe = cfg.num_layers - m.first_k_dense
    passes = 4 if kind == "train" else 1
    return passes * n_moe * rows * 3 * 2 * cfg.d_model * m.d_ff_expert


@pytest.mark.parametrize("arch,kind", FLOP_CELLS)
def test_per_device_flops_match_jax(jax_side, arch, kind):
    cfg = TB.get_smoke_config(arch)
    rec = dryrun.run_cell(cfg, TB.ShapeConfig("cell", S, B, kind),
                          mesh_shape=(8, 1), verbose=False)
    got = rec["cost"]["flops_per_dev"]
    want = jax_side[1][(arch, kind)]
    if cfg.moe is not None:
        assert got - want == _expert_rows_gap(cfg, kind) > 0
    elif arch == "mamba2-2.7b" and kind == "train":
        Q, H = cfg.ssm.chunk_size, cfg.ssm.expand * cfg.d_model // \
            cfg.ssm.head_dim
        cumsum_dots = cfg.num_layers * (B // 8) * 2 * (S // Q) * Q * H * Q
        assert want - got == cumsum_dots
    else:
        assert got == want
