"""``repro_torch.launch.dryrun`` on small meshes and through its CLI: the
reference's JSONL record on both production meshes, the port's gathered
compute (equal FLOPs on (2, 4) and (2, 1): the batch splits over "data"
only and every rank computes on whole weights; ROADMAP Queue 1 item 4
replaces this test when tensor-parallel compute lands), and a train
cell traced with the ``OptConfig`` it is given."""
import json

import pytest

from repro_torch.configs import base as TB
from repro_torch.launch import dryrun

REFERENCE_KEYS = {"arch", "shape", "mesh", "devices", "schedule", "impl",
                  "remat", "rules", "capacity_factor", "qkv_constraint",
                  "memory", "cost", "collectives", "op_histogram", "params",
                  "roofline"}


def test_cli_writes_the_reference_record(tmp_path):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                        "--both-meshes", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["devices"]) for r in recs] == [
        ("16x16", 256), ("2x16x16", 512)]
    for r in recs:
        assert REFERENCE_KEYS <= set(r)
        assert r["memory"]["per_device_total"] > 0
    # 128 sequences over ("pod", "data"): 8 a rank, then 4
    assert recs[0]["cost"]["flops_per_dev"] == pytest.approx(
        2 * recs[1]["cost"]["flops_per_dev"], rel=1e-9)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-2.7b"])
def test_model_axis_does_not_split_the_compute(arch, kind):
    """Gathered compute: on (2, 4) each rank does the FLOPs of (2, 1)."""
    cfg = TB.get_smoke_config(arch)
    shape = TB.ShapeConfig("cell", 128, 8, kind)
    f = {m: dryrun.run_cell(cfg, shape, mesh_shape=m, verbose=False)
         ["cost"]["flops_per_dev"] for m in ((2, 4), (2, 1), (8, 1))}
    assert f[(2, 4)] == f[(2, 1)]
    assert f[(2, 1)] == 4 * f[(8, 1)]


def test_train_cell_traces_the_given_opt_config():
    """``run_cell``'s ``opt_cfg`` reaches the traced step: without
    clipping the step skips the clip's scale and its pass over the
    gradients (fewer bytes and ops), with the same matmul FLOPs."""
    from repro_torch.optim.adamw import OptConfig
    cfg = TB.get_smoke_config("deepseek-7b")
    shape = TB.ShapeConfig("cell", 64, 4, "train")
    recs = {c: dryrun.run_cell(cfg, shape, mesh_shape=(1,), verbose=False,
                               opt_cfg=OptConfig(clip_norm=c))
            for c in (1.0, 0.0)}
    assert recs[0.0]["cost"]["flops_per_dev"] == \
        recs[1.0]["cost"]["flops_per_dev"]
    assert recs[0.0]["cost"]["bytes_per_dev"] < \
        recs[1.0]["cost"]["bytes_per_dev"]
    default = dryrun.run_cell(cfg, shape, mesh_shape=(1,), verbose=False)
    for key in ("memory", "cost", "op_histogram"):
        assert default[key] == recs[1.0][key], key
