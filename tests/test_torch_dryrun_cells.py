"""``repro_torch.launch.dryrun`` at full width: a ``train_4k`` cell on the
256-rank single-pod mesh (its gathered compute per device), and the
refusal of ``--qkv-constraint`` until tensor-parallel compute lands
(ROADMAP Queue 1 item 4)."""
import pytest

from repro_torch.configs import base as TB
from repro_torch.launch import dryrun

REFERENCE_KEYS = {"arch", "shape", "mesh", "devices", "schedule", "impl",
                  "remat", "rules", "capacity_factor", "qkv_constraint",
                  "memory", "cost", "collectives", "op_histogram", "params",
                  "roofline"}


def test_full_width_train_cell_on_the_single_pod_mesh():
    rec = dryrun.run_cell("deepseek-7b", "train_4k", verbose=False)
    assert REFERENCE_KEYS <= set(rec)
    assert (rec["mesh"], rec["devices"], rec["impl"]) == ("16x16", 256,
                                                         "plain")
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes", "per_device_total"}
    assert mem["per_device_total"] == mem["argument_bytes"] + \
        mem["temp_bytes"]
    # the state is sharded 256 ways (params, m, v: 12 B/param) but each
    # rank gathers whole fp32 weights and their gradients to compute
    n = rec["params"]["total"]
    assert 12 * n / 256 < mem["argument_bytes"] < 12 * n / 200
    assert mem["temp_bytes"] > 8 * n
    assert mem["alias_bytes"] >= 12 * n / 256       # the state, in place
    by_op = rec["collectives"]["by_op"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(by_op)
    # the gradients leave each rank whole, fp32, through a reduce-scatter,
    # but the replicated norm scales' (30 x 2 + 1 of 4096), all-reduced
    norms = (2 * 30 + 1) * 4096
    assert by_op["reduce-scatter"]["bytes"] == 4 * (n - norms)
    rl = rec["roofline"]
    # every rank runs its 16 sequences on whole weights: 16 times the
    # share of the model's FLOPs that 256 ranks would each take
    assert 0.04 < rl["useful_ratio"] < 1 / 16
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert sum(rec["op_histogram"].values()) > 0


def test_qkv_constraint_needs_tensor_parallel_compute():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        dryrun.main(["--arch", "deepseek-7b", "--shape", "train_4k",
                     "--qkv-constraint", "batch"])
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        dryrun.run_cell(TB.get_smoke_config("deepseek-7b"),
                        TB.ShapeConfig("cell", 64, 4, "train"),
                        mesh_shape=(2, 2), verbose=False,
                        cfg_overrides={"qkv_constraint": "batch"})
