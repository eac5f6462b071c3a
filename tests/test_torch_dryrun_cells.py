"""``repro_torch.launch.dryrun`` at full width: a ``train_4k`` cell on the
256-rank single-pod mesh (its tensor-parallel compute per device), and
``--qkv-constraint``, taken by every kind of cell."""
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
    # the state is sharded 256 ways (params, m, v: 12 B/param); each rank
    # gathers its 1/16 of the fp32 weights over "data" and computes their
    # gradients at that shape: heads, ffn and vocabulary split 16 ways
    n = rec["params"]["total"]
    assert 12 * n / 256 < mem["argument_bytes"] < 12 * n / 200
    # at the peak it holds the 30 layers' saved bf16 inputs (remat "full";
    # 16 sequences of 4096 x 4096) and the weights and gradients of its
    # split (4 B/param each over 16); beside them at most eight fp32
    # buffers of its logits' shape (16 x 4096 x 6400: the logits, the
    # cross-entropy's exponentials, their gradients, in fp32 and bf16)
    cfg = TB.get_config("deepseek-7b")
    Bl, S, Vl = 256 // 16, 4096, cfg.padded_vocab // 16
    saved = 30 * Bl * S * cfg.d_model * 2
    floor = saved + 2 * 4 * n / 16
    assert floor < mem["temp_bytes"] < floor + 8 * 4 * Bl * S * Vl
    assert mem["alias_bytes"] >= 12 * n / 256       # the state, in place
    by_op = rec["collectives"]["by_op"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(by_op)
    # the gradients leave each rank at its 1/16, fp32, through a
    # reduce-scatter over "data", but the replicated norm scales' (30 x 2
    # + 1 of 4096), all-reduced
    norms = (2 * 30 + 1) * 4096
    assert by_op["reduce-scatter"]["bytes"] == 4 * (n - norms) / 16
    # a layer's attention and MLP outputs are all-reduced over "model" in
    # the forward, the attention's again in remat's recompute (which stops
    # before the MLP's wo), and the two blocks' input gradients in the
    # backward: 5 x 30 bf16 activations of 16 x 4096 x 4096, summed in fp32
    assert by_op["all-reduce"]["bytes"] >= 5 * 30 * Bl * S * cfg.d_model * 4
    rl = rec["roofline"]
    # every rank runs 1/16 of its 16 sequences' work: the model's FLOPs
    # over 256 ranks, but remat recomputes the layers' forward (8 N D a
    # token there, for 6), and the attention's products come on top
    assert 0.7 < rl["useful_ratio"] < 0.85
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert sum(rec["op_histogram"].values()) > 0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_qkv_constraint_traces_every_kind_of_cell(kind):
    """``batch`` pins q, k and v to heads over "model", which is how the
    port computes them in every cell once serving computes split: a
    train, a prefill and a decode cell take it and trace the same step
    (the same FLOPs and bytes) as without it; so does the CLI on a
    full-width decode cell."""
    cfg = TB.get_smoke_config("deepseek-7b")
    shape = TB.ShapeConfig("cell", 64, 4, kind)
    rec = dryrun.run_cell(cfg, shape, mesh_shape=(2, 2), verbose=False,
                          cfg_overrides={"qkv_constraint": "batch"})
    plain = dryrun.run_cell(cfg, shape, mesh_shape=(2, 2), verbose=False)
    assert rec["qkv_constraint"] == "batch"
    assert rec["cost"] == plain["cost"]
    if kind == "decode":
        assert dryrun.main(["--arch", "stablelm-1.6b", "--shape",
                            "decode_32k", "--qkv-constraint", "batch"]) == 0
