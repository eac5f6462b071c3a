"""``repro_torch.launch.dryrun`` on small meshes and through its CLI: the
reference's JSONL record on both production meshes, the port's
tensor-parallel compute of train and serving cells (on (2, 4) each rank
does (2, 1)'s FLOPs less 3/4 of the split blocks'; the MoE families' do
their gathered (2, 4) step's less 3/4 of theirs, the routed experts on EP
in both; mamba2-2.7b's ``ssm`` blocks split by SSD heads, all but the B
and C sections every rank computes whole; seamless-m4t-large-v2 does its
step with "heads" kept off "model" less 3/4 of its ``enc``, ``xdec`` and
``cross`` blocks' FLOPs),
and a train cell traced with the ``OptConfig`` it is given."""
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


def _split_flops(cfg, B, S):
    """The matmul FLOPs of a train step's split blocks on one rank of a
    mesh without a model axis, B sequences of S tokens: per layer the
    q/k/v/o projections, the attention's two products (the plain path's
    one 512-row block covers S = 128 whole) and the SwiGLU MLP, counted
    four times (forward, remat's recompute, the backward's two products a
    matmul) but the MLP's wo once less (the recompute stops at the last
    tensor the backward needs), and the head three times (no remat)."""
    T, D, F, V = B * S, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    proj = 2 * T * D * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * T * cfg.q_dim * D
    core = 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim
    mlp = 3 * 2 * T * D * F
    layer = 4 * (proj + core + mlp) - 2 * T * F * D
    return cfg.num_layers * layer + 3 * 2 * T * D * V


def _serve_flops(cfg, B, S, kind):
    """The matmul FLOPs of a serving call on one rank of a mesh without a
    model axis, B sequences: a prefill of S tokens (the projections, the
    attention's two products over one 512-row block, the MLP, the head on
    the last token) or a decode step over a cache of S slots (the
    projections of one token, its scores and values over every slot, the
    MLP, the head)."""
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.head_dim
    T = B * S if kind == "prefill" else B
    proj = 2 * T * D * (cfg.q_dim + 2 * cfg.kv_dim) + 2 * T * cfg.q_dim * D
    core = 2 * 2 * B * cfg.num_heads * (S if kind == "prefill" else 1) * \
        S * hd
    mlp = 3 * 2 * T * D * F
    return cfg.num_layers * (proj + core + mlp) + 2 * B * D * V


def _moe_split_flops(cfg, B, S, kind):
    """The matmul FLOPs of the MoE families' split blocks on one rank
    computing them whole, B sequences: per layer the attention (q/k/v/o,
    or MLA's ``wq_b``, ``wkv_b``, ``wo`` and its two products at head dim
    ``qk_nope + qk_rope``; a decode step's absorbed products, ``q_eff``,
    the scores and the context over S slots and ``w_v``), the dense layer
    0's MLP and the head, counted as ``_split_flops`` and ``_serve_flops``
    count them. The shared experts are not among them: gathered beside EP
    they run on the rank's quarter of the tokens, split on every token at
    a quarter of the width, the same FLOPs."""
    D, V, H, Fd = cfg.d_model, cfg.padded_vocab, cfg.num_heads, \
        cfg.moe.d_ff_dense
    T, Sq = (B * S, S) if kind != "decode" else (B, 1)
    m = cfg.mla
    if m is None:
        proj = 2 * T * D * (cfg.q_dim + 2 * cfg.kv_dim) + \
            2 * T * cfg.q_dim * D
        core = 2 * 2 * B * H * Sq * S * cfg.head_dim
    else:
        L, v, nope = m.kv_lora_rank, m.v_head_dim, m.qk_nope_head_dim
        qk = nope + m.qk_rope_head_dim
        proj = 2 * T * m.q_lora_rank * H * qk + 2 * T * H * v * D
        if kind != "decode":
            proj += 2 * T * L * H * (nope + v)
            core = 2 * 2 * B * H * Sq * S * qk
        else:
            proj += 2 * B * H * nope * L + 2 * B * H * L * v
            core = 2 * B * H * S * (L + m.qk_rope_head_dim) + \
                2 * B * H * S * L
    mlp = 3 * 2 * T * D * Fd
    if kind == "train":
        return cfg.num_layers * 4 * (proj + core) + 4 * mlp - \
            2 * T * Fd * D + 3 * 2 * T * D * V
    return cfg.num_layers * (proj + core) + mlp + 2 * B * D * V


def _encdec_mixer_flops(cfg, B, S, kind):
    """The matmul FLOPs of the encoder-decoder's ``enc``, ``xdec`` and
    ``cross`` blocks on one rank computing them whole, B sequences of S
    tokens over S frames: per encoder and decoder layer the self
    attention's q/k/v/o projections and two products (one 512-row block
    covers S = 128 whole, causal or not), per decoder layer the
    cross-attention's q and o projections of the tokens, its k and v of
    the frames and its two products, counted four times in a train step
    (forward, remat's recompute, the backward's two products a matmul)
    and once in a prefill; a decode step projects one token, attends over
    the S slots of its self cache and the S frames of its cross cache,
    and projects no frame."""
    D, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    core = 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim
    if kind == "decode":
        qo = 2 * B * D * q * 2
        self_ = qo + 2 * B * D * 2 * kv + core // S
        return cfg.num_layers * (self_ + qo + core // S)
    T = B * S
    self_ = 2 * T * D * (q + 2 * kv) + 2 * T * q * D + core
    cross = 2 * T * D * q * 2 + 2 * T * D * 2 * kv + core
    mix = cfg.encoder_layers * self_ + cfg.num_layers * (self_ + cross)
    return (4 if kind == "train" else 1) * mix


def _ssm_whole_flops(cfg, B, kind):
    """The matmul FLOPs of mamba2-2.7b's split step that every rank of the
    model axis computes whole, B sequences of 128 tokens: ``in_proj``'s B
    and C columns (four times in a train step: forward, remat's recompute,
    the backward's two products) and, in a decode step, the conv window's
    B and C channels (``einsum("bkc,kc->bc")``; a full sequence's conv is
    elementwise)."""
    s = cfg.ssm
    gn2 = 2 * s.ngroups * s.d_state
    T = B * 128 if kind != "decode" else B
    flops = 2 * T * cfg.d_model * gn2 * (4 if kind == "train" else 1)
    if kind == "decode":
        flops += 2 * B * s.d_conv * gn2
    return cfg.num_layers * flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-2.7b",
                                  "deepseek-moe-16b", "deepseek-v2-236b",
                                  "seamless-m4t-large-v2"])
def test_model_axis_splits_the_train_compute(arch, kind):
    """deepseek-7b on (2, 4): each rank does (2, 1)'s FLOPs less 3/4 of
    its attention's, MLPs' and head's, which are all of them: in the train
    step (``_split_flops``) and in the serving calls (``_serve_flops``; a
    decode step attends every head over its quarter of the cache, whose
    sequence is split over "model"). mamba2-2.7b's ``ssm`` blocks split by
    SSD heads and its vocabulary by rows: (2, 4) does (2, 1)'s FLOPs less
    3/4 of all but those every rank computes whole (``_ssm_whole_flops``).
    The MoE families on (2, 4) do the FLOPs of the
    same step with "heads", "ffn" and "vocab" kept off "model" (EP beside
    gathered compute: the routed experts as in the split step) less 3/4
    of their split blocks' (``_moe_split_flops``). seamless-m4t-large-v2
    on (2, 4) does the FLOPs of the same step with "heads" kept off
    "model" (its MLPs and vocabulary split in both) less 3/4 of its
    ``enc``, ``xdec`` and ``cross`` blocks' (``_encdec_mixer_flops``)."""
    cfg = TB.get_smoke_config(arch)
    shape = TB.ShapeConfig("cell", 128, 8, kind)
    if cfg.encoder_layers:
        split, gathered = (dryrun.run_cell(
            cfg, shape, mesh_shape=(2, 4), verbose=False, rules=rules)
            ["cost"]["flops_per_dev"] for rules in (None, {"heads": None}))
        assert split == gathered - 3 * _encdec_mixer_flops(cfg, 4, 128,
                                                           kind) / 4
        return
    if cfg.moe is not None:
        split, gathered = (dryrun.run_cell(
            cfg, shape, mesh_shape=(2, 4), verbose=False, rules=rules)
            ["cost"]["flops_per_dev"] for rules in (
                None, {"heads": None, "ffn": None, "vocab": None}))
        assert split == gathered - 3 * _moe_split_flops(cfg, 4, 128,
                                                        kind) / 4
        return
    f = {m: dryrun.run_cell(cfg, shape, mesh_shape=m, verbose=False)
         ["cost"]["flops_per_dev"] for m in ((2, 4), (2, 1), (8, 1))}
    assert f[(2, 1)] == 4 * f[(8, 1)]
    if arch == "deepseek-7b":
        split = (_split_flops(cfg, 8 // 2, 128) if kind == "train" else
                 _serve_flops(cfg, 8 // 2, 128, kind))
        assert split == f[(2, 1)]
        assert f[(2, 4)] == f[(2, 1)] - 3 * split / 4
    else:
        split = f[(2, 1)] - _ssm_whole_flops(cfg, 8 // 2, kind)
        assert 0 < split < f[(2, 1)]
        assert f[(2, 4)] == f[(2, 1)] - 3 * split / 4


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
