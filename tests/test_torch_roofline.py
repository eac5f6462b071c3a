"""``repro_torch.roofline``: parameter counts and model FLOPs equal to the
JAX reference's (``repro/roofline/analysis.py``) for every arch and every
applicable shape, the roofline terms on the H100's figures, and the
counter (``roofline/counter.py``) on shapes whose FLOPs, bytes and
collective bytes have a closed form."""
import contextlib

import pytest
import torch

from repro_torch.configs import base as TB
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.counter import Counter

ARCHS = TB.ARCH_IDS
CELLS = [(a, s) for a in ARCHS for s in TB.SHAPES if TB.shape_applicable(a, s)]


def fake_mode():
    """A ``FakeTensorMode``: the counter counts its fake tensors as it
    counts meta ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _jax_lm(arch, smoke):
    from repro.configs.base import get_config, get_smoke_config
    from repro.models.model import LM
    return LM((get_smoke_config if smoke else get_config)(arch))


def _port_cfg(arch, smoke):
    return (TB.get_smoke_config if smoke else TB.get_config)(arch)


def test_every_applicable_cell_is_listed():
    assert len(CELLS) == 33


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_jax(arch, smoke):
    from repro.roofline import analysis as jroof
    assert roof.count_params(_port_cfg(arch, smoke)) == \
        jroof.count_params(_jax_lm(arch, smoke))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    from repro.configs.base import SHAPES
    from repro.roofline import analysis as jroof
    got = roof.model_flops(_port_cfg(arch, False), TB.SHAPES[shape])
    want = jroof.model_flops(_jax_lm(arch, False), SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_jax_on_smoke_configs(arch):
    """Every kind at a smoke config's size, the decode cache-read term
    (local windows, MLA's compressed width, the encoder-decoder's
    cross-attention layers) included."""
    from repro.configs.base import ShapeConfig
    from repro.roofline import analysis as jroof
    lm = _jax_lm(arch, True)
    cfg = _port_cfg(arch, True)
    for kind in ("train", "prefill", "decode"):
        for S in (16, 100):
            got = roof.model_flops(cfg, TB.ShapeConfig("s", S, 3, kind))
            want = jroof.model_flops(lm, ShapeConfig("s", S, 3, kind))
            assert got == pytest.approx(want, rel=1e-12), (kind, S)


def test_model_flops_accept_an_lm_and_its_counts():
    from repro_torch.models.model import LM
    cfg = TB.get_config("deepseek-7b")
    lm = LM(cfg, device="meta")
    counts = roof.count_params(lm)
    assert 6.5e9 < counts["total"] < 8e9
    mf = roof.model_flops(lm, TB.SHAPES["train_4k"], counts)
    assert mf == 6 * counts["total"] * 256 * 4096
    c2 = roof.count_params(TB.get_config("deepseek-v2-236b"))
    assert c2["active"] < 0.15 * c2["total"]   # MoE discount applies


def test_roofline_terms_and_bottleneck_on_h100_figures():
    """As ``tests/test_roofline.py`` does with v5e's figures."""
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    r = roof.analyze(flops_per_dev=989e12, bytes_per_dev=3.35e12 / 2,
                     coll_bytes_per_dev=0.0,
                     model_flops_total=989e12 * 256, n_devices=256)
    assert r.bottleneck == "compute"
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert abs(r.useful_ratio - 1.0) < 1e-9
    assert r.step_s == r.compute_s and r.roofline_frac == 1.0
    r2 = roof.analyze(flops_per_dev=1e9, bytes_per_dev=3.35e12,
                      coll_bytes_per_dev=0.0, model_flops_total=1.0,
                      n_devices=2)
    assert r2.bottleneck == "memory" and abs(r2.memory_s - 1.0) < 1e-9
    r3 = roof.analyze(flops_per_dev=1e9, bytes_per_dev=1e9,
                      coll_bytes_per_dev=450e9 * 2, model_flops_total=1.0,
                      n_devices=2)
    assert r3.bottleneck == "collective" and abs(r3.collective_s - 2) < 1e-9
    assert set(r3.as_dict()) == {
        "compute_s", "memory_s", "collective_s", "model_flops_total",
        "useful_ratio", "bottleneck", "step_s", "roofline_frac"}


@pytest.mark.parametrize("mode", ["meta", "fake"])
def test_counter_matmul_chain(mode):
    """FLOPs = sum 2mnk, bytes = every operand and output once, and the
    peak of live temporaries: the first product while the second is made."""
    dims = [(128, 256), (256, 512), (512, 64), (64, 32)]
    ctx = fake_mode() if mode == "fake" else contextlib.nullcontext()
    dev = "cpu" if mode == "fake" else "meta"
    with ctx:
        ts = [torch.empty(d, device=dev) for d in dims]
        with Counter() as c:
            y = ts[0]
            for w in ts[1:]:
                y = y @ w
    flops = sum(2 * 128 * k * n for (k, n) in dims[1:])
    outs = [(128, n) for _, n in dims[1:]]
    ins = [dims[0]] + outs[:-1]
    nbytes = 4 * sum(a * b for a, b in dims[1:] + ins + outs)
    tot = c.totals()
    assert tot["flops"] == flops
    assert tot["bytes"] == nbytes
    assert tot["collective_bytes"] == 0 and tot["by_op"] == {}
    assert c.op_histogram() == {"aten.mm": 3}
    assert c.peak_bytes == 4 * (128 * 512 + 128 * 64)
    assert y.shape == (128, 32)


def test_counter_views_and_allocations_move_no_bytes():
    with Counter() as c:
        x = torch.empty(64, 64, device="meta")
        x.t()
        x.reshape(-1)[:10]
        x.detach()
    assert c.bytes == 0 and c.flops == 0
    assert c.peak_bytes == 64 * 64 * 4


def _stack_flops(n_layers, remat, grad):
    from repro_torch.models.model import LM
    cfg = TB.get_smoke_config("deepseek-7b").replace(num_layers=n_layers,
                                                     remat=remat)
    lm = LM(cfg, device="meta")
    x = torch.empty((2, 64, cfg.d_model), device="meta",
                    requires_grad=grad)
    ctx = {"positions": lm._positions(2, 64), "impl": "plain"}
    with torch.set_grad_enabled(grad), Counter() as c:
        y, _ = lm.decoder(x, ctx)
        if grad:
            y.sum().backward()
    return c.flops


@pytest.mark.parametrize("n_layers", [1, 3, 4])
def test_remat_stack_counts_each_layer_forward_and_its_recompute(n_layers):
    """A remat'd N-layer ``Stack``: its forward is N times one layer's, and
    a step under full remat is the step without it plus the recompute,
    counted as it runs: each layer's forward again but its last product,
    the MLP's down projection (2 T d_ff D), whose output the backward does
    not need (``torch.utils.checkpoint`` stops its recompute early)."""
    cfg = TB.get_smoke_config("deepseek-7b")
    fwd1 = _stack_flops(1, "none", grad=False)
    fwd = _stack_flops(n_layers, "none", grad=False)
    assert fwd == n_layers * fwd1
    full = _stack_flops(n_layers, "full", grad=True)
    none = _stack_flops(n_layers, "none", grad=True)
    down = 2 * (2 * 64) * cfg.d_ff * cfg.d_model
    assert full == none + fwd - n_layers * down
    assert none > 2 * fwd            # forward, and the two backward products


@pytest.fixture(scope="module")
def world4():
    from repro_torch.launch import dryrun, mesh
    with dryrun.fake_world(4):
        yield mesh.make_mesh((2, 2), ("data", "model"), device="cpu")


def _all_reduce(t, m):
    import torch.distributed as dist
    dist.all_reduce(t, group=m.get_group(0))


def _all_gather(t, m):
    import torch.distributed as dist
    out = torch.empty((2 * t.shape[0],) + t.shape[1:], device=t.device)
    dist.all_gather_into_tensor(out, t, group=m.get_group(1))


def _reduce_scatter(t, m):
    import torch.distributed as dist
    out = torch.empty((t.shape[0] // 2,) + t.shape[1:], device=t.device)
    dist.reduce_scatter_tensor(out, t, group=m.get_group(0))


def _all_to_all(t, m):
    import torch.distributed as dist
    dist.all_to_all_single(torch.empty_like(t), t, group=m.get_group(1))


def _broadcast(t, m):
    import torch.distributed as dist
    dist.broadcast(t, src=0, group=m.get_group(0))


def _dtensor_gather(t, m):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dt = distribute_tensor(t, m, [Shard(0), Replicate()], src_data_rank=None)
    full = dt.redistribute(m, [Replicate(), Replicate()]).to_local()
    assert full.shape == t.shape


def _dtensor_reduce_scatter(t, m):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    DTensor.from_local(t, m, [Partial(), Replicate()], run_check=False) \
        .redistribute(m, [Shard(0), Replicate()])


@pytest.mark.parametrize("name,fn,want", [
    ("all-reduce", _all_reduce, 1.0),
    ("all-gather", _all_gather, 1.0),
    ("reduce-scatter", _reduce_scatter, 1.0),
    ("all-to-all", _all_to_all, 1.0),
    ("broadcast", _broadcast, 1.0),
    ("all-gather", _dtensor_gather, 0.5),     # this rank's half of dim 0
    ("reduce-scatter", _dtensor_reduce_scatter, 1.0),
])
@pytest.mark.parametrize("mode", ["meta", "fake"])
def test_collective_bytes_on_a_4_rank_fake_group(world4, name, fn, want,
                                                 mode):
    """Each collective's bytes are its input's (a DTensor gather's input is
    the local shard), counted once under the reference's name."""
    ctx = fake_mode() if mode == "fake" else contextlib.nullcontext()
    with ctx:
        t = torch.empty((64, 48), device="cpu" if mode == "fake" else "meta")
        with Counter() as c:
            fn(t, world4)
    tot = c.totals()
    assert tot["by_op"] == {name: {"bytes": want * 64 * 48 * 4, "count": 1}}
    assert tot["collective_bytes"] == want * 64 * 48 * 4
