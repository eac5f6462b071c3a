"""Elastic re-meshing in the port (``runtime/elastic.py``) on four gloo
processes, and the port's ``examples/elastic_training.py``: the re-mesh
round trips 4 -> 2 -> 4 bit for bit, ``scaled_batch`` and
``plan_remesh_migrations`` against the reference's, and the example's 8
losses against an unsharded run of the same 8 steps."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.model import LM
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.sharding import partition as part

RTOL = 1e-4            # as tests/test_torch_train.py


def _train_state():
    """deepseek-7b smoke's train state after one unsharded AdamW step (m
    and v not zero), on every rank the same."""
    lm = LM(get_smoke_config("deepseek-7b"), device="cpu")
    state = adamw.init_state(lm)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (4, 32)))
    state, _ = adamw.make_train_step(lm, adamw.OptConfig())(
        state, {"tokens": tok})
    return lm, state


def _remesh_rank(rank, world):
    """One rank: the leaf of tests/test_substrate.py's round trip and the
    train state moved None -> 4 ranks -> 2 -> 4; each leaf's local shard
    and the whole leaf gathered back after every move."""
    from torch.distributed.tensor import DTensor
    m4 = make_mesh((4,), ("data",), device="cpu")
    m2 = make_mesh((2,), ("data",), device="cpu")
    lm, state = _train_state()
    trees = {"leaf": ({"w": torch.arange(64, dtype=torch.float32)
                       .reshape(8, 8)}, {"w": ("embed", None)}),
             "train": (state, adamw.state_logical(lm))}
    out = {}
    for name, (tree, logical) in trees.items():
        moves = []
        s = tree
        for old, new in ((None, m4), (m4, m2), (m2, m4)):
            s = elastic.remesh_state(s, logical, old, new)
            member = new.get_coordinate() is not None
            flat = {}
            for key, leaf in (s["params"].items() if name == "train"
                              else s.items()):
                flat[key] = dict(
                    local=leaf.to_local().clone(),
                    full=leaf.full_tensor() if member else None,
                    shard_dims=[p.dim if p.is_shard() else None
                                for p in leaf.placements])
            for k in ("m", "v") if name == "train" else ():
                for key, leaf in s[k].items():
                    flat[f"{k}.{key}"] = dict(
                        local=leaf.to_local().clone(),
                        full=leaf.full_tensor() if member else None,
                        shard_dims=[p.dim if p.is_shard() else None
                                for p in leaf.placements])
            if name == "train":
                flat["step"] = dict(local=s["step"].clone(), full=None,
                                    shard_dims=[])
                assert not isinstance(s["step"], DTensor)
            moves.append(flat)
        out[name] = moves
    # a new mesh whose first rank held nothing cannot be the source
    from torch.distributed.device_mesh import DeviceMesh
    m23 = DeviceMesh("cpu", [2, 3], mesh_dim_names=("data",))
    try:
        elastic.remesh_state(trees["leaf"][0], trees["leaf"][1], m2, m23)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    return out


@pytest.fixture(scope="module")
def remeshed(tmp_path_factory):
    d = tmp_path_factory.mktemp("remesh")
    return run_ranks(_remesh_rank, 4, timeout_s=180, device="cpu",
                     workdir=str(d))


def test_remesh_roundtrip_of_the_substrate_leaf(remeshed):
    """tests/test_substrate.py:125-137 on the port: (8, 8) over ("embed",
    None) shards its rows 4, then 2 ways; ranks 2 and 3 hold nothing on
    the 2-rank mesh and get their rows back on the 4-rank one."""
    want = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for rank, r in enumerate(remeshed):
        s4, s2, back = (m["w"] for m in r["leaf"])
        assert torch.equal(s4["local"], want[2 * rank:2 * rank + 2])
        assert s4["shard_dims"] == [0]
        if rank < 2:
            assert torch.equal(s2["local"], want[4 * rank:4 * rank + 4])
            assert torch.equal(s2["full"], want)
        else:
            assert s2["local"].numel() == 0 and s2["full"] is None
        assert torch.equal(back["local"], want[2 * rank:2 * rank + 2])
        assert torch.equal(back["full"], want)
        assert r["refused"]


def test_remesh_roundtrip_of_a_train_state(remeshed):
    """Every leaf of a deepseek-7b smoke train state (params, m, v, step)
    after 4 -> 2 -> 4, bit for bit, at the placements ``resolve`` gives on
    each mesh; rank r's local shard is its chunk of the leaf."""
    _, state = _train_state()
    want = {f"{k}.{n}" if k != "params" else n: t.detach()
            for k in ("params", "m", "v") for n, t in state[k].items()}
    logical = adamw.state_logical(LM(get_smoke_config("deepseek-7b"),
                                     device="meta"))["params"]
    for rank, r in enumerate(remeshed):
        for move, n_ranks in zip(r["train"], (4, 2, 4)):
            assert int(move["step"]["local"]) == 1
            for key, w in want.items():
                got = move[key]
                if rank >= n_ranks:
                    assert got["local"].numel() == 0
                    continue
                assert torch.equal(got["full"], w), key
                axes = logical[key.split(".", 1)[1] if key[:2] in ("m.", "v.")
                               else key]
                mesh = part.AbstractMesh((n_ranks,), ("data",))
                spec = part.resolve(axes, w.shape, mesh)
                dim = next((i for i, e in enumerate(spec) if e), None)
                assert got["shard_dims"] == [dim], key
                chunk = w if dim is None else w.chunk(n_ranks, dim)[rank]
                assert torch.equal(got["local"], chunk), key


def test_scaled_batch_and_migration_plan_match_the_reference():
    from repro.runtime import elastic as jel
    for args in ((64, 4, 2), (64, 2, 4), (96, 4, 3), (8, 8, 1), (7, 2, 2)):
        assert elastic.scaled_batch(*args) == jel.scaled_batch(*args)
    GB = 1 << 30
    for shard, kw in [(GB, dict(bw_Bps=10 * GB, max_downtime_s=0.5)),
                      (GB, dict(bw_Bps=1 * GB, max_downtime_s=0.5)),
                      (GB, dict(bw_Bps=1 * GB, max_downtime_s=0.5,
                                dirty_rate_Bps=0.6 * GB)),
                      (GB, dict(bw_Bps=0.0, max_downtime_s=10.0))]:
        got = elastic.plan_remesh_migrations(shard, [2, 3], **kw)
        assert got == jel.plan_remesh_migrations(shard, [2, 3], **kw)
    assert {elastic.STOP_AND_COPY, elastic.PRE_COPY, elastic.POST_COPY} == {
        "stop_and_copy", "pre_copy", "post_copy"}


def test_elastic_example_matches_an_unsharded_run():
    """The example's 4 steps on 4 ranks and 4 on 2, after the re-mesh,
    against the same 8 steps unsharded (losses at rtol 1e-4)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.examples import elastic_training as ex
    got = ex.main(["--device", "cpu"])
    assert got["worlds"] == [4, 2] and len(got["losses"]) == 2 * ex.STEPS
    cfg = get_smoke_config(ex.ARCH)
    lm = LM(cfg, device="cpu")
    state = adamw.init_state(lm)
    step = adamw.make_train_step(lm, adamw.OptConfig(lr=1e-3))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, ex.SEQ, ex.BATCH))
    want = []
    for _ in range(2 * ex.STEPS):
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in pipe.next().items()})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=RTOL)
