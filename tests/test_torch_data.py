"""The port's data pipeline against ``repro.data.pipeline``: the same
batches byte for byte, the same resume, the same frontend stubs."""
import numpy as np
import pytest

from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.data.pipeline import (DataConfig, TokenPipeline,
                                       frontend_stub_batch)


@pytest.mark.parametrize("seed", [0, 9, 12345])
def test_batches_byte_equal_to_reference(seed):
    from repro.data import pipeline as ref
    for vocab, S, B in ((1000, 32, 4), (102400, 64, 2)):
        got = TokenPipeline(DataConfig(vocab, S, B, seed=seed))
        want = ref.TokenPipeline(ref.DataConfig(vocab, S, B, seed=seed))
        for _ in range(5):
            g, w = got.next()["tokens"], want.next()["tokens"]
            assert g.dtype == w.dtype == np.int32 and g.shape == (B, S)
            assert g.tobytes() == w.tobytes()
        assert got.state_dict() == want.state_dict() == {"step": 5,
                                                         "seed": seed}


def test_state_dict_resume():
    """tests/test_substrate.py::test_pipeline_determinism_and_restore."""
    cfg = DataConfig(1000, 32, 4, seed=9)
    p1 = TokenPipeline(cfg)
    seq = [p1.next()["tokens"] for _ in range(5)]
    p2 = TokenPipeline(cfg)
    p2.load_state_dict({"step": 3, "seed": 9})
    np.testing.assert_array_equal(p2.next()["tokens"], seq[3])
    np.testing.assert_array_equal(next(iter(p2))["tokens"], seq[4])
    with pytest.raises(ValueError, match="seed"):
        p2.load_state_dict({"step": 3, "seed": 8})


@pytest.mark.parametrize("arch", ["deepseek-7b", "internvl2-76b",
                                  "seamless-m4t-large-v2"])
def test_frontend_stub_batch_equal_to_reference(arch):
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import get_smoke_config as ref_smoke
    from repro.data import pipeline as ref
    shape = ShapeConfig("t", 64, 2, "train")
    got = frontend_stub_batch(get_smoke_config(arch), shape, rng_seed=3)
    want = ref.frontend_stub_batch(ref_smoke(arch), RefShape("t", 64, 2,
                                                             "train"), 3)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
