"""The port's copy of the configs against the reference's, on the CPU.

``repro_torch.configs`` is a copy of ``repro.configs`` (plain dataclasses,
no JAX), kept so that the port imports nothing of ``repro``. Every card
path and memory reckoning reads it, so each ``ModelConfig`` of every
architecture, ``CONFIG`` (full size) and ``smoke()`` alike, is held to its
twin field for field, nested dataclasses (``moe``, ``mla``, ...) walked
through by field, with the derived quantities the models read beside
them. Both packages' ``ARCH_IDS`` and ``SHAPES`` must agree as well.
"""
import dataclasses

import pytest

from repro.configs import base as jax_base
from repro_torch.configs import base

ARCH_IDS = base.ARCH_IDS


def _fields(cfg, jcfg, path):
    """Every field of ``cfg`` against ``jcfg``'s, recursing into nested
    dataclasses; returns the number of leaves compared."""
    assert dataclasses.is_dataclass(cfg) == dataclasses.is_dataclass(jcfg), \
        path
    if not dataclasses.is_dataclass(cfg):
        assert cfg == jcfg and type(cfg) is type(jcfg), (path, cfg, jcfg)
        return 1
    assert type(cfg).__name__ == type(jcfg).__name__, path
    names = [f.name for f in dataclasses.fields(cfg)]
    assert names == [f.name for f in dataclasses.fields(jcfg)], path
    return sum(_fields(getattr(cfg, n), getattr(jcfg, n), f"{path}.{n}")
               for n in names)


def test_arch_ids_and_shapes_agree():
    assert base.ARCH_IDS == jax_base.ARCH_IDS
    assert len(ARCH_IDS) == 10
    assert base.SHAPES.keys() == jax_base.SHAPES.keys()
    for name, shape in base.SHAPES.items():
        _fields(shape, jax_base.SHAPES[name], name)
    assert base.LONG_CONTEXT_ARCHS == jax_base.LONG_CONTEXT_ARCHS


@pytest.mark.parametrize("kind", ["CONFIG", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_config_matches_reference_field_for_field(arch, kind):
    get, jget = ((base.get_config, jax_base.get_config) if kind == "CONFIG"
                 else (base.get_smoke_config, jax_base.get_smoke_config))
    cfg, jcfg = get(arch), jget(arch)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert _fields(cfg, jcfg, arch) >= len(dataclasses.fields(cfg))
    assert cfg.layer_kinds == jcfg.layer_kinds
    assert [cfg.mlp_kind_at(i) for i in range(cfg.num_layers)] == \
        [jcfg.mlp_kind_at(i) for i in range(jcfg.num_layers)]
    assert (cfg.q_dim, cfg.kv_dim, cfg.padded_vocab) == \
        (jcfg.q_dim, jcfg.kv_dim, jcfg.padded_vocab)
    for shape in base.SHAPES:
        assert base.shape_applicable(arch, shape) == \
            jax_base.shape_applicable(arch, shape)
