"""The port stands alone: it imports without ``jax`` and without ``repro``,
and its entry points default to the card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for want in ('serving.engine', 'data.pipeline', 'checkpoint.ckpt',\n"
        "             'examples.quickstart', 'examples.train_e2e',\n"
        "             'examples.serve_batch', 'sharding.partition',\n"
        "             'launch.mesh', 'runtime.elastic',\n"
        "             'examples.elastic_training', 'roofline.analysis',\n"
        "             'roofline.counter', 'launch.specs',\n"
        "             'launch.dryrun'):\n"
        "    assert 'repro_torch.' + want in names, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_sources_name_no_jax_and_no_repro():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|msgpack\b|repro(\.|\s|$))",
                     re.M)
    for path in _port_sources():
        hits = bad.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)}: {hits}"


@pytest.mark.parametrize("entry", ["LM", "ServingEngine", "quickstart",
                                   "train_e2e", "serve_batch",
                                   "elastic_training", "run_ranks"])
def test_entry_points_default_to_cuda(entry):
    import importlib
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import LM
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.serving.engine import ServingEngine
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would work")
    cfg = get_smoke_config("deepseek-7b")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "LM":
            LM(cfg)
        elif entry == "ServingEngine":
            ServingEngine(LM(cfg, device="cpu"), slots=2, capacity=32)
        elif entry == "run_ranks":
            run_ranks(print, 2)
        else:     # an example's main, with no arguments, runs on the card
            importlib.import_module(f"repro_torch.examples.{entry}").main([])
