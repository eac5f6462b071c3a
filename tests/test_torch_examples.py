"""The port's three examples on the CPU, at small counts: each one's own
check, a restart against an uninterrupted run, and the refusal of a
failure step that comes before the first checkpoint."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import get_smoke_config
from repro_torch.examples import quickstart, serve_batch, train_e2e
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine

ROOT = Path(__file__).resolve().parent.parent
# lm-100m's layout at smoke widths
NARROW = train_e2e.CFG.replace(num_layers=2, d_model=64, num_heads=4,
                               num_kv_heads=4, head_dim=16, d_ff=128,
                               vocab_size=512)
E2E_ARGS = ["--steps", "60", "--seq", "32", "--batch", "2"]


def test_quickstart_restored_step_equals_the_uninterrupted_one():
    out = quickstart.main([], device="cpu")
    assert out["equal"] and out["step"] == quickstart.STEPS + 1
    assert out["loss_restored"] == out["loss_uninterrupted"]
    assert np.isfinite(out["loss_restored"])


def test_train_e2e_restart_matches_an_uninterrupted_run():
    """--steps 60 fails at 30 and restarts from the checkpoint of step 25:
    every step's loss, by state["step"], equals the uninterrupted run's bit
    for bit; the restarted run makes one update more (the reference's
    loop)."""
    failed = train_e2e.main(E2E_ARGS, device="cpu", cfg=NARROW)
    clean = train_e2e.main(E2E_ARGS + ["--fail-at", "1000"], device="cpu",
                           cfg=NARROW)
    assert failed["restarted"] == train_e2e.CKPT_EVERY
    assert clean["restarted"] is None
    assert clean["final_step"] == 60 and failed["final_step"] == 61
    assert sorted(clean["losses"]) == list(range(1, 61))
    for step, loss in clean["losses"].items():
        assert failed["losses"][step] == loss, step
    assert clean["losses"][60] < clean["losses"][1]


@pytest.mark.parametrize("args", [["--steps", "45"],
                                  ["--steps", "60", "--fail-at", "25"]])
def test_train_e2e_refuses_a_failure_before_the_first_checkpoint(args,
                                                                  capsys):
    with pytest.raises(SystemExit) as exc:
        train_e2e.main(args, device="cpu", cfg=NARROW)
    assert exc.value.code == 2
    assert "before the first checkpoint" in capsys.readouterr().err


def test_serve_batch_serves_every_request_through_the_migration():
    """Every request gets its tokens, and the streams equal an engine's that
    was never migrated."""
    got = serve_batch.main([], device="cpu")
    cfg = get_smoke_config("gemma3-1b")
    eng = ServingEngine(LM(cfg, device="cpu"), slots=serve_batch.SLOTS,
                        capacity=serve_batch.CAPACITY, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, 16).astype(np.int32),
                    max_new=8) for i in range(6)]
    pending = list(reqs)
    while pending or any(eng.active):
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
    assert got == [r.out for r in reqs]
    assert all(len(o) >= 8 for o in got)


def test_examples_run_as_modules():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m",
                          "repro_torch.examples.serve_batch", "--device",
                          "cpu"], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "OK: all requests served" in res.stdout
