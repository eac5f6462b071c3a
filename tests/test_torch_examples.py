"""The port's three examples on the CPU, at small counts: each one's own
check, a restart against an uninterrupted run, and the refusal of a
failure step that comes before the first checkpoint."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.examples import quickstart, serve_batch, train_e2e
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine

ROOT = Path(__file__).resolve().parent.parent
# lm-100m's layout at smoke widths, without remat (the runs below take
# some 3000 steps on the CPU)
NARROW = train_e2e.CFG.replace(num_layers=2, d_model=64, num_heads=4,
                               num_kv_heads=4, head_dim=16, d_ff=128,
                               vocab_size=512, remat="none")
# NARROW learns the pipeline's structure (a token follows from the one
# before it in a share of places) at this peak rate in this many steps; at
# the example's 1e-3 its loss stays near ln 512 for hundreds of steps
LR = 3e-2
STEPS = 1000
E2E_ARGS = ["--steps", str(STEPS), "--seq", "32", "--batch", "32",
            "--fail-at", "30"]
LEARN_MARGIN = 10      # the fall of the unseen loss over the witness's spread


def test_quickstart_restored_step_equals_the_uninterrupted_one():
    out = quickstart.main([], device="cpu")
    assert out["equal"] and out["step"] == quickstart.STEPS + 1
    assert out["loss_restored"] == out["loss_uninterrupted"]
    assert np.isfinite(out["loss_restored"])


@pytest.fixture
def one_thread():
    """The runs' small products on one thread: beside other test processes
    torch's default of a thread a core makes every step wait for threads
    that other processes hold, tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(monkeypatch, args, nudge=False):
    """``train_e2e.main(args)`` on NARROW at peak rate LR -> (its result,
    the trained LM, whose ``before`` holds its ``_unseen_losses`` before
    training). With ``nudge`` every initial weight is one ulp up: the same
    run under another host's rounding."""
    made = []
    opt_config = train_e2e.adamw.OptConfig

    class Recorded(LM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            with torch.no_grad():
                if nudge:
                    for p in self.parameters():
                        p.copy_(torch.nextafter(p, torch.full_like(
                            p, math.inf)))
                self.before = _unseen_losses(self)
            made.append(self)
    monkeypatch.setattr(train_e2e, "LM", Recorded)
    monkeypatch.setattr(train_e2e.adamw, "OptConfig",
                        lambda **kw: opt_config(**{**kw, "lr": LR}))
    return train_e2e.main(args, device="cpu", cfg=NARROW), made[0]


def _unseen_losses(lm):
    """{structure: loss} of a [32, 32] batch the runs never draw (the
    pipeline's seed 1): of the stream's own structure (0.7), and of
    uniform tokens (0.0), which the control reads."""
    with torch.no_grad():
        return {st: float(lm.loss({"tokens": torch.as_tensor(TokenPipeline(
            DataConfig(NARROW.vocab_size, 32, 32, seed=1, structure=st))
            ._batch_at(0)).long()})[0]) for st in (0.7, 0.0)}


def test_train_e2e_restart_matches_an_uninterrupted_run(monkeypatch,
                                                        one_thread):
    """--steps 1000 fails at 30 and restarts from the checkpoint of step 25:
    every step's loss, by state["step"], equals the uninterrupted run's bit
    for bit; the restarted run makes one update more (the reference's
    loop). The uninterrupted run learns: an unseen batch's loss falls by
    LEARN_MARGIN times the witness's spread (the same run from weights one
    ulp up) or more, and the control, a batch of uniform tokens, does not
    fall so."""
    failed, _ = _run(monkeypatch, E2E_ARGS)
    clean, lm = _run(monkeypatch, E2E_ARGS + ["--fail-at", "100000"])
    assert failed["restarted"] == train_e2e.CKPT_EVERY
    assert clean["restarted"] is None
    assert clean["final_step"] == STEPS and failed["final_step"] == STEPS + 1
    assert sorted(clean["losses"]) == list(range(1, STEPS + 1))
    for step, loss in clean["losses"].items():
        assert failed["losses"][step] == loss, step
    after = _unseen_losses(lm)
    _, nudged = _run(monkeypatch, E2E_ARGS + ["--fail-at", "100000"],
                     nudge=True)
    spread = abs(_unseen_losses(nudged)[0.7] - after[0.7])
    fall = {st: lm.before[st] - after[st] for st in after}
    assert fall[0.7] >= LEARN_MARGIN * spread > 0, (fall, spread)
    assert fall[0.0] < LEARN_MARGIN * spread, (fall, spread)


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
