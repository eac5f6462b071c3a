"""Expert parallelism under remat (``models/moe.py``'s EP path inside
``torch.utils.checkpoint``) on two gloo processes: the backward, and so
the remat recompute, runs on another thread than the forward, as the
autograd engine runs a CUDA backward on its device thread, where no mesh
is active (``partition.activate`` is thread-local). ``LM.forward`` reads
the expert axis once (``moe.ep_context``) and carries it in its layers'
context, so the recompute takes the EP path as the forward did.

The deepseek-moe-16b smoke model at ``remat="full"`` on a (1, 2) ("data",
"model") mesh, capacity factor 8 (no copy drops): every gradient after a
backward on another thread equal to the one after a backward on the
forward's thread, bit for bit, and the loss equal.
"""
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import make_mesh, run_ranks
from repro_torch.models.model import LM
from repro_torch.sharding import partition as part


def _cfg():
    cfg = get_smoke_config("deepseek-moe-16b")
    return cfg.replace(remat="full", moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _grads(mesh, tokens, on_thread):
    """The loss and every gradient of the seeded LM, its forward inside
    ``activate(mesh)``, its backward on this thread or another."""
    lm = LM(_cfg(), device="cpu", generator=torch.Generator().manual_seed(0))
    with part.activate(mesh):
        loss, _ = lm.loss({"tokens": tokens})
    err = []

    def backward():
        try:
            loss.backward()
        except Exception as e:     # noqa: BLE001 (reported below)
            err.append(e)
    if on_thread:
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "the backward did not finish"
    else:
        with part.activate(mesh):
            backward()
    if err:
        raise err[0]
    return float(loss), {n: p.grad.clone() for n, p in lm.named_parameters()
                         if p.grad is not None}


def _rank(rank, world):
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    tokens = torch.from_numpy(
        np.random.RandomState(0).randint(0, 512, (2, 16)))
    return {"thread": _grads(mesh, tokens, True),
            "main": _grads(mesh, tokens, False)}


def test_ep_under_remat_recomputes_on_the_expert_axis(tmp_path):
    for r in run_ranks(_rank, 2, timeout_s=180, device="cpu",
                       workdir=str(tmp_path)):
        (loss_t, g_t), (loss_m, g_m) = r["thread"], r["main"]
        assert loss_t == loss_m
        assert g_t.keys() == g_m.keys()
        assert any(".mlp.wi_gate" in n for n in g_m)
        for n, g in g_m.items():
            assert torch.equal(g_t[n], g), n
