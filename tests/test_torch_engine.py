"""Port's ServingEngine: token streams against the JAX engine and itself.

deepseek-7b smoke in fp32 on the CPU, weights bridged from the JAX init.
Prompts come from a numpy seed. Streams are compared token for token.
JAX is imported inside the fixture and the tests, so that a host without
it (the card's) can collect this file.
"""
import copy

import numpy as np
import pytest

from repro_torch.bridge import load_jax_numpy
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServingEngine, state_to

CAP = 64


@pytest.fixture(scope="module")
def models():
    import jax
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.models.model import LM as JaxLM
    jlm = JaxLM(jax_smoke_config("deepseek-7b"))
    params = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_smoke_config("deepseek-7b"), device="cpu")
    load_jax_numpy(lm, jax.tree.map(np.asarray, params))
    return jlm, params, lm


def _prompts(n, seed=0, vocab=512):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, rng.randint(5, 14)).astype(np.int32)
            for _ in range(n)]


def _serve(eng, reqs, hand_off=None):
    """Submit in order as slots free up; step until every request is done.
    ``hand_off(eng)`` is called after the third step and returns the engine
    that carries on."""
    pending = list(reqs)
    while pending or any(eng.active):
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
        if hand_off is not None and eng.steps == 3:
            eng, hand_off = hand_off(eng), None
    return [r.out for r in reqs]


def _torch_reqs(prompts, max_new=6):
    return [Request(i, p, max_new=max_new) for i, p in enumerate(prompts)]


def test_streams_match_jax_engine(models):
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServingEngine as JaxEngine
    jlm, params, lm = models
    prompts = _prompts(3)
    jstreams = _serve(JaxEngine(jlm, params, slots=2, capacity=CAP),
                      [JaxRequest(i, p, max_new=6)
                       for i, p in enumerate(prompts)])
    streams = _serve(ServingEngine(lm, slots=2, capacity=CAP, device="cpu"),
                     _torch_reqs(prompts))
    assert streams == jstreams
    assert all(len(s) == 6 for s in streams)


def test_state_dict_hand_off_keeps_streams(models):
    _, _, lm = models
    prompts = _prompts(3, seed=1)
    plain = _serve(ServingEngine(lm, slots=2, capacity=CAP, device="cpu"),
                   _torch_reqs(prompts))

    def hand_off(eng):
        blob = copy.deepcopy(state_to(eng.state_dict(), "cpu"))
        fresh = ServingEngine(lm, slots=2, capacity=CAP, device="cpu")
        fresh.load_state_dict(blob)
        fresh.active = eng.active
        return fresh

    moved = _serve(ServingEngine(lm, slots=2, capacity=CAP, device="cpu"),
                   _torch_reqs(prompts), hand_off=hand_off)
    assert moved == plain


def test_slots_equal_to_periods_do_not_cross_write(models):
    """slots == n_periods == 3: the reference's shape guess writes request
    1's cache over request 0's; the port's structural write must not."""
    _, _, lm = models
    assert lm.decoder.n_periods == 3
    p0, p1 = _prompts(2, seed=2)
    alone = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                   [Request(0, p0, max_new=6)])
    both = _serve(ServingEngine(lm, slots=3, capacity=CAP, device="cpu"),
                  [Request(0, p0, max_new=6), Request(1, p1, max_new=6)])
    assert both[0] == alone[0]


def test_idle_slot_past_capacity_is_clamped(models):
    """An idle slot's length keeps growing with every step; past capacity
    its write index clamps (as jax.lax.dynamic_update_slice does) and the
    active slot's stream is unaffected."""
    _, _, lm = models
    cap = 16
    rng = np.random.RandomState(3)
    pa = rng.randint(0, 512, 3).astype(np.int32)
    pb = rng.randint(0, 512, cap - 2).astype(np.int32)
    alone = _serve(ServingEngine(lm, slots=2, capacity=cap, device="cpu"),
                   [Request(0, pa, max_new=11)])
    eng = ServingEngine(lm, slots=2, capacity=cap, device="cpu")
    a, b = Request(0, pa, max_new=11), Request(1, pb, max_new=2)
    got = _serve(eng, [a, b])        # b finishes after one step, then idles
    assert b.done and len(b.out) == 2
    assert eng.steps == 10
    assert int(eng.cache["lengths"][1]) == cap - 2 + 10 > cap
    assert got[0] == alone[0]


def test_run_until_done_after_hand_off_matches_jax_engine(models):
    """tests/test_substrate.py::test_serving_engine_decodes_and_migrates on
    both engines: two requests, one step, the state handed to a fresh
    engine, then ``run_until_done``; slots=2 != n_periods=3, which the
    reference's slot write needs."""
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServingEngine as JaxEngine
    jlm, params, lm = models
    assert lm.decoder.n_periods != 2
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, 8).astype(np.int32) for _ in range(2)]

    def drive(make, request):
        eng = make()
        reqs = [request(i, p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            assert eng.submit(r)
        eng.step()
        fresh = make()
        fresh.load_state_dict(eng.state_dict())
        fresh.active = eng.active
        fresh.run_until_done()
        assert not any(fresh.active) and fresh.steps == 5
        return [r.out for r in reqs]

    want = drive(lambda: JaxEngine(jlm, params, slots=2, capacity=CAP),
                 JaxRequest)
    got = drive(lambda: ServingEngine(lm, slots=2, capacity=CAP,
                                      device="cpu"), Request)
    assert got == want
    assert all(len(s) == 6 for s in got)


def test_run_until_done_stops_at_max_steps(models):
    _, _, lm = models
    eng = ServingEngine(lm, slots=2, capacity=CAP, device="cpu")
    req = Request(0, _prompts(1)[0], max_new=10)
    assert eng.submit(req)
    eng.run_until_done(max_steps=3)
    assert eng.steps == 3 and len(req.out) == 4 and not req.done
    eng.run_until_done()
    assert req.done and len(req.out) == 10 and eng.steps == 9
