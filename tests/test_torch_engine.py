"""The port's serving engine against the reference's, on the workloads
of ``tests/test_serving.py`` (greedy, no prefix sharing, one clock).

Tokens, every step's packed status rows and the non-timing ``stats``
must be identical, with exactly one counted device-to-host transfer
per step and a leak-free drain.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import itertools

import jax
import numpy as np

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.serving import engine as jengine
from repro.serving.telemetry import FlightRecorder as JFlight
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.serving import engine as tengine
from repro_torch.serving.telemetry import FlightRecorder as TFlight

#: counters that read the wall clock (the step watchdog)
TIMING = {"stragglers", "step_timeouts"}


def _setup(arch):
    cfg = smoke_config(get_config(arch))
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = t_smoke_config(t_get_config(arch))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def setup():
    return _setup("olmo-1b")


def _serve(setup, port, prompts, max_new, **kw):
    """Run one workload through one package's engine with a counting
    clock; returns (engine, requests)."""
    cfg, params, tcfg, tparams = setup
    clock = itertools.count()
    if port:
        eng = tengine.ServingEngine(
            tcfg, tparams, flight=TFlight(capacity=4096),
            clock=lambda: float(next(clock)), device="cpu", **kw)
        Req = tengine.Request
    else:
        eng = jengine.ServingEngine(
            cfg, params, flight=JFlight(capacity=4096), prefix_sharing=False,
            clock=lambda: float(next(clock)), **kw)
        Req = jengine.Request
    reqs = [Req(i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=500)
    return eng, reqs


def _assert_same(setup, prompts, max_new, **kw):
    je, jr = _serve(setup, False, prompts, max_new, **kw)
    te, tr = _serve(setup, True, prompts, max_new, **kw)
    assert all(r.done for r in tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    jrec, trec = list(je.flight.ring), list(te.flight.ring)
    assert len(trec) == len(jrec) == te.stats["steps"]
    for s, (a, b) in enumerate(zip(jrec, trec)):
        assert (b["T"], b["status"], b["ctr"], b["rids"]) == \
            (a["T"], a["status"], a["ctr"], a["rids"]), f"step {s}"
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    assert te.telemetry.snapshot()["per_shard"] == \
        je.telemetry.snapshot()["per_shard"]
    assert te.latency_quantiles() == je.latency_quantiles()
    assert te.host_transfers == te.stats["steps"]
    assert te.page_occupancy() == je.page_occupancy() == 0.0
    assert te.leak_free()
    return tr, te


def test_continuous_batching_9_requests_on_4_slots(setup):
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 10)))
               for _ in range(9)]
    tr, te = _assert_same(setup, prompts, 5, dp=2, b_local=2, max_len=64)
    assert all(len(r.out_tokens) == 5 for r in tr)
    assert te.stats["admitted"] == 9


def test_gqa_rmsnorm_config_matches_reference():
    """llama3.2-1b smoke (GQA G = 2, RMSNorm, rope theta 5e5)."""
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 20)))
               for _ in range(5)]
    _assert_same(_setup("llama3.2-1b"), prompts, 4, dp=1, b_local=2,
                 max_len=64, chunk_size=4)


def test_no_page_leaks(setup):
    _assert_same(setup, [[1, 2, 3, 4, 5]] * 6, 4, dp=1, b_local=2,
                 max_len=48)


def test_eos_stops_generation(setup):
    prompt = [5, 9, 17, 3]
    _, (probe,) = _serve(setup, True, [prompt], 6, dp=1, b_local=1,
                         max_len=64)
    eos = probe.out_tokens[2]
    first = probe.out_tokens.index(eos)
    (r,), _ = _assert_same(setup, [prompt], 6, dp=1, b_local=1, max_len=64,
                           eos_id=eos)
    assert r.out_tokens == probe.out_tokens[:first + 1]


def test_capacity_cap_when_max_len_not_page_multiple(setup):
    tr, te = _assert_same(setup, [[2] * 30] * 2, 64, dp=1, b_local=2,
                          max_len=44, chunk_size=8)
    assert te.capacity == 40
    assert all(len(r.out_tokens) <= 10 for r in tr)


def test_token_identity_across_lane_widths(setup):
    """The port alone, at lane widths 1, 4 and 16: identical tokens."""
    rng = np.random.RandomState(42)
    prompts = [list(rng.randint(1, 255, rng.randint(2, 29)))
               for _ in range(9)]
    outs = {}
    for chunk in (1, 4, 16):
        eng, reqs = _serve(setup, True, prompts, 4, dp=2, b_local=2,
                           max_len=64, chunk_size=chunk)
        outs[chunk] = [r.out_tokens for r in reqs]
        assert eng.page_occupancy() == 0.0
    assert outs[1] == outs[4] == outs[16]


@pytest.mark.parametrize("option", [
    dict(speculate=True), dict(prefix_sharing=True), dict(size_classes=2),
    dict(expert_paging=True), dict(greedy=False), dict(mesh="auto")])
def test_options_outside_the_slice_raise(setup, option):
    _, _, tcfg, tparams = setup
    with pytest.raises(NotImplementedError):
        tengine.ServingEngine(tcfg, tparams, dp=1, b_local=1, max_len=32,
                              device="cpu", **option)


def test_sampling_request_raises(setup):
    _, _, tcfg, tparams = setup
    eng = tengine.ServingEngine(tcfg, tparams, dp=1, b_local=1, max_len=32,
                                device="cpu")
    with pytest.raises(NotImplementedError):
        eng.submit(tengine.Request(0, prompt=[1, 2], temperature=0.7))
