"""The port's serving engine against the reference's, on the workloads
of ``tests/test_serving.py`` (greedy, no prefix sharing, one clock;
tests/test_torch_spec.py covers sharing and speculation).

Tokens, every step's packed status rows and the non-timing ``stats``
must be identical, with exactly one counted device-to-host transfer
per step and a leak-free drain.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import numpy as np

from _torch_helpers import assert_same, engine_setup, serve
from repro_torch.serving import engine as tengine

#: the plain path of the first slice: no prefix sharing in either engine
PLAIN = dict(prefix_sharing=False)


@pytest.fixture(scope="module")
def setup():
    return engine_setup("olmo-1b")


def _serve(setup, port, prompts, max_new, **kw):
    return serve(setup, port, prompts, max_new, **PLAIN, **kw)


def _assert_same(setup, prompts, max_new, **kw):
    tr, te, _ = assert_same(setup, prompts, max_new, **PLAIN, **kw)
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
    _assert_same(engine_setup("llama3.2-1b"), prompts, 4, dp=1, b_local=2,
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


def _deadline(eng):
    """A request with a deadline (deadlines come with fault tolerance)."""
    eng.submit(tengine.Request(0, prompt=[1, 2, 3], deadline_s=1.0))


def _sampled_under_speculation(eng):
    eng.submit(tengine.Request(0, prompt=[1, 2], temperature=0.7))


@pytest.mark.parametrize("option,drive", [
    (dict(journal=object()), None),
    (dict(), _deadline),
    (dict(speculate=True), _sampled_under_speculation),
    (dict(size_classes=3), None), (dict(expert_paging=True), None),
    (dict(greedy=False), None), (dict(mesh="auto"), None)])
def test_options_outside_the_slice_raise(setup, option, drive):
    _, _, tcfg, tparams = setup
    with pytest.raises(NotImplementedError):
        eng = tengine.ServingEngine(tcfg, tparams, dp=1, b_local=1,
                                    max_len=32, device="cpu", **option)
        drive(eng)


def test_sampling_request_raises(setup):
    _, _, tcfg, tparams = setup
    eng = tengine.ServingEngine(tcfg, tparams, dp=1, b_local=1, max_len=32,
                                device="cpu")
    with pytest.raises(NotImplementedError):
        eng.submit(tengine.Request(0, prompt=[1, 2], temperature=0.7))
