"""The port's serving engine against the reference's, on the workloads
of ``tests/test_serving.py`` (greedy, no prefix sharing, one clock;
tests/test_torch_spec.py covers sharing and speculation).

Tokens, every step's packed status rows and the non-timing ``stats``
must be identical, with exactly one counted device-to-host transfer
per step and a leak-free drain.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import os

import numpy as np

from _torch_helpers import assert_same, engine_setup, serve
from repro_torch.serving import chaos
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


@pytest.mark.parametrize("arch,heads", [("phi4-mini-3.8b", 6),
                                        ("llama4-maverick-400b-a17b", 10)])
def test_gqa_at_g3_and_g5_matches_reference(arch, heads):
    """G = 3 (phi4-mini-3.8b's 24 heads over 8) and G = 5
    (llama4-maverick's 40 over 8) at smoke width: ``heads`` query heads
    of 16 over 2 kv heads, llama4's MoE layers (4 experts, top-1)
    resident; prompts past a page and a prefill chunk, so that both the
    chunk and the width-1 decode steps run."""
    setup = engine_setup(arch, n_heads=heads, n_kv_heads=2, head_dim=16)
    assert setup[2].n_heads // setup[2].n_kv_heads == heads // 2
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 30)))
               for _ in range(5)]
    tr, te = _assert_same(setup, prompts, 6, dp=1, b_local=2, max_len=64,
                          chunk_size=8)
    assert te.stats["chunk_hist"].get(1, 0) > 0


def test_llama4_smoke_served_resident_matches_reference():
    """llama4-maverick's smoke config as it is (``global_moe`` and
    ``global`` layers, 4 experts top-1, G 2), its experts resident (no
    expert paging), at dp 2."""
    setup = engine_setup("llama4-maverick-400b-a17b")
    assert setup[2].moe.num_experts == 4 and setup[2].moe.top_k == 1
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 20)))
               for _ in range(7)]
    tr, te = _assert_same(setup, prompts, 5, dp=2, b_local=2, max_len=64,
                          chunk_size=4)
    assert te.state.expert_tables is None


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


def test_options_outside_the_slice_raise(setup, tmp_path):
    """A mesh that is not a DPGroup, or a group of another size than
    ``dp``, is refused.  Fault injection and in-place recovery, which
    raised under a group before the group's recovery was ported, now
    construct: on a one-rank gloo group in this process an injected step
    error recovers in place."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import DPGroup, make_dp_group
    _, _, tcfg, tparams = setup
    with pytest.raises(TypeError):
        tengine.ServingEngine(tcfg, tparams, dp=1, b_local=1, max_len=32,
                              device="cpu", mesh="auto")
    with pytest.raises(ValueError):
        tengine.ServingEngine(tcfg, tparams, dp=2, b_local=1, max_len=32,
                              device="cpu", mesh=DPGroup(0, 1, "cpu", "gloo"))
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE")}
    os.environ.update(RANK="0", WORLD_SIZE="1")
    try:
        group = make_dp_group(1, "gloo", "cpu",
                              init_method=f"file://{tmp_path / 'pg'}")
        eng = tengine.ServingEngine(
            tcfg, tparams, dp=1, b_local=2, max_len=32, device="cpu",
            mesh=group, max_restarts=4,
            injector=chaos.ServingFailureInjector(
                [chaos.Fault(step=2, phase="post_sync", kind="error")]))
        reqs = [tengine.Request(i, prompt=[3 + i, 5, 7], max_new_tokens=4)
                for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=100)
        assert eng.stats["recoveries"] == 1 and all(r.done for r in reqs)
        assert eng.leak_free()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("option,experts", [
    (dict(), (0, 1)), (dict(size_classes=3), None),
    (dict(expert_paging=True), None)])
def test_expert_options_on_a_dense_model(setup, option, experts):
    """On a model without experts the expert options gate off as in the
    reference: no expert class (size_classes 3 serves two), no expert
    plane, and a request's footprint changes nothing; the engine serves
    the reference's tokens and status rows."""
    import jax.numpy as jnp

    from repro.serving import engine as jengine
    cfg, params, tcfg, tparams = setup
    runs = []
    for mod, c, p, kw in ((jengine, cfg, params, dict(mesh=None)),
                          (tengine, tcfg, tparams, dict(device="cpu"))):
        eng = mod.ServingEngine(c, p, dp=1, b_local=2, max_len=32,
                                prefix_sharing=False, **option, **kw)
        req = mod.Request(0, prompt=[1, 2, 3], max_new_tokens=3,
                          experts=experts)
        eng.submit(req)
        eng.run(max_steps=50)
        assert req.done and not eng.expert_paging
        assert eng.expert_ledger is None and eng.state.expert_tables is None
        runs.append((eng.n_classes, req.out_tokens,
                     [r["status"] for r in eng.flight.ring],
                     tuple(np.asarray(jnp.asarray(eng.expert_mask)).shape)))
    assert runs[1] == runs[0]
    assert runs[1][0] == (2 if option.get("size_classes") == 3 else 1)


@pytest.mark.parametrize("option,request_kw", [
    (dict(greedy=False), dict(temperature=0.7, top_k=5, seed=3)),
    (dict(speculate=True), dict(temperature=0.7)),
    (dict(journal=chaos.ServingJournal(),
          injector=chaos.ServingFailureInjector([])),
     dict(deadline_s=100.0)),
    (dict(max_restarts=2), dict(temperature=1.3, seed=-4))])
def test_options_of_the_sampling_and_recovery_slice_serve(setup, option,
                                                          request_kw):
    """What earlier slices refused (sampling, greedy=False, deadlines)
    now serves to the end and drains; a sampled slot's registers are
    cleared when it finishes."""
    _, _, tcfg, tparams = setup
    eng = tengine.ServingEngine(tcfg, tparams, dp=1, b_local=1,
                                max_len=32, device="cpu", **option)
    req = tengine.Request(0, prompt=[1, 2, 3], max_new_tokens=3,
                          **request_kw)
    eng.submit(req)
    eng.run(max_steps=100)
    assert req.done and len(req.out_tokens) == 3 and eng.leak_free()
    assert not eng._sampling_slots and not eng.temps.any()
