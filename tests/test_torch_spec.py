"""The port's second slice against the reference: prefix sharing from
live donors and greedy speculative decoding over shared prefixes.

Host structures (``SpeculationStore``, ``PrefixCache``) hold the same
state after the same calls; the device share step gives the same page
tables, refcounts and copy-on-write page; the engines give identical
tokens, status rows, counter blocks and non-timing stats on the
reference's speculation workloads (``tests/test_speculative.py``), on a
mixed prompt/decode workload whose drafts really ride prefill steps,
and on a staggered workload that shares prefixes with a COW copy.
Both engines always get ``prefix_sharing``, ``speculate`` and
``spec_gate=False`` explicitly (the gate reads the wall clock).
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import (assert_pools_equal, assert_same, engine_setup,
                            serve)
from repro.core import classed_pool as j_classed
from repro.models.decode_init import empty_decode_state as j_empty
from repro.models.transformer import forward_decode_chunk as j_forward
from repro.serving import prefix_cache as jpc
from repro_torch.core import classed_pool as t_classed
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.transformer import forward_decode_chunk as t_forward
from repro_torch.serving import engine as tengine
from repro_torch.serving import prefix_cache as tpc

SPEC = dict(prefix_sharing=True, speculate=True, draft_len=4,
            spec_gate=False)
PLAIN = dict(prefix_sharing=True, speculate=False)


@pytest.fixture(scope="module")
def setup():
    return engine_setup("olmo-1b")


# ------------------------------------------------------------ host state

def _store_state(st):
    return st.streams, st._accept, st._lru


def test_speculation_store_matches_reference():
    """Random record / observe / draft calls on a small vocabulary (so
    exact replays and n-gram fallbacks both fire, and LRU eviction
    runs): same return values and same streams, EWMAs and LRU."""
    rng = np.random.RandomState(0)
    j, t = (jpc.SpeculationStore(page_size=4, keep=2, max_keys=3),
            tpc.SpeculationStore(page_size=4, keep=2, max_keys=3))
    keys = [tuple(rng.randint(0, 4, 4 * n)) for n in (1, 1, 2, 2, 3)]
    for i in range(300):
        key = keys[rng.randint(len(keys))]
        op = rng.randint(3)
        if op == 0:
            cont = tuple(rng.randint(0, 5, rng.randint(0, 9)))
            assert j.record(key, cont) == t.record(key, cont)
        elif op == 1:
            d = int(rng.randint(0, 5))
            a = int(rng.randint(0, d + 1))
            j.observe(key, d, a)
            t.observe(key, d, a)
        else:
            suffix = tuple(rng.randint(0, 5, rng.randint(0, 6)))
            k = int(rng.randint(0, 5))
            assert j.draft(key, suffix, k) == t.draft(key, suffix, k), i
        assert j.accept_rate(key) == t.accept_rate(key)
        assert _store_state(j) == _store_state(t), i
    prompt = list(rng.randint(0, 9, 11))
    assert j.key_of(prompt) == t.key_of(prompt)
    assert j.key_of(prompt[:3]) is t.key_of(prompt[:3]) is None


def _trie(node):
    return (sorted(node.slots),
            {k: _trie(c) for k, c in sorted(node.children.items())})


def _cache_state(pc):
    return (pc.tokens, pc.shard_of, pc.completed,
            {s: _trie(r) for s, r in pc.roots.items()})


def test_prefix_cache_matches_reference():
    """Random insert / update_progress / remove / match on two shards,
    prompts drawn from a few shared prefixes: same matches (donor,
    shard, length), same trie, tokens, progress and hit counters."""
    rng = np.random.RandomState(1)
    stems = [list(rng.randint(0, 3, 14)) for _ in range(3)]

    def prompt():
        s = stems[rng.randint(3)]
        cut = rng.randint(0, len(s) + 1)
        return s[:cut] + list(rng.randint(0, 3, rng.randint(0, 8)))

    j, t = jpc.PrefixCache(page_size=4), tpc.PrefixCache(page_size=4)
    live = set()
    for i in range(400):
        op = rng.randint(4)
        if op == 0 and len(live) < 6:
            slot = int(rng.choice([s for s in range(8) if s not in live]))
            toks, shard = prompt(), slot // 4
            j.insert(slot, shard, toks)
            t.insert(slot, shard, toks)
            live.add(slot)
        elif op == 1 and live:
            slot = int(rng.choice(sorted(live)))
            n = int(rng.randint(0, 25))
            j.update_progress(slot, n)
            t.update_progress(slot, n)
        elif op == 2 and live:
            slot = int(rng.choice(sorted(live)))
            j.remove(slot)
            t.remove(slot)
            live.discard(slot)
        else:
            toks = prompt()
            shard = [None, 0, 1][rng.randint(3)]
            a, b = j.match(toks, shard=shard), t.match(toks, shard=shard)
            assert (a is None) == (b is None), i
            if a is not None:
                assert (b.slot, b.shard, b.n_tokens) == \
                    (a.slot, a.shard, a.n_tokens), i
        assert _cache_state(j) == _cache_state(t), i
        assert j.live_slots() == t.live_slots()


# ----------------------------------------------------------- device step

def test_addref_dp_matches_reference(setup):
    """Extra references per shard, NULL ids and duplicates included."""
    cfg, _, tcfg, _ = setup
    jpool = j_empty(cfg, 2, 2, 64).pool
    tpool = t_empty(tcfg, 2, 2, 64, device="cpu").pool
    rng = np.random.RandomState(2)
    for _ in range(4):
        ids = rng.randint(-1, 20, (2, 7)).astype(np.int32)
        jpool = j_classed.addref_dp(jpool, 0, jnp.asarray(ids))
        tpool = t_classed.addref_dp(tpool, 0, torch.from_numpy(ids))
        assert_pools_equal(jpool, tpool, "addref_dp")


def test_share_prefix_step_matches_reference(setup):
    """Two donors prefilled through both packages' forward (DP 2,
    page 8), then a sequence of shares: whole pages only, a partial
    tail (COW), a second sharer of the same donor, a donor on shard 1,
    and a donor too short for the match (denied).  After each call the
    ok flag, tables, lengths and every pool leaf are equal, and the
    COW page holds the donor's partial page in every layer."""
    cfg, params, tcfg, tparams = setup
    js = j_empty(cfg, 2, 3, 64)
    ts = t_empty(tcfg, 2, 3, 64, device="cpu")
    rng = np.random.RandomState(3)
    toks = np.zeros((2, 3, 24), np.int32)
    toks[:, 0] = rng.randint(1, 255, (2, 24))
    lens = np.zeros((2, 3), np.int32)
    lens[:, 0] = (22, 13)                  # donors: slot 0 of each shard
    _, js, _ = j_forward(cfg, params, jnp.asarray(toks), js,
                         jnp.asarray(lens))
    _, ts, _ = t_forward(tcfg, tparams, torch.from_numpy(toks), ts,
                         torch.from_numpy(lens))
    P = t_classed.pages_local(ts.pool, 0)
    for dst, src, n in [((0, 1), (0, 0), 16), ((0, 2), (0, 0), 21),
                        ((1, 1), (1, 0), 12), ((1, 2), (1, 0), 20)]:
        dst_oh = np.zeros((2, 3), bool)
        dst_oh[dst] = True
        src_oh = np.zeros((2, 3), bool)
        src_oh[src] = True
        js, jok = jpc.share_prefix_step(8, js, jnp.asarray(dst_oh),
                                        jnp.asarray(src_oh), jnp.int32(n))
        ts, tok = tpc.share_prefix_step(8, ts, torch.from_numpy(dst_oh),
                                        torch.from_numpy(src_oh), n)
        what = f"share {src} -> {dst}, {n} tokens"
        assert bool(tok) == bool(jok), what
        assert np.array_equal(ts.page_tables.numpy(),
                              np.asarray(js.page_tables)), what
        assert np.array_equal(ts.seq_lens.numpy(),
                              np.asarray(js.seq_lens)), what
        assert_pools_equal(js.pool, ts.pool, what)
        row = ts.page_tables[dst].numpy()
        donor = ts.page_tables[src].numpy()
        if bool(tok) and n % 8:
            cow, orig = row[n // 8], donor[n // 8]
            assert cow >= 0 and cow != orig, what
            for pos, pages in ts.kv_pages.items():
                for tp, jp in zip(pages, js.kv_pages[pos]):
                    assert torch.equal(tp[:, dst[0], cow],
                                       tp[:, dst[0], orig]), what
                    np.testing.assert_allclose(
                        tp[:, dst[0], cow].numpy(),
                        np.asarray(jp[:, dst[0], cow]), atol=1e-4,
                        rtol=1e-4, err_msg=what)
        for pos, pages in ts.kv_pages.items():   # nothing else written
            for tp, jp in zip(pages, js.kv_pages[pos]):
                np.testing.assert_allclose(tp[:, :, :P].numpy(),
                                           np.asarray(jp), atol=1e-4,
                                           rtol=1e-4, err_msg=what)
    assert not bool(tok), "a donor with 13 tokens cannot give 20"


# ---------------------------------------------------------------- engine

def _hot_prefix_prompts():
    rng = np.random.RandomState(0)
    hot = list(rng.randint(1, 255, 16))          # 2 pages of 8
    return [list(hot) for _ in range(6)] + \
        [list(rng.randint(1, 255, 10)) for _ in range(3)]


def test_hot_prefix_speculation_matches_reference(setup):
    """tests/test_speculative.py's identity workload (DP 2, 2 slots a
    shard, a hot prompt six times and three cold ones, draft_len 4):
    the port equals the reference step for step, its tokens equal the
    non-speculative run of the same trace, drafts are accepted, and
    after every verify/rollback step each shard conserves its pages
    and keeps every lane stocked (§4.2)."""
    prompts = _hot_prefix_prompts()
    kw = dict(dp=2, b_local=2, max_len=64)
    tr, te, _ = assert_same(setup, prompts, 6, **SPEC, **kw)
    _, ref = serve(setup, True, prompts, 6, **PLAIN, **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in ref]
    assert te.stats["spec_accepted"] > 0 and te.stats["spec_lanes"] > 0

    _, _, tcfg, tparams = setup
    eng = tengine.ServingEngine(tcfg, tparams, device="cpu", **SPEC, **kw)
    for i, p in enumerate(prompts):
        eng.submit(tengine.Request(i, prompt=list(p), max_new_tokens=6))
    ell = t_classed.lane_ell(eng.state.pool, 0)
    while not eng.idle():
        eng.step()
        free = t_classed.free_per_shard(eng.state.pool, 0)
        live = t_classed.live_per_shard(eng.state.pool, 0)
        assert (free + live == eng.pages_local).all()
        assert int(eng.state.pool.classes[0].private_top.min()) >= ell
    assert eng.leak_free()


def test_rejected_drafts_roll_back_pages(setup):
    """tests/test_speculative.py's rollback workload: a recorded stream
    that matches one real token and then diverges.  Every draft is
    rejected, the whole pages over-allocated for them come back, the
    output equals the non-speculative stream."""
    cfg = setup[0]
    rng = np.random.RandomState(1)
    prompt = list(rng.randint(1, 255, 23))   # decode sits mid-page
    kw = dict(dp=1, b_local=1, max_len=64)
    _, (probe,) = serve(setup, True, [prompt], 6, **PLAIN, **kw)
    ref = probe.out_tokens
    garbage = tuple((t + 101) % (cfg.vocab - 2) + 1 for t in ref)

    def prepare(eng):
        key = eng.spec_store.key_of(prompt)
        eng.spec_store.record(key, tuple(prompt[len(key):]) + (ref[0],)
                              + garbage)

    (r,), te, _ = assert_same(setup, [prompt], 6, prepare=prepare, **SPEC,
                              **kw)
    assert r.out_tokens == ref
    assert te.stats["spec_drafted"] > 0 and te.stats["spec_accepted"] == 0
    assert te.stats["spec_pages_rolled_back"] > 0
    assert te.stats["accept_hist"].get(0, 0) >= 1
    assert te.telemetry.shard["spec_rollback_pages"].sum() > 0


def test_drafts_ride_mixed_prompt_decode_steps(setup):
    """A decoding slot drafts while another slot prefills: the recorded
    stream starts with the true first generated token (the reference's
    own mixed-step test records one that never matches, so no draft is
    ever made there), so drafts are made and accepted on mixed steps.
    Equal to the reference, and to the non-speculative run."""
    rng = np.random.RandomState(23)
    p0 = list(rng.randint(1, 255, 16))
    p1 = list(rng.randint(1, 255, 24))
    kw = dict(dp=1, b_local=2, max_len=64, chunk_size=4, submit_at=[0, 4])
    _, ref = serve(setup, True, [p0, p1], 12, **PLAIN, **kw)
    truth = ref[0].out_tokens

    def prepare(eng):
        key = eng.spec_store.key_of(p0)
        eng.spec_store.record(key, tuple(p0[len(key):]) + tuple(truth))

    tr, te, _ = assert_same(setup, [p0, p1], 12, prepare=prepare,
                            **dict(SPEC, draft_len=3), **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in ref]
    assert te.stats["spec_mixed_steps"] > 0
    assert te.stats["spec_accepted"] > 0
    assert any(rec["spec"] and rec["T"] == 4 and len(rec["rids"]) == 2
               for rec in te.flight.ring)


def test_shared_prefixes_with_copy_on_write(setup):
    """Staggered arrivals on one shard: later requests map a live
    donor's prefix (whole pages plus a COW copy of its partial page)
    and speculate on the hot prefix; equal to the reference, and to the
    run without sharing or speculation."""
    rng = np.random.RandomState(5)
    stem = list(rng.randint(1, 255, 20))         # 2.5 pages of 8
    prompts = [stem + list(rng.randint(1, 255, 6)) for _ in range(3)] + \
        [list(stem)]
    kw = dict(dp=1, b_local=2, max_len=64, submit_at=[0, 3, 3, 9])
    tr, te, _ = assert_same(setup, prompts, 8, **SPEC, **kw)
    _, ref = serve(setup, True, prompts, 8, prefix_sharing=False, **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in ref]
    assert te.stats["prefix_shared_tokens"] > 0
    assert te.stats["cow_copies"] > 0
    assert te.admission_transfers >= te.stats["prefix_shared_reqs"] > 0
