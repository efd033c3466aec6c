"""Pinned prefixes and preemption in the port, held against the
reference.

Host structures (``PinnedPrefixes``, the trie's pinned pseudo-slots)
hold the same state after the same calls; the device pin, unpin and
pinned-share steps give the same pin tables, page tables and pool
leaves; and the engines give identical tokens, status rows, counter
blocks, stats, pool leaves and pin tables on the workloads of
``tests/test_sched.py`` (preemption, page pressure, pins under mixed
finish orders, single-token pins, LRU eviction) and of
``tests/test_prefix_sharing.py`` (a pinned donor across an idle gap).
Both engines get ``prefix_sharing`` and ``speculate`` explicitly.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import (assert_engines_equal, assert_pools_equal, drive,
                            engine_setup)
from repro.models.decode_init import empty_decode_state as j_empty
from repro.models.transformer import forward_decode_chunk as j_forward
from repro.serving import prefix_cache as jpc
from repro.serving.sched import SchedConfig as JSched
from repro_torch.core import classed_pool as t_classed
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.transformer import forward_decode_chunk as t_forward
from repro_torch.serving import prefix_cache as tpc
from repro_torch.serving.sched import SchedConfig as TSched

SHARE = dict(prefix_sharing=True, speculate=False)


@pytest.fixture(scope="module")
def setup():
    return engine_setup("olmo-1b")


def _sched(**kw):
    """The same SchedConfig for each package."""
    return JSched(**kw), TSched(**kw)


def _both(setup, script, sched=None, **kw):
    """``script`` through both engines; everything compared, then both
    pin caches flushed and the pools compared again, drained to zero.
    Returns (port engine, port requests, reference engine)."""
    js, ts = _sched(**(sched or {}))
    je, jr = drive(setup, False, script, sched=js, **SHARE, **kw)
    te, tr = drive(setup, True, script, sched=ts, **SHARE, **kw)
    assert_engines_equal(je, jr, te, tr, drained=False)
    assert [r.preemptions for r in tr] == [r.preemptions for r in jr]
    assert te.scheduler.stats == je.scheduler.stats
    assert_pools_equal(je.state.pool, te.state.pool, "after the run")
    assert (te.pins is None) == (je.pins is None)
    if te.pins is not None:
        assert np.array_equal(te.pin_tables.numpy(),
                              np.asarray(je.pin_tables))
        assert te.pins.to_state() == je.pins.to_state()
        assert te.pinned_pages() == je.pinned_pages()
        assert te.pages_in_use() == je.pages_in_use()
    assert te.flush_pins() == je.flush_pins()
    assert_pools_equal(je.state.pool, te.state.pool, "after the flush")
    assert te.page_occupancy() == je.page_occupancy() == 0.0
    assert te.leak_free()
    return te, tr, je


def _run(setup, script, sched=None, **kw):
    """``script`` through the port alone."""
    return drive(setup, True, script, sched=TSched(**(sched or {})),
                 **SHARE, **kw)


# ------------------------------------------------------------ preemption

def test_preempt_then_readmit_token_identity(setup):
    """tests/test_sched.py:109 (greedy): two batch requests hold both
    slots mid-generation when an interactive one arrives; the victim
    finishes with exactly the tokens of a run on three slots."""
    def script(extra=()):
        return [("submit", 0, [2, 3, 4], 10, "batch"),
                ("submit", 1, [8, 9, 10], 10, "batch"),
                ("step", 3), ("submit", 2, [5, 6, 7], 4, "interactive"),
                ("run",)]
    te, tr, _ = _both(setup, script(), dp=1, b_local=2, max_len=64,
                      chunk_size=8)
    assert te.stats["preemptions"] >= 1
    assert sum(r.preemptions for r in tr) >= 1
    ref, rr = _run(setup, script(), dp=1, b_local=3, max_len=64,
                   chunk_size=8)
    assert ref.stats["preemptions"] == 0
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]


def test_preemption_on_page_pressure(setup):
    """tests/test_sched.py:154: a free slot but no page headroom; the
    interactive head preempts the standard holder."""
    te, tr, _ = _both(setup, [
        ("submit", 0, [2] * 20, 8, "standard"), ("step", 1),
        ("submit", 1, [4] * 20, 4, "interactive"), ("run",)],
        sched=dict(page_budget=6), dp=1, b_local=2, max_len=64,
        chunk_size=16)
    assert tr[0].preemptions >= 1


def test_readmission_estimate_stable_under_tight_budget(setup):
    """tests/test_sched.py:174: a victim that exactly fit the page
    budget fits again on readmission."""
    te, tr, _ = _both(setup, [
        ("submit", 0, [2] * 20, 8, "standard"), ("step", 7),
        ("submit", 1, [4, 5], 2, "interactive"), ("run",)],
        sched=dict(page_budget=4), dp=1, b_local=2, max_len=64,
        chunk_size=16)
    assert tr[0].preemptions >= 1 and len(tr[0].out_tokens) == 8


def test_preempt_mid_prefill_resumes_cleanly(setup):
    """tests/test_sched.py:197: preempted after one prefill chunk, the
    victim's tokens equal an undisturbed run's."""
    prompt = list(range(2, 26))
    te, tr, _ = _both(setup, [
        ("submit", 0, prompt, 4, "batch"), ("step", 1),
        ("submit", 1, [3, 5], 2, "interactive"), ("run",)],
        dp=1, b_local=1, max_len=64, chunk_size=8)
    assert tr[0].preemptions == 1
    ref, (r_ref,) = _run(setup, [("submit", 0, prompt, 4, "standard"),
                                 ("run",)],
                         dp=1, b_local=2, max_len=64, chunk_size=8)
    assert tr[0].out_tokens == r_ref.out_tokens


def test_preemption_with_pins_resumes_through_the_pin(setup):
    """The preempting path of a full-width serve, at smoke size: pins
    on and a page budget; the interactive requests preempt standard
    victims, whose whole pages are pinned in ``preempt`` and shared
    back on readmission."""
    rng = np.random.RandomState(7)
    script = [("submit", i, list(rng.randint(1, 255, rng.randint(20, 40))),
               12, "standard") for i in range(2)]
    script += [("step", 6)]
    script += [("submit", 2 + i, list(rng.randint(1, 255, 6)), 3,
                "interactive") for i in range(2)]
    script += [("run",)]
    te, tr, _ = _both(setup, script, sched=dict(pin_pages=8), dp=1,
                      b_local=2, max_len=64, chunk_size=8)
    assert te.stats["preemptions"] >= 1 and te.stats["pin_hit_reqs"] >= 1
    ref, rr = _run(setup, script, sched=dict(preemption=False), dp=1,
                   b_local=2, max_len=64, chunk_size=8)
    assert ref.stats["preemptions"] == 0
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]


# ---------------------------------------------------------------- pinning

@pytest.mark.parametrize("first_longer", [False, True])
def test_refcount_accounting_mixed_finish_orders(setup, first_longer):
    """tests/test_sched.py:225: two sharers of a hot prefix finish in
    either order; both pin the same 2 whole pages (deduplicated), a
    re-arrival hits the pin, and a flush empties the pool."""
    rng = np.random.RandomState(2)
    hot = list(rng.randint(1, 255, 16))
    na, nb = (6, 3) if first_longer else (3, 6)
    script = [("submit", 0, hot + [90, 91], na, "standard"), ("step", 2),
              ("submit", 1, hot + [77, 78, 79], nb, "standard"), ("run",),
              ("submit", 2, hot + [50, 51], 3, "standard"), ("run",)]
    te, tr, _ = _both(setup, script, sched=dict(pin_pages=8), dp=1,
                      b_local=2, max_len=64, chunk_size=16)
    assert te.stats["pin_hit_reqs"] == 1
    assert te.stats["pin_hit_tokens"] == 16


def test_pinned_refcounts_after_drain(setup):
    """After the drain only the pin holds pages: refcount 1 each."""
    rng = np.random.RandomState(2)
    hot = list(rng.randint(1, 255, 16))
    te, _ = _run(setup, [("submit", 0, hot + [90, 91], 3, "standard"),
                         ("step", 2),
                         ("submit", 1, hot + [77, 78, 79], 6, "standard"),
                         ("run",)],
                 sched=dict(pin_pages=8), dp=1, b_local=2, max_len=64,
                 chunk_size=16)
    assert te.pinned_pages() == te.pages_in_use() == 2
    rc = te.state.pool.classes[0].shared.refcount[0].numpy()
    assert (rc == 1).sum() == 2 and (rc >= 2).sum() == 0
    row = te.pin_tables[0].reshape(-1)
    assert int((rc[row[row >= 0].long()] == 1).sum()) == 2
    te.flush_pins()
    assert te.page_occupancy() == 0.0


def test_pin_engages_for_single_token_requests(setup):
    """tests/test_sched.py:271: a request that finishes on its
    prompt-completion step pins before the step's dispatch."""
    rng = np.random.RandomState(5)
    hot = list(rng.randint(1, 255, 16))
    te, tr, je = _both(setup, [
        ("submit", 0, hot + [3, 4], 1, "standard"), ("run",),
        ("submit", 1, hot + [5, 6], 1, "standard"), ("run",)],
        sched=dict(pin_pages=8), dp=1, b_local=2, max_len=64, chunk_size=8)
    assert te.stats["pins_created"] == 1
    assert te.stats["pin_hit_reqs"] == 1


def test_lru_eviction_under_pin_budget(setup):
    """tests/test_sched.py:297: three 2-page prefixes against a 4-page
    budget; after A is touched, B is the one evicted."""
    rng = np.random.RandomState(3)
    pA, pB, pC = (list(rng.randint(1, 255, 16)) for _ in range(3))
    script = [("submit", 0, pA + [60], 2, "standard"), ("run",),
              ("submit", 1, pB + [61], 2, "standard"), ("run",),
              ("submit", 7, pA + [99], 2, "standard"), ("run",),
              ("submit", 8, pC + [98], 2, "standard"), ("run",)]
    te, _ = _run(setup, script, sched=dict(pin_pages=4), dp=1, b_local=2,
                 max_len=64, chunk_size=16)
    assert te.pinned_pages() == 4
    assert te.scheduler.stats["pins_evicted"] == 1
    assert te.pins.lookup(0, tuple(pB)) is None
    assert te.pins.lookup(0, tuple(pA)) is not None
    assert te.pins.lookup(0, tuple(pC)) is not None
    _both(setup, script, sched=dict(pin_pages=4), dp=1, b_local=2,
          max_len=64, chunk_size=16)


@pytest.mark.parametrize("pin_pages", [8, 0])
def test_pinned_prefix_survives_idle_gap(setup, pin_pages):
    """tests/test_prefix_sharing.py:306: a second wave after a full
    drain shares the hot prefix from the pin (fewer prompt tokens fed)
    with the tokens of the run without pins."""
    rng = np.random.RandomState(11)
    hot = list(rng.randint(1, 255, 32))
    waves = [[hot + list(rng.randint(1, 255, 4)) for _ in range(3)]
             for _ in range(2)]
    script = []
    for w, wave in enumerate(waves):
        script += [("submit", w * 10 + i, p, 4, "standard")
                   for i, p in enumerate(wave)] + [("run",)]
    te, tr, _ = _both(setup, script, sched=dict(pin_pages=pin_pages), dp=1,
                      b_local=3, max_len=96, chunk_size=16)
    if pin_pages:
        assert te.stats["pin_hit_reqs"] >= 1
        raw, rr = _run(setup, script, dp=1, b_local=3, max_len=96,
                       chunk_size=16)
        assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]
        assert (raw.stats["prompt_tokens"] - te.stats["prompt_tokens"]
                >= len(hot) - 8)


def test_pins_across_two_shards(setup):
    """DP 2: pins are shard-local; each shard's pin rows and pool stay
    equal to the reference's."""
    rng = np.random.RandomState(4)
    hot = list(rng.randint(1, 255, 24))
    script = [("submit", i, hot + list(rng.randint(1, 255, 3)), 3,
               "standard") for i in range(6)] + [("run",)]
    script += [("submit", 10 + i, hot + [i + 1], 2, "interactive")
               for i in range(3)] + [("run",)]
    te, _, _ = _both(setup, script, sched=dict(pin_pages=6), dp=2,
                     b_local=2, max_len=64, chunk_size=8)
    assert te.stats["pins_created"] >= 2


def test_pins_off_without_a_prefix_cache():
    """Ring and recurrent models cannot share: pins stay off, as in the
    reference, and the engine serves as before."""
    setup = engine_setup("recurrentgemma-2b")
    te, tr, je = _both(setup, [("submit", 0, [3, 4, 5], 3, "standard"),
                               ("run",)],
                       sched=dict(pin_pages=8), dp=1, b_local=1, max_len=64)
    assert te.pins is None and te.pin_tables is None


# ------------------------------------------------------------ host state

def test_pinned_prefixes_ledger_matches_reference():
    """Random add / touch / remove / lookup / lru on both ledgers, then
    to_state and load_state across the packages."""
    rng = np.random.RandomState(6)
    j, t = jpc.PinnedPrefixes(2, 3, 9), tpc.PinnedPrefixes(2, 3, 9)
    keys = [tuple(rng.randint(0, 4, 4)) for _ in range(5)]
    for i in range(300):
        op, shard = rng.randint(5), int(rng.randint(2))
        if op == 0 and j.has_free_row(shard):
            key = keys[rng.randint(5)]
            if j.lookup(shard, key) is None:
                pages = int(rng.randint(1, 4))
                assert j.fits(shard, pages) == t.fits(shard, pages)
                assert t.add(shard, key, pages) == j.add(shard, key, pages)
        elif op == 1 and j.entries:
            pid = int(rng.choice(sorted(j.entries)))
            j.touch(pid)
            t.touch(pid)
        elif op == 2 and j.entries:
            pid = int(rng.choice(sorted(j.entries)))
            assert t.remove(pid) == j.remove(pid)
        elif op == 3:
            assert t.lru(shard) == j.lru(shard)
        else:
            key = keys[rng.randint(5)]
            assert t.lookup(shard, key) == j.lookup(shard, key)
        assert t.to_state() == j.to_state(), i
        assert [t.pages_on(s) for s in (0, 1)] == \
            [j.pages_on(s) for s in (0, 1)]
        assert t.total_pages() == j.total_pages()
        assert t.free_rows == j.free_rows
    state = j.to_state()
    t2, j2 = tpc.PinnedPrefixes(2, 3, 9), jpc.PinnedPrefixes(2, 3, 9)
    t2.load_state(state)
    j2.load_state(t.to_state())
    assert t2.to_state() == j2.to_state() == state
    assert t2.free_rows == j2.free_rows == j.free_rows
    assert t2.by_key == j2.by_key


def test_trie_pinned_pseudo_slots_match_reference():
    """Pinned rows as trie donors: same matches, the tie preferring a
    live donor, pin_remove pruning as the reference prunes."""
    assert tpc.pin_id_of(tpc.pin_pseudo_slot(5)) == 5
    assert tpc.pin_pseudo_slot(0) == jpc.pin_pseudo_slot(0) == -2
    rng = np.random.RandomState(8)
    stem = list(rng.randint(0, 3, 16))
    j, t = jpc.PrefixCache(page_size=4), tpc.PrefixCache(page_size=4)
    for c in (j, t):
        c.pin_insert(0, 0, stem[:8])
        c.insert(3, 0, stem + [1, 2])
        c.pin_insert(1, 1, stem[:12])
    for toks in (stem[:9] + [0], stem + [2], stem[:4] + [9] * 6):
        for shard in (0, 1, None):
            a, b = j.match(toks, shard=shard), t.match(toks, shard=shard)
            assert (a is None) == (b is None)
            if a is not None:
                assert (b.slot, b.shard, b.n_tokens, b.pinned) == \
                    (a.slot, a.shard, a.n_tokens, a.pinned)
    # the live donor has written nothing yet: the pinned row donates
    m = t.match(stem[:9] + [0], shard=0)
    assert m.pinned and m.n_tokens == 8
    for c in (j, t):
        c.update_progress(3, 18)
    # a tie (8 tokens from either donor) goes to the live slot
    for c in (j, t):
        m = c.match(stem[:8] + [5], shard=0)
        assert not m.pinned and m.slot == 3 and m.n_tokens == 8
    for c in (j, t):
        c.pin_remove(0)
        c.remove(3)
    assert t.match(stem + [2], shard=0) is None
    assert j.match(stem + [2], shard=0) is None
    assert set(t.roots[0].children) == set(j.roots[0].children) == set()


# ----------------------------------------------------------- device steps

def test_pin_unpin_and_pinned_share_steps_match_reference(setup):
    """A donor prefilled through both forwards (DP 2, page 8); pin its
    first 2 pages, release the donor's own references, share from the
    pin (whole pages, then a partial tail with its COW page), and unpin:
    after each call the pin table, page tables, lengths and every pool
    leaf are equal."""
    cfg, params, tcfg, tparams = setup
    js = j_empty(cfg, 2, 3, 64)
    ts = t_empty(tcfg, 2, 3, 64, device="cpu")
    rng = np.random.RandomState(9)
    toks = np.zeros((2, 3, 24), np.int32)
    toks[:, 0] = rng.randint(1, 255, (2, 24))
    lens = np.zeros((2, 3), np.int32)
    lens[:, 0] = (22, 19)
    _, js, _ = j_forward(cfg, params, jnp.asarray(toks), js,
                         jnp.asarray(lens))
    _, ts, _ = t_forward(tcfg, tparams, torch.from_numpy(toks), ts,
                         torch.from_numpy(lens))
    maxp = ts.page_tables.shape[2]
    jpin = jnp.full((2, 2, maxp), -1, jnp.int32)
    tpin = torch.full((2, 2, maxp), -1, dtype=torch.int32)

    def oh(shape, *idx):
        a = np.zeros(shape, bool)
        for i in idx:
            a[i] = True
        return a

    def same(what):
        assert np.array_equal(tpin.numpy(), np.asarray(jpin)), what
        assert np.array_equal(ts.page_tables.numpy(),
                              np.asarray(js.page_tables)), what
        assert np.array_equal(ts.seq_lens.numpy(),
                              np.asarray(js.seq_lens)), what
        assert_pools_equal(js.pool, ts.pool, what)

    for d, row, n_pages in ((0, 1, 2), (1, 0, 2)):
        p, s = oh((2, 2), (d, row)), oh((2, 3), (d, 0))
        jpool, jpin = jpc.pin_prefix_step(js.pool, jpin, js.page_tables,
                                          jnp.asarray(p), jnp.asarray(s),
                                          jnp.int32(n_pages))
        tpool, tpin = tpc.pin_prefix_step(ts.pool, tpin, ts.page_tables,
                                          torch.from_numpy(p),
                                          torch.from_numpy(s), n_pages)
        js, ts = js._replace(pool=jpool), ts._replace(pool=tpool)
        same(f"pin shard {d}")
    # the donors release their own references: the pins keep the pages
    from repro.serving.engine import _release_slots as j_release
    from repro_torch.serving.engine import _release_slots as t_release
    m = oh((2, 3), (0, 0), (1, 0))
    js, _ = j_release(js, jnp.asarray(m))
    ts, _ = t_release(ts, torch.from_numpy(m))
    same("release the donors")
    assert t_classed.live_per_shard(ts.pool, 0).tolist() == [2, 2]
    for dst, (d, row), n in (((0, 1), (0, 1), 16), ((1, 2), (1, 0), 12)):
        dst_oh, p = oh((2, 3), dst), oh((2, 2), (d, row))
        js, jok = jpc.share_pinned_step(8, js, jpin, jnp.asarray(dst_oh),
                                        jnp.asarray(p), jnp.int32(n))
        ts, tok = tpc.share_pinned_step(8, ts, tpin,
                                        torch.from_numpy(dst_oh),
                                        torch.from_numpy(p), n)
        assert bool(tok) == bool(jok) is True
        same(f"share pin {d}/{row} -> {dst}, {n} tokens")
        for pos, pages in ts.kv_pages.items():
            P = t_classed.pages_local(ts.pool, 0)
            for tp, jp in zip(pages, js.kv_pages[pos]):
                np.testing.assert_allclose(tp[:, :, :P].numpy(),
                                           np.asarray(jp), atol=1e-4,
                                           rtol=1e-4)
    p = oh((2, 2), (0, 1), (1, 0))
    jpool, jpin = jpc.unpin_step(js.pool, jpin, jnp.asarray(p))
    tpool, tpin = tpc.unpin_step(ts.pool, tpin, torch.from_numpy(p))
    js, ts = js._replace(pool=jpool), ts._replace(pool=tpool)
    same("unpin both rows")
    assert (tpin == -1).all()


def test_free_shared_dp_matches_reference(setup):
    """classed_pool.free_shared_dp: lane-less releases to the shared
    stack, duplicates and NULL ids included."""
    from repro.core import classed_pool as j_classed
    cfg, _, tcfg, _ = setup
    jpool = j_empty(cfg, 2, 2, 64).pool
    tpool = t_empty(tcfg, 2, 2, 64, device="cpu").pool
    counts = np.full((2, 2), 3, np.int32)
    jpool, jids = j_classed.alloc_from_shared_dp(jpool, 0,
                                                 jnp.asarray(counts), 3)
    tpool, tids = t_classed.alloc_from_shared_dp(tpool, 0,
                                                 torch.from_numpy(counts), 3)
    ids = np.array(jids).reshape(2, -1)
    extra = np.concatenate([ids[:, :2], np.full((2, 1), -1, np.int32)], 1)
    jpool = j_classed.addref_dp(jpool, 0, jnp.asarray(extra))
    tpool = t_classed.addref_dp(tpool, 0, torch.from_numpy(extra))
    for rows in (extra, ids[:, 1:4], ids[:, [0, 4, 5]]):
        jpool = j_classed.free_shared_dp(jpool, 0, jnp.asarray(rows))
        tpool = t_classed.free_shared_dp(tpool, 0, torch.from_numpy(rows))
        assert_pools_equal(jpool, tpool, "free_shared_dp")
