"""Crash recovery of the port's serving plane, held against the
reference (the classes of ``tests/test_chaos.py``).

* ``audit_and_reconcile`` (hier_pool and classed_pool) on torn and
  random pools: every rebuilt leaf and the report exactly equal to the
  reference's, on the pool's own device and dtypes;
* a host crash at every phase of ``chaos.PHASES`` and in the torn
  drain/refill window, greedy and sampled lanes in one batch: the same
  reconcile report and rebuilt pool as the JAX engine, streams equal to
  the JAX engine's uninterrupted run, 0 leaked pages;
* the journal's JSONL round trip; poison, retry, terminal; deadlines on
  queued and running work and across a crash; a step error recovered in
  place and one past the restart budget; shard loss at dp 2;
* a warm restart with pins, speculation and queued requests through the
  checkpoint's ``aux`` sidecar, and two shard writers of one step (the
  ranks of a DP group) marking it complete only when both files landed;
* the port's ``core/linearizability.py`` giving the reference's verdicts
  on recovery histories.
"""

import json

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                 # pragma: no cover
    from _hypothesis_fallback import given, settings, st

from _torch_helpers import assert_pools_equal, engine_setup, pool_leaves
from repro.core import classed_pool as j_classed
from repro.core import hier_pool as j_hier
from repro_torch.core.linearizability import check_recovery_history
from repro_torch.core.sim import OpRecord
from repro.serving import chaos as jchaos
from repro.serving import engine as jengine
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.core import classed_pool as t_classed
from repro_torch.core import hier_pool as t_hier
from repro_torch.core.block_pool import BlockPool
from repro_torch.serving import chaos
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sched import FAILURE_REASONS, SchedConfig


@pytest.fixture(scope="module")
def setup():
    return engine_setup("olmo-1b")


def _port(setup, **kw):
    _, _, tcfg, tparams = setup
    return ServingEngine(tcfg, tparams, device="cpu", **kw)


def _conserved(eng):
    hp = eng.state.pool.classes[0]
    free = int(t_hier.total_free(hp))
    live = int(t_hier.num_live(hp))
    assert free + live == eng.pages_local * eng.dp, "pages lost or doubled"


def _mk_reqs(Req=Request, n=4, max_new=6):
    """Greedy and sampled lanes in one batch: rids 0, 2 greedy; 1, 3
    sampled (tests/test_chaos.py::_mk_reqs)."""
    return [Req(rid=i, prompt=[2 + i, 3, 5, 7 + i], max_new_tokens=max_new,
                temperature=0.8 if i % 2 else 0.0, seed=100 + i)
            for i in range(n)]


@pytest.fixture(scope="module")
def ref_outputs(setup):
    """The JAX engine's uninterrupted streams of the _mk_reqs batch."""
    cfg, params, _, _ = setup
    reqs = _mk_reqs(jengine.Request)
    eng = jengine.ServingEngine(cfg, params, dp=1, b_local=4)
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=300)
    assert all(r.done for r in reqs)
    return {r.rid: list(r.out_tokens) for r in reqs}


# --------------------------------------------------- pool reconcile

def _jpool(leaves):
    fi, top, ref, pids, ptop = (jnp.asarray(a) for a in leaves)
    return j_hier.HierPool(j_hier.BlockPool(fi, top, ref), pids, ptop)


def _tpool(leaves):
    fi, top, ref, pids, ptop = (torch.as_tensor(np.asarray(a))
                                for a in leaves)
    return t_hier.HierPool(BlockPool(fi, top, ref), pids, ptop)


def _reconcile_both(leaves, keep=None, pins=None):
    """The same numpy pool and rows through both packages'
    ``hier_pool.audit_and_reconcile``: every leaf, its dtype and the
    report equal.  Returns the port's (pool, report)."""
    jp, jrep = j_hier.audit_and_reconcile(_jpool(leaves), keep, pins)
    tp, trep = t_hier.audit_and_reconcile(
        _tpool(leaves), None if keep is None else torch.as_tensor(keep),
        pins)
    assert_pools_equal(jp, tp, "reconciled")
    assert trep == jrep
    return tp, trep


def _torn_pool_with_tables(dp=2, m=16, lanes=2, ell=3):
    """tests/test_chaos.py's torn pool, built by the port's ops: 3 pages
    on each shard's lane 0, then drained and never refilled."""
    pool = t_hier.create_dp(dp, m, lanes, ell, "cpu")
    counts = torch.zeros((dp, lanes), dtype=torch.int32)
    counts[:, 0] = 3
    pool, ids = t_hier.alloc_n_dp(pool, counts, 3)
    tables = np.full((dp, lanes, 4), -1, np.int64)
    tables[:, 0, :3] = ids.numpy()[:, 0, :3]
    return t_hier.rebalance_drain_dp(pool), tables


def test_torn_pool_reconciles_like_the_reference():
    pool, tables = _torn_pool_with_tables()
    leaves = pool_leaves(pool)
    new, report = _reconcile_both(leaves, keep=tables)
    assert report["conserved"] and report["never_dry"]
    assert [s["live"] for s in report["shards"]] == [3, 3]
    assert bool((new.private_top == t_hier.lane_ell(new)).all())
    # every slot row dead, lane-0 rows kept as pins; then nobody holds
    dead = np.full_like(tables, -1)
    _, rep = _reconcile_both(leaves, keep=dead, pins=tables[:, :1])
    assert rep["reclaimed"] == 0
    _, rep = _reconcile_both(leaves, keep=dead)
    assert rep["reclaimed"] == 6
    # a torn mirror that already dropped the refcounts: resurrection
    zeroed = list(leaves)
    zeroed[2] = np.zeros_like(leaves[2])
    _, rep = _reconcile_both(zeroed, keep=tables)
    assert rep["resurrected"] == 6


def test_single_shard_pool_and_the_refcount_clamp():
    """A single-shard pool (0-d top), and a page referenced by more rows
    than the int16 refcount holds: clamped to 32767 and reported, as in
    the reference."""
    pool = t_hier.create(24, 2, 3, "cpu")
    leaves = pool_leaves(pool)
    keep = np.full((40000,), 5, np.int64)
    new, rep = _reconcile_both(leaves, keep=keep)
    assert rep["clamped"] == 1 and int(new.shared.refcount[5]) == 32767
    assert new.shared.refcount.dtype == torch.int16


@settings(max_examples=6, deadline=None, derandomize=True)
@given(st.integers(min_value=0, max_value=10**6))
def test_random_pools_reconcile_like_the_reference(seed):
    """Random (even inconsistent) pools and random keep and pin rows
    over two shards: leaves and report exactly the reference's."""
    rng = np.random.RandomState(seed)
    dp, m, lanes, ell = 2, 40, 3, 2
    leaves = [rng.permutation(m)[None].repeat(dp, 0).astype(np.int32),
              rng.randint(0, m + 1, dp).astype(np.int32),
              rng.randint(-1, 4, (dp, m)).astype(np.int16),
              rng.randint(-1, m, (dp, lanes, 3 * ell)).astype(np.int32),
              rng.randint(0, 3 * ell + 1, (dp, lanes)).astype(np.int32)]
    keep = rng.randint(-1, m, (dp, lanes, 5))
    pins = rng.randint(-1, m, (dp, 2, 5)) if seed % 2 else None
    _, rep = _reconcile_both(leaves, keep=keep, pins=pins)
    for s in rep["shards"]:
        assert s["free"] + s["live"] == s["capacity"] == m


def test_classed_pool_reconcile_and_num_live():
    """Two size classes, pins in the KV class only: the merged report
    and every leaf equal the reference's; num_live agrees."""
    jspecs = [j_classed.ClassSpec(8, 30, 2, 2), j_classed.ClassSpec(4, 20, 2, 3)]
    tspecs = [t_classed.ClassSpec(*s) for s in jspecs]
    jp = j_classed.create_dp(2, jspecs)
    tp = t_classed.create_dp(2, tspecs, "cpu")
    counts = np.array([[2, 1], [0, 3]], np.int32)
    jp, jids = j_classed.alloc_from_shared_dp(jp, 1, jnp.asarray(counts), 3)
    tp, tids = t_classed.alloc_from_shared_dp(tp, 1, torch.as_tensor(counts),
                                              3)
    assert np.array_equal(np.asarray(jids), tids.numpy())
    assert int(t_classed.num_live(tp)) == int(j_classed.num_live(jp)) == 6
    pins = np.array([[[0, 1, -1]], [[2, -1, -1]]])
    jn, jrep = j_classed.audit_and_reconcile(jp, pin_tables=(pins, None))
    tn, trep = t_classed.audit_and_reconcile(tp, pin_tables=(pins, None))
    assert_pools_equal(jn, tn, "classed reconcile")
    assert trep == jrep and trep["reclaimed"] == 6
    assert int(t_classed.num_live(tn)) == 3


def test_single_block_ops_match_the_reference():
    """hier_pool.alloc, alloc_or_shared and free (and their _dp names)
    give the reference's grants and leaves, the shared fallback
    included."""
    jp = j_hier.create_dp(2, 12, 3, 1)
    tp = t_hier.create_dp(2, 12, 3, 1, "cpu")
    rng = np.random.RandomState(3)
    held = []
    for i in range(12):
        want = rng.rand(2, 3) < 0.7
        if i % 3 == 2:
            jp, jids = j_hier.alloc_dp(jp, jnp.asarray(want))
            tp, tids = t_hier.alloc_dp(tp, torch.as_tensor(want))
        else:
            jp, jids = j_hier.alloc_or_shared_dp(jp, jnp.asarray(want))
            tp, tids = t_hier.alloc_or_shared_dp(tp, torch.as_tensor(want))
        assert np.array_equal(np.asarray(jids), tids.numpy()), i
        held.append(tids.numpy())
        if i % 4 == 3:
            ids = held.pop(0)
            jp = j_hier.jax.vmap(j_hier.free, in_axes=(j_hier.DP_AXES, 0))(
                jp, jnp.asarray(ids))
            tp = t_hier.free(tp, torch.as_tensor(ids))
        assert_pools_equal(jp, tp, f"op {i}")
        assert int(t_hier.num_live(tp)) == int(j_hier.num_live(jp))


def _recovery_history(held, back, Op=OpRecord):
    """Pid 0 allocates ``held`` one block at a time, pid 1 crashes it,
    then reconciles ``back``."""
    ops = [Op(opid=i, pid=0, name="allocate", arg=None,
              invoke_step=i, response_step=i + 1, result=b)
           for i, b in enumerate(held)]
    n = len(ops)
    ops.append(Op(opid=n, pid=1, name="crash", arg=[0],
                  invoke_step=n, response_step=n + 1, result=None))
    ops.append(Op(opid=n + 1, pid=1, name="reconcile", arg=back,
                  invoke_step=n + 2, response_step=n + 3, result=None))
    return ops


def _reclaimed_by_reconcile():
    """The pages one crashed slot held (3 of a 16-page pool) and what
    the port's reconcile reclaimed."""
    pool = t_hier.create(16, 2, 3, "cpu")
    pool, ids = t_hier.alloc_n(pool, torch.tensor([3, 0]), 3)
    held = [int(b) for b in ids[0]]
    _, rep = t_hier.audit_and_reconcile(pool)
    return held, rep["shards"][0]["reclaimed"]


def test_reconcile_history_passes_the_recovery_checker():
    """The pages a crashed slot held, allocated then reclaimed by the
    port's reconcile: ``check_recovery_history`` finds no leak and no
    double free; dropping one reclaimed page is a leak."""
    held, reclaimed = _reclaimed_by_reconcile()
    assert sorted(reclaimed) == sorted(held)
    assert check_recovery_history(_recovery_history(held, reclaimed)) == []
    assert any("leaked" in e for e in check_recovery_history(
        _recovery_history(held, reclaimed[1:])))


def test_recovery_checker_gives_the_reference_verdicts():
    """The port's ``core/linearizability.py`` and the reference's give
    the same findings on the same recovery histories: the clean and the
    leaking history above, a double free, an orphan never reconciled,
    and seeded random histories of batch grants, frees, crashes and
    reconciles over a few pids (most of them faulty)."""
    from repro.core import linearizability as j_lin
    from repro.core.sim import OpRecord as JOp
    from repro_torch.core import linearizability as t_lin

    held, reclaimed = _reclaimed_by_reconcile()
    cases = [(held, reclaimed), (held, reclaimed[1:]),
             (held, reclaimed + [15]), (held, None)]
    histories = [(_recovery_history(h, b), _recovery_history(h, b, JOp))
                 for h, b in cases]
    rng = np.random.RandomState(11)
    for _ in range(40):
        specs, t = [], 0
        for i in range(int(rng.randint(4, 14))):
            kind = rng.choice(["alloc_n", "free_n", "crash", "reconcile"],
                              p=[0.45, 0.25, 0.15, 0.15])
            pid = int(rng.randint(0, 3))
            ids = [int(b) for b in rng.choice(12, int(rng.randint(0, 4)),
                                              replace=False)]
            arg = (ids if kind in ("free_n", "reconcile")
                   else [pid] if kind == "crash" else len(ids))
            result = ids if kind == "alloc_n" else None
            specs.append(dict(opid=i, pid=pid, name=str(kind), arg=arg,
                              invoke_step=t, response_step=t + 1,
                              result=result))
            t += int(rng.randint(1, 3))
        histories.append(([OpRecord(**x) for x in specs],
                          [JOp(**x) for x in specs]))
    verdicts = [t_lin.check_recovery_history(a) for a, _ in histories]
    assert verdicts == [j_lin.check_recovery_history(b)
                        for _, b in histories]
    assert verdicts[0] == [] and all(verdicts[1:4])
    assert sum(bool(v) for v in verdicts) > len(verdicts) // 2


# -------------------------------------------------- crash recovery e2e

CRASH_CASES = [("pre_tick", False), ("post_admission", False),
               ("feed", False), ("dispatched", True),
               ("post_sync", True), ("post_step", False)]


def _crash_and_recover(setup, port, phase, torn):
    """Crash one package's engine at step 3's ``phase`` and recover it
    through its ``recover_engine``; returns the journal, the report (its
    requests left out), the pool leaves right after recovery, and the
    recovered engine after its run."""
    cfg, params, tcfg, tparams = setup
    ch = chaos if port else jchaos
    journal = ch.ServingJournal()
    injector = ch.ServingFailureInjector(
        [ch.Fault(step=3, phase=phase, kind="crash", torn=torn)])

    def build():
        if port:
            return _port(setup, dp=1, b_local=4, journal=journal,
                         injector=injector)
        return jengine.ServingEngine(cfg, params, dp=1, b_local=4,
                                     journal=journal, injector=injector)

    eng = build()
    for r in _mk_reqs(Request if port else jengine.Request):
        eng.submit(r)
    with pytest.raises(ch.HostCrash):
        eng.run(max_steps=300)
    eng2, report = ch.recover_engine(build, eng, journal)
    leaves = pool_leaves(eng2.state.pool)
    report = {k: v for k, v in report.items() if k != "requests"}
    eng2.run(max_steps=300)
    return journal, report, leaves, eng2


@pytest.mark.parametrize("phase,torn", CRASH_CASES,
                         ids=[f"{p}{'-torn' if t else ''}"
                              for p, t in CRASH_CASES])
def test_crash_recovers_like_the_reference(setup, ref_outputs, phase, torn):
    """Greedy and sampled lanes: the recovered streams equal the JAX
    engine's uninterrupted ones, 0 pages leak; in the torn window the
    port's reconcile report and rebuilt pool also equal the JAX engine's
    after the same crash (one case: each JAX engine compiles anew)."""
    tj, trep, tleaves, te = _crash_and_recover(setup, True, phase, torn)
    assert trep["conserved"] and trep["never_dry"]
    assert tj.finished() == set(ref_outputs)
    assert tj.outputs() == ref_outputs
    assert te.leak_free()
    _conserved(te)
    if phase == "dispatched":
        jj, jrep, jleaves, _ = _crash_and_recover(setup, False, phase, torn)
        assert trep == jrep
        for a, b in zip(jleaves, tleaves):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert jj.outputs() == ref_outputs


def test_recovered_state_stays_on_the_engine_device(setup):
    """Every tensor recovery puts back (pool leaves, registers, page
    tables, pin table) is on the engine's device with the fresh
    engine's dtypes."""
    journal = chaos.ServingJournal()
    injector = chaos.ServingFailureInjector(
        [chaos.Fault(step=2, phase="dispatched", kind="crash", torn=True)])

    def build():
        return _port(setup, dp=1, b_local=2, journal=journal,
                     injector=injector, prefix_sharing=True,
                     sched=SchedConfig(pin_pages=8))

    eng = build()
    eng.submit(Request(0, prompt=list(range(2, 20)), max_new_tokens=4))
    with pytest.raises(chaos.HostCrash):
        eng.run(max_steps=100)
    fresh = build()
    eng2, _ = chaos.recover_engine(build, eng, journal)
    got = (pool_leaves(eng2.state.pool), [eng2.temps, eng2.topks, eng2.seeds,
                                          eng2.last_tok, eng2.pin_tables])
    want = (pool_leaves(fresh.state.pool), [fresh.temps, fresh.topks,
                                            fresh.seeds, fresh.last_tok,
                                            fresh.pin_tables])
    assert [a.dtype for a in got[0]] == [a.dtype for a in want[0]]
    for a, b in zip(got[1], want[1]):
        assert a.device == b.device and a.dtype == b.dtype
    assert all(t.device.type == "cpu" for t in
               (eng2.state.page_tables, eng2.state.seq_lens))


def test_journal_jsonl_roundtrip(setup, tmp_path):
    path = tmp_path / "journal.jsonl"
    journal = chaos.ServingJournal(path=str(path))
    eng = _port(setup, dp=1, b_local=4, journal=journal)
    reqs = _mk_reqs(n=2)
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=300)
    journal.close()
    replay = chaos.ServingJournal.load(str(path))
    assert replay.finished() == {0, 1}
    assert replay.outputs()[0] == list(reqs[0].out_tokens)
    assert not replay.in_flight()
    for line in path.read_text().splitlines():
        json.loads(line)


# --------------------------------------------- typed failures/deadlines

def _both(setup, script, kw):
    """``script(eng, Req)`` on both packages' engines; returns (port,
    reference) results."""
    cfg, params, _, _ = setup
    t = script(_port(setup, **kw(chaos, SchedConfig)), Request)
    from repro.serving.sched import SchedConfig as JSched
    j = script(jengine.ServingEngine(cfg, params, **kw(jchaos, JSched)),
               jengine.Request)
    return t, j


def test_poison_retries_then_terminal(setup):
    def kw(ch, Sched):
        return dict(dp=1, b_local=4, sched=Sched(retry_limit=1,
                                                 retry_backoff=1),
                    injector=ch.ServingFailureInjector(
                        [ch.Fault(step=s, phase="feed", kind="poison", rid=1)
                         for s in (1, 3, 6)]))

    def script(eng, Req):
        reqs = _mk_reqs(Req, n=3)
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=300)
        assert reqs[1].rejected == "poisoned" and reqs[1].retries == 1
        assert eng.stats["retries"] == 1 and eng.stats["failed"] == 1
        assert reqs[0].done and reqs[2].done
        assert eng.leak_free()
        return [r.out_tokens for r in reqs], eng.stats["steps"]

    t, j = _both(setup, script, kw)
    assert t == j
    assert "poisoned" in FAILURE_REASONS


def test_deadline_expires_queued_and_running(setup):
    clock = [0.0]
    eng = _port(setup, dp=1, b_local=4, clock=lambda: clock[0])
    reqs = [Request(rid=i, prompt=[2 + i, 3, 5], max_new_tokens=20,
                    deadline_s=10.0) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    assert all(r.deadline_at == 10.0 for r in reqs)
    for _ in range(2):
        eng.step()
    clock[0] = 11.0                          # everyone expires
    eng.run(max_steps=300)
    assert all(r.rejected == "deadline" for r in reqs if not r.done)
    assert any(r.rejected == "deadline" for r in reqs)
    assert eng.stats["deadline_expired"] >= 1
    _conserved(eng)
    assert eng.leak_free()


def test_deadline_survives_crash_recovery(setup):
    clock = [0.0]
    journal = chaos.ServingJournal()
    injector = chaos.ServingFailureInjector(
        [chaos.Fault(step=2, phase="post_sync", kind="crash")])

    def build():
        return _port(setup, dp=1, b_local=4, journal=journal,
                     injector=injector, clock=lambda: clock[0])

    eng = build()
    eng.submit(Request(rid=0, prompt=[2, 3, 5], max_new_tokens=20,
                       deadline_s=10.0))
    with pytest.raises(chaos.HostCrash):
        eng.run(max_steps=300)
    eng2, report = chaos.recover_engine(build, eng, journal)
    assert [r.deadline_at for r in report["requests"]] == [10.0]
    clock[0] = 11.0
    eng2.run(max_steps=300)
    assert not journal.in_flight()
    assert report["requests"][0].rejected == "deadline"
    assert eng2.stats["deadline_expired"] == 1
    assert eng2.leak_free()


def test_step_error_recovers_in_place_like_the_reference(setup):
    def kw(ch, Sched):
        return dict(dp=1, b_local=4, max_restarts=2,
                    injector=ch.ServingFailureInjector(
                        [ch.Fault(step=2, phase="post_sync",
                                  kind="error")]))

    def script(eng, Req):
        reqs = _mk_reqs(Req)
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=300)
        assert eng.stats["recoveries"] == 1
        assert all(r.done for r in reqs)
        assert any(r.preemptions >= 1 for r in reqs)
        assert eng.leak_free()
        return [r.out_tokens for r in reqs], [r.preemptions for r in reqs]

    t, j = _both(setup, script, kw)
    assert t == j


def test_step_error_past_budget_raises_conserved(setup):
    injector = chaos.ServingFailureInjector(
        [chaos.Fault(step=2, phase="post_sync", kind="error"),
         chaos.Fault(step=3, phase="post_sync", kind="error")])
    eng = _port(setup, dp=1, b_local=4, injector=injector, max_restarts=1)
    for r in _mk_reqs():
        eng.submit(r)
    with pytest.raises(chaos.StepError):
        eng.run(max_steps=300)
    assert eng.stats["recoveries"] == 2
    _conserved(eng)
    assert eng.leak_free()


def test_lost_shard_evacuates_and_degrades_like_the_reference(setup):
    def kw(ch, Sched):
        return dict(dp=2, b_local=2, injector=ch.ServingFailureInjector(
            [ch.Fault(step=3, phase="post_admission", kind="shard_loss",
                      shard=1)]))

    def script(eng, Req):
        reqs = _mk_reqs(Req, n=6)
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=400)
        assert eng.lost_shards == {1} and eng.stats["shards_lost"] == 1
        assert all(r.done or r.rejected for r in reqs)
        assert any(r.done for r in reqs)
        assert eng.leak_free()
        assert all(s // eng.bl != 1 for s in eng._free_slots)
        return [(r.out_tokens, r.rejected) for r in reqs]

    t, j = _both(setup, script, kw)
    assert t == j


def test_parse_faults_schedule():
    inj = chaos.parse_faults("crash@3:post_sync,shard_loss@5:post_admission:1,"
                             "straggler@2:pre_tick:0.05,poison@1:feed:7,"
                             "crash@9:dispatched:torn,error@4:feed")
    got = [(f.kind, f.step, f.phase, f.shard, f.rid, f.delay, f.torn)
           for f in inj.faults]
    ref = jchaos.parse_faults("crash@3:post_sync,shard_loss@5:post_admission"
                              ":1,straggler@2:pre_tick:0.05,poison@1:feed:7,"
                              "crash@9:dispatched:torn,error@4:feed")
    assert got == [(f.kind, f.step, f.phase, f.shard, f.rid, f.delay, f.torn)
                   for f in ref.faults]
    assert inj.pending() == 6


# ----------------------------------------------------------- warm restart

def _hot_reqs(hot, base=0):
    return [Request(rid=base + i, prompt=hot + [11 + i, 13],
                    max_new_tokens=4, temperature=0.7 if i == 1 else 0.0,
                    seed=5) for i in range(3)]


def test_pins_and_speculation_survive_restart(setup, tmp_path):
    hot = list(range(2, 18))                 # 2 pages of 8

    def fresh():
        return _port(setup, dp=1, b_local=4, speculate=True, draft_len=4,
                     spec_gate=False, sched=SchedConfig(pin_pages=8))

    warmup = fresh()
    for r in _hot_reqs(hot):
        warmup.submit(r)
    warmup.run(max_steps=300)
    assert warmup.pinned_pages() > 0
    ckptr = Checkpointer(str(tmp_path), keep=1)
    warmup.save_warm(ckptr, step=1)
    assert ckptr.restore_aux(1)["pins"] == warmup.pins.to_state()

    cold = fresh()
    cold_reqs = _hot_reqs(hot, base=100)
    for r in cold_reqs:
        cold.submit(r)
    cold.run(max_steps=300)

    warm = fresh()
    assert warm.restore_warm(ckptr) == 1
    assert warm.pinned_pages() == warmup.pinned_pages()
    assert warm.spec_store.to_state() == warmup.spec_store.to_state()
    assert torch.equal(warm.pin_tables, warmup.pin_tables)
    assert_pools_equal(warmup.state.pool, warm.state.pool, "restored")
    warm_reqs = _hot_reqs(hot, base=200)
    for r in warm_reqs:
        warm.submit(r)
    warm.run(max_steps=300)
    assert warm.stats["pin_hit_reqs"] > 0, "restored pins unused"
    assert warm.stats["prompt_tokens"] < cold.stats["prompt_tokens"]
    assert ([r.out_tokens for r in warm_reqs]
            == [r.out_tokens for r in cold_reqs])
    warm.flush_pins()
    _conserved(warm)
    assert warm.leak_free()


def test_shard_writers_mark_a_step_only_when_every_file_landed(
        tmp_path, monkeypatch):
    """Two shard writers share a step directory (the ranks of a DP
    group): each saves its file without a marker and the marker, listing
    both, is written only once both files landed.  When writer 1 dies
    before its ``os.replace``, ``mark_complete`` refuses, ``latest_step``
    still names the earlier complete step, and ``restore`` of the new
    step raises on both writers; a marker that lists shard 0 alone (one
    writer's own save) is no step of shard 1's: ``latest_step`` does not
    name it there and ``restore`` refuses it."""
    from repro_torch.checkpoint import ckpt as tckpt
    writers = [Checkpointer(str(tmp_path), shard_id=k, keep=3)
               for k in range(2)]
    state = {"x": torch.arange(6, dtype=torch.int32)}
    for w in writers:
        w.save(3, state, complete=False)
    writers[0].mark_complete(3, [0, 1])
    assert [w.latest_step() for w in writers] == [3, 3]
    real = tckpt.os.replace

    def dies(src, dst):
        if str(src).endswith(".shard_1.npz.tmp"):
            raise OSError("writer 1 died before its rename")
        return real(src, dst)

    monkeypatch.setattr(tckpt.os, "replace", dies)
    writers[0].save(5, state, complete=False)
    with pytest.raises(OSError):
        writers[1].save(5, state, complete=False)
    monkeypatch.setattr(tckpt.os, "replace", real)
    with pytest.raises(FileNotFoundError, match="shard files \\[1\\]"):
        writers[0].mark_complete(5, [0, 1])
    assert [w.latest_step() for w in writers] == [3, 3]
    for w in writers:
        with pytest.raises(FileNotFoundError):
            w.restore(5, state)
        assert torch.equal(w.restore(3, state)["x"], state["x"])
    writers[0].save(7, state)                # marker lists shard 0 alone
    assert [w.latest_step() for w in writers] == [7, 3]
    assert torch.equal(writers[0].restore(7, state)["x"], state["x"])
    with pytest.raises(FileNotFoundError, match="no file of shard 1"):
        writers[1].restore(7, state)


def test_queued_requests_survive_restart(setup, tmp_path):
    eng = _port(setup, dp=1, b_local=4)
    queued = [Request(rid=i, prompt=[3 + i, 5, 7], max_new_tokens=3,
                      temperature=0.9 * i, top_k=4, seed=i)
              for i in range(2)]
    for r in queued:
        eng.submit(r)                        # never stepped: all queued
    ckptr = Checkpointer(str(tmp_path), keep=1)
    eng.save_warm(ckptr, step=1)
    eng2 = _port(setup, dp=1, b_local=4)
    eng2.restore_warm(ckptr)
    assert eng2.scheduler.backlog() == 2
    assert [(r.temperature, r.top_k, r.seed)
            for r in eng2.scheduler.pending()] == [(0.0, 4, 0), (0.9, 4, 1)]
    eng2.run(max_steps=300)
    assert eng2.stats["tokens_out"] == 6
    assert eng2.leak_free()
