"""The port's expert-paged MoE serving against the reference's.

Each test of ``tests/test_expert_paging.py`` through both packages'
engines on the mixtral-8x7b smoke config (capacity factor 64, as there),
the reference's seed-0 weights bridged into the port: tokens, every
step's status rows and counter blocks, stats, per-shard telemetry,
pool leaves and expert tables identical to the JAX engine's, and the
port's paged engine token-identical to its resident one.  The refcount
churn trace runs the port's pool beside the JAX pool and the sequential
witness ``repro_torch.core.refpool.RefClassedPool``, op for op.  The step
makes exactly one device-to-host read under slot turnover, and
``launch.serve.main --expert-paging`` matches the reference's ``main``.
The reference's one-collective test needs a device mesh, which the port
does not have.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from _torch_helpers import (TIMING, _engine, assert_engines_equal,
                            assert_pools_equal, engine_setup, run_main)
from repro.core import classed_pool as jpool
from repro_torch.core import refpool
from repro.launch import serve as jserve
from repro.models.moe import moe_apply as j_moe_apply
from repro_torch.bridge import params_from_numpy
from repro_torch.core import classed_pool
from repro_torch.core.classed_pool import ClassSpec
from repro_torch.launch import serve as tserve
from repro_torch.models.moe import moe_apply
from repro_torch.models.transformer import EXPERT_PPE, expert_layer_slots
from repro_torch.serving.telemetry import parse_prom


def _cf64(c):
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=64.0))


@functools.lru_cache(maxsize=None)
def _setup():
    cfg, params, tcfg, tparams = engine_setup("mixtral-8x7b")
    return _cf64(cfg), params, _cf64(tcfg), tparams


FOOTPRINTS = {
    "mixed": lambda rid: [(0, 1), None, (2, 3)][rid % 3],
    "alternating": lambda rid: (0, 1) if rid % 2 == 0 else (2, 3),
}


def _budget():
    return EXPERT_PPE * expert_layer_slots(_setup()[2]) * 2  # one footprint


def _drive(port, fp, expert_paging, budget=None, n_req=6, max_new=5,
           steps=None, recover=False):
    """The reference test's ``_drive`` through one package's engine:
    ``steps`` steps (then an in-place recovery when ``recover``) before
    the run to the end."""
    eng, Req = _engine(_setup(), port, dp=1, b_local=2, max_len=64,
                       prefix_sharing=False, mesh=None,
                       expert_paging=expert_paging, expert_budget=budget)
    rng = np.random.RandomState(0)
    reqs = []
    for rid in range(n_req):
        prompt = [int(t) for t in rng.randint(1, _setup()[0].vocab - 1, 6)]
        reqs.append(Req(rid, prompt=prompt, max_new_tokens=max_new,
                        experts=FOOTPRINTS[fp](rid)))
        eng.submit(reqs[-1])
    report = None
    if steps:
        for _ in range(steps):
            eng.step()
        loads = eng.stats["expert_load_pages"]
        report = (loads, eng._recover_inplace() if recover else None)
    eng.run(max_steps=500)
    return eng, reqs, report


@functools.lru_cache(maxsize=None)
def _pair(fp, expert_paging, budget=None, steps=None, recover=False):
    """(reference run, port run) of one workload, cached across tests."""
    return tuple(_drive(port, fp, expert_paging, budget, steps=steps,
                        recover=recover) for port in (False, True))


def _same_engines(j, t, flush=True):
    """The port's engine state equal to the reference's: the
    engine-parity checks, pool leaves and expert tables, then again
    after ``flush_experts`` on both, leak-free."""
    (je, jr, _), (te, tr, _) = j, t
    assert_engines_equal(je, jr, te, tr, drained=False)
    assert te.scheduler.stats == je.scheduler.stats

    def same_state(what):
        assert_pools_equal(je.state.pool, te.state.pool, what)
        assert (je.state.expert_tables is None) == (
            te.state.expert_tables is None)
        for pos, tab in (je.state.expert_tables or {}).items():
            assert np.array_equal(np.asarray(tab),
                                  te.state.expert_tables[pos].numpy()), what

    same_state("drained")
    if flush:
        assert te.flush_experts() == je.flush_experts()
        same_state("flushed")
        assert te.leak_free() and je.leak_free()


def _meter(eng, key):
    return int(eng.telemetry.shard[key].sum())


def test_paged_vs_resident_token_identity():
    res, paged = _pair("mixed", False), _pair("mixed", True)
    for j, t in (res, paged):
        _same_engines(j, t)
    (te0, tr0, _), (te1, tr1, _) = res[1], paged[1]
    assert all(r.done for r in tr0 + tr1)
    assert [r.out_tokens for r in tr0] == [r.out_tokens for r in tr1]
    for eng in (te0, te1):
        assert _meter(eng, "moe_dropped_tokens") == 0
    assert _meter(te1, "expert_miss_pages_c2") == 0
    assert _meter(te1, "expert_hit_pages_c2") > 0
    assert _meter(te1, "expert_prefetch_pages_c2") > 0
    assert te1.telemetry.expert_hit_rate() is not None
    assert te1.telemetry.never_dry_margin_min() >= 0
    assert te1.n_classes == 3 and te0.n_classes == 1


def test_tight_budget_eviction_churn_identity():
    budget = _budget()
    res = _pair("alternating", False)
    paged = _pair("alternating", True, budget)
    _same_engines(*paged)
    te, tr, _ = paged[1]
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in res[1][1]]
    assert te.stats["expert_evictions"] > 0
    assert te.stats["expert_pages_resident_peak"] <= budget
    assert te.scheduler.stats["defer_experts"] > 0
    assert _meter(te, "expert_miss_pages_c2") == 0
    assert _meter(te, "moe_dropped_tokens") == 0
    assert te.telemetry.never_dry_margin_min() >= 0


def test_unservable_footprint_rejected_too_large():
    runs = []
    for port in (False, True):
        eng, Req = _engine(_setup(), port, dp=1, b_local=2, max_len=64,
                           prefix_sharing=False, mesh=None,
                           expert_paging=True, expert_budget=_budget())
        big = Req(0, prompt=[3, 4, 5], max_new_tokens=3, experts=None)
        adm = eng.submit(big)
        assert not adm.accepted and adm.reason == "too_large"
        assert big.rejected == "too_large"
        ok = Req(1, prompt=[3, 4, 5], max_new_tokens=3, experts=(1, 2))
        assert eng.submit(ok).accepted
        eng.run(max_steps=200)
        assert ok.done
        runs.append((eng, [ok], None))
    _same_engines(*runs)
    assert runs[1][0].scheduler.stats["rejected"] == 1


DP = 2
ESPEC = ClassSpec(page_size=64, num_blocks=30, num_lanes=2, ell=2)
SPECS = (ClassSpec(page_size=8, num_blocks=24, num_lanes=2, ell=2), ESPEC)
ECLS = 1        # the expert-like read-only class in this mini vector


def test_expert_refcount_churn_vs_witness():
    """The reference's randomized residency trace (bulk shared-stack
    loads, addref per admission, free_shared per release and eviction,
    eviction storms) on the port's pool, the JAX pool and the witness
    in lockstep: identical grants and leaves after every op,
    conservation, final conformance, and a never-dry rebalance."""
    rng = random.Random(11)
    pool = classed_pool.create_dp(DP, SPECS, device="cpu")
    jp = jpool.create_dp(DP, [jpool.ClassSpec(*s) for s in SPECS])
    refs = refpool.create_classed_dp(DP, SPECS)
    ledger = [dict() for _ in range(DP)]     # expert -> (pages, batch)
    next_eid = 0

    def free_shared(d, pages):
        nonlocal pool, jp
        rows = np.full((DP, EXPERT_PPE), -1, np.int32)
        rows[d] = pages
        pool = classed_pool.free_shared_dp(pool, ECLS,
                                           torch.from_numpy(rows))
        jp = jpool.free_shared_dp(jp, ECLS, jnp.asarray(rows))
        for s in range(DP):
            refs[s].free_shared(ECLS, [int(x) for x in rows[s]])

    for step in range(250):
        op = rng.choice(["load", "admit", "admit", "release", "release",
                         "evict", "evict_storm"])
        d = rng.randrange(DP)
        if op == "load":
            if (sum(len(e[0]) for e in ledger[d].values()) + EXPERT_PPE
                    > ESPEC.num_blocks - 3 * ESPEC.ell * ESPEC.num_lanes):
                continue        # admission respects the budget
            counts = np.zeros((DP, ESPEC.num_lanes), np.int32)
            counts[d, 0] = EXPERT_PPE
            pool, ids = classed_pool.alloc_from_shared_dp(
                pool, ECLS, torch.from_numpy(counts), EXPERT_PPE)
            jp, jids = jpool.alloc_from_shared_dp(
                jp, ECLS, jnp.asarray(counts), EXPERT_PPE)
            got = ids.numpy()
            assert np.array_equal(got, np.asarray(jids)), step
            for s in range(DP):
                flat = [b for row in refs[s].alloc_from_shared(
                    ECLS, counts[s], EXPERT_PPE) for b in row]
                assert [int(x) for x in got[s].reshape(-1) if x >= 0] == \
                    flat, f"shard {s}: load grant diverged"
            pages = [int(x) for x in got[d, 0] if x >= 0]
            assert len(pages) == EXPERT_PPE
            ledger[d][next_eid] = (pages, 0)
            next_eid += 1
        elif op == "admit" and ledger[d]:
            eid = rng.choice(list(ledger[d]))
            pages, b = ledger[d][eid]
            rows = np.full((DP, EXPERT_PPE), -1, np.int32)
            rows[d] = pages
            pool = classed_pool.addref_dp(pool, ECLS, torch.from_numpy(rows))
            jp = jpool.addref_dp(jp, ECLS, jnp.asarray(rows))
            for s in range(DP):
                refs[s].addref(ECLS, [int(x) for x in rows[s]])
            ledger[d][eid] = (pages, b + 1)
        elif op == "release":
            hot = [e for e, (_, b) in ledger[d].items() if b > 0]
            if not hot:
                continue
            eid = rng.choice(hot)
            pages, b = ledger[d][eid]
            free_shared(d, pages)
            ledger[d][eid] = (pages, b - 1)
        elif op in ("evict", "evict_storm"):
            cold = [e for e, (_, b) in ledger[d].items() if b == 0]
            if not cold:
                continue
            for eid in (cold if op == "evict_storm" else [rng.choice(cold)]):
                free_shared(d, ledger[d].pop(eid)[0])
        assert_pools_equal(jp, pool, f"op {step} {op}")
        for c, spec in enumerate(SPECS):
            free = classed_pool.free_per_shard(pool, c)
            live = classed_pool.live_per_shard(pool, c)
            assert all(int(free[s] + live[s]) == spec.num_blocks
                       for s in range(DP))

    for d in range(DP):
        msg = refpool.conforms_classed(refs[d], pool, d)
        assert msg is None, f"shard {d}: {msg}"
    pool = classed_pool.rebalance_dp(pool)
    for c in range(len(SPECS)):
        margin = int(pool.classes[c].private_top.min()) - SPECS[c].ell
        assert margin >= 0, f"class {c} ran a lane dry"


def test_moe_apply_meters_dropped_tokens():
    """The reference's drop-meter test on both packages' ``moe_apply``:
    0 drops at the serving capacity factor, > 0 at 0.25, every valid
    assignment kept or metered, the meters equal."""
    cfg, _, tcfg, _ = _setup()
    d, E, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    x = np.random.RandomState(3).randn(16, 1, d).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ffn = {
        "router": jax.random.normal(key, (d, E)) * 0.1,
        "w_gate": jax.random.normal(key, (E, d, cfg.d_ff)) * 0.05,
        "w_up": jax.random.normal(key, (E, d, cfg.d_ff)) * 0.05,
        "w_down": jax.random.normal(key, (E, cfg.d_ff, d)) * 0.05,
    }
    tffn = params_from_numpy(jax.tree.map(np.asarray, ffn), "cpu")
    for cf, drops in ((64.0, False), (0.25, True)):
        jc = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        tc = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
        _, jd, jr = j_moe_apply(jc, ffn, jnp.asarray(x), metered=True)
        _, dropped, routed = moe_apply(tc, tffn, torch.from_numpy(x),
                                       metered=True)
        assert np.array_equal(dropped.numpy(), np.asarray(jd))
        assert np.array_equal(routed.numpy(), np.asarray(jr))
        assert (int(dropped.sum()) > 0) == drops
        assert int(routed.sum()) + int(dropped.sum()) == 16 * k


def test_expert_counters_in_snapshot_and_prom():
    budget = _budget()
    (je, _, _), (te, treqs, _) = _pair("alternating", True, budget)
    assert all(r.done for r in treqs)
    snap, jsnap = te.telemetry.snapshot(), je.telemetry.snapshot()
    assert snap["expert_hit_rate"] == jsnap["expert_hit_rate"] is not None
    assert snap["counters"]["expert_load_pages"] > 0
    assert snap["counters"]["expert_pages_resident_peak"] == budget
    assert sum(snap["per_shard"]["expert_hit_pages_c2"]) > 0
    assert sum(snap["per_shard"]["expert_miss_pages_c2"]) == 0
    prom = parse_prom(te.telemetry.render_prom())
    jprom = parse_prom(je.telemetry.render_prom())
    timing = {f"repro_{k}" for k in TIMING}
    assert ({k: v for k, v in prom.items() if k not in timing}
            == {k: v for k, v in jprom.items() if k not in timing})
    assert prom["repro_expert_hit_rate"][()] >= 0
    assert prom["repro_expert_load_pages"][()] > 0
    assert sum(prom["repro_expert_hit_pages_c2"].values()) > 0
    assert prom["repro_moe_dropped_tokens"][(("shard", "0"),)] == 0


READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
         "__index__")


def test_one_transfer_per_step_expert_paged(monkeypatch):
    """Expert paging adds no device-to-host read to the serve loop:
    under a one-footprint budget, slots turn over inside the watched
    window, so release (bulk free_shared), admission (addref), eviction
    and reload all run, and every served step reads exactly one tensor
    to the host, the packed status."""
    cfg, _, tcfg, tparams = _setup()
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(tcfg, tparams, dp=1, b_local=2, max_len=64,
                        prefix_sharing=False, expert_paging=True,
                        expert_budget=_budget(), device="cpu")
    rng = np.random.RandomState(5)
    for rid in range(4):
        eng.submit(Request(rid, prompt=[int(t) for t in
                                        rng.randint(1, 255, 6)],
                           max_new_tokens=2,
                           experts=(0, 1) if rid % 2 else (2, 3)))
    eng.step()                       # admission and the first loads
    reads = []
    for name in READS:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            reads.append((_name, tuple(self.shape)))
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    loads0, steps0 = eng.stats["expert_load_pages"], eng.stats["steps"]
    transfers0 = eng.host_transfers
    for _ in range(5):               # may drain early: idle steps read
        eng.step()                   # nothing
    monkeypatch.undo()
    served = eng.stats["steps"] - steps0
    assert served >= 3, "window too short to cover slot turnover"
    assert len(reads) == served == eng.host_transfers - transfers0, reads
    assert {name for name, _ in reads} == {"numpy"}
    assert eng.stats["expert_load_pages"] > loads0, (
        "the watched window never exercised the expert load path")
    assert eng.stats["expert_evictions"] > 0


def test_recover_inplace_reloads_experts():
    """In-place recovery after 3 steps reclaims every CLS_EXPERT page
    (tables NULL, ledger empty, mask reset) with the reference's
    reconcile report; the requeued requests load again and drain to the
    unrecovered streams, as in the reference engine."""
    res = _pair("alternating", False)
    runs = _pair("alternating", True, steps=3, recover=True)
    (je, _, (jloads, jrep)), (te, tr, (tloads, trep)) = runs
    assert tloads == jloads > 0
    assert {k: v for k, v in trep.items() if k != "classes"} == \
        {k: v for k, v in jrep.items() if k != "classes"}
    assert trep["classes"][2]["reclaimed"] > 0
    _same_engines(*runs)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in res[1][1]]
    assert te.stats["expert_load_pages"] > tloads
    assert te.stats["recoveries"] == 1


def test_recovery_clears_the_expert_plane():
    _, _, tcfg, tparams = _setup()
    from repro_torch.serving.engine import Request, ServingEngine
    eng = ServingEngine(tcfg, tparams, dp=1, b_local=2, max_len=64,
                        prefix_sharing=False, expert_paging=True,
                        device="cpu")
    for rid in range(3):
        eng.submit(Request(rid, prompt=[5, 6, 7], max_new_tokens=4,
                           experts=(rid, rid + 1)))
    eng.step()
    assert eng.expert_ledger.resident_count() > 0
    # two slots: footprints (0, 1) and (1, 2), 3 experts x 2 MoE layers
    assert eng.expert_pages_resident(0) == EXPERT_PPE * 3 * 2 == \
        int(classed_pool.live_per_shard(eng.state.pool, 2).sum())
    assert not bool(eng.expert_mask.all())
    eng._recover_inplace()
    assert eng.expert_ledger.resident_count() == 0
    assert eng.expert_pages_resident(0) == 0
    assert all(int(t.max()) < 0 for t in eng.state.expert_tables.values())
    assert bool(eng.expert_mask.all()) and not eng._slot_experts
    assert classed_pool.live_per_shard(eng.state.pool, 2).sum() == 0


@pytest.mark.parametrize("budget", ["12", "0"])
def test_serve_main_expert_paging_matches_reference(monkeypatch, capsys,
                                                    budget):
    """``main --expert-paging`` (half of full residency, and full) at the
    smoke config: the same tokens, rejections, stats, scheduler stats,
    step records and printed expert line; every request done but, at
    half residency, the unrestricted ones (``too_large``); 0 misses,
    leak-free after ``flush_experts``."""
    argv = ["--arch", "mixtral-8x7b", "--smoke", "--dp", "1", "--b-local",
            "2", "--requests", "8", "--max-new", "4", "--expert-paging",
            "--expert-budget", budget, "--expert-frac", "0.5"]

    def expert_line():
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("expert paging:")]

    je, jreqs = run_main(jserve, argv, monkeypatch)
    jline = expert_line()
    te, treqs = run_main(tserve, argv + ["--device", "cpu"], monkeypatch,
                      jax.tree.map(np.asarray, _setup()[1]))
    tline = expert_line()
    assert tline == jline and len(tline) == 1
    assert len(treqs) == len(jreqs) == 8
    # at half residency an unrestricted footprint cannot fit: too_large
    assert [r.rejected for r in treqs] == [r.rejected for r in jreqs]
    assert all(r.done or (r.rejected == "too_large" and budget == "12"
                          and r.experts is None) for r in treqs)
    assert sum(r.done for r in treqs) >= 4
    assert [r.experts for r in treqs] == [r.experts for r in jreqs]
    assert any(r.experts is not None for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    assert te.scheduler.stats == je.scheduler.stats
    keys = ("T", "spec", "status", "ctr", "rids")
    assert [[r[k] for k in keys] for r in te.flight.ring] == \
        [[r[k] for k in keys] for r in je.flight.ring]
    assert te.host_transfers == te.stats["steps"]
    assert te.expert_budget == (12 if budget == "12" else 24)
    assert _meter(te, "expert_miss_pages_c2") == 0
    assert te.leak_free() and te.expert_ledger.resident_count() == 0

