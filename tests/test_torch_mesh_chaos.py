"""Faults, recovery and warm restart on the port's DP ranks.

Two ``gloo`` ranks on the CPU (``tests/_torch_mesh_rank.py``, spawned
processes that import the port alone) serve olmo-1b's smoke config
through ``ServingEngine(mesh=group)`` under fault schedules, while this
process runs the reference's ``ServingEngine(dp=2, mesh=None)`` (and the
port's single-process engine) on the same inputs and schedules, as the
reference's ``tests/test_chaos.py`` runs chaos at dp 2.  Held:

* a host crash at each phase of ``test_torch_chaos.CRASH_CASES`` (torn
  where marked), recovered on both ranks: each rank's reconcile report
  and its shard's integer pool right after recovery exactly the
  reference's for that shard, the streams the reference's, the ranks'
  host state equal, the crashed slots' pages reclaimed exactly
  (``check_recovery_history``);
* a step error recovered in place on both ranks, and a raise past the
  budget with every shard conserved;
* the loss of shard 1: the reference's streams, with rank 1 in every
  gather;
* failures of rank 1 alone, before and after the status gather: both
  ranks recover, or both raise, well within the spawn's limit; journals
  that differ at recovery raise on both ranks;
* warm restarts (pins, speculation, queued requests) with each rank's
  own shard file, and a save whose rank-1 file never lands;
* ``launch.serve.main`` on the ranks with every fault kind: the
  single-process run's lines and streams.

One pair of ranks runs every scenario in turn and is killed, failing
the tests, if it outlasts ``RANK_LIMIT_S``.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import contextlib
import io

import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
import _torch_mesh_rank as rank_mod
from _torch_helpers import engine_setup, pool_leaves
from repro.serving import chaos as jchaos
from repro.serving import engine as jengine
from repro_torch.core.linearizability import check_recovery_history
from repro_torch.core.sim import OpRecord
from repro_torch.launch import serve as tserve
from test_torch_chaos import CRASH_CASES

RANK_LIMIT_S = 300
DP = 2
FAULTS = ("poison@2:feed:5,straggler@4:pre_tick:0.01,crash@8:post_sync,"
          "shard_loss@14:post_admission:1,crash@20:dispatched:torn,"
          "error@26:post_sync")
CHAOS_ARGV = ["--arch", "olmo-1b", "--smoke", "--requests", "12",
              "--max-new", "6", "--dp", "2", "--b-local", "2",
              "--pin-pages", "8", "--hot-prefix", "8", "--deadline-s",
              "900", "--inject-fault", FAULTS, "--device", "cpu"]


def _jreqs(n=6, max_new=6):
    return [jengine.Request(rid=r.rid, prompt=list(r.prompt),
                            max_new_tokens=max_new,
                            temperature=r.temperature, seed=r.seed)
            for r in rank_mod.chaos_requests(n, max_new)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks on every fault scenario, run this process's
    side meanwhile, and hand both over."""
    tmp = tmp_path_factory.mktemp("mesh_chaos")
    olmo = engine_setup("olmo-1b")
    torch.save(olmo[3], tmp / "olmo.pt")
    job = dict(
        dp=DP, init=str(tmp / "pg"), out=str(tmp),
        scenarios=["crash", "error", "shard_loss", "one_rank", "journals",
                   "warm", "serve_chaos"],
        olmo=str(tmp / "olmo.pt"),
        crash_cases=[list(c) for c in CRASH_CASES],
        chaos_argv=CHAOS_ARGV + ["--mesh", "auto", "--dist-backend",
                                 "gloo"])
    ranks, mine = rank_mod.spawn(tmp, job, lambda: _this_side(olmo),
                                 RANK_LIMIT_S)
    return ranks, mine


def _this_side(olmo):
    """The reference at dp 2 under each schedule, and the port's
    single-process ``launch.serve.main`` under the fault schedule."""
    cfg, params, _, _ = olmo

    def engine(**kw):
        return jengine.ServingEngine(cfg, params, dp=DP, b_local=2,
                                     mesh=None, **kw)

    clean = engine()
    reqs = _jreqs()
    for r in reqs:
        clean.submit(r)
    clean.run(max_steps=300)
    out = dict(clean=[r.out_tokens for r in reqs], crash={})
    for phase, torn in CRASH_CASES:
        journal = jchaos.ServingJournal()
        injector = jchaos.ServingFailureInjector(
            [jchaos.Fault(step=3, phase=phase, kind="crash", torn=torn)])

        def build():
            return engine(journal=journal, injector=injector)

        eng = build()
        for r in _jreqs():
            eng.submit(r)
        with pytest.raises(jchaos.HostCrash):
            eng.run(max_steps=300)
        eng2, report = jchaos.recover_engine(build, eng, journal)
        leaves = pool_leaves(eng2.state.pool)
        eng2.run(max_steps=300)
        out["crash"][phase] = dict(
            report={k: v for k, v in report.items() if k != "requests"},
            leaves=leaves, outputs=journal.outputs())
    eng = engine(max_restarts=2, injector=jchaos.ServingFailureInjector(
        [jchaos.Fault(step=2, phase="post_sync", kind="error")]))
    reqs = _jreqs()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=300)
    out["error"] = dict(tokens=[r.out_tokens for r in reqs],
                        preemptions=[r.preemptions for r in reqs])
    eng = engine(injector=jchaos.ServingFailureInjector(
        [jchaos.Fault(step=3, phase="post_admission", kind="shard_loss",
                      shard=1)]))
    reqs = _jreqs()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=400)
    out["shard_loss"] = [(r.out_tokens, r.rejected) for r in reqs]
    out["share"] = [r.out_tokens for r in rank_mod.share_workload(
        engine(), jengine.Request)]
    made, base = [], tserve.Request

    def request(*a, **kw):
        made.append(base(*a, **kw))
        return made[-1]

    tserve.Request = request
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            tserve.main(CHAOS_ARGV)
    finally:
        tserve.Request = base
    out["serve"] = dict(stdout=buf.getvalue(),
                        tokens=[r.out_tokens for r in made])
    return out


def _shard_report(report, d):
    """The part of a dp-2 recovery report that is shard ``d``'s, in the
    form a rank's one-shard report takes; the journal's counts
    (requeued, finished at the crash, pins restored) are every rank's."""
    classes = [{**c, "shards": [c["shards"][d]],
                "reclaimed": len(c["shards"][d]["reclaimed"]),
                "resurrected": c["shards"][d]["resurrected"],
                "clamped": len(c["shards"][d]["clamped"]),
                "never_dry": c["shards"][d]["never_dry"]}
               for c in report["classes"]]
    return {
        "classes": classes,
        "reclaimed": sum(c["reclaimed"] for c in classes),
        "resurrected": sum(c["resurrected"] for c in classes),
        "clamped": sum(c["clamped"] for c in classes),
        "never_dry": all(c["never_dry"] for c in classes),
        "conserved": report["conserved"],
        **{k: report[k] for k in ("requeued", "finished_at_crash",
                                  "pins_restored")}}


def _one_collective_a_step(g):
    """The collectives a run made: one ``all_gather`` a serve step (its
    status gather, the failure flag inside it) and a clock sync (an
    in-place recovery makes one, which tells a failed recovery), one
    ``all_reduce`` a share's agreement, nothing else."""
    steps, syncs, agreements = g["delta"]
    assert steps > 0
    assert sorted(g["colls"]) == sorted(["all_gather"] * (steps + syncs)
                                        + ["all_reduce"] * agreements)


def _recovery_history(held, reclaimed):
    """Each crashed slot's pages granted to it (one ``alloc_n`` a slot),
    the crash of every slot, then the reconcile's reclaimed pages."""
    ops = [OpRecord(opid=i, pid=slot, name="alloc_n", arg=len(pages),
                    invoke_step=i, response_step=i, result=list(pages))
           for i, (slot, pages) in enumerate(sorted(held.items()))]
    n = len(ops)
    ops.append(OpRecord(opid=n, pid=-1, name="crash", arg=sorted(held),
                        invoke_step=n, response_step=n + 1))
    ops.append(OpRecord(opid=n + 1, pid=-1, name="reconcile",
                        arg=list(reclaimed), invoke_step=n + 2,
                        response_step=n + 3))
    return ops


@pytest.mark.parametrize("case", range(len(CRASH_CASES)),
                         ids=[f"{p}{'-torn' if t else ''}"
                              for p, t in CRASH_CASES])
def test_crash_on_ranks_recovers_like_the_reference(run, case):
    """A crash at step 3 of the phase on both ranks, both recovering
    through ``recover_engine``: rank d's reconcile report (reclaimed,
    resurrected, clamped pages, free and live counts, never-dry,
    conserved) and its shard's free stacks, tops, refcounts and lanes
    right after recovery equal the reference's for shard d; the streams
    (greedy and sampled) equal the reference's recovered ones and its
    uninterrupted ones; host state equal on both ranks after recovery
    and at the end; the pages each crashed slot held are reclaimed
    exactly, no leak and no double free; rank 0's journal file (rank 1
    writes none) replays its in-memory journal."""
    ranks, mine = run
    phase, torn = CRASH_CASES[case]
    ref = mine["crash"][phase]
    got = [r["crash"][case] for r in ranks]
    for d, g in enumerate(got):
        assert (g["phase"], g["torn"], g["crashed"]) == (phase, torn, True)
        assert g["report"] == _shard_report(ref["report"], d), d
        assert g["report"]["conserved"] and g["report"]["never_dry"]
        for i, (a, b) in enumerate(zip(ref["leaves"], g["leaves"])):
            assert a.dtype == b.dtype and np.array_equal(a[d:d + 1], b), \
                (d, i)
        assert g["outputs"] == ref["outputs"]
        assert g["finished"] == sorted(ref["outputs"]) == list(range(6))
        assert g["in_flight"] == 0 and g["leak_free"]
        assert all(f + lv == g["pages_local"] for f, lv in g["counts"])
        assert g["stats"][1] == g["stats"][2] == g["stats"][0]
        reclaimed = g["report"]["classes"][0]["shards"][0]["reclaimed"]
        assert g["held"], "no slot held pages at the crash"
        assert check_recovery_history(
            _recovery_history(g["held"], reclaimed)) == []
        leaky = dict(g["held"])
        slot = next(iter(leaky))
        leaky[slot] = leaky[slot] + [10**6]
        assert any("leaked" in e for e in check_recovery_history(
            _recovery_history(leaky, reclaimed)))
    assert {o: t for o, t in got[0]["outputs"].items()} == \
        dict(enumerate(mine["clean"]))
    assert got[0]["jsonl"] is True and got[1]["jsonl"] is None
    assert got[0]["host_after"] == got[1]["host_after"]
    assert got[0]["host_end"] == got[1]["host_end"]


def test_step_error_on_ranks_recovers_in_place(run):
    """``error@2:post_sync`` fires on both ranks: both recover in place
    once, the streams and each request's preemptions equal the
    reference's at dp 2; past a budget of one (errors at steps 2 and 3)
    both ranks raise after recovering twice, every shard conserved and
    empty; one transfer and one collective a step, the recovery none of
    its own (collectives counted at ``torch.distributed``); host state
    equal."""
    ranks, mine = run
    for r in ranks:
        one, past = r["error"]["one"], r["error"]["past"]
        assert one["done"] and one["recoveries"] == 1 and one["leak_free"]
        assert one["tokens"] == mine["error"]["tokens"] == mine["clean"]
        assert one["preemptions"] == mine["error"]["preemptions"]
        assert one["stats"][0] == one["stats"][1] == one["stats"][2]
        _one_collective_a_step(one)
        assert past["raised"] == "StepError" and past["recoveries"] == 2
        assert all(f + lv == past["pages_local"] and lv == 0
                   for f, lv in past["counts"])
        assert past["leak_free"]
    for key in ("one", "past"):
        assert ranks[0]["error"][key]["host"] == \
            ranks[1]["error"][key]["host"]


def test_lost_shard_on_ranks_degrades_like_the_reference(run):
    """Shard 1 lost at step 3 on both ranks: the reference's streams and
    rejections, shard 1's slots out of service, the survivor leak-free;
    rank 1 owns no slot after the loss but joins every status gather
    (one collective a step on both) and keeps the same host state after
    every step."""
    ranks, mine = run
    a, b = (r["shard_loss"] for r in ranks)
    for g in (a, b):
        assert g["streams"] == [tuple(x) for x in mine["shard_loss"]]
        assert g["lost"] == [1] and g["shards_lost"] == 1
        assert g["leak_free"] and all(s // 2 != 1 for s in g["free_slots"])
        assert g["stats"][0] == g["stats"][1] == g["stats"][2] > 3
    assert a["hosts"] == b["hosts"] and len(a["hosts"]) == a["stats"][0]


def test_one_rank_failures_fail_both_ranks_cleanly(run):
    """Failures of rank 1 alone never leave rank 0 waiting: a schedule
    only rank 1 holds with an error at ``dispatched``, rank 1's device
    step raising, or its share step raising in admission, rides the
    step's status gather and both ranks recover in place, serving the
    uninterrupted streams (the reference's) with equal host state and
    one collective a step (the flag rides the status gather); an
    error after the gather (``post_sync``), or after the run's last
    gather (the last step's ``post_step``), makes both ranks raise
    ``RankFailure`` naming rank 1 and the serve step, at the next status
    gather or at the next read of the group.  So does a raise in rank 1's
    recovery alone: in its in-place recovery (its adoption, or midway
    after one requeue), told at the gather that ends every in-place
    recovery, or inside ``recover_engine`` after a crash its adoption or
    its engine's rebuild, told at the group's next gather; each far
    inside the group's timeout."""
    ranks, mine = run
    for case, want in (("before", mine["clean"]), ("device", mine["clean"]),
                       ("admission", mine["share"])):
        a, b = (r["one_rank"][case] for r in ranks)
        for g in (a, b):
            assert g["raised"] is None and g["recoveries"] == 1, case
            assert g["done"] and g["tokens"] == want, case
            assert g["stats"][0] == g["stats"][1] == g["stats"][2]
            _one_collective_a_step(g)
        assert a["host"] == b["host"], case
    assert ranks[1]["one_rank"]["device"]["calls"] >= 3
    assert ranks[1]["one_rank"]["admission"]["calls"] >= 1
    for case, step in (("after", 3), ("last", 2)):
        a, b = (r["one_rank"][case] for r in ranks)
        for g in (a, b):
            assert g["raised"] is not None, case
            kind, msg = g["raised"]
            assert kind == "RankFailure", (case, g["raised"])
            assert msg == (f"rank 1 failed in serve step {step} after its "
                           f"status gather"), (case, msg)
            assert g["recoveries"] == 0
        assert a["stats"] == b["stats"], case
    where = {"recovery": "in its in-place recovery after serve step 3",
             "requeue": "in its in-place recovery after serve step 3",
             "adoption": "in recover_engine's rebuild after serve step 3",
             "rebuild": "in recover_engine's rebuild after serve step 3"}
    for case, told in where.items():
        for g in (r["one_rank"][case] for r in ranks):
            assert g["raised"] == ("RankFailure", f"rank 1 failed {told}"), \
                (case, g["raised"])
            assert g["seconds"] < rank_mod.GROUP_TIMEOUT_S / 3, (case, g)
            if case in ("recovery", "requeue"):
                # told right after the recovery: no rank served on
                assert g["steps"] == 3, (case, g)


def test_recovery_refuses_journals_that_differ(run):
    """Rank 1's journal holds an event rank 0's lacks when the group
    recovers from a crash: ``recover_engine`` raises on both ranks,
    naming the digests, and neither rank builds an engine."""
    ranks, _ = run
    for r in ranks:
        g = r["journals"]
        assert g["raised"] is not None and "journals differ" in g["raised"]
        assert g["built"] == 0


def test_warm_restart_on_ranks(run):
    """``tests/test_chaos.py``'s warm restarts at dp 2, each rank
    through a checkpointer of its own shard: the step directory holds
    both shard files, rank 0's sidecar and one marker; the restored
    pins, speculation store, pin rows and pool equal the saved ones on
    each rank; the warm engine shares the pinned pages (fewer prompt
    tokens than a cold one) and serves the cold engine's streams;
    leak-free after the pins are flushed.  Queued requests come back
    through rank 0's sidecar on both ranks.  A save whose rank-1 shard
    file never lands raises on both ranks, leaves no marker, and
    neither rank restores that step."""
    ranks, _ = run
    for r in ranks:
        g = r["warm"]
        assert g["step"] == 1 and g["aux_pins"] == g["ledger"]
        assert g["files"] == ["INDEX.json", "aux.json", "shard_0.npz",
                              "shard_1.npz"]
        assert g["pins"][0] == g["pins"][1] > 0
        assert g["spec_same"] and g["pin_tables_same"] and g["pool_same"]
        assert g["pin_hits"] > 0
        assert g["prompt_tokens"][0] < g["prompt_tokens"][1]
        assert g["tokens"][0] == g["tokens"][1]
        assert g["leak_free"]
        assert all(f + lv == g["pages_local"] and lv == 0
                   for f, lv in g["counts"])
        q = g["queued"]
        assert q["backlog"] == 2 and q["regs"] == [(0.0, 4, 0), (0.9, 4, 1)]
        assert q["tokens_out"] == 6 and q["leak_free"]
        m = g["missing"]
        assert m["latest"] == 1 and m["restore2"] is not None
    assert ranks[0]["warm"]["missing"]["raised"] == "RuntimeError"
    assert ranks[1]["warm"]["missing"]["raised"] == "OSError"
    assert ranks[0]["warm"]["host"] == ranks[1]["warm"]["host"]


def test_serve_main_with_every_fault_on_ranks(run):
    """``launch.serve.main --mesh auto --dist-backend gloo`` with every
    fault kind (poison, straggler, crash at ``post_sync``, the loss of
    shard 1, a torn crash at ``dispatched``, an error at ``post_sync``):
    rank 0 prints the single-process ``--dp 2`` run's lines (its
    ``served`` line up to the wall-clock figures, and every ``[chaos]``
    line), rank 1 nothing; both ranks serve its streams, fired every
    fault at the same (step, phase) and end in the same host state."""
    ranks, mine = run
    lead, other = (r["serve_chaos"] for r in ranks)
    assert other["stdout"] == ""
    assert lead["tokens"] == other["tokens"] == mine["serve"]["tokens"]
    assert lead["log"] == other["log"] and lead["pending"] == 0
    assert sorted({k for _, _, k in lead["log"]}) == [
        "crash", "error", "poison", "shard_loss", "straggler"]
    assert lead["lost"] == [1] and lead["host"] == other["host"]

    def lines(out):
        keep = []
        for ln in out.splitlines():
            if ln.startswith(("allocation plane", "latency ")):
                continue
            keep.append(ln.split(" (")[0] if ln.startswith("served ")
                        else ln)
        return keep
    got, want = lines(lead["stdout"]), lines(mine["serve"]["stdout"])
    assert got == want
    assert sum(ln.startswith("[chaos]") for ln in got) == 4
    assert lead["stdout"].startswith(f"allocation plane: {DP} ranks over "
                                     f"gloo")
