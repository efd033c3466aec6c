"""One rank of the port's DP serving plane, for ``tests/test_torch_mesh.py``
and ``tests/test_torch_mesh_chaos.py``.

    RANK=r WORLD_SIZE=n PYTHONPATH=src python tests/_torch_mesh_rank.py JOB

``JOB`` is a JSON file: the process group's ``init`` file, the ``out``
directory, the ``scenarios`` to run in order and their inputs (prompts,
the bridged weights saved with ``torch.save``).  The rank joins a
``gloo`` group through the file (no network port), runs each scenario
through ``ServingEngine(mesh=group)`` on the CPU, and saves what the
tests compare to ``out/rank<r>.pt``.  Run as a script it imports the
port alone: the JAX package is blocked before anything is imported.
The tests import the module too, to start the ranks (:func:`spawn`)
and to drive the same scenarios through the port's single-process
engine (``group=None``).
"""

import sys

if __name__ == "__main__":
    for _name in ("jax", "jaxlib", "repro"):
        sys.modules[_name] = None       # any import of these now fails

import contextlib
import io
import itertools
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import classed_pool  # noqa: E402
from repro_torch.core.classed_pool import CLS_EXPERT, CLS_KV  # noqa: E402
from repro_torch.launch.mesh import make_dp_group  # noqa: E402
from repro_torch.launch.steps import gather_state  # noqa: E402
from repro_torch.serving import chaos  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.sched import SchedConfig  # noqa: E402
from repro_torch.serving.telemetry import FlightRecorder  # noqa: E402

#: the gloo group's timeout: a rank left waiting raises after it
GROUP_TIMEOUT_S = 90
#: Tensor methods that read a tensor's values on the host
READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
         "__index__")


@contextlib.contextmanager
def counting_collectives():
    """Yield a list that gathers the name of every collective call
    (``all_gather``, ``all_reduce``, ``broadcast``, ``all_to_all``)
    made inside the block."""
    colls = []
    real = {n: getattr(dist, n) for n in ("all_gather", "all_reduce",
                                          "broadcast", "all_to_all")}
    for n, fn in real.items():
        def coll(*a, _fn=fn, _n=n, **kw):
            colls.append(_n)
            return _fn(*a, **kw)
        setattr(dist, n, coll)
    try:
        yield colls
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def _engine(cfg, params, group, clock=None, **kw):
    if clock is None:
        count = itertools.count()
        clock = lambda: float(next(count))  # noqa: E731
    return tengine.ServingEngine(
        cfg, params, flight=FlightRecorder(capacity=4096), mesh=group,
        clock=clock, device="cpu", **kw)


def pool_leaves(pool):
    return [np.asarray(x) for hp in pool.classes
            for x in (hp.shared.free_ids, hp.shared.top, hp.shared.refcount,
                      hp.private_ids, hp.private_top)]


def int_state(state):
    """The integer leaves of a (shard of a) serving state."""
    out = {"page_tables": state.page_tables.numpy(),
           "seq_lens": state.seq_lens.numpy(),
           "pool": pool_leaves(state.pool)}
    if state.expert_tables is not None:
        out["expert_tables"] = {p: t.numpy()
                                for p, t in state.expert_tables.items()}
    return out


def requests(job, key="prompts", max_new=4, **kw):
    return [tengine.Request(i, prompt=list(p), max_new_tokens=max_new, **kw)
            for i, p in enumerate(job[key])]


def olmo(job):
    return (smoke_config(get_config("olmo-1b")),
            torch.load(job["olmo"], weights_only=False))


def scenario_greedy(group, job):
    """(b): greedy olmo-1b smoke at dp 2, every request at once."""
    cfg, params = olmo(job)
    eng = _engine(cfg, params, group, dp=2, b_local=2, max_len=64,
                  prefix_sharing=False, speculate=False, spec_gate=False)
    reqs = requests(job)
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=500)
    whole = eng.state if group is None else gather_state(eng.state, group)
    return dict(
        tokens=[r.out_tokens for r in reqs], done=[r.done for r in reqs],
        flight=[{k: rec[k] for k in ("T", "spec", "drafts", "status", "ctr",
                                     "rids")} for rec in eng.flight.ring],
        local=int_state(eng.state), whole=int_state(whole),
        whole_kv={p: [t.numpy() for t in kv]
                  for p, kv in whole.kv_pages.items()},
        local_kv={p: [t.numpy() for t in kv]
                  for p, kv in eng.state.kv_pages.items()},
        steps=eng.stats["steps"], transfers=eng.host_transfers,
        collectives=eng.collectives, leak_free=eng.leak_free(),
        pages_in_use=eng.pages_in_use(), host=eng.host_state(),
        occupancy=eng.shard_occupancy())


def scenario_idle_gap(group, job):
    """A request served, then the clock moved on by more than the next
    request's ``deadline_s`` while the engine idles, then that request
    submitted.  Each rank's own clock reads differently (rank r's runs
    1000 r ahead), so only an agreed value can match on both."""
    cfg, params = olmo(job)
    now = [0.0]
    ahead = 1000.0 * (0 if group is None else group.rank)
    eng = _engine(cfg, params, group, clock=lambda: now[0] + ahead, dp=2,
                  b_local=2, max_len=64, prefix_sharing=False,
                  speculate=False, spec_gate=False)
    first, late = requests(job, max_new=3, deadline_s=5.0)[:2]
    eng.submit(first)
    eng.run(max_steps=100)
    now[0] = 100.0
    for _ in range(3):
        eng.step()                          # idle: nothing owed
    eng.submit(late)
    stamped = (late.submitted_at, late.deadline_at)
    eng.run(max_steps=100)
    return dict(stamped=stamped, done=[first.done, late.done],
                rejected=[first.rejected, late.rejected],
                tokens=[first.out_tokens, late.out_tokens],
                steps=eng.stats["steps"], collectives=eng.collectives,
                syncs=eng.clock_syncs, host=eng.host_state())


def scenario_storm(group, job):
    """(c): a seeded storm of standard and interactive requests with
    prefix sharing, speculation (gated on the agreed step cost), pins
    and preemption; the shard's invariants after every step."""
    cfg, params = olmo(job)
    eng = _engine(cfg, params, group, dp=2, b_local=2, max_len=64,
                  prefix_sharing=True, speculate=True, draft_len=3,
                  spec_gate=True, sched=SchedConfig(**job["storm_sched"]))
    reqs = {}
    hosts, bad = [], []
    kv = eng.state.pool.classes[CLS_KV]
    ell = classed_pool.lane_ell(eng.state.pool, CLS_KV)
    for op in job["storm"]:
        if op[0] == "submit":
            _, rid, prompt, max_new, slo = op
            reqs[rid] = tengine.Request(rid, prompt=list(prompt),
                                        max_new_tokens=max_new, slo=slo)
            eng.submit(reqs[rid])
            continue
        for _ in range(op[1]):
            if eng.idle():
                break
            eng.step()
            kv = eng.state.pool.classes[CLS_KV]
            free = int(classed_pool.free_per_shard(eng.state.pool,
                                                   CLS_KV)[0])
            live = int(classed_pool.live_per_shard(eng.state.pool,
                                                   CLS_KV)[0])
            low = int(kv.private_top.min())
            if free + live != eng.pages_local or low < ell:
                bad.append((eng.stats["steps"], free, live, low))
            hosts.append(eng.host_state())
    eng.run(max_steps=500)
    hosts.append(eng.host_state())
    pins = eng.flush_pins()
    return dict(tokens={rid: r.out_tokens for rid, r in reqs.items()},
                done=all(r.done for r in reqs.values()), hosts=hosts,
                bad=bad, pins=pins, leak_free=eng.leak_free(),
                preemptions=eng.stats["preemptions"],
                shares=eng.stats["prefix_shared_reqs"],
                pin_hits=eng.stats["pin_hit_reqs"],
                drafted=eng.stats["spec_drafted"],
                gate_costs=len(eng._step_cost))


def scenario_counts(group, job):
    """(d): the device-to-host reads and the collectives of the served
    steps, with shares inside the watched window."""
    cfg, params = olmo(job)
    eng = _engine(cfg, params, group, dp=2, b_local=2, max_len=64,
                  prefix_sharing=True, speculate=False, spec_gate=False)
    hot = job["prompts"][0][:16]
    first = [tengine.Request(i, prompt=hot + [7 + i], max_new_tokens=6)
             for i in range(2)]
    later = [tengine.Request(10 + i, prompt=hot + [30 + i],
                             max_new_tokens=3) for i in range(4)]
    for r in first:
        eng.submit(r)
    for _ in range(3):                     # the donors' prompts resident
        eng.step()
    for r in later:
        eng.submit(r)
    reads = []
    saved = {n: getattr(torch.Tensor, n) for n in READS}
    for n, fn in saved.items():
        def counted(self, *a, _fn=fn, _n=n, **kw):
            reads.append(_n)
            return _fn(self, *a, **kw)
        setattr(torch.Tensor, n, counted)
    n0 = (eng.stats["steps"], eng.host_transfers, eng.collectives,
          eng.agreements, eng.admission_transfers)
    try:
        with counting_collectives() as colls:
            for _ in range(6):
                eng.step()
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
    n1 = (eng.stats["steps"], eng.host_transfers, eng.collectives,
          eng.agreements, eng.admission_transfers)
    eng.run(max_steps=500)
    eng.flush_pins()
    return dict(reads=reads, colls=colls,
                delta=[b - a for a, b in zip(n0, n1)],
                shared=eng.stats["prefix_shared_reqs"],
                leak_free=eng.leak_free(),
                tokens=[r.out_tokens for r in first + later])


def _moe_run(eng, reqs, schedule=None, budget=None):
    """Serve ``reqs``; without ``schedule`` all at once, recording the
    admissions as (steps before the admitting tick, rid); with it each
    request submitted just before the tick that admitted it there."""
    admitted, admit = [], eng.admit

    def record(req, match, shard):
        admitted.append((eng.stats["steps"], req.rid))
        return admit(req, match, shard)

    eng.admit = record
    by_rid = {r.rid: r for r in reqs}
    pending = list(schedule or [])
    if schedule is None:
        for r in reqs:
            eng.submit(r)
    over = []
    while True:
        while pending and pending[0][0] == eng.stats["steps"]:
            eng.submit(by_rid[pending.pop(0)[1]])
        if eng.idle() and not pending:
            break
        eng.step()
        if budget is not None:
            live = int(classed_pool.live_per_shard(eng.state.pool,
                                                   CLS_EXPERT)[0])
            if live > budget:
                over.append((eng.stats["steps"], live))
    eng.admit = admit
    return dict(tokens=[r.out_tokens for r in reqs],
                done=all(r.done for r in reqs), admitted=admitted,
                over=over)


def scenario_experts(group, job):
    """(e): expert-paged mixtral-8x7b smoke at dp 2 under a one-footprint
    budget a shard, then the resident engine on the paged run's
    batches."""
    import dataclasses
    cfg = smoke_config(get_config("mixtral-8x7b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0))
    params = torch.load(job["mixtral"], weights_only=False)
    budget = job["expert_budget"]

    def reqs():
        return [tengine.Request(i, prompt=list(p), max_new_tokens=5,
                                experts=((0, 1), (2, 3), (1, 2))[i % 3])
                for i, p in enumerate(job["moe_prompts"])]

    paged = _engine(cfg, params, group, dp=2, b_local=2, max_len=64,
                    prefix_sharing=False, expert_paging=True,
                    expert_budget=budget)
    p = _moe_run(paged, reqs(), budget=budget)
    stats = {k: paged.stats[k] for k in (
        "expert_load_pages", "expert_evictions",
        "expert_pages_resident_peak", "steps")}
    dropped = paged.telemetry.shard["moe_dropped_tokens"].tolist()
    host = paged.host_state()
    flushed = paged.flush_experts()
    leak = paged.leak_free()
    resident = _engine(cfg, params, group, dp=2, b_local=2, max_len=64,
                       prefix_sharing=False)
    r = _moe_run(resident, reqs(), schedule=p["admitted"])
    return dict(paged=p, resident=r, stats=stats, dropped=dropped,
                host=host, flushed=flushed, leak_free=leak,
                transfers=paged.host_transfers,
                collectives=paged.collectives)


def scenario_serve(group, job):
    """(f): ``launch.serve.main`` on the ranks, its requests kept."""
    eng, made, out = _serve_main(job["serve_argv"])
    return dict(stdout=out, tokens=[r.out_tokens for r in made],
                done=all(r.done for r in made), rank=eng.mesh.rank,
                steps=eng.stats["steps"], collectives=eng.collectives)


# ------------------------------------------------ faults on the ranks

def chaos_requests(n=6, max_new=6):
    """Greedy and sampled lanes in one batch: rids 0, 2, 4 greedy; 1, 3,
    5 sampled (``tests/test_chaos.py::_mk_reqs``)."""
    return [tengine.Request(rid=i, prompt=[2 + i, 3, 5, 7 + i],
                            max_new_tokens=max_new,
                            temperature=0.8 if i % 2 else 0.0, seed=100 + i)
            for i in range(n)]


def _coll_counters(eng):
    """(serve steps, clock syncs, agreements): what a run's collectives
    should number, a status gather a step, a gather a clock sync, an
    all-reduce an agreement."""
    return eng.stats["steps"], eng.clock_syncs, eng.agreements


def _rank(group):
    return 0 if group is None else group.rank


def _held_pages(eng):
    """{slot: its pages} of the slots whose rows this process holds."""
    pt = eng.state.page_tables.cpu().numpy()
    first = _rank(eng.mesh)
    return {(first + r) * eng.bl + b: [int(p) for p in pt[r, b] if p >= 0]
            for r in range(pt.shape[0]) for b in range(eng.bl)
            if (pt[r, b] >= 0).any()}


def _shard_counts(eng):
    """(free, live) KV blocks of each shard this process holds."""
    pool = eng.state.pool
    return list(zip(classed_pool.free_per_shard(pool, CLS_KV).tolist(),
                    classed_pool.live_per_shard(pool, CLS_KV).tolist()))


def scenario_crash(group, job):
    """A host crash at step 3 of each phase of ``job["crash_cases"]``
    (torn where marked) at dp 2, recovered through ``recover_engine``:
    the report, the pool right after recovery, the pages the crashed
    slots held, the host state after recovery and at the end, and the
    streams.  Rank 0's journal (alone) also goes to a JSONL file."""
    cfg, params = olmo(job)
    out = []
    for phase, torn in job["crash_cases"]:
        path = (os.path.join(job["out"], f"journal_{phase}.jsonl")
                if _rank(group) == 0 else None)
        journal = chaos.ServingJournal(path=path)
        injector = chaos.ServingFailureInjector(
            [chaos.Fault(step=3, phase=phase, kind="crash", torn=torn)])

        def build():
            return _engine(cfg, params, group, dp=2, b_local=2,
                           journal=journal, injector=injector)

        eng = build()
        for r in chaos_requests():
            eng.submit(r)
        try:
            eng.run(max_steps=300)
            crashed = False
        except chaos.HostCrash:
            crashed = True
        held = _held_pages(eng)
        eng2, report = chaos.recover_engine(build, eng, journal)
        leaves = pool_leaves(eng2.state.pool)
        host_after = eng2.host_state()
        eng2.run(max_steps=300)
        journal.close()
        out.append(dict(
            jsonl=(None if path is None else
                   chaos.ServingJournal.load(path).events == journal.events),
            phase=phase, torn=torn, crashed=crashed, held=held,
            report={k: v for k, v in report.items() if k != "requests"},
            leaves=leaves, host_after=host_after,
            host_end=eng2.host_state(), outputs=journal.outputs(),
            finished=sorted(journal.finished()),
            in_flight=len(journal.in_flight()), leak_free=eng2.leak_free(),
            counts=_shard_counts(eng2), pages_local=eng2.pages_local,
            stats=(eng2.stats["steps"], eng2.host_transfers,
                   eng2.collectives)))
    return out


def scenario_error(group, job):
    """A step error at step 2's ``post_sync`` recovered in place, then
    errors at steps 2 and 3 past a budget of one: the second run
    raises, every shard conserved."""
    cfg, params = olmo(job)
    eng = _engine(cfg, params, group, dp=2, b_local=2, max_restarts=2,
                  injector=chaos.ServingFailureInjector(
                      [chaos.Fault(step=2, phase="post_sync",
                                   kind="error")]))
    reqs = chaos_requests()
    for r in reqs:
        eng.submit(r)
    with counting_collectives() as colls:
        n0 = _coll_counters(eng)
        eng.run(max_steps=300)
        n1 = _coll_counters(eng)
    one = dict(colls=colls, delta=[b - a for a, b in zip(n0, n1)],
               tokens=[r.out_tokens for r in reqs],
               preemptions=[r.preemptions for r in reqs],
               done=all(r.done for r in reqs),
               recoveries=eng.stats["recoveries"], host=eng.host_state(),
               leak_free=eng.leak_free(),
               stats=(eng.stats["steps"], eng.host_transfers,
                      eng.collectives))
    eng = _engine(cfg, params, group, dp=2, b_local=2, max_restarts=1,
                  injector=chaos.ServingFailureInjector(
                      [chaos.Fault(step=s, phase="post_sync", kind="error")
                       for s in (2, 3)]))
    for r in chaos_requests():
        eng.submit(r)
    raised = None
    try:
        eng.run(max_steps=300)
    except chaos.StepError as e:
        raised = type(e).__name__
    past = dict(raised=raised, recoveries=eng.stats["recoveries"],
                counts=_shard_counts(eng), pages_local=eng.pages_local,
                leak_free=eng.leak_free(), host=eng.host_state())
    return dict(one=one, past=past)


def scenario_shard_loss(group, job):
    """``tests/test_chaos.py::test_lost_shard_evacuates_and_degrades``:
    shard 1 lost at step 3's ``post_admission``; its rank stays in every
    gather, owning no slot."""
    cfg, params = olmo(job)
    eng = _engine(cfg, params, group, dp=2, b_local=2,
                  injector=chaos.ServingFailureInjector(
                      [chaos.Fault(step=3, phase="post_admission",
                                   kind="shard_loss", shard=1)]))
    reqs = chaos_requests()
    for r in reqs:
        eng.submit(r)
    hosts = []
    while not eng.idle() and eng.stats["steps"] < 400:
        eng.step()
        hosts.append(eng.host_state())
    return dict(streams=[(r.out_tokens, r.rejected) for r in reqs],
                lost=sorted(eng.lost_shards),
                shards_lost=eng.stats["shards_lost"],
                leak_free=eng.leak_free(),
                free_slots=sorted(eng._free_slots), hosts=hosts,
                stats=(eng.stats["steps"], eng.host_transfers,
                       eng.collectives))


def share_workload(eng, Req):
    """Two requests on a 16-token prefix (two pages of 8), three steps,
    then four more on it, whose admissions share the first two's pages;
    returns the six requests after the run."""
    hot = list(range(2, 18))
    first = [Req(i, prompt=hot + [40 + i], max_new_tokens=6)
             for i in range(2)]
    later = [Req(10 + i, prompt=hot + [60 + i], max_new_tokens=3)
             for i in range(4)]
    for r in first:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    for r in later:
        eng.submit(r)
    eng.run(max_steps=300)
    return first + later


def _once(real, at, what):
    """``real``, but its ``at``-th call raises ``RuntimeError(what)``;
    ``.calls`` counts the calls."""
    def flaky(*a, **kw):
        flaky.calls += 1
        if flaky.calls == at:
            raise RuntimeError(what)
        return real(*a, **kw)
    flaky.calls = 0
    return flaky


def scenario_one_rank(group, job):
    """Failures of rank 1 alone: a schedule only rank 1 holds with an
    error before its status gather (``dispatched``), rank 1's device
    step raising once, rank 1's first share step (in admission) raising,
    and a schedule only rank 1 holds with an error after the gather
    (``post_sync``) and after the run's last gather (``post_step`` of
    its last step).  Each case: what each rank raised, its recoveries,
    streams and host state, and how often rank 1's patched step ran."""
    cfg, params = olmo(job)
    alone = _rank(group) == 1
    out = {}
    patched = {"device": "_serve_step", "admission": "share_prefix_step"}
    for case, fault in (("before", ("error", 2, "dispatched")),
                        ("device", None), ("admission", None),
                        ("after", ("error", 2, "post_sync")),
                        ("last", ("error", 1, "post_step"))):
        injector = None
        if alone and fault is not None:
            injector = chaos.ServingFailureInjector(
                [chaos.Fault(step=fault[1], phase=fault[2], kind=fault[0])])
        name, flaky = patched.get(case), None
        real = getattr(tengine, name) if name else None
        if alone and name:
            flaky = _once(real, 3 if case == "device" else 1,
                          f"{name} failed on this rank")
            setattr(tengine, name, flaky)
        eng = _engine(cfg, params, group, dp=2, b_local=2, max_restarts=4,
                      injector=injector)
        raised, reqs = None, []
        n0 = _coll_counters(eng)
        try:
            with counting_collectives() as colls:
                if case == "admission":
                    reqs = share_workload(eng, tengine.Request)
                else:
                    reqs = (chaos_requests() if case != "last"
                            else [tengine.Request(0, prompt=[2, 3, 5, 7],
                                                  max_new_tokens=2)])
                    for r in reqs:
                        eng.submit(r)
                    eng.run(max_steps=300)
            n1 = _coll_counters(eng)
            eng.leak_free()
        except Exception as e:
            raised = (type(e).__name__, str(e))
        finally:
            if name:
                setattr(tengine, name, real)
        out[case] = dict(
            colls=colls, delta=[b - a for a, b in zip(n0, n1)]
            if raised is None else None,
            raised=raised, recoveries=eng.stats["recoveries"],
            tokens=[r.out_tokens for r in reqs],
            calls=0 if flaky is None else flaky.calls,
            done=all(r.done for r in reqs), host=eng.host_state(),
            stats=(eng.stats["steps"], eng.host_transfers,
                   eng.collectives))
    out.update(_recovery_failures(cfg, params, group, alone))
    return out


def _raises_adopting(eng, what):
    """``eng`` whose first ``adopt_crashed_state`` raises."""
    eng.adopt_crashed_state = _once(eng.adopt_crashed_state, 1, what)
    return eng


def _raises_requeueing(eng, what):
    """``eng`` whose first requeue in an in-place recovery raises after
    requeueing its slot: a recovery that stops midway, its other slots
    still active and its pool not reconciled."""
    real = eng._requeue

    def requeue(slot, reason):
        real(slot, reason)
        if reason == "recovery" and not requeue.raised:
            requeue.raised = True
            raise RuntimeError(what)
    requeue.raised = False
    eng._requeue = requeue
    return eng


def _recovery_failures(cfg, params, group, alone):
    """Rank 1's recovery raising on rank 1 alone: its in-place recovery
    (after an error at ``dispatched`` that only rank 1's schedule
    holds, both ranks recover in place and rank 1's adoption raises,
    ``recovery``, or its first requeue raises midway, ``requeue``), and
    after a crash at ``post_sync`` on both ranks, inside
    ``recover_engine`` rank 1's adoption (``adoption``) or its factory
    before building (``rebuild``).  Each case: what each rank raised,
    the case's seconds and the serve steps of its (first) engine."""
    out = {}
    for case in ("recovery", "requeue", "adoption", "rebuild"):
        t0 = time.perf_counter()
        raised = None
        try:
            if case in ("recovery", "requeue"):
                eng = _engine(cfg, params, group, dp=2, b_local=2,
                              max_restarts=4,
                              injector=chaos.ServingFailureInjector(
                                  [chaos.Fault(step=2, phase="dispatched",
                                               kind="error")])
                              if alone else None)
                if alone and case == "recovery":
                    _raises_adopting(eng, "recovery failed on this rank")
                if alone and case == "requeue":
                    _raises_requeueing(eng, "requeue failed on this rank")
                for r in chaos_requests():
                    eng.submit(r)
                eng.run(max_steps=300)
            else:
                journal = chaos.ServingJournal()
                injector = chaos.ServingFailureInjector(
                    [chaos.Fault(step=2, phase="post_sync", kind="crash")])

                def build():
                    return _engine(cfg, params, group, dp=2, b_local=2,
                                   journal=journal, injector=injector)

                def rebuild():
                    if alone and case == "rebuild":
                        raise RuntimeError("rebuild failed on this rank")
                    eng = build()
                    if alone:
                        _raises_adopting(eng, "adoption failed on this rank")
                    return eng

                eng = build()
                for r in chaos_requests():
                    eng.submit(r)
                try:
                    eng.run(max_steps=300)
                except chaos.HostCrash:
                    pass
                chaos.recover_engine(rebuild, eng, journal)
        except Exception as e:
            raised = (type(e).__name__, str(e))
        out[case] = dict(raised=raised, seconds=time.perf_counter() - t0,
                         steps=eng.stats["steps"])
    return out


def scenario_journals(group, job):
    """A crash after which rank 1's journal holds one event more than
    rank 0's: ``recover_engine`` compares the journals first and raises
    on both ranks, before either rebuilds."""
    cfg, params = olmo(job)
    journal = chaos.ServingJournal()
    injector = chaos.ServingFailureInjector(
        [chaos.Fault(step=1, phase="post_sync", kind="crash")])

    def build():
        return _engine(cfg, params, group, dp=2, b_local=2,
                       journal=journal, injector=injector)

    eng = build()
    for r in chaos_requests():
        eng.submit(r)
    try:
        eng.run(max_steps=300)
    except chaos.HostCrash:
        pass
    if _rank(group) == 1:
        journal.record("finish", rid=0)
    built = []
    try:
        chaos.recover_engine(lambda: built.append(1) or build(), eng,
                             journal)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    return dict(raised=raised, built=len(built))


def scenario_warm(group, job):
    """``tests/test_chaos.py``'s warm restarts at dp 2, each rank saving
    and restoring its own shard, and a save whose rank-1 shard file
    never lands."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    cfg, params = olmo(job)
    rank = _rank(group)
    hot = list(range(2, 18))                 # 2 pages of 8

    def hot_reqs(base=0):
        return [tengine.Request(rid=base + i, prompt=hot + [11 + i, 13],
                                max_new_tokens=4,
                                temperature=0.7 if i == 1 else 0.0, seed=5)
                for i in range(3)]

    def fresh():
        return _engine(cfg, params, group, dp=2, b_local=2, speculate=True,
                       draft_len=4, spec_gate=False,
                       sched=SchedConfig(pin_pages=8))

    base = os.path.join(job["out"], "warm")
    ck = Checkpointer(os.path.join(base, "pins"), shard_id=rank, keep=1)
    warmup = fresh()
    for r in hot_reqs():
        warmup.submit(r)
    warmup.run(max_steps=300)
    warmup.save_warm(ck, step=1)
    cold = fresh()                           # its construction: a barrier
    aux = ck.restore_aux(1)
    cold_reqs = hot_reqs(100)
    for r in cold_reqs:
        cold.submit(r)
    cold.run(max_steps=300)
    warm = fresh()
    step = warm.restore_warm(ck)
    got = dict(step=step, aux_pins=aux["pins"],
               pins=(warm.pinned_pages(), warmup.pinned_pages()),
               ledger=warmup.pins.to_state(),
               spec_same=warm.spec_store.to_state()
               == warmup.spec_store.to_state(),
               pin_tables_same=torch.equal(warm.pin_tables,
                                           warmup.pin_tables),
               pool_same=all(np.array_equal(a, b) for a, b in zip(
                   pool_leaves(warm.state.pool),
                   pool_leaves(warmup.state.pool))),
               files=sorted(os.listdir(os.path.join(
                   base, "pins", "step_00000001"))))
    warm_reqs = hot_reqs(200)
    for r in warm_reqs:
        warm.submit(r)
    warm.run(max_steps=300)
    got.update(pin_hits=warm.stats["pin_hit_reqs"],
               prompt_tokens=(warm.stats["prompt_tokens"],
                              cold.stats["prompt_tokens"]),
               tokens=([r.out_tokens for r in warm_reqs],
                       [r.out_tokens for r in cold_reqs]),
               host=warm.host_state())
    warm.flush_pins()
    got.update(leak_free=warm.leak_free(), counts=_shard_counts(warm),
               pages_local=warm.pages_local)

    # queued requests through rank 0's sidecar
    ck2 = Checkpointer(os.path.join(base, "queued"), shard_id=rank, keep=1)
    eng = _engine(cfg, params, group, dp=2, b_local=2)
    for i in range(2):
        eng.submit(tengine.Request(rid=i, prompt=[3 + i, 5, 7],
                                   max_new_tokens=3,
                                   temperature=0.9 * i, top_k=4, seed=i))
    eng.save_warm(ck2, step=1)
    eng2 = _engine(cfg, params, group, dp=2, b_local=2)
    eng2.restore_warm(ck2)
    got["queued"] = dict(
        backlog=eng2.scheduler.backlog(),
        regs=[(r.temperature, r.top_k, r.seed)
              for r in eng2.scheduler.pending()])
    eng2.run(max_steps=300)
    got["queued"].update(tokens_out=eng2.stats["tokens_out"],
                         leak_free=eng2.leak_free())

    # a step whose rank-1 shard file never lands: no marker, and neither
    # rank restores it
    real = ck2._write

    def dies(step, flat, aux=None, complete=True):
        raise OSError("the rank died before its shard file's rename")

    if rank == 1:
        ck2._write = dies
    raised = None
    try:
        eng2.save_warm(ck2, step=2)
    except Exception as e:
        raised = type(e).__name__
    finally:
        ck2._write = real
    probe = _engine(cfg, params, group, dp=2, b_local=2)   # a barrier
    try:
        probe.restore_warm(ck2, step=2)
        restore2 = None
    except FileNotFoundError as e:
        restore2 = str(e)
    got["missing"] = dict(raised=raised, latest=ck2.latest_step(),
                          restore2=restore2)
    return got


def _serve_main(argv):
    from repro_torch.launch import serve
    made, base = [], serve.Request

    def request(*a, **kw):
        made.append(base(*a, **kw))
        return made[-1]

    serve.Request = request
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            eng = serve.main(argv)
    finally:
        serve.Request = base
    return eng, made, out.getvalue()


def scenario_serve_chaos(group, job):
    """``launch.serve.main`` on the ranks with every fault kind."""
    eng, made, out = _serve_main(job["chaos_argv"])
    inj = eng._injector
    return dict(stdout=out, tokens=[r.out_tokens for r in made],
                log=inj.log, pending=inj.pending(), host=eng.host_state(),
                lost=sorted(eng.lost_shards),
                stats=(eng.stats["steps"], eng.host_transfers,
                       eng.collectives))


def spawn(tmp, job, this_side, limit_s):
    """Start ``job["dp"]`` ranks of this script on ``job`` (written to
    ``tmp/job.json``; logs ``tmp/rank<r>.log``), run ``this_side()``
    here meanwhile, and join the ranks within ``limit_s`` seconds of
    their start, killing any still running.  Returns ``(ranks' results
    in rank order, this side's result)``; fails with the ranks' logs
    unless every rank exited 0 in time."""
    import pathlib
    import subprocess
    import time

    root = pathlib.Path(__file__).resolve().parents[1]
    (tmp / "job.json").write_text(json.dumps(job))
    procs = []
    for r in range(job["dp"]):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(job["dp"]),
                   LOCAL_RANK=str(r), PYTHONPATH=str(root / "src"))
        log = open(tmp / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(root / "tests" / "_torch_mesh_rank.py"),
             str(tmp / "job.json")], env=env, cwd=root, stdout=log,
            stderr=subprocess.STDOUT), log))
    t0 = time.monotonic()
    try:
        mine = this_side()
    finally:
        codes = []
        for p, log in procs:
            try:
                codes.append(p.wait(timeout=max(
                    t0 + limit_s - time.monotonic(), 1)))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
            log.close()
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(tmp / f"rank{r}.log").read_text()[-4000:]
            for r in range(job["dp"])]
    assert codes == [0] * job["dp"], (f"ranks exited {codes} (limit "
                                      f"{limit_s} s):\n" + "\n".join(logs))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(job["dp"])], mine


def main(path):
    job = json.load(open(path))
    group = make_dp_group(job["dp"], "gloo", "cpu",
                          init_method="file://" + job["init"],
                          timeout_s=job.get("timeout_s", GROUP_TIMEOUT_S))
    out = {}
    for name in job["scenarios"]:
        out[name] = globals()[f"scenario_{name}"](group, job)
    torch.save(out, os.path.join(job["out"], f"rank{group.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
