"""One rank of the port's DP serving plane, for ``tests/test_torch_mesh.py``.

    RANK=r WORLD_SIZE=n PYTHONPATH=src python tests/_torch_mesh_rank.py JOB

``JOB`` is a JSON file: the process group's ``init`` file, the ``out``
directory, the ``scenarios`` to run in order and their inputs (prompts,
the bridged weights saved with ``torch.save``).  The rank joins a
``gloo`` group through the file (no network port), runs each scenario
through ``ServingEngine(mesh=group)`` on the CPU, and saves what the
test compares to ``out/rank<r>.pt``.  Run as a script it imports the
port alone: the JAX package is blocked before anything is imported.
The test imports the module too, to drive the same scenarios through
the port's single-process engine (``group=None``).
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

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import classed_pool  # noqa: E402
from repro_torch.core.classed_pool import CLS_EXPERT, CLS_KV  # noqa: E402
from repro_torch.launch.mesh import make_dp_group  # noqa: E402
from repro_torch.launch.steps import gather_state  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.sched import SchedConfig  # noqa: E402
from repro_torch.serving.telemetry import FlightRecorder  # noqa: E402

#: Tensor methods that read a tensor's values on the host
READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
         "__index__")


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
    reads, colls = [], []
    saved = {n: getattr(torch.Tensor, n) for n in READS}
    real = {n: getattr(dist, n) for n in ("all_gather", "all_reduce",
                                          "broadcast", "all_to_all")}
    for n, fn in saved.items():
        def counted(self, *a, _fn=fn, _n=n, **kw):
            reads.append(_n)
            return _fn(self, *a, **kw)
        setattr(torch.Tensor, n, counted)
    for n, fn in real.items():
        def coll(*a, _fn=fn, _n=n, **kw):
            colls.append(_n)
            return _fn(*a, **kw)
        setattr(dist, n, coll)
    n0 = (eng.stats["steps"], eng.host_transfers, eng.collectives,
          eng.agreements, eng.admission_transfers)
    try:
        for _ in range(6):
            eng.step()
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
        for n, fn in real.items():
            setattr(dist, n, fn)
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
    from repro_torch.launch import serve
    made, base = [], serve.Request

    def request(*a, **kw):
        made.append(base(*a, **kw))
        return made[-1]

    serve.Request = request
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            eng = serve.main(job["serve_argv"])
    finally:
        serve.Request = base
    return dict(stdout=out.getvalue(), tokens=[r.out_tokens for r in made],
                done=all(r.done for r in made), rank=eng.mesh.rank,
                steps=eng.stats["steps"], collectives=eng.collectives)


def main(path):
    job = json.load(open(path))
    group = make_dp_group(job["dp"], "gloo", "cpu",
                          init_method="file://" + job["init"],
                          timeout_s=job.get("timeout_s", 90))
    out = {}
    for name in job["scenarios"]:
        out[name] = globals()[f"scenario_{name}"](group, job)
    torch.save(out, os.path.join(job["out"], f"rank{group.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
