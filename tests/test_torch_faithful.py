"""The port's faithful-layer carry-overs against the JAX package's.

``repro_torch.core.scheduler`` (``Scheduler``, ``closed_loop``),
``baselines`` (``LockFreeListAllocator``, ``TreiberAllocator``,
``HoardSpaceModel``) and ``refpool`` (``RefShardPool``,
``RefClassedPool``, ``conforms``, ``conforms_classed``) are host-only
copies of the reference's modules.  Each test runs the same seeded
workload through both packages and asserts identical results: every
operation of the history (process, name, argument, result, invocation
and response step, steps charged), the scheduler's step count and the
final memory words; for the pool witness, every grant and the final
stacks and refcounts.  ``conforms`` and ``conforms_classed`` are also
run against the port's device pool leaves.
"""

import random

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from repro.core import (SimContext as JSimContext,  # noqa: E402
                        WaitFreeAllocator as JWaitFree,
                        Scheduler as JScheduler, closed_loop as j_closed_loop)
from repro.core import baselines as jbase, refpool as jref  # noqa: E402
from repro_torch.core import (SimContext, WaitFreeAllocator,  # noqa: E402
                              Scheduler, closed_loop, baselines, refpool,
                              check_alloc_history, classed_pool, hier_pool)

POLICIES = ("random", "bursty", "round_robin", "stall_one")


def _history(ctx):
    return [(r.opid, r.pid, r.name, r.arg, r.result, r.invoke_step,
             r.response_step, r.steps) for r in ctx.history]


def _run(pkg, make, p, policy, seed, n_ops=60, crash_at=None):
    """One closed-loop workload of ``p`` processes under ``policy``:
    (history, scheduler steps, memory words)."""
    Ctx, Sched, loop = pkg
    ctx = Ctx(p, seed=seed)
    alloc = make(ctx)
    sched = Sched(seed=seed)
    for pid in range(p):
        sched.add(pid, loop(pid, alloc, n_ops,
                            random.Random(seed * 97 + pid)))
    steps = sched.run(policy, crash_at=dict(crash_at or {}))
    return _history(ctx), steps, [list(w) for w in alloc.mem.words]


PORT = (SimContext, Scheduler, closed_loop)
REF = (JSimContext, JScheduler, j_closed_loop)


@pytest.mark.parametrize("policy", POLICIES)
def test_wait_free_allocator_schedules_equal_reference(policy):
    """The paper's allocator under every scheduling policy (one process
    crashing mid-run): identical histories, steps and memory, and the
    port's history linearizes."""
    p, seed = 3, 11
    crash = {1: 150}
    got = _run(PORT, lambda c: WaitFreeAllocator(c, shared_batches=4 * p),
               p, policy, seed, crash_at=crash)
    want = _run(REF, lambda c: JWaitFree(c, shared_batches=4 * p),
                p, policy, seed, crash_at=crash)
    assert got == want
    assert got[1] > 0 and len(got[0]) > 0


def test_port_history_linearizes():
    ctx = SimContext(3, seed=4)
    alloc = WaitFreeAllocator(ctx, shared_batches=12)
    sched = Scheduler(seed=4)
    for pid in range(3):
        sched.add(pid, closed_loop(pid, alloc, 80, random.Random(pid)))
    sched.run("bursty")
    assert check_alloc_history(ctx.history) == []


def test_callable_policy_equals_reference():
    """A user policy ``(step, runnable, rng) -> pid`` drives both
    schedulers alike."""
    def policy(step, runnable, rng):
        return runnable[(step * 7 + rng.randrange(3)) % len(runnable)]
    got = _run(PORT, lambda c: WaitFreeAllocator(c, shared_batches=8),
               2, policy, 3)
    want = _run(REF, lambda c: JWaitFree(c, shared_batches=8), 2, policy, 3)
    assert got == want


@pytest.mark.parametrize("name", ["LockFreeListAllocator",
                                  "TreiberAllocator"])
@pytest.mark.parametrize("policy", ["random", "stall_one"])
def test_baselines_equal_reference(name, policy):
    """The blocking and lock-free baselines under the same schedule:
    identical histories, step counts and free-list words."""
    mk_port = getattr(baselines, name)
    mk_ref = getattr(jbase, name)
    got = _run(PORT, lambda c: mk_port(c, 64), 3, policy, 5, n_ops=40)
    want = _run(REF, lambda c: mk_ref(c, 64), 3, policy, 5, n_ops=40)
    assert got == want


def test_hoard_space_model_equals_reference():
    for p, S, c in ((4, 64, 2), (16, 256, 3), (64, 1024, 1)):
        assert (baselines.HoardSpaceModel(p, S, c).additive_blowup_blocks()
                == jbase.HoardSpaceModel(p, S, c).additive_blowup_blocks())
        assert (baselines.HoardSpaceModel.paper_blowup_blocks(p)
                == jbase.HoardSpaceModel.paper_blowup_blocks(p))
        assert (baselines.HoardSpaceModel.paper_blowup_blocks(p, 3 * p)
                == jbase.HoardSpaceModel.paper_blowup_blocks(p, 3 * p))


def _state(ref):
    return (list(ref.shared), [list(x) for x in ref.lanes],
            list(ref.refcount))


def _random_trace(pool_a, pool_b, rng, n_ops, lanes, ell):
    """Apply the same randomized op trace to two shard witnesses and
    return both result lists."""
    outs = ([], [])
    live = []
    for _ in range(n_ops):
        op = rng.choice(["alloc", "alloc_n", "shared", "addref", "free_n",
                         "free_shared", "rebalance", "drain", "refill"])
        if op == "alloc":
            want = [rng.random() < 0.6 for _ in range(lanes)]
            args = (want,)
        elif op in ("alloc_n", "shared"):
            args = ([rng.randrange(0, ell + 2) for _ in range(lanes)],
                    ell + 1)
        elif op == "addref":
            args = ([rng.choice(live) for _ in range(2)] if live else [],)
        elif op == "free_n":
            rows = [[] for _ in range(lanes)]
            for _ in range(min(len(live), rng.randrange(0, 5))):
                rows[rng.randrange(lanes)].append(
                    live.pop(rng.randrange(len(live))))
            width = max([len(r) for r in rows] + [1])
            args = ([r + [-1] * (width - len(r)) for r in rows],)
        elif op == "free_shared":
            ids = [live.pop(rng.randrange(len(live)))
                   for _ in range(min(len(live), 2))]
            args = (ids + [-1],)
        else:
            args = ()
        method = {"shared": "alloc_from_shared", "drain": "rebalance_drain",
                  "refill": "rebalance_refill"}.get(op, op)
        for pool, out in zip((pool_a, pool_b), outs):
            out.append((op, getattr(pool, method)(*args)))
        res = outs[0][-1][1]
        if op == "alloc":
            live += [b for b in res if b >= 0]
        elif op in ("alloc_n", "shared"):
            live += [b for row in res for b in row]
        elif op == "addref":
            live += [b for b in args[0] if b >= 0]
    return outs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refpool_traces_equal_reference(seed):
    """``RefShardPool`` under a randomized trace (lane and shared
    grants, addrefs, row-major frees with spills, lane-less frees,
    drains and refills): identical grants and final state."""
    rng = random.Random(seed)
    lanes, ell, blocks = 3, 2, 40
    port = refpool.RefShardPool(blocks, lanes, ell)
    ref = jref.RefShardPool(blocks, lanes, ell)
    assert _state(port) == _state(ref)
    got, want = _random_trace(port, ref, rng, 120, lanes, ell)
    assert got == want
    assert _state(port) == _state(ref)
    assert port.free_total() == ref.free_total()
    assert port.num_live() == ref.num_live()


def test_classed_refpool_equals_reference():
    """``RefClassedPool``: class-indexed ops delegate to per-class
    witnesses, summed queries, one class's torn rebalance."""
    specs = [(40, 3, 2), (24, 3, 2)]
    port = refpool.create_classed_dp(2, specs)[1]
    ref = jref.create_classed_dp(2, specs)[1]
    for pool in (port, ref):
        g = pool.alloc_n(0, [2, 1, 3], 3)
        pool.alloc(1, [True, False, True])
        pool.alloc_from_shared(1, [4, 4, 4], 4)
        pool.free_n(0, [[g[0][0], -1], [g[1][0], -1], [-1, -1]])
        pool.rebalance_drain(1)
        pool.rebalance()
    for c in range(2):
        assert _state(port.classes[c]) == _state(ref.classes[c])
    assert port.free_total() == ref.free_total()
    assert port.num_live() == ref.num_live()


def test_conforms_against_the_port_pool():
    """``conforms`` / ``conforms_classed`` hold the port's device pool
    leaves against the witness: equal after the same grants and frees,
    and a changed stack is reported."""
    from repro_torch.core.classed_pool import ClassSpec
    dp, blocks, lanes, ell = 2, 24, 3, 2
    spec = ClassSpec(page_size=8, num_blocks=blocks, num_lanes=lanes,
                     ell=ell)
    pool = classed_pool.create_dp(dp, (spec,), device="cpu")
    refs = refpool.create_classed_dp(dp, [(blocks, lanes, ell)])
    for d in range(dp):
        assert refpool.conforms_classed(refs[d], pool, d) is None
    counts = torch.tensor([[1, 2, 0], [2, 0, 1]], dtype=torch.int32)
    hp, ids = hier_pool.alloc_n(pool.classes[0], counts, 2)
    pool = pool._replace(classes=(hp,))
    for d in range(dp):
        got = refs[d].alloc_n(0, counts[d].tolist(), 2)
        assert [[b for b in row if b >= 0] for row in ids[d].tolist()] == got
        assert refpool.conforms_classed(refs[d], pool, d) is None
    refs[0].classes[0].shared.append(blocks - 1)
    assert refpool.conforms_classed(refs[0], pool, 0) is not None
    leaves = [np.asarray(x) for x in (
        hp.shared.free_ids[1], hp.shared.top[1], hp.private_ids[1],
        hp.private_top[1], hp.shared.refcount[1])]
    assert refpool.conforms(refs[1].classes[0], *leaves) is None
