"""The paper, end to end: every Result demonstrated in one script.

  PYTHONPATH=src python -m repro_torch.examples.allocator_showcase

Twin of the JAX package's ``examples/allocator_showcase.py``, on the
port's faithful layer (host only, as its reference).  Walks through:
O(1) worst-case bound under four adversarial schedulers (Result 1.2),
live-block capacity m - Theta(p^2) (1.3), Theta(p^2) metadata (1.4),
wait-freedom under crash failures, and the comparison against
lock-based and Treiber-stack baselines.
"""

from __future__ import annotations

import argparse
import random

from ..core import (SimContext, WaitFreeAllocator, Scheduler,
                    check_alloc_history, PoolExhausted)
from ..core.baselines import (HoardSpaceModel, LockFreeListAllocator,
                              TreiberAllocator)


def phased_bursts(pid, alloc, phases=4):
    """Alloc/free bursts sized to force shared-pool batch transfers."""
    held = []
    for ph in range(phases):
        if ph % 2 == 0:
            for _ in range(alloc.ell * 3):
                held.append((yield from alloc.allocate(pid)))
        else:
            while held:
                yield from alloc.free(pid, held.pop())


def worst_case():
    print("=== Result 1.2: O(1) worst-case, any scheduler, any p ===")
    for p in (2, 8, 32):
        worst = 0
        for policy in ("random", "bursty", "round_robin", "stall_one"):
            ctx = SimContext(p, seed=1)
            alloc = WaitFreeAllocator(ctx, shared_batches=4 * p)
            sched = Scheduler(seed=1)
            for pid in range(p):
                sched.add(pid, phased_bursts(pid, alloc))
            sched.run(policy)
            assert (ctx.violations == []
                    and check_alloc_history(ctx.history) == [])
            worst = max(worst, max(o.steps for o in ctx.history
                                   if o.completed))
        print(f"  p={p:3d}: worst-case steps/op = {worst}")


def live_capacity():
    print("=== Result 1.3: live capacity m - Theta(p^2) ===")
    for p in (2, 8):
        ctx = SimContext(p, seed=0)
        alloc = WaitFreeAllocator(ctx, shared_batches=6 * p)
        sched = Scheduler(seed=0)
        got = []

        def greedy(pid, alloc=alloc, got=got):
            try:
                while True:
                    got.append((yield from alloc.allocate(pid)))
            except PoolExhausted:
                return

        sched.add(0, greedy(0))
        try:
            sched.run("round_robin")
        except PoolExhausted:
            pass
        m = alloc.mem.m
        print(f"  p={p}: allocated {len(got)}/{m} blocks "
              f"(unreachable: {m - len(got)} <= c*p^2 = {11 * p * p + 8 * p})")


def metadata():
    print("=== Result 1.4: Theta(p^2) metadata ===")
    for p in (4, 8, 16, 32):
        ctx = SimContext(p, seed=0)
        alloc = WaitFreeAllocator(ctx, shared_batches=4 * p)
        print(f"  p={p:3d}: {alloc.metadata_words():7d} words "
              f"({alloc.metadata_words() / p / p:.1f} * p^2)")


def crashes():
    print("=== wait-freedom under crashes ===")
    p = 6
    ctx = SimContext(p, seed=9)
    alloc = WaitFreeAllocator(ctx, shared_batches=4 * p)
    sched = Scheduler(seed=9)
    for pid in range(p):
        sched.add(pid, phased_bursts(pid, alloc))
    sched.run("random", crash_at={0: 400, 1: 1200, 2: 2000})
    alive = [pid for pid in range(p) if sched.done[pid]]
    worst = max(o.steps for o in ctx.history
                if o.completed and o.pid in (3, 4, 5))
    print(f"  crashed 3 of {p} processes mid-run; survivors {alive[-3:]} all "
          f"finished, worst op {worst} steps, violations: "
          f"{len(ctx.violations)}")


def baselines():
    print("=== baselines: worst-case op cost under contention ===")
    p = 8
    for name, cls in (("global lock", LockFreeListAllocator),
                      ("treiber stack", TreiberAllocator)):
        ctx = SimContext(p, seed=0)
        alloc = cls(ctx, m=4096)
        sched = Scheduler(seed=0)

        def wl(pid, alloc=alloc):
            held = []
            rng = random.Random(pid)
            for _ in range(200):
                if not held or rng.random() < 0.6:
                    b = yield from alloc.allocate(pid)
                    if b >= 0:
                        held.append(b)
                else:
                    yield from alloc.free(pid, held.pop())

        for pid in range(p):
            sched.add(pid, wl(pid))
        sched.run("random")
        worst = max(o.steps for o in ctx.history if o.completed)
        print(f"  {name:14s}: worst {worst:5d} steps "
              f"(unbounded in theory; ours is provably constant)")


def blowup():
    print("=== section 3.1: additive memory blowup ===")
    for p in (8, 64, 512):
        ours = HoardSpaceModel.paper_blowup_blocks(p)
        hoard = HoardSpaceModel(p, superblock_blocks=1024
                                ).additive_blowup_blocks()
        print(f"  p={p:4d}: ours Theta(p^2) = {ours:9d} blocks, "
              f"Hoard Theta(p*S) = {hoard:9d} blocks")


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    for section in (worst_case, live_capacity, metadata, crashes, baselines,
                    blowup):
        section()
    print("showcase done.")


if __name__ == "__main__":
    main()
