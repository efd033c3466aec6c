"""Adversarial instruction-level schedulers for the concurrency simulation.

Carried over from the JAX package's ``core/scheduler.py`` (host-only).

A *process program* is a generator (built from the allocator / stack
operations); the scheduler interleaves them one instruction at a time.
Policies:

* ``random``      — uniformly random runnable process each step.
* ``round_robin`` — cyclic.
* ``bursty``      — random process runs a geometric burst of steps
  (models cache-friendly co-runs and long stalls of everyone else).
* ``stall_one``   — one chosen victim process is scheduled only once
  every ``stall`` steps (models a straggler).
* callable        — any ``(step, runnable_pids, rng) -> pid``.

Crash failures: ``crash(pid)`` stops a process forever (it is never
scheduled again); the paper's wait-freedom means everyone else still
completes in bounded own-steps.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Generator, List, Optional


class Scheduler:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.programs: Dict[int, Generator] = {}
        self.done: Dict[int, bool] = {}
        self.crashed: set = set()
        self.steps = 0

    def add(self, pid: int, program: Generator) -> None:
        self.programs[pid] = program
        self.done[pid] = False

    def crash(self, pid: int) -> None:
        self.crashed.add(pid)

    def runnable(self) -> List[int]:
        return [p for p, d in self.done.items()
                if not d and p not in self.crashed]

    def step_one(self, pid: int) -> None:
        try:
            next(self.programs[pid])
        except StopIteration:
            self.done[pid] = True
        self.steps += 1

    def run(
        self,
        policy: str | Callable = "random",
        max_steps: int = 10_000_000,
        crash_at: Optional[Dict[int, int]] = None,
    ) -> int:
        """Run until all non-crashed programs finish; returns steps taken."""
        crash_at = crash_at or {}
        burst_pid, burst_left = None, 0
        victim = None
        if policy == "stall_one":
            victim = self.rng.choice(list(self.programs))
        while self.steps < max_steps:
            for pid, at in list(crash_at.items()):
                if self.steps >= at:
                    self.crash(pid)
                    del crash_at[pid]
            runnable = self.runnable()
            if not runnable:
                break
            if callable(policy):
                pid = policy(self.steps, runnable, self.rng)
            elif policy == "round_robin":
                pid = runnable[self.steps % len(runnable)]
            elif policy == "bursty":
                if burst_pid not in runnable or burst_left <= 0:
                    burst_pid = self.rng.choice(runnable)
                    burst_left = self.rng.randint(1, 64)
                pid = burst_pid
                burst_left -= 1
            elif policy == "stall_one":
                others = [p for p in runnable if p != victim]
                if others and (self.steps % 200 != 0 or victim not in runnable):
                    pid = self.rng.choice(others)
                else:
                    pid = victim if victim in runnable else self.rng.choice(runnable)
            else:  # random
                pid = self.rng.choice(runnable)
            self.step_one(pid)
        return self.steps


def closed_loop(pid: int, allocator, n_ops: int, rng: random.Random,
                held: Optional[List[int]] = None,
                max_held: int = 32,
                scribble: bool = True) -> Generator:
    """A user workload: random mix of allocate/free, holding <= max_held.

    ``scribble`` writes garbage into every word of allocated (live) blocks
    to validate the paper's claim that the allocator "works correctly
    regardless of what the user writes into the memory blocks".
    """
    held = held if held is not None else []
    for _ in range(n_ops):
        do_alloc = (not held) or (len(held) < max_held and rng.random() < 0.55)
        if do_alloc:
            b = yield from allocator.allocate(pid)
            if scribble:
                for w in range(allocator.mem.k):
                    allocator.mem.words[b][w] = 0xDEAD0000 | (pid << 8) | (w & 0xFF)
            held.append(b)
        else:
            b = held.pop(rng.randrange(len(held)))
            yield from allocator.free(pid, b)
    while held:
        yield from allocator.free(pid, held.pop())
