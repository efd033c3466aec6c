"""Baseline allocators for the paper's comparisons (Section 3.1).

Carried over from the JAX package's ``core/baselines.py`` (host-only).

All run under the same instruction-level simulation so step counts and
space are directly comparable with :class:`~repro_torch.core.allocator.
WaitFreeAllocator`:

* :class:`LockFreeListAllocator` — a single global free list guarded by a
  test-and-CAS lock.  Blocking: a stalled lock holder stalls everyone
  (worst-case op time unbounded under adversarial scheduling).
* :class:`TreiberAllocator` — lock-free Treiber stack of free blocks with
  (pointer, tag) CAS (the tag models the unbounded sequence numbers the
  paper avoids).  Lock-free but not wait-free: an op can fail its CAS an
  unbounded number of times under contention.
* :class:`HoardSpaceModel` — no execution; models the Theta(p * S)
  additive blowup of Hoard-style superblock allocators for the space
  benchmark (Berger et al. [3]).
"""

from __future__ import annotations

from typing import Generator, Optional

from .memory import BlockMemory
from .sim import CASWord, NULL, SimContext


class LockFreeListAllocator:
    """Global free list + CAS spin lock (blocking baseline)."""

    def __init__(self, ctx: SimContext, m: int, k: int = 2):
        self.ctx = ctx
        self.mem = BlockMemory(ctx, m, k)
        self.lock = CASWord(ctx, 0, category="baseline_lock")
        self.head = CASWord(ctx, NULL, category="baseline_head")
        for b in range(m - 1, -1, -1):
            self.mem.words[b][0] = self.head.value
            self.head.value = b
        self.live: set = set()

    def _acquire(self, pid: int) -> Generator:
        while True:
            ok = yield from self.lock.cas(pid, 0, 1 + pid)
            if ok:
                return

    def _release(self, pid: int) -> Generator:
        yield from self.lock.cas(pid, 1 + pid, 0)

    def allocate(self, pid: int) -> Generator:
        rec = self.ctx.begin_op(pid, "allocate")
        yield from self._acquire(pid)
        b = yield from self.head.read(pid)
        if b == NULL:
            yield from self._release(pid)
            self.ctx.end_op(rec, NULL)
            return NULL
        nxt = yield from self.mem.read(pid, b, 0)
        yield from self.head.cas(pid, b, nxt)   # plain write would do
        yield from self._release(pid)
        self.live.add(b)
        self.ctx.end_op(rec, b)
        return b

    def free(self, pid: int, b: int) -> Generator:
        rec = self.ctx.begin_op(pid, "free", b)
        self.live.discard(b)
        yield from self._acquire(pid)
        h = yield from self.head.read(pid)
        yield from self.mem.write(pid, b, 0, h)
        yield from self.head.cas(pid, h, b)
        yield from self._release(pid)
        self.ctx.end_op(rec)


class TreiberAllocator:
    """Treiber-stack free list; lock-free, unbounded retries possible."""

    def __init__(self, ctx: SimContext, m: int, k: int = 2):
        self.ctx = ctx
        self.mem = BlockMemory(ctx, m, k)
        # (head pointer, tag) packed into one CAS object; the tag is the
        # unbounded sequence number the paper's algorithm avoids.
        self.head = CASWord(ctx, (NULL, 0), category="baseline_head")
        top = NULL
        for b in range(m):
            self.mem.words[b][0] = top
            top = b
        self.head.value = (top, 0)
        self.live: set = set()

    def allocate(self, pid: int) -> Generator:
        rec = self.ctx.begin_op(pid, "allocate")
        while True:
            h, tag = yield from self.head.read(pid)
            if h == NULL:
                self.ctx.end_op(rec, NULL)
                return NULL
            nxt = yield from self.mem.read(pid, h, 0)
            ok = yield from self.head.cas(pid, (h, tag), (nxt, tag + 1))
            if ok:
                self.live.add(h)
                self.ctx.end_op(rec, h)
                return h

    def free(self, pid: int, b: int) -> Generator:
        rec = self.ctx.begin_op(pid, "free", b)
        self.live.discard(b)
        while True:
            h, tag = yield from self.head.read(pid)
            yield from self.mem.write(pid, b, 0, h)
            ok = yield from self.head.cas(pid, (h, tag), (b, tag + 1))
            if ok:
                self.ctx.end_op(rec)
                return


class HoardSpaceModel:
    """Additive memory blowup model for superblock allocators.

    Hoard-style allocators move blocks between private heaps and the
    global heap in contiguous *superblocks* of S blocks; each private
    heap can hold up to a constant number of partially-empty superblocks,
    giving Theta(p * S) additive blowup (S is typically a multiple of the
    page size, so S >> p).  The paper's allocator achieves Theta(p^2)
    additive blowup with batches of ell = Theta(p) non-contiguous blocks.
    """

    def __init__(self, p: int, superblock_blocks: int, per_heap_superblocks: int = 2):
        self.p = p
        self.S = superblock_blocks
        self.c = per_heap_superblocks

    def additive_blowup_blocks(self) -> int:
        return self.p * self.S * self.c

    @staticmethod
    def paper_blowup_blocks(p: int, ell: Optional[int] = None) -> int:
        ell = ell if ell is not None else 4 * p
        return p * 3 * ell   # <= 3 ell blocks per private pool
