"""Wait-free fixed-size allocate/free (Result 1; Figures 3 and 4).

Each process owns a *private pool*:

* ``current_batch`` — a partially-filled stack of blocks (chained through
  word 0 of each free block),
* ``local_batches`` — a stack of zero..two *full* batches of ``ell``
  blocks each (chained through word 1 of each batch's first block),
* ``num_batches``   — number of full batches, plus one if a shared-pool
  pop is in flight (the paper's invariant: always 1 or 2).

The *shared pool* is the P-SIM stack of batches (:class:`~repro_torch.core.psim.
PSimStack`, Result 2).  Shared pushes/pops cost O(p) instructions and are
**deamortized**: every user-level ``allocate``/``free`` advances the
in-flight shared operation by ``DEAMORT_C`` instructions
(``run_delayed_step``), so each user operation is O(1) worst-case and the
shared operation completes within p user operations.

The shared stack allocates its nodes from the *same* private pools via
``allocate_private``/``free_private`` (Figure 4) — the paper's recursion
trick.  A shared op makes at most 2p such calls (Result 2, property 2),
which the batch-size choice ``ell >= 3p`` absorbs.  We default to
``ell = 4p`` — still Theta(p) as the paper requires — because our
instruction-count constants for the deamortization slices are concrete
(see DESIGN.md); the paper's ``3p`` bound assumes idealized unit costs.

Implementation clarifications vs. the paper's schematic pseudocode (both
noted in DESIGN.md):

* In Figure 3 the final ``current_batch.pop()``/``push(b)`` happen *after*
  ``run_delayed_step()``, whose internal ``allocate_private``/
  ``free_private`` calls may have emptied/filled ``current_batch`` in the
  meantime.  The take/put helpers therefore re-apply the Figure-4
  refill/overflow logic if needed; the paper's accounting (at most 2p
  internal calls per shared op) bounds this.
* ``rvals`` of a shared pop carries the popped node's *data* word (batch
  pointer) because the node is freed by the applier (see psim.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generator, List, Optional

from .memory import BlockMemory
from .psim import PSimStack
from .sim import NULL, SimContext, Step

# Words borrowed from blocks (paper section 4.2).
BLK_NEXT = 0    # next block within a batch (and user data word 0 when live)
BAT_NEXT = 1    # next batch in local_batches (only on a batch's first block)

# Instructions of the in-flight shared op executed per user op.  A shared
# push/pop costs <= ~34p + O(1) simulated instructions (P-SIM: two
# attempt iterations, each copying a (2p+1)-word record, reading p
# toggles, applying <= p requests, plus <= 2p internal allocate/free
# calls).  DEAMORT_C = 48 completes it within ~0.75p user ops < p.
DEAMORT_C = 48


class PoolExhausted(RuntimeError):
    pass


@dataclass
class DelayedOp:
    kind: str                      # 'push' | 'pop'
    gen: Generator
    slices: int = 0                # user ops that advanced it (monitor: <= p)


class PrivatePool:
    """Thread-local pool state (O(1) words per process)."""

    def __init__(self, ctx: SimContext):
        # current_batch: top pointer + size counter (thread-local words)
        self.cur_top: int = NULL
        self.cur_size: int = 0
        # local_batches: top pointer + (monitor-only) count
        self.lb_top: int = NULL
        self.lb_count: int = 0
        self.num_batches: int = 0
        self.delayed: Optional[DelayedOp] = None
        ctx.add_space("private_pool_meta", 6)


class WaitFreeAllocator:
    """Result 1: O(1) wait-free allocate/free with Theta(p^2) overhead."""

    def __init__(
        self,
        ctx: SimContext,
        k: int = 2,
        ell: Optional[int] = None,
        shared_batches: int = 8,
        allow_os_growth: bool = False,
        deamort_c: int = DEAMORT_C,
    ):
        p = ctx.nprocs
        self.ctx = ctx
        self.ell = ell if ell is not None else max(4 * p, 4)
        assert self.ell >= 3 * p, "the paper requires ell >= 3p"
        self.allow_os_growth = allow_os_growth
        self.deamort_c = deamort_c

        cur_init = self.ell // 2
        m = p * (2 * self.ell + cur_init) + shared_batches * (self.ell + 1)
        self.mem = BlockMemory(ctx, m, k)
        self.pools = [PrivatePool(ctx) for _ in range(p)]

        # --- sequential initialization (not part of any measured op) ---
        blocks = iter(range(m))
        for pool in self.pools:
            for _ in range(2):
                self._init_push_full_batch(pool, [next(blocks) for _ in range(self.ell)])
            pool.num_batches = 2
            for _ in range(cur_init):
                b = next(blocks)
                self.mem.words[b][BLK_NEXT] = pool.cur_top
                pool.cur_top = b
                pool.cur_size += 1

        top_node = NULL
        for _ in range(shared_batches):
            node = next(blocks)
            batch = [next(blocks) for _ in range(self.ell)]
            first = self._link_batch(batch)
            self.mem.words[node][0] = first     # NODE_DATA
            self.mem.words[node][1] = top_node  # NODE_NEXT
            top_node = node
        assert next(blocks, None) is None

        self.shared = PSimStack(
            ctx, self.mem,
            alloc_node=self._allocate_private,
            free_node=self._free_private,
            init_top=top_node,
        )

        # monitors / stats
        self.live: set = set()
        self.os_requests = 0
        self.max_delayed_slices = 0
        self.delayed_started = 0
        self.delayed_completed = 0
        # Critical-section depth per process: >0 while inside a private-
        # pool operation.  Deamortization slices must not suspend the
        # delayed generator mid private-pool op (the paper's sequential-
        # process model makes thread-local ops atomic w.r.t. the process's
        # own instruction stream); _run_delayed_step drains to a safe
        # boundary, adding at most O(1) instructions per slice.
        self._crit = [0] * p

    # ------------------------------------------------------------------ init
    def _link_batch(self, blocks: List[int]) -> int:
        top = NULL
        for b in blocks:
            self.mem.words[b][BLK_NEXT] = top
            top = b
        return top

    def _init_push_full_batch(self, pool: PrivatePool, blocks: List[int]) -> None:
        first = self._link_batch(blocks)
        self.mem.words[first][BAT_NEXT] = pool.lb_top
        pool.lb_top = first
        pool.lb_count += 1

    # ----------------------------------------------------- low-level stacks
    def _cur_push(self, pid: int, b: int) -> Generator:
        pool = self.pools[pid]
        self._crit[pid] += 1
        try:
            yield from self.mem.write(pid, b, BLK_NEXT, pool.cur_top)
            yield from self.ctx.local_step(pid)
            pool.cur_top = b
            pool.cur_size += 1
        finally:
            self._crit[pid] -= 1

    def _cur_pop(self, pid: int) -> Generator:
        pool = self.pools[pid]
        assert pool.cur_size > 0
        self._crit[pid] += 1
        try:
            b = pool.cur_top
            nxt = yield from self.mem.read(pid, b, BLK_NEXT)
            yield from self.ctx.local_step(pid)
            pool.cur_top = nxt
            pool.cur_size -= 1
        finally:
            self._crit[pid] -= 1
        return b

    def _lb_push(self, pid: int, batch_first: int) -> Generator:
        pool = self.pools[pid]
        self._crit[pid] += 1
        try:
            yield from self.mem.write(pid, batch_first, BAT_NEXT, pool.lb_top)
            yield from self.ctx.local_step(pid)
            pool.lb_top = batch_first
            pool.lb_count += 1
        finally:
            self._crit[pid] -= 1

    def _lb_pop(self, pid: int) -> Generator:
        pool = self.pools[pid]
        if pool.lb_top == NULL:
            raise PoolExhausted(
                f"process {pid}: local_batches empty (invariant violation)")
        self._crit[pid] += 1
        try:
            first = pool.lb_top
            nxt = yield from self.mem.read(pid, first, BAT_NEXT)
            yield from self.ctx.local_step(pid)
            pool.lb_top = nxt
            pool.lb_count -= 1
        finally:
            self._crit[pid] -= 1
        return first

    # ------------------------------------------------ Figure 4 (private ops)
    def _allocate_private(self, pid: int) -> Generator:
        pool = self.pools[pid]
        self._crit[pid] += 1
        try:
            yield from self.ctx.local_step(pid)         # is_empty check
            if pool.cur_size == 0:
                first = yield from self._lb_pop(pid)
                pool.cur_top = first
                pool.cur_size = self.ell
                pool.num_batches -= 1                    # Fig 4 line 4
            b = yield from self._cur_pop(pid)
        finally:
            self._crit[pid] -= 1
        return b

    def _free_private(self, pid: int, b: int) -> Generator:
        pool = self.pools[pid]
        self._crit[pid] += 1
        try:
            yield from self.ctx.local_step(pid)          # full() check
            if pool.cur_size == self.ell:
                pool.num_batches += 1                    # Fig 4 lines 9-10
                yield from self._lb_push(pid, pool.cur_top)
                pool.cur_top = NULL
                pool.cur_size = 0
            yield from self._cur_push(pid, b)
        finally:
            self._crit[pid] -= 1

    # ---------------------------------------------- deamortized shared ops
    def _start_delayed(self, pid: int, kind: str, batch_first: int = NULL) -> None:
        pool = self.pools[pid]
        if pool.delayed is not None:
            self.ctx.violation(
                f"process {pid}: second delayed {kind} while "
                f"{pool.delayed.kind} in flight")
            # Safety valve (never hit in a correct configuration): finish
            # the in-flight op synchronously.  Monitored via violations.
            self._drain_delayed(pid)
        gen = self._delayed_pop_gen(pid) if kind == "pop" else \
            self._delayed_push_gen(pid, batch_first)
        pool.delayed = DelayedOp(kind, gen)
        self.delayed_started += 1

    def _delayed_pop_gen(self, pid: int) -> Generator:
        batch = yield from self.shared.pop(pid)
        if batch == NULL:
            batch = yield from self._os_refill(pid)
        yield from self._lb_push(pid, batch)
        # num_batches unchanged: the in-flight pop it counted is now a
        # full batch in local_batches.

    def _delayed_push_gen(self, pid: int, batch_first: int) -> Generator:
        yield from self.shared.push(pid, batch_first)

    def _os_refill(self, pid: int) -> Generator:
        """Model requesting a fresh batch from the OS (m grows)."""
        if not self.allow_os_growth:
            raise PoolExhausted("shared pool empty and OS growth disabled")
        self.os_requests += 1
        self._crit[pid] += 1
        try:
            blocks = self.mem.grow(self.ell)
            top = NULL
            for b in blocks:
                yield from self.mem.write(pid, b, BLK_NEXT, top)
                top = b
        finally:
            self._crit[pid] -= 1
        return top

    def _run_delayed_step(self, pid: int) -> Generator:
        pool = self.pools[pid]
        yield from self.ctx.local_step(pid)
        op = pool.delayed
        if op is None:
            return
        op.slices += 1
        budget = self.deamort_c
        while budget > 0 or self._crit[pid] > 0:
            # Never suspend inside a private-pool operation: drain to a
            # safe boundary (private ops are O(1) instructions, so the
            # overage per slice is constant).  Other processes may still
            # interleave (the outer yield); only *this* process's user
            # operation must not resume mid-private-op.
            budget -= 1
            try:
                next(op.gen)
            except StopIteration:
                pool.delayed = None
                self.delayed_completed += 1
                self.max_delayed_slices = max(self.max_delayed_slices, op.slices)
                return
            yield Step

    def _drain_delayed(self, pid: int) -> None:
        """Safety valve: run the in-flight op to completion (sequentially)."""
        pool = self.pools[pid]
        op = pool.delayed
        for _ in op.gen:
            pass
        pool.delayed = None
        self.delayed_completed += 1

    # --------------------------------------------------- Figure 3 (user ops)
    def allocate(self, pid: int) -> Generator:
        rec = self.ctx.begin_op(pid, "allocate")
        pool = self.pools[pid]
        yield from self.ctx.local_step(pid)          # is_empty check
        if pool.cur_size == 0:
            yield from self._refill_user(pid)
        yield from self._run_delayed_step(pid)
        yield from self.ctx.local_step(pid)
        if pool.cur_size == 0:                        # drained by delayed step
            yield from self._refill_user(pid)
        b = yield from self._cur_pop(pid)
        if b in self.live:
            self.ctx.violation(f"block {b} allocated while live")
        self.live.add(b)
        self.ctx.end_op(rec, b)
        return b

    def _refill_user(self, pid: int) -> Generator:
        """Figure 3 lines 9-12."""
        pool = self.pools[pid]
        first = yield from self._lb_pop(pid)
        pool.cur_top = first
        pool.cur_size = self.ell
        yield from self.ctx.local_step(pid)
        if pool.num_batches == 1:
            self._start_delayed(pid, "pop")
        else:
            pool.num_batches -= 1

    def free(self, pid: int, b: int) -> Generator:
        rec = self.ctx.begin_op(pid, "free", b)
        if b not in self.live:
            self.ctx.violation(f"free of non-live block {b}")
        self.live.discard(b)
        pool = self.pools[pid]
        yield from self.ctx.local_step(pid)           # full() check
        if pool.cur_size == self.ell:
            yield from self._overflow_user(pid)
        yield from self._run_delayed_step(pid)
        yield from self.ctx.local_step(pid)
        if pool.cur_size == self.ell:                 # filled by delayed step
            yield from self._overflow_user(pid)
        yield from self._cur_push(pid, b)
        self.ctx.end_op(rec)
        return None

    def _overflow_user(self, pid: int) -> Generator:
        """Figure 3 lines 17-23."""
        pool = self.pools[pid]
        yield from self.ctx.local_step(pid)
        if pool.num_batches == 2:
            self._start_delayed(pid, "push", pool.cur_top)
        else:
            pool.num_batches += 1
            yield from self._lb_push(pid, pool.cur_top)
        pool.cur_top = NULL
        pool.cur_size = 0

    # -------------------------------------------------------- introspection
    def private_pool_blocks(self, pid: int) -> int:
        """Blocks held in pid's private pool (monitor; no step charges)."""
        pool = self.pools[pid]
        total = pool.cur_size
        bat = pool.lb_top
        while bat != NULL:
            total += self.ell
            bat = self.mem.words[bat][BAT_NEXT]
        return total

    def metadata_words(self) -> int:
        """All words of internal metadata (excludes the block pool itself)."""
        return self.ctx.total_space(exclude=("pool_blocks",))

    def check_num_batches_invariant(self) -> None:
        for pid, pool in enumerate(self.pools):
            inflight = 1 if (pool.delayed and pool.delayed.kind == "pop") else 0
            if pool.num_batches != pool.lb_count + inflight:
                self.ctx.violation(
                    f"process {pid}: num_batches={pool.num_batches} != "
                    f"full({pool.lb_count}) + inflight_pop({inflight})")
            if not (0 <= pool.num_batches <= 3):
                self.ctx.violation(
                    f"process {pid}: num_batches={pool.num_batches} out of range")
