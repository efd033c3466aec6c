"""P-SIM universal construction + stack, with the paper's memory management.

Faithful implementation of Figures 1 and 2 of the paper (reproduced from
Fatourou & Kallimanis [10]) plus the modifications of Section 4.1 that
turn it into Result 2:

* the fetch-and-add on ``Toggles`` is replaced by an array of single-writer
  registers (the paper: "the array toggles can instead be implemented as an
  array of registers without affecting any theoretical bounds");
* the LL/SC object ``S`` is the constant-time pointer-width LL/SC-from-CAS
  of Blelloch & Wei DISC'20 (see :class:`repro_torch.core.sim.LLSC`) instead of a
  timestamped CAS, so no unbounded sequence numbers are hidden in words;
* stack nodes are allocated from the *caller's private pool* via the
  ``alloc_node`` / ``free_node`` callbacks (``allocate_private`` /
  ``free_private`` of Figure 4) — the paper's recursion trick;
* each ``Attempt`` iteration tracks locally-pushed and locally-popped
  nodes: on SC failure (or a failed VL) the locally-pushed nodes are freed
  (they never became visible); on SC success the locally-popped nodes are
  freed (they are now popped from the global state);
* the dangerous dereference of ``pst->top`` in ``local_pop`` (the paper's
  line 61 read of ``top->next``, plus the ``top->data`` read that the
  stack-of-batches use needs — see DESIGN.md §2a clarification) is guarded
  by an immediate ``VL(S)``: if the VL fails the iteration is aborted, so a
  freed node's garbage words are never acted upon.

Return values: ``rvals[a]`` stores the popped node's *data* word (the
batch pointer), not the node pointer, because the node itself is freed by
the applier on a successful SC.  Values are carried forward by the state
record copies exactly as in P-SIM.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generator, List, Optional, Tuple

from .memory import BlockMemory
from .sim import LLSC, NULL, RegisterArray, SimContext, Step

# Node layout inside a k>=2-word block (see memory.py):
NODE_DATA = 0   # word 0: data (pointer to the batch's first block)
NODE_NEXT = 1   # word 1: next node in the shared stack

PUSH = "push"
POP = "pop"


@dataclass
class Request:
    """An announced operation (a single word: pointer to this record)."""

    op: str                 # PUSH | POP
    arg: int = NULL         # batch pointer for PUSH
    seq: int = 0            # sim-internal id for the applied-exactly-once monitor


@dataclass
class StRec:
    """P-SIM state record: stack top + applied bits + return values.

    ``2p + 1`` words of shared memory; copied field-by-field (each field
    copy is one shared-memory instruction, interruptible between fields —
    torn copies are discarded by the VL that follows, as in P-SIM).
    """

    st_top: int
    applied: List[int]
    rvals: List[Any]
    owner: int = -1          # sim-internal (recycling monitor)
    slot: int = 0            # sim-internal


class PSimStack:
    """Shared stack of batches (Result 2)."""

    def __init__(
        self,
        ctx: SimContext,
        mem: BlockMemory,
        alloc_node: Callable[[int], Generator],
        free_node: Callable[[int, int], Generator],
        init_top: int = NULL,
    ):
        p = ctx.nprocs
        self.ctx = ctx
        self.mem = mem
        self.alloc_node = alloc_node
        self.free_node = free_node
        self.announce = RegisterArray(ctx, p, init=None, category="psim_announce")
        self.toggles = RegisterArray(ctx, p, init=0, category="psim_toggles")
        # Pool[1..p+1][1..2] of state records: 2(p+1) records of 2p+1 words.
        ctx.add_space("psim_pool", 2 * (p + 1) * (2 * p + 1))
        self.pool: List[List[StRec]] = [
            [
                StRec(NULL, [0] * p, [None] * p, owner=i, slot=s)
                for s in range(2)
            ]
            for i in range(p + 1)
        ]
        init_rec = self.pool[p][0]
        init_rec.st_top = init_top
        self.S = LLSC(ctx, init=init_rec, category="psim_S")
        # thread-local state.  The paper's `toggle = 2^i` + fetch-and-add
        # makes the first announce flip Toggles bit i from 0 to 1; with an
        # array of registers the equivalent is: start at 0, flip before
        # each announce write (so the first announced value is 1 != the
        # initial applied[] of 0).
        self._toggle = [0] * p
        self._index = [1] * p    # next slot to use (0/1); paper's `index`
        self._seq = 0
        # monitors / stats
        self.applied_seqs: set = set()
        self.installed_count = 0
        self.alloc_calls_by = [0] * p
        self.free_calls_by = [0] * p
        self.last_op_internal_calls: Optional[Tuple[int, int]] = None

    # -- public API ----------------------------------------------------------
    def push(self, pid: int, batch_ptr: int) -> Generator:
        """Linearizable push of a batch pointer.  O(p) instructions."""
        req = self._new_request(PUSH, batch_ptr)
        return (yield from self._apply_op(pid, req))

    def pop(self, pid: int) -> Generator:
        """Linearizable pop; returns a batch pointer or NULL.  O(p)."""
        req = self._new_request(POP)
        return (yield from self._apply_op(pid, req))

    def _new_request(self, op: str, arg: int = NULL) -> Request:
        self._seq += 1
        return Request(op, arg, self._seq)

    # -- P-SIM core (Figure 1 + Section 4.1 modifications) --------------------
    def _apply_op(self, pid: int, req: Request) -> Generator:
        """PSimApplyOp — announce, flip toggle, Attempt, read rvals."""
        a0, f0 = self.alloc_calls_by[pid], self.free_calls_by[pid]
        yield from self.announce.write(pid, pid, req)
        self._toggle[pid] ^= 1
        yield from self.toggles.write(pid, pid, self._toggle[pid])
        yield from self._attempt(pid)
        rec = yield from self.S.read(pid)
        result = yield from self._read_rval(pid, rec, pid)
        self.last_op_internal_calls = (
            self.alloc_calls_by[pid] - a0, self.free_calls_by[pid] - f0)
        return result

    def _read_rval(self, pid: int, rec: StRec, slot: int) -> Generator:
        yield Step
        self.ctx.global_step += 1
        self.ctx.charge(pid)
        return rec.rvals[slot]

    def _attempt(self, pid: int) -> Generator:
        p = self.ctx.nprocs
        for _j in range(2):
            ls = yield from self.S.ll(pid)                       # line 28
            rec = self.pool[pid][self._index[pid]]
            if rec is self.S.peek():                              # monitor only
                self.ctx.violation(
                    f"process {pid} overwrites the installed record")
            # Pool[i][index] = *ls_ptr  (field-by-field copy, line 29)
            yield from self._copy_rec(pid, ls, rec)
            ok = yield from self.S.vl(pid)                        # line 30
            if not ok:
                continue
            ltoggles = yield from self.toggles.read_all(pid)      # line 32
            locally_pushed: List[int] = []
            locally_popped: List[int] = []
            aborted = False
            for a in range(p):                                    # line 33
                yield from self.ctx.local_step(pid)
                if ltoggles[a] != rec.applied[a]:                 # line 35
                    request = yield from self.announce.read(pid, a)
                    ok = yield from self._apply_local(
                        pid, rec, a, request, locally_pushed, locally_popped)
                    if not ok:           # VL failed inside local_pop
                        aborted = True
                        break
                    rec.applied[a] = ltoggles[a]                  # line 39
            if aborted:
                # free nodes allocated by local_push ops this iteration
                yield from self._free_all(pid, locally_pushed)
                continue
            success = yield from self.S.sc(pid, rec)              # line 40
            if success:
                self.installed_count += 1
                for seqno in rec_applied_seqs(rec):
                    if seqno in self.applied_seqs:
                        self.ctx.violation(f"request {seqno} applied twice")
                    self.applied_seqs.add(seqno)
                rec.meta_applied = []                              # reset
                self._index[pid] ^= 1                             # line 41
                yield from self._free_all(pid, locally_popped)
            else:
                yield from self._free_all(pid, locally_pushed)

    def _copy_rec(self, pid: int, src: StRec, dst: StRec) -> Generator:
        """Copy a (2p+1)-word state record, one word per instruction."""
        p = self.ctx.nprocs
        yield Step
        self.ctx.global_step += 1
        self.ctx.charge(pid)
        dst.st_top = src.st_top
        dst.meta_applied = []   # sim-internal: only NEW applications tracked
        for i in range(p):
            yield Step
            self.ctx.global_step += 1
            self.ctx.charge(pid)
            dst.applied[i] = src.applied[i]
        for i in range(p):
            yield Step
            self.ctx.global_step += 1
            self.ctx.charge(pid)
            dst.rvals[i] = src.rvals[i]

    def _apply_local(
        self,
        pid: int,
        rec: StRec,
        a: int,
        request: Request,
        locally_pushed: List[int],
        locally_popped: List[int],
    ) -> Generator:
        """Apply one announced request to the local record.

        Returns False iff a VL guard failed (iteration must abort).
        """
        if request.op == PUSH:                                    # Figure 2, local_push
            nd = yield from self._alloc(pid)
            yield from self.mem.write(pid, nd, NODE_DATA, request.arg)
            yield from self.mem.write(pid, nd, NODE_NEXT, rec.st_top)
            yield from self.ctx.local_step(pid)
            rec.st_top = nd
            locally_pushed.append(nd)
            rec.rvals[a] = True
        else:                                                     # local_pop
            yield from self.ctx.local_step(pid)
            ret = rec.st_top
            if ret == NULL:
                rec.rvals[a] = NULL
            else:
                data = yield from self.mem.read(pid, ret, NODE_DATA)
                nxt = yield from self.mem.read(pid, ret, NODE_NEXT)
                ok = yield from self.S.vl(pid)   # paper's VL-after-line-61 guard
                if not ok:
                    return False
                rec.st_top = nxt
                rec.rvals[a] = data
                locally_popped.append(ret)
        if not hasattr(rec, "meta_applied"):
            rec.meta_applied = []
        rec.meta_applied.append(request.seq)
        return True

    # -- node allocation bookkeeping ------------------------------------------
    def _alloc(self, pid: int) -> Generator:
        self.alloc_calls_by[pid] += 1
        nd = yield from self.alloc_node(pid)
        return nd

    def _free(self, pid: int, nd: int) -> Generator:
        self.free_calls_by[pid] += 1
        yield from self.free_node(pid, nd)

    def _free_all(self, pid: int, nodes: List[int]) -> Generator:
        """Free a list of nodes with a loop-bookkeeping step between frees.

        The interleaved local step also guarantees a suspension point
        *outside* any private-pool critical section between consecutive
        frees, so deamortization slices stay O(1) (see allocator.py).
        """
        for nd in nodes:
            yield from self.ctx.local_step(pid)
            yield from self._free(pid, nd)

    # -- test helpers (no step charges) ----------------------------------------
    def snapshot_stack(self) -> List[Tuple[int, int]]:
        """[(node, data), ...] from top; sim-internal, for checkers."""
        out = []
        node = self.S.peek().st_top
        while node != NULL:
            out.append((node, self.mem.words[node][NODE_DATA]))
            node = self.mem.words[node][NODE_NEXT]
        return out


def rec_applied_seqs(rec: StRec) -> List[int]:
    return list(getattr(rec, "meta_applied", []))
