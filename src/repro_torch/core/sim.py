"""Simulated asynchronous shared memory with instruction-level scheduling.

This module is the substrate for the *faithful* reproduction of
"Concurrent Fixed-Size Allocation and Free in Constant Time"
(Blelloch & Wei, 2020).  Every shared-memory instruction (read / write /
CAS / LL / VL / SC, and block-word accesses) is one atomic *step* of a
process coroutine.  Process code is written as Python generators; each
primitive is invoked as ``value = yield from obj.op(pid, ...)`` which

  1. yields once (a scheduling point *before* the instruction), then
  2. executes the instruction atomically (the simulator is single
     threaded, so everything between two yields is atomic), and
  3. charges one instruction to the process's current operation.

The paper's time complexity counts local and shared instructions; we
charge local O(1) bookkeeping via :meth:`SimContext.local_step` where it
corresponds to real work (loop iterations, stack pointer updates).

Space accounting: every shared object registers its word count with the
context under a category, so benchmarks can verify the Theta(p^2)
metadata bound of Result 1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

NULL = -1  # null pointer in simulated memory (block index / record id)

Step = None  # what primitives yield; the scheduler ignores the value


@dataclass
class OpRecord:
    """One high-level operation instance in the history."""

    opid: int
    pid: int
    name: str
    arg: Any
    invoke_step: int
    steps: int = 0                  # instructions charged to this op
    result: Any = None
    response_step: Optional[int] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def completed(self) -> bool:
        return self.response_step is not None


class SimContext:
    """Global simulation state: step counts, history, space accounting."""

    def __init__(self, nprocs: int, seed: int = 0):
        self.nprocs = nprocs
        self.global_step = 0
        self.current_op: List[Optional[OpRecord]] = [None] * nprocs
        self.history: List[OpRecord] = []
        self._opid = itertools.count()
        self.space_words: Dict[str, int] = {}
        self.monitors: List[Callable[[], None]] = []
        self.violations: List[str] = []

    # -- operation history -------------------------------------------------
    def begin_op(self, pid: int, name: str, arg: Any = None) -> OpRecord:
        rec = OpRecord(next(self._opid), pid, name, arg, self.global_step)
        self.current_op[pid] = rec
        self.history.append(rec)
        return rec

    def end_op(self, rec: OpRecord, result: Any = None) -> None:
        rec.result = result
        rec.response_step = self.global_step
        if self.current_op[rec.pid] is rec:
            self.current_op[rec.pid] = None

    # -- step accounting ---------------------------------------------------
    def charge(self, pid: int, n: int = 1) -> None:
        rec = self.current_op[pid]
        if rec is not None:
            rec.steps += n

    def local_step(self, pid: int) -> Generator:
        """One unit of local O(1) work (counted, schedulable)."""
        yield Step
        self.global_step += 1
        self.charge(pid)

    # -- space accounting ----------------------------------------------------
    def add_space(self, category: str, words: int) -> None:
        self.space_words[category] = self.space_words.get(category, 0) + words

    def total_space(self, exclude: Tuple[str, ...] = ()) -> int:
        return sum(v for k, v in self.space_words.items() if k not in exclude)

    # -- invariant monitors --------------------------------------------------
    def check_monitors(self) -> None:
        for m in self.monitors:
            m()

    def violation(self, msg: str) -> None:
        self.violations.append(msg)


class _Shared:
    def __init__(self, ctx: SimContext, category: str, words: int):
        self.ctx = ctx
        ctx.add_space(category, words)

    def _tick(self, pid: int) -> None:
        self.ctx.global_step += 1
        self.ctx.charge(pid)


class Register(_Shared):
    """Word-sized atomic register."""

    def __init__(self, ctx: SimContext, init: Any = 0, category: str = "register"):
        super().__init__(ctx, category, 1)
        self.value = init

    def read(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        return self.value

    def write(self, pid: int, v: Any) -> Generator:
        yield Step
        self._tick(pid)
        self.value = v


class RegisterArray(_Shared):
    """Array of word-sized registers (one instruction per element access)."""

    def __init__(self, ctx: SimContext, n: int, init: Any = 0,
                 category: str = "register"):
        super().__init__(ctx, category, n)
        self.values = [init] * n

    def read(self, pid: int, idx: int) -> Generator:
        yield Step
        self._tick(pid)
        return self.values[idx]

    def write(self, pid: int, idx: int, v: Any) -> Generator:
        yield Step
        self._tick(pid)
        self.values[idx] = v

    def read_all(self, pid: int) -> Generator:
        """n instructions (used for the Toggles array: the paper notes the
        fetch-and-add is only an optimization and an array of registers
        preserves all bounds)."""
        out = []
        for i in range(len(self.values)):
            out.append((yield from self.read(pid, i)))
        return out


class CASWord(_Shared):
    """Word-sized CAS object supporting read and CAS."""

    def __init__(self, ctx: SimContext, init: Any = 0, category: str = "cas"):
        super().__init__(ctx, category, 1)
        self.value = init

    def read(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        return self.value

    def cas(self, pid: int, expected: Any, new: Any) -> Generator:
        yield Step
        self._tick(pid)
        if self.value == expected:
            self.value = new
            return True
        return False


class LLSC(_Shared):
    """Pointer-width LL/SC object.

    The paper builds LL/SC from pointer-width CAS via Blelloch & Wei
    (DISC'20, "LL/SC and atomic copy"), which gives O(1)-time LL/VL/SC
    with O(c p^2) space and *no* unbounded sequence numbers.  The paper
    uses that construction as a black box, and so do we: this class
    provides exact LL/SC semantics at O(1) simulated instructions per
    call, and registers the cited O(p^2) words (c = 1) so the space
    benchmarks account for it honestly.  A tag-based from-CAS backend
    (:class:`LLSCFromTaggedCAS`) is provided for cross-checking
    semantics; it would need unbounded tags in a real word, which is
    exactly what the DISC'20 construction removes.
    """

    def __init__(self, ctx: SimContext, init: Any = None, nprocs: Optional[int] = None,
                 category: str = "llsc"):
        p = ctx.nprocs if nprocs is None else nprocs
        # Cited bound: O(c p^2) words with c = 1 outstanding LL per process.
        super().__init__(ctx, category, p * p)
        self.value = init
        self._version = 0                      # sim-internal, not algorithm state
        self._link: Dict[int, int] = {}        # pid -> version at last LL

    def ll(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        self._link[pid] = self._version
        return self.value

    def read(self, pid: int) -> Generator:
        """Plain read (no link established)."""
        yield Step
        self._tick(pid)
        return self.value

    def vl(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        return self._link.get(pid) == self._version

    def sc(self, pid: int, new: Any) -> Generator:
        yield Step
        self._tick(pid)
        if self._link.get(pid) == self._version:
            self.value = new
            self._version += 1
            return True
        return False

    # non-linearizable peek for monitors/tests only (no step charge)
    def peek(self) -> Any:
        return self.value


class LLSCFromTaggedCAS(_Shared):
    """LL/SC simulated from CAS with (value, tag) pairs.

    This is the classic construction the paper *avoids* (it needs an
    unbounded tag packed into the word).  Provided to cross-validate the
    semantics of :class:`LLSC` in tests.
    """

    def __init__(self, ctx: SimContext, init: Any = None, category: str = "llsc_tagged"):
        super().__init__(ctx, category, 1)
        self._cell: Tuple[Any, int] = (init, 0)
        self._link: Dict[int, Tuple[Any, int]] = {}

    def ll(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        self._link[pid] = self._cell
        return self._cell[0]

    def read(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        return self._cell[0]

    def vl(self, pid: int) -> Generator:
        yield Step
        self._tick(pid)
        return self._link.get(pid) == self._cell

    def sc(self, pid: int, new: Any) -> Generator:
        yield Step
        self._tick(pid)
        if self._link.get(pid) == self._cell:
            self._cell = (new, self._cell[1] + 1)
            return True
        return False

    def peek(self) -> Any:
        return self._cell[0]
