"""Simulated pool memory: ``m`` blocks of ``k >= 2`` words each.

Pointers are block indices (ints); :data:`~repro_torch.core.sim.NULL` is the
null pointer.  Block word reads/writes are shared-memory instructions.

Word-borrowing layout used by the allocator (paper section 4.2):

* word 0 of a free block — ``next`` pointer chaining the blocks of a
  batch (``batch = stack<block>``),
* word 1 of the *first* block of a batch — ``next`` pointer for the
  thread-local ``local_batches`` stack,
* shared-stack nodes are ordinary blocks obtained from
  ``allocate_private``: word 0 = ``data`` (pointer to the batch's first
  block), word 1 = ``next`` (next node in the shared stack).

Live blocks belong entirely to the user; the allocator never relies on
their contents (the test harness scribbles over them to prove it).
"""

from __future__ import annotations

from typing import Generator, List

from .sim import SimContext, Step


class BlockMemory:
    """``m`` blocks x ``k`` words of simulated shared memory."""

    def __init__(self, ctx: SimContext, m: int, k: int = 2):
        assert k >= 2, "the paper requires blocks of k >= 2 words"
        self.ctx = ctx
        self.k = k
        self.words: List[List[int]] = [[0] * k for _ in range(m)]
        ctx.add_space("pool_blocks", m * k)

    @property
    def m(self) -> int:
        return len(self.words)

    def grow(self, nblocks: int) -> List[int]:
        """Model requesting more memory from the OS; returns new block ids."""
        start = len(self.words)
        self.words.extend([0] * self.k for _ in range(nblocks))
        self.ctx.add_space("pool_blocks", nblocks * self.k)
        return list(range(start, start + nblocks))

    def read(self, pid: int, block: int, word: int) -> Generator:
        yield Step
        self.ctx.global_step += 1
        self.ctx.charge(pid)
        return self.words[block][word]

    def write(self, pid: int, block: int, word: int, value: int) -> Generator:
        yield Step
        self.ctx.global_step += 1
        self.ctx.charge(pid)
        self.words[block][word] = value
