"""Core of the port: the paper's wait-free fixed-size allocator.

Faithful layer (simulated asynchronous shared memory, host-only,
carried over from the JAX package): sim, memory, psim, allocator, and
the history checkers of linearizability.

Device layer (PyTorch tensors): block_pool, hier_pool, classed_pool.
"""

from .sim import NULL, SimContext
from .allocator import WaitFreeAllocator, PoolExhausted

__all__ = ["NULL", "SimContext", "WaitFreeAllocator", "PoolExhausted"]
