"""Core of the port: the paper's wait-free fixed-size allocator.

Faithful layer (simulated asynchronous shared memory, host-only,
carried over from the JAX package):
  sim, memory, psim, allocator, scheduler, linearizability, baselines,
  refpool (the device pool's sequential witness)

Device layer (PyTorch tensors):
  block_pool, hier_pool, classed_pool, kv_cache
"""

from .sim import NULL, SimContext, Register, RegisterArray, CASWord, LLSC
from .memory import BlockMemory
from .psim import PSimStack
from .allocator import WaitFreeAllocator, PoolExhausted, DEAMORT_C
from .scheduler import Scheduler, closed_loop
from .linearizability import (check_alloc_history, check_batch_alloc_history,
                              check_classed_batch_history,
                              check_cross_class_frees,
                              check_cross_shard_frees,
                              check_preemption_history,
                              check_sharded_batch_history,
                              expand_batch_history, split_history_by_class,
                              split_history_by_shard,
                              WGStackChecker, Event)
from . import block_pool, classed_pool, hier_pool, kv_cache, refpool

__all__ = [
    "NULL", "SimContext", "Register", "RegisterArray", "CASWord", "LLSC",
    "BlockMemory", "PSimStack", "WaitFreeAllocator", "PoolExhausted",
    "DEAMORT_C", "Scheduler", "closed_loop", "check_alloc_history",
    "check_batch_alloc_history", "check_classed_batch_history",
    "check_cross_class_frees", "check_cross_shard_frees",
    "check_preemption_history", "check_sharded_batch_history",
    "expand_batch_history", "split_history_by_class",
    "split_history_by_shard",
    "WGStackChecker", "Event", "block_pool", "classed_pool", "hier_pool",
    "kv_cache", "refpool",
]
