"""Size-classed allocation plane: one allocator, many fixed sizes.

A static tuple of independent :class:`~repro_torch.core.hier_pool.HierPool`
s, one per size class; the §4.2 never-dry argument holds per class
because the classes never exchange blocks.  Counterpart of the JAX
package's ``core/classed_pool.py``.  This slice of the port serves the
single coarse KV class (C = 1); the fine bounded-state and expert
classes arrive with the layers that use them.

Every op takes the class index ``cls`` as a Python int and runs the
single-class op on that class's leaves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import hier_pool
from .hier_pool import HierPool

#: class index of the coarse paged-KV class — always present, always 0.
CLS_KV = 0


class ClassSpec(NamedTuple):
    """Static description of one size class."""
    page_size: int       # granularity, in token-capacity units
    num_blocks: int      # per-shard blocks in this class
    num_lanes: int       # private lanes (serving slots)
    ell: int             # lane batch size (lane capacity = 3*ell)


class ClassedPool(NamedTuple):
    """A static tuple of independent per-class HierPools."""
    classes: Tuple[HierPool, ...]


def _put(pool: ClassedPool, cls: int, hp: HierPool) -> ClassedPool:
    cs = list(pool.classes)
    cs[cls] = hp
    return ClassedPool(classes=tuple(cs))


def validate_specs(specs: Sequence[ClassSpec],
                   max_live: Sequence[int], *,
                   degraded_ok: bool = False) -> Tuple[bool, ...]:
    """Plan-time §4.2 validation, per class (hier_pool.validate_plan)."""
    assert len(specs) == len(max_live)
    return tuple(
        hier_pool.validate_plan(
            s.num_blocks, s.num_lanes, s.ell, int(max_live[c]),
            degraded_ok=degraded_ok,
            what=f"class {c} (page_size={s.page_size})")
        for c, s in enumerate(specs))


def create_dp(dp: int, specs: Sequence[ClassSpec],
              device="cuda") -> ClassedPool:
    """One identical per-class pool vector per DP shard."""
    return ClassedPool(classes=tuple(
        hier_pool.create_dp(dp, s.num_blocks, s.num_lanes, s.ell, device)
        for s in specs))


def alloc_n_or_shared_dp(pool: ClassedPool, cls: int, counts: torch.Tensor,
                         max_per_lane: int
                         ) -> Tuple[ClassedPool, torch.Tensor]:
    hp, ids = hier_pool.alloc_n_or_shared_dp(
        pool.classes[cls], counts, max_per_lane)
    return _put(pool, cls, hp), ids


def alloc_from_shared_dp(pool: ClassedPool, cls: int, counts: torch.Tensor,
                         max_per_lane: int
                         ) -> Tuple[ClassedPool, torch.Tensor]:
    hp, ids = hier_pool.alloc_from_shared_dp(
        pool.classes[cls], counts, max_per_lane)
    return _put(pool, cls, hp), ids


def free_n_metered_dp(pool: ClassedPool, cls: int, ids: torch.Tensor
                      ) -> Tuple[ClassedPool, torch.Tensor]:
    hp, spilled = hier_pool.free_n_metered_dp(pool.classes[cls], ids)
    return _put(pool, cls, hp), spilled


def rebalance_drain_dp(pool: ClassedPool,
                       cls: Optional[int] = None) -> ClassedPool:
    if cls is not None:
        return _put(pool, cls,
                    hier_pool.rebalance_drain_dp(pool.classes[cls]))
    return ClassedPool(classes=tuple(
        hier_pool.rebalance_drain_dp(hp) for hp in pool.classes))


def rebalance_refill_dp(pool: ClassedPool,
                        cls: Optional[int] = None) -> ClassedPool:
    if cls is not None:
        return _put(pool, cls,
                    hier_pool.rebalance_refill_dp(pool.classes[cls]))
    return ClassedPool(classes=tuple(
        hier_pool.rebalance_refill_dp(hp) for hp in pool.classes))


def rebalance_dp(pool: ClassedPool,
                 cls: Optional[int] = None) -> ClassedPool:
    """Deamortized rebalance of all classes (default) or one."""
    return rebalance_refill_dp(rebalance_drain_dp(pool, cls), cls)


def free_per_shard(pool: ClassedPool, cls: int) -> torch.Tensor:
    return hier_pool.free_per_shard(pool.classes[cls])


def live_per_shard(pool: ClassedPool, cls: int) -> torch.Tensor:
    return hier_pool.live_per_shard(pool.classes[cls])


def lane_ell(pool: ClassedPool, cls: int) -> int:
    return hier_pool.lane_ell(pool.classes[cls])


def pages_local(pool: ClassedPool, cls: int) -> int:
    """Per-shard block capacity of class ``cls`` (static)."""
    return pool.classes[cls].shared.free_ids.shape[-1]


def total_free(pool: ClassedPool) -> torch.Tensor:
    """Free blocks summed over ALL classes (and shards)."""
    return sum(hier_pool.total_free(hp) for hp in pool.classes)
