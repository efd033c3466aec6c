"""Two-level (private / shared) block pool — the paper's structure.

Each *lane* (a serving request slot) owns a private stack of block ids
with capacity ``3 * ell``; a shared pool (:mod:`.block_pool`) holds the
rest.  As in the paper:

* ``alloc_n`` / ``free_n`` touch **only the lane's private stack** —
  O(K) tensor ops per lane, vectorized across lanes, no cross-lane
  coordination (the common case);
* ``rebalance`` is the deamortized shared-pool traffic, once per
  engine step: lanes above ``2*ell`` push a batch of ``ell`` blocks to
  the shared pool, then lanes below ``ell`` pull one.

Invariant (paper section 4.2): with ell >= max per-step demand, a
lane's private pool never runs dry between rebalances.

Counterpart of the JAX package's ``core/hier_pool.py``.  Every op is
batched over the leading axes of the pool's leaves (see
:mod:`.block_pool`), so a pool created by :func:`create_dp` carries one
independent pool per DP shard and the ``*_dp`` names below are the same
functions: block ids stay shard-local by construction, no vmap needed.
Crash reconciliation (``audit_and_reconcile``) waits for the port's
fault-tolerance slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import block_pool
from .block_pool import I32, NULL, BlockPool


class HierPool(NamedTuple):
    shared: BlockPool           # shared stack + the pool-wide refcounts
    private_ids: torch.Tensor   # int32[..., L, 3*ell] — per-lane stacks
    private_top: torch.Tensor   # int32[..., L]


def create(num_blocks: int, num_lanes: int, ell: int,
           device="cuda") -> HierPool:
    """All blocks start in the shared pool except one warm batch per
    lane, carved off the top of the shared stack in one slice."""
    cap = 3 * ell
    assert num_blocks >= num_lanes * ell, "need >= one batch per lane"
    shared = block_pool.create(num_blocks, device)
    n = num_lanes * ell
    carve = shared.free_ids[num_blocks - n:]
    private_ids = torch.full((num_lanes, cap), NULL, dtype=I32,
                             device=device)
    # lane i gets carve slice [n - (i+1)*ell : n - i*ell] == reversed rows
    private_ids[:, :ell] = carve.reshape(num_lanes, ell).flip(0)
    private_top = torch.full((num_lanes,), ell, dtype=I32, device=device)
    shared = shared._replace(top=shared.top - n)
    return HierPool(shared, private_ids, private_top)


def create_dp(dp: int, num_blocks: int, num_lanes: int, ell: int,
              device="cuda") -> HierPool:
    """One identical HierPool per DP shard (ids are shard-local)."""
    pool = create(num_blocks, num_lanes, ell, device)
    return _map(lambda a: a[None].repeat((dp,) + (1,) * a.dim()), pool)


def _map(fn, pool: HierPool) -> HierPool:
    return HierPool(BlockPool(*(fn(a) for a in pool.shared)),
                    fn(pool.private_ids), fn(pool.private_top))


def lane_ell(pool: HierPool) -> int:
    """The lane batch size, derived from the (static) lane capacity."""
    return pool.private_ids.shape[-1] // 3


def validate_plan(num_blocks: int, num_lanes: int, ell: int,
                  max_live: int, *, degraded_ok: bool = False,
                  what: str = "pool") -> bool:
    """Plan-time §4.2 never-dry validation: the pool-wide slack over the
    worst-case live demand must be at least ``3 * ell * num_lanes``.
    Raises ``ValueError`` unless ``degraded_ok``; returns True when
    fully provisioned, False when admitted degraded."""
    slack = num_blocks - max_live
    need = 3 * ell * num_lanes
    if slack >= need:
        return True
    msg = (f"{what}: num_blocks={num_blocks} leaves slack {slack} over "
           f"max_live={max_live}, but the §4.2 never-dry argument needs "
           f"3*ell*L = {need} (ell={ell}, lanes={num_lanes}); lanes can "
           f"run dry between rebalances. Provision num_blocks >= "
           f"{max_live + need}, or pass degraded_ok to accept "
           f"synchronous shared-pool fallback on the hot path.")
    if not degraded_ok:
        raise ValueError(msg)
    return False


def alloc_n(pool: HierPool, counts: torch.Tensor,
            max_per_lane: int) -> Tuple[HierPool, torch.Tensor]:
    """Per-lane batched allocate: counts int32[..., L] -> ids
    int32[..., L, K].  All-or-nothing per lane, private stack only;
    granted blocks are stamped refcount 1."""
    counts = counts.to(I32).clamp(0, max_per_lane)
    n = torch.where(counts <= pool.private_top, counts, 0)
    k = torch.arange(max_per_lane, dtype=I32, device=counts.device)
    want = k < n[..., None]
    idx = (pool.private_top[..., None] - 1 - k).clamp(min=0)
    ids = torch.where(want, block_pool.take(pool.private_ids, idx), NULL)
    shared = pool.shared._replace(
        refcount=block_pool._set_ref(pool.shared.refcount, ids, 1))
    return pool._replace(shared=shared,
                         private_top=pool.private_top - n), ids


def alloc_n_or_shared(pool: HierPool, counts: torch.Tensor,
                      max_per_lane: int) -> Tuple[HierPool, torch.Tensor]:
    """Batched lane-first allocate with a shared-pool fallback: a lane
    whose private stack cannot cover its whole demand takes the WHOLE
    batch from the shared pool instead (never half from each level)."""
    counts = counts.to(I32).clamp(0, max_per_lane)
    pool, ids = alloc_n(pool, counts, max_per_lane)
    miss = (counts > 0) & ~block_pool.granted_mask(ids, counts)
    shared, got = block_pool.alloc_n(
        pool.shared, torch.where(miss, counts, 0), max_per_lane)
    ids = torch.where(miss[..., None], got, ids)
    return pool._replace(shared=shared), ids


def alloc_from_shared(pool: HierPool, counts: torch.Tensor,
                      max_per_lane: int) -> Tuple[HierPool, torch.Tensor]:
    """Bulk user grants straight from the shared pool (admission-time
    traffic, off the per-token hot path)."""
    shared, ids = block_pool.alloc_n(pool.shared, counts, max_per_lane)
    return pool._replace(shared=shared), ids


def addref(pool: HierPool, ids: torch.Tensor) -> HierPool:
    """Register one extra reference per valid id (prefix sharing)."""
    return pool._replace(shared=block_pool.addref(pool.shared, ids))


def free_n_metered(pool: HierPool, ids: torch.Tensor
                   ) -> Tuple[HierPool, torch.Tensor]:
    """Per-lane batched free (ids int32[..., L, K], NULL = no-op) that
    also reports the lane-cap spill.

    Drops one reference per valid id; blocks reaching zero return to
    the owning lane's private stack up to its capacity, the overflow
    spilling to the shared stack.  Returns ``(pool, n_spilled)`` with
    n_spilled int32[...] — the §13 spill counter row."""
    cap = pool.private_ids.shape[-1]
    refcount, released = block_pool.release_plan(
        pool.shared.refcount, block_pool._lead(ids, pool.private_top))
    released = released.reshape(ids.shape)
    rel_ids = torch.where(released, ids, NULL)
    rank = torch.cumsum(released.to(I32), -1, dtype=I32)      # 1-based
    pos = pool.private_top[..., None] + rank - 1
    to_lane = released & (pos < cap)
    private_ids = block_pool.put(pool.private_ids,
                                 torch.where(to_lane, pos, cap), rel_ids)
    private_top = pool.private_top + to_lane.to(I32).sum(-1, dtype=I32)
    spilled = released & ~to_lane
    spill = block_pool._lead(torch.where(spilled, rel_ids, NULL),
                             pool.private_top)
    shared = block_pool._push(pool.shared._replace(refcount=refcount), spill)
    n_spilled = block_pool._lead(spilled, pool.private_top).to(I32).sum(
        -1, dtype=I32)
    return HierPool(shared, private_ids, private_top), n_spilled


def free_n(pool: HierPool, ids: torch.Tensor) -> HierPool:
    """:func:`free_n_metered` without the spill count."""
    pool, _ = free_n_metered(pool, ids)
    return pool


def free_shared(pool: HierPool, ids: torch.Tensor) -> HierPool:
    """Release lane-less references straight to the SHARED stack (the
    cache-owner release path; ids [..., K])."""
    return pool._replace(shared=block_pool.free(pool.shared, ids))


def free_per_shard(pool: HierPool) -> torch.Tensor:
    """Free blocks available to each shard (shared stack + lane
    stocks): int32[DP] on a DP-sharded pool, a scalar otherwise."""
    return pool.shared.top + pool.private_top.sum(-1, dtype=I32)


def live_per_shard(pool: HierPool) -> torch.Tensor:
    """Referenced blocks per shard, each counted once."""
    return block_pool.num_live_rows(pool.shared.refcount)


def rebalance_drain(pool: HierPool) -> HierPool:
    """Phase 1: every lane above ``2*ell`` pushes its top ``ell`` blocks
    to the shared pool in one fixed-shape scatter."""
    ell = lane_ell(pool)
    k = torch.arange(ell, dtype=I32, device=pool.private_top.device)
    drain = pool.private_top > 2 * ell
    idx = (pool.private_top[..., None] - 1 - k).clamp(min=0)
    dids = torch.where(drain[..., None],
                       block_pool.take(pool.private_ids, idx), NULL)
    shared = block_pool._push(
        pool.shared, block_pool._lead(dids, pool.private_top))
    private_top = pool.private_top - torch.where(drain, ell, 0)
    return pool._replace(shared=shared, private_top=private_top.to(I32))


def rebalance_refill(pool: HierPool) -> HierPool:
    """Phase 2: every lane below ``ell`` pulls one batch of ``ell``
    blocks from the shared pool (prefix grants in lane order)."""
    cap = pool.private_ids.shape[-1]
    ell = cap // 3
    k = torch.arange(ell, dtype=I32, device=pool.private_top.device)
    refill = pool.private_top < ell
    counts = torch.where(refill, ell, 0).to(I32)
    shared, got = block_pool._take_n(pool.shared, counts, ell)
    granted = block_pool.granted_mask(got, counts) & refill
    place = torch.where(granted[..., None], pool.private_top[..., None] + k,
                        cap)
    private_ids = block_pool.put(pool.private_ids, place, got)
    private_top = pool.private_top + torch.where(granted, ell, 0)
    return HierPool(shared, private_ids, private_top.to(I32))


def rebalance(pool: HierPool) -> HierPool:
    """Deamortized shared-pool traffic: drains first, then refills, so
    this call's drains can supply this call's refills."""
    return rebalance_refill(rebalance_drain(pool))


def total_free(pool: HierPool) -> torch.Tensor:
    return pool.shared.top.sum(dtype=I32) + pool.private_top.sum(dtype=I32)


# The DP-sharded names of the reference: the ops above already run per
# shard over the leading [DP] axis of the leaves.
alloc_n_dp = alloc_n
alloc_n_or_shared_dp = alloc_n_or_shared
alloc_from_shared_dp = alloc_from_shared
addref_dp = addref
free_n_dp = free_n
free_n_metered_dp = free_n_metered
free_shared_dp = free_shared
rebalance_dp = rebalance
rebalance_drain_dp = rebalance_drain
rebalance_refill_dp = rebalance_refill
