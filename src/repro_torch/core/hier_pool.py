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
Crash reconciliation (:func:`audit_and_reconcile`) is host-side numpy,
as in the reference, and puts the rebuilt pool back on the pool's own
device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
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


def alloc(pool: HierPool, want: torch.Tensor
          ) -> Tuple[HierPool, torch.Tensor]:
    """Per-lane allocate: want bool[..., L] -> ids int32[..., L] (NULL
    where denied).  Touches only the lane's private stack; granted
    blocks are stamped refcount 1."""
    take = want & (pool.private_top > 0)
    idx = (pool.private_top - 1).clamp(min=0)
    ids = block_pool.take(pool.private_ids, idx[..., None])[..., 0]
    ids = torch.where(take, ids, NULL)
    shared = pool.shared._replace(
        refcount=block_pool._set_ref(pool.shared.refcount, ids, 1))
    return pool._replace(shared=shared,
                         private_top=pool.private_top - take.to(I32)), ids


def alloc_or_shared(pool: HierPool, want: torch.Tensor
                    ) -> Tuple[HierPool, torch.Tensor]:
    """Lane-first allocate with a synchronous shared-pool fallback: a
    lane whose private stack is empty pulls from the shared stack."""
    pool, ids = alloc(pool, want)
    miss = want & (ids < 0)
    shared, got = block_pool.alloc(pool.shared, miss)
    return pool._replace(shared=shared), torch.where(miss, got, ids)


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


def free(pool: HierPool, ids: torch.Tensor) -> HierPool:
    """Per-lane free: ids int32[..., L] (NULL = no-op for that lane),
    the one-column case of :func:`free_n`."""
    return free_n(pool, ids[..., None])


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


def num_live(pool: HierPool) -> torch.Tensor:
    """Blocks with at least one reference (each counted once), summed
    over shards."""
    return (pool.shared.refcount > 0).sum(dtype=I32)


# The DP-sharded names of the reference: the ops above already run per
# shard over the leading [DP] axis of the leaves.
alloc_dp = alloc
alloc_or_shared_dp = alloc_or_shared
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


# ----------------------------------------------------------- crash recovery
#
# After a host crash the free stacks and the host's shadow of lane
# occupancy are untrusted: the crash may have landed anywhere, inside
# the rebalance's torn drain/refill window too.  What stays trustworthy
# is reachability: the page-table rows recovery keeps and the journaled
# pin rows.  Reconciliation recounts references from those rows alone
# and rebuilds the whole pool, host-side, off the hot path.


def _reconcile_shard(refcount: np.ndarray, L: int, cap: int,
                     keep_rows: Optional[np.ndarray],
                     pin_rows: Optional[np.ndarray]) -> Tuple[tuple, dict]:
    """One shard's rebuilt leaves (free_ids, top, refcount, private_ids,
    private_top) as numpy arrays in the pool's dtypes, and its report."""
    m = refcount.shape[0]
    ell = cap // 3

    refs = np.zeros(m, np.int64)
    for rows in (keep_rows, pin_rows):
        if rows is None:
            continue
        ids = np.asarray(rows).reshape(-1)
        ids = ids[(ids >= 0) & (ids < m)]
        np.add.at(refs, ids, 1)

    # pages a dead episode held that no keeping row reaches any more,
    # and referenced pages the torn state thought free
    reclaimed = np.nonzero((refcount > 0) & (refs == 0))[0]
    resurrected = int(np.sum((refcount <= 0) & (refs > 0)))

    # the recount runs in int64, the pool stores a narrow refcount: clamp
    # to its dtype's max and report (a clamped page stays live; releases
    # decrement, so the count errs toward never freeing early)
    ref_cap = np.iinfo(refcount.dtype).max
    clamped = np.nonzero(refs > ref_cap)[0]
    refs = np.minimum(refs, ref_cap)

    free_list = np.nonzero(refs == 0)[0]           # ascending ids
    # lanes first, exactly ell ids each while supply lasts, so the §4.2
    # never-dry floor holds by construction whenever slack allows
    new_lanes = np.full((L, cap), NULL, np.int32)
    new_tops = np.zeros(L, np.int32)
    pos = 0
    for i in range(L):
        take = min(ell, len(free_list) - pos)
        if take <= 0:
            break
        new_lanes[i, :take] = free_list[pos:pos + take]
        new_tops[i] = take
        pos += take
    rest = free_list[pos:]
    new_free = np.full(m, NULL, np.int32)
    new_free[:len(rest)] = rest[::-1]              # pops come off the end

    leaves = (new_free, np.int32(len(rest)), refs.astype(refcount.dtype),
              new_lanes, new_tops)
    report = {
        "reclaimed": [int(b) for b in reclaimed],
        "resurrected": resurrected,
        "clamped": [int(b) for b in clamped],
        "free": int(len(rest)) + int(new_tops.sum()),
        "live": int(np.sum(refs > 0)),
        "capacity": int(m),
        "never_dry": bool(new_tops.min() >= ell) if L else True,
    }
    if report["free"] + report["live"] != m:
        raise RuntimeError("reconcile broke conservation")
    return leaves, report


def audit_and_reconcile(pool: HierPool, keep_tables=None, pin_tables=None
                        ) -> Tuple[HierPool, dict]:
    """Rebuild a (possibly torn) pool from device-resident references.

    ``keep_tables`` are the page-table rows recovery keeps (``[B,
    maxp]`` per shard; usually none: in-flight requests requeue through
    the preemption-resume path) and ``pin_tables`` the journal-trusted
    pin rows, NULL (-1) for empty entries; tensors or numpy arrays.
    Every block a keeping row references stays live with a recounted
    refcount; every other block becomes free, each lane refilled to
    exactly ``ell``, the rest restacked on the shared pool in a fixed
    order.

    Accepts a single-shard pool or a DP-stacked one.  Only the
    refcounts are read to the host (once); the rebuilt leaves go back to
    the pool's device in its dtypes.  Returns ``(pool, report)``:
    conservation (free + live == capacity, per shard) is checked,
    never-dry reported per shard.
    """
    refcount = pool.shared.refcount.cpu().numpy()
    L, cap = pool.private_ids.shape[-2:]
    dp_form = refcount.ndim == 2

    def rows(tables, s):
        if tables is None:
            return None
        t = tables.cpu().numpy() if torch.is_tensor(tables) else tables
        return np.asarray(t)[s] if s is not None else np.asarray(t)

    built, reps = [], []
    for s in (range(refcount.shape[0]) if dp_form else [None]):
        leaves, rep = _reconcile_shard(
            refcount[s] if dp_form else refcount, L, cap,
            rows(keep_tables, s), rows(pin_tables, s))
        built.append(leaves)
        reps.append(rep)
    free_ids, top, ref, private_ids, private_top = (
        torch.as_tensor(np.stack(xs) if dp_form else xs[0]).to(
            pool.private_top.device) for xs in zip(*built))
    new = HierPool(BlockPool(free_ids, top, ref), private_ids, private_top)
    return new, {
        "shards": reps,
        "reclaimed": sum(len(r["reclaimed"]) for r in reps),
        "resurrected": sum(r["resurrected"] for r in reps),
        "clamped": sum(len(r["clamped"]) for r in reps),
        "never_dry": all(r["never_dry"] for r in reps),
        "conserved": True}
