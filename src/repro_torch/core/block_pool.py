"""Fixed-size block pool as a functional PyTorch state machine.

The paper's constant-time discipline on the device: the pool is a
free-*stack* of block ids plus a stack pointer; ``alloc``/``free`` are
fixed-shape gathers/scatters whose cost is O(R) for R requests and
independent of the pool size m (no scans over the pool, no
compaction).  Counterpart of the JAX package's ``core/block_pool.py``,
op for op and grant for grant.

Every op is batched over any leading axes: a pool whose leaves carry a
leading ``[DP]`` axis (``free_ids [DP, m]``, ``top [DP]``) is DP
independent pools, and the same code serves the single pool (``top``
a 0-d tensor).  That is how the ``*_dp`` variants of
:mod:`.hier_pool` run without a vmap.  Request tensors carry the same
leading axes as the pool.

Three differences from JAX are handled here once, in the helpers:

* a scatter whose JAX form drops out-of-range indices
  (``mode="drop"``) writes through a sentinel column that is sliced
  off (torch raises on an out-of-range index instead of dropping);
* a gather clamps its indices into range, as a JAX gather does;
* integer reductions keep int32 (torch promotes them to int64).

NULL = -1 ids mark failed/masked allocations.  Refcounts are int16,
as in the reference; scatter-adds run in int32 and narrow back, which
wraps exactly as the int16 add does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

NULL = -1
I32 = torch.int32
I16 = torch.int16
_I32_MAX = 2 ** 31 - 1


class BlockPool(NamedTuple):
    """free_ids[..., 0:top] are the available block ids (a stack)."""

    free_ids: torch.Tensor   # int32[..., m]
    top: torch.Tensor        # int32[...] — number of free blocks
    refcount: torch.Tensor   # int16[..., m] — live references (0 = free)


# ------------------------------------------------------------ helpers

def _lead(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Flatten ``t``'s trailing axes so it carries exactly ``like``'s
    leading (batch) axes plus one request axis."""
    nb = like.dim() - 1
    return t.reshape(t.shape[:nb] + (-1,))


def take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[..., idx]`` along the last axis with JAX's clamped gather:
    idx [..., R] (or [..., R, K], flattened) over a [..., m]."""
    n = a.shape[-1]
    flat = _lead(idx, a).clamp(0, n - 1).long()
    return a.gather(-1, flat).reshape(idx.shape)


def put(a: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """Functional ``a.at[..., idx].set(src, mode="drop")`` along the
    last axis: indices outside [0, m) land in a sentinel column that is
    sliced off.  ``idx``/``src`` carry ``a``'s leading axes."""
    n = a.shape[-1]
    pad = torch.cat([a, a.new_zeros(a.shape[:-1] + (1,))], -1)
    idx = torch.where((idx >= 0) & (idx < n), idx, n).long()
    if not torch.is_tensor(src):
        src = torch.full_like(idx, src, dtype=a.dtype)
    pad.scatter_(-1, idx, src.to(a.dtype).expand(idx.shape))
    return pad[..., :n]


def _add(a: torch.Tensor, idx: torch.Tensor, delta: int) -> torch.Tensor:
    """Functional ``a.at[..., idx].add(delta, mode="drop")`` — duplicate
    ids add once each.  Runs in int32 and narrows back to a's dtype."""
    n = a.shape[-1]
    flat = _lead(idx, a)
    pad = torch.cat([a.to(I32), a.new_zeros(a.shape[:-1] + (1,), dtype=I32)],
                    -1)
    flat = torch.where((flat >= 0) & (flat < n), flat, n).long()
    pad.scatter_add_(-1, flat, torch.full_like(flat, delta, dtype=I32))
    return pad[..., :n].to(a.dtype)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(I32), -1, dtype=I32)


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32).sum(-1, dtype=I32)


# ---------------------------------------------------------------- ops

def create(num_blocks: int, device="cuda") -> BlockPool:
    return BlockPool(
        free_ids=torch.arange(num_blocks - 1, -1, -1, dtype=I32,
                              device=device),
        top=torch.full((), num_blocks, dtype=I32, device=device),
        refcount=torch.zeros((num_blocks,), dtype=I16, device=device),
    )


def num_live(pool: BlockPool) -> torch.Tensor:
    """Blocks with at least one reference (each counted once)."""
    return (pool.refcount > 0).to(I32).sum(dtype=I32)


def num_live_rows(refcount: torch.Tensor) -> torch.Tensor:
    """Per-row live-block counts: int16[..., m] -> int32[...] (each
    shard's conservation check runs on its own row)."""
    return _count(refcount > 0)


def _set_ref(refcount: torch.Tensor, ids: torch.Tensor, value: int
             ) -> torch.Tensor:
    """refcount[id] = value for valid ids (NULL / out-of-range dropped)."""
    return put(refcount, _lead(ids, refcount), value)


def addref(pool: BlockPool, ids: torch.Tensor) -> BlockPool:
    """Register one extra reference per valid id (NULL = no-op);
    duplicate ids in one call add one reference each."""
    return pool._replace(refcount=_add(pool.refcount, ids, 1))


def alloc(pool: BlockPool, mask: torch.Tensor
          ) -> Tuple[BlockPool, torch.Tensor]:
    """Allocate one block per True slot of ``mask`` (bool[..., R]).

    ids = NULL where mask is False or the pool ran short (all-or-nothing
    per slot, in slot order).  Granted blocks start with refcount 1."""
    m = mask.to(I32)
    rank = _cumsum(m) * m                       # 1-based rank
    top = pool.top[..., None]
    take_ = (m == 1) & (rank <= top)
    idx = torch.where(take_, top - rank, 0)
    ids = torch.where(take_, take(pool.free_ids, idx), NULL).to(I32)
    refcount = _set_ref(pool.refcount, ids, 1)
    return BlockPool(pool.free_ids, pool.top - _count(take_), refcount), ids


def _take_n(pool: BlockPool, counts: torch.Tensor,
            max_per_slot: int) -> Tuple[BlockPool, torch.Tensor]:
    """alloc_n without the refcount stamp — the pool-internal transfer
    used by lane refills (blocks stay free, just change stacks)."""
    counts = counts.to(I32).clamp(0, max_per_slot)
    R = counts.shape[-1]
    k = torch.arange(max_per_slot, dtype=I32, device=counts.device)
    want = k < counts[..., None]                          # [..., R, K]
    have = _cumsum(counts) <= pool.top[..., None]         # prefix-feasible
    take_ = want & have[..., None]
    flat = take_.reshape(take_.shape[:-2] + (R * max_per_slot,)).to(I32)
    rank = (_cumsum(flat) * flat).reshape(take_.shape)    # 1-based
    idx = torch.where(take_, pool.top[..., None, None] - rank, 0)
    ids = torch.where(take_, take(pool.free_ids, idx), NULL).to(I32)
    return pool._replace(top=pool.top - _count(flat)), ids


def alloc_n(pool: BlockPool, counts: torch.Tensor,
            max_per_slot: int) -> Tuple[BlockPool, torch.Tensor]:
    """Allocate ``counts[..., i]`` blocks for slot i in one fixed-shape
    gather: ids [..., R, max_per_slot], NULL padded.  Prefix grants in
    slot order, refcount 1 on every granted block."""
    pool, ids = _take_n(pool, counts, max_per_slot)
    return pool._replace(refcount=_set_ref(pool.refcount, ids, 1)), ids


def chunk_page_plan(seq_lens: torch.Tensor, lens: torch.Tensor, psz: int,
                    maxp: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Page demand for appending ``lens`` tokens per sequence: (lens,
    pages_before, counts), lens zeroed where the chunk would overflow a
    ``maxp``-page table (the all-or-nothing append contract)."""
    lens = torch.where((seq_lens + lens + psz - 1) // psz <= maxp, lens, 0)
    pages_before = (seq_lens + psz - 1) // psz
    counts = (seq_lens + lens + psz - 1) // psz - pages_before
    return lens, pages_before, counts


def granted_mask(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Did :func:`alloc_n` grant a request in full?  Prefix-grant
    semantics make one probe of the last needed id sufficient.
    ids: [..., K]; counts: [...] -> bool[...]."""
    last = take(ids, (counts - 1).clamp(min=0)[..., None])[..., 0]
    return (counts == 0) | (last >= 0)


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """bool[..., R]: True where ids is the first occurrence of its value
    among the valid entries of its row (stable sort + adjacent compare,
    O(R log R), independent of m)."""
    valid = ids >= 0
    key = torch.where(valid, ids, _I32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    sk = key.gather(-1, order)
    lead = torch.cat([torch.ones_like(sk[..., :1], dtype=torch.bool),
                      sk[..., 1:] != sk[..., :-1]], -1)
    first = torch.zeros_like(valid).scatter(-1, order, lead)
    return first & valid


def release_plan(refcount: torch.Tensor, ids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop one reference per valid id (ids [..., R]); return
    (new_refcount, released) where released marks, exactly once per
    block, the entries whose block reached refcount zero here."""
    valid = ids >= 0
    refcount = _add(refcount, ids, -1)
    now_zero = take(refcount, torch.where(valid, ids, 0)) == 0
    return refcount, valid & now_zero & _first_occurrence(ids)


def _push(pool: BlockPool, ids: torch.Tensor) -> BlockPool:
    """Push valid ids [..., R] onto the free stack (callers guarantee
    the blocks are free; overflow past m is dropped, as in JAX)."""
    valid = ids >= 0
    rank = _cumsum(valid) * valid                       # 1-based
    pos = torch.where(valid, pool.top[..., None] + rank - 1,
                      pool.free_ids.shape[-1])
    return pool._replace(free_ids=put(pool.free_ids, pos, ids),
                         top=pool.top + _count(valid))


def free(pool: BlockPool, ids: torch.Tensor) -> BlockPool:
    """Drop one reference per valid id; blocks whose refcount reaches
    zero return to the free stack, each exactly once."""
    flat = _lead(ids, pool.free_ids)
    refcount, released = release_plan(pool.refcount, flat)
    return _push(pool._replace(refcount=refcount),
                 torch.where(released, flat, NULL))


def _window(pool: BlockPool, start: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the ``n``-wide window at ``start``, clamped into the
    stack as ``dynamic_slice`` / ``dynamic_update_slice`` clamp it."""
    m = pool.free_ids.shape[-1]
    start = start.clamp(0, m - n)
    return start[..., None] + torch.arange(n, dtype=I32,
                                           device=start.device)


def alloc_batch(pool: BlockPool, n: int) -> Tuple[BlockPool, torch.Tensor]:
    """Take a contiguous batch of exactly ``n`` free ids (all NULL if the
    pool holds fewer).  Pool-internal: refcounts untouched."""
    ok = pool.top >= n
    ids = take(pool.free_ids, _window(pool, (pool.top - n).clamp(min=0), n))
    ids = torch.where(ok[..., None], ids, NULL).to(I32)
    return pool._replace(top=torch.where(ok, pool.top - n, pool.top)), ids


def free_batch(pool: BlockPool, ids: torch.Tensor) -> BlockPool:
    """Return a full batch of free blocks (all ids valid or all NULL).
    Pool-internal: refcounts untouched."""
    n = ids.shape[-1]
    ok = ids[..., 0] >= 0
    updated = put(pool.free_ids, _window(pool, pool.top, n), ids)
    return pool._replace(
        free_ids=torch.where(ok[..., None], updated, pool.free_ids),
        top=torch.where(ok, pool.top + n, pool.top))
