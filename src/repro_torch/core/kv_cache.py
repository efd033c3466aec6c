"""Paged KV cache built on the block pool — the allocator's main client.

Counterpart of the JAX package's ``core/kv_cache.py``, op for op: the
cache-level form of paging (vLLM-style), which no engine path imports
(the engine keeps its pages in the decode state,
``models/transformer.py``).  The KV store is a pool of fixed-size
*pages* of ``page_size`` tokens; each sequence owns a page table (a
row of page ids).  Appending a token is O(1) tensor ops; crossing a
page boundary allocates a page from :mod:`.block_pool` (constant time,
the paper's contribution).  Pages store K and V as ``[num_pages,
page_size, kv_heads, head_dim]``.

Every op is functional, as the reference's: it returns a new cache and
leaves its argument alone.  A JAX scatter with ``mode="drop"`` writes
here through a sink page past the last one, sliced off again
(:func:`_set_pages`); a JAX gather clamps its indices, and so do the
reads here.  Everything runs in torch ops on the cache's device and
launches none of the port's kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import block_pool
from .block_pool import NULL, BlockPool

I32 = torch.int32


class PagedKVCache(NamedTuple):
    pool: BlockPool              # page allocator
    k_pages: torch.Tensor        # [num_pages, page_size, kv_heads, head_dim]
    v_pages: torch.Tensor        # [num_pages, page_size, kv_heads, head_dim]
    page_tables: torch.Tensor    # int32[max_seqs, max_pages_per_seq]
    seq_lens: torch.Tensor       # int32[max_seqs] — tokens currently stored


def create(num_pages: int, page_size: int, kv_heads: int, head_dim: int,
           max_seqs: int, max_pages_per_seq: int,
           dtype=torch.bfloat16, device="cuda") -> PagedKVCache:
    shape = (num_pages, page_size, kv_heads, head_dim)
    return PagedKVCache(
        pool=block_pool.create(num_pages, device),
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_tables=torch.full((max_seqs, max_pages_per_seq), NULL,
                               dtype=I32, device=device),
        seq_lens=torch.zeros((max_seqs,), dtype=I32, device=device),
    )


def page_size(cache: PagedKVCache) -> int:
    return cache.k_pages.shape[1]


def _set_pages(pages: torch.Tensor, page_ids: torch.Tensor,
               values: torch.Tensor, pos: torch.Tensor = None
               ) -> torch.Tensor:
    """``pages.at[page_ids(, pos)].set(values, mode="drop")``: ids
    outside [0, num_pages) write to a sink page that is sliced off."""
    n = pages.shape[0]
    pad = torch.cat([pages, pages.new_zeros((1,) + pages.shape[1:])])
    ids = torch.where((page_ids >= 0) & (page_ids < n), page_ids, n).long()
    index = (ids,) if pos is None else (ids, pos.long())
    pad.index_put_(index, values.to(pages.dtype))
    return pad[:n]


def _row(table: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``table[rows, col]`` for one column a row, clamped as a JAX
    gather clamps."""
    return block_pool.take(table, col[:, None])[:, 0]


def append(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
           active: torch.Tensor) -> Tuple[PagedKVCache, torch.Tensor]:
    """Append one token of K/V per active sequence.

    k, v: [max_seqs, kv_heads, head_dim]; active: bool[max_seqs].
    Returns (cache, ok[max_seqs]) — ok False if a page allocation failed.
    O(max_seqs) work, independent of cache size (paper's discipline).
    """
    psz = page_size(cache)
    pos_in_page = cache.seq_lens % psz
    page_idx = cache.seq_lens // psz

    needs_page = active & (pos_in_page == 0)
    pool, new_ids = block_pool.alloc(cache.pool, needs_page)
    ok = torch.where(needs_page, new_ids >= 0, True) & active

    cur = _row(cache.page_tables, page_idx)
    page_tables = block_pool.put(
        cache.page_tables, page_idx[:, None],
        torch.where(needs_page & ok, new_ids, cur)[:, None])

    page_ids = _row(page_tables, page_idx)
    write = ok & (page_ids >= 0)
    tgt = torch.where(write, page_ids, cache.k_pages.shape[0])
    k_pages = _set_pages(cache.k_pages, tgt, k, pos_in_page)
    v_pages = _set_pages(cache.v_pages, tgt, v, pos_in_page)

    seq_lens = cache.seq_lens + write.to(I32)
    return PagedKVCache(pool, k_pages, v_pages, page_tables, seq_lens), ok


def append_chunk(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                 lens: torch.Tensor, active: torch.Tensor = None
                 ) -> Tuple[PagedKVCache, torch.Tensor]:
    """Append up to C tokens of K/V per sequence in one fixed-shape call.

    k, v: [max_seqs, C, kv_heads, head_dim]; lens: int32[max_seqs] —
    tokens to append per sequence (0 <= lens[s] <= C); active:
    bool[max_seqs] (default all).  Pages for the whole chunk
    (ceil(C/psz) worst case per sequence) are taken from the pool in ONE
    :func:`block_pool.alloc_n` call, so cost stays O(max_seqs * C),
    independent of the pool size m.  Returns (cache, ok[max_seqs]) — ok
    False where the allocation was denied or the chunk would overflow
    the page table; denied sequences append nothing (all-or-nothing).
    """
    S, C = k.shape[0], k.shape[1]
    psz = page_size(cache)
    maxp = cache.page_tables.shape[1]
    num_pages = cache.k_pages.shape[0]
    dev = k.device
    if active is None:
        active = torch.ones((S,), dtype=torch.bool, device=dev)
    L = cache.seq_lens
    n = torch.where(active, lens.to(I32).clamp(0, C), 0)
    asked = n
    n, pages_before, counts = block_pool.chunk_page_plan(L, n, psz, maxp)

    kmax = -(-C // psz)                            # ceil(C / psz), static
    pool, ids = block_pool.alloc_n(cache.pool, counts, kmax)
    ok = active & (n == asked) & block_pool.granted_mask(ids, counts)
    n = torch.where(ok, n, 0)

    kk = torch.arange(kmax, dtype=I32, device=dev)[None, :]
    slot = pages_before[:, None] + kk
    new_page = (kk < counts[:, None]) & ok[:, None] & (ids >= 0)
    slot = torch.where(new_page, slot, maxp)       # out-of-range => dropped
    page_tables = block_pool.put(cache.page_tables, slot, ids)

    t = torch.arange(C, dtype=I32, device=dev)[None, :]
    pos = L[:, None] + t                           # [S, C] absolute positions
    write = t < n[:, None]
    pid = block_pool.take(page_tables, (pos // psz).clamp(max=maxp - 1))
    write = write & (pid >= 0)
    pid = torch.where(write, pid, num_pages)       # out-of-range => dropped
    pip = pos % psz
    k_pages = _set_pages(cache.k_pages, pid, k, pip)
    v_pages = _set_pages(cache.v_pages, pid, v, pip)

    seq_lens = L + n
    return PagedKVCache(pool, k_pages, v_pages, page_tables, seq_lens), ok


def rollback(cache: PagedKVCache, n_tokens: torch.Tensor) -> PagedKVCache:
    """Un-append the last ``n_tokens[s]`` tokens of each sequence.

    The cache-level form of the serving step's speculative rollback: a
    rejected draft keeps its accepted prefix and returns exactly the
    whole-page over-allocation — pages that hold no remaining token —
    to the pool, in one fixed-shape release (:func:`block_pool.free`
    refcount semantics: a page another sequence still maps merely loses
    one reference).  The partial page the surviving prefix ends in stays
    mapped; its stale tail positions sit beyond ``seq_lens`` and are
    overwritten by the next append before any read can see them.
    O(max_seqs * max_pages_per_seq), independent of num_pages.
    """
    S, P = cache.page_tables.shape
    psz = page_size(cache)
    n = torch.minimum(n_tokens.to(I32).clamp(min=0), cache.seq_lens)
    new_len = cache.seq_lens - n
    keep_pages = (new_len + psz - 1) // psz
    have_pages = (cache.seq_lens + psz - 1) // psz
    k = torch.arange(P, dtype=I32, device=n.device)[None, :]
    roll = (k >= keep_pages[:, None]) & (k < have_pages[:, None])
    to_free = torch.where(roll, cache.page_tables, NULL)
    pool = block_pool.free(cache.pool, to_free.reshape(-1))
    page_tables = torch.where(roll, NULL, cache.page_tables)
    return PagedKVCache(pool, cache.k_pages, cache.v_pages,
                        page_tables, new_len)


def release(cache: PagedKVCache, seq_mask: torch.Tensor) -> PagedKVCache:
    """Release all pages of the masked sequences (one batch call).

    Each page loses one reference; pages still mapped by a
    prefix-sharing sibling stay live (release decrements instead of
    frees — :func:`block_pool.free`'s refcount semantics).
    O(max_seqs * max_pages_per_seq) scatter — independent of num_pages.
    """
    to_free = torch.where(seq_mask[:, None], cache.page_tables, NULL)
    pool = block_pool.free(cache.pool, to_free.reshape(-1))
    page_tables = torch.where(seq_mask[:, None], NULL, cache.page_tables)
    seq_lens = torch.where(seq_mask, 0, cache.seq_lens)
    return PagedKVCache(pool, cache.k_pages, cache.v_pages,
                        page_tables, seq_lens)


def share_prefix(cache: PagedKVCache, dst: int, src: int,
                 n_tokens) -> Tuple[PagedKVCache, torch.Tensor]:
    """Map ``n_tokens`` of seq ``src``'s prefix into seq ``dst`` (static
    dst/src, ``n_tokens`` an int or a 0-d tensor) — the refcount/COW
    protocol at the cache level.

    Full pages are shared: dst's table points at src's pages and each
    gains a reference (:func:`block_pool.addref`).  A partial tail page
    is copied-on-write: one fresh page from the pool, src's page
    content copied, so dst's first divergent append never touches the
    shared page.  seq_lens[dst] = n_tokens.  Returns (cache, ok) — ok
    False (nothing changed) if the COW allocation was denied or src's
    prefix is not resident.
    """
    psz = page_size(cache)
    maxp = cache.page_tables.shape[1]
    num_pages = cache.k_pages.shape[0]
    dev = cache.page_tables.device
    n_tokens = torch.as_tensor(n_tokens, dtype=I32, device=dev)
    fp = n_tokens // psz
    partial = n_tokens % psz
    src_row = cache.page_tables[src]
    np_needed = (n_tokens + psz - 1) // psz
    donor_ok = ((cache.seq_lens[src] >= n_tokens)
                & (src_row[(np_needed - 1).clamp(0, maxp - 1)] >= 0))

    want = torch.zeros(cache.seq_lens.shape, dtype=torch.bool, device=dev)
    want[dst] = (partial > 0) & donor_ok
    pool, fresh = block_pool.alloc(cache.pool, want)
    fresh_id = fresh[dst]
    ok = donor_ok & ((partial == 0) | (fresh_id >= 0))

    k = torch.arange(maxp, dtype=I32, device=dev)
    shared_ids = torch.where((k < fp) & ok, src_row, NULL)
    pool = block_pool.addref(pool, shared_ids)
    row = torch.where(k < fp, src_row, cache.page_tables[dst])
    row = torch.where((k == fp) & (partial > 0) & (fresh_id >= 0),
                      fresh_id, row)
    page_tables = cache.page_tables.clone()
    page_tables[dst] = torch.where(ok, row, cache.page_tables[dst])

    src_pid = src_row[fp.clamp(0, maxp - 1)].clamp(min=0)
    tgt = torch.where(ok & (partial > 0) & (fresh_id >= 0), fresh_id,
                      num_pages)                   # out-of-range => drop
    k_pages = _set_pages(cache.k_pages, tgt[None],
                         cache.k_pages[src_pid][None])
    v_pages = _set_pages(cache.v_pages, tgt[None],
                         cache.v_pages[src_pid][None])
    seq_lens = cache.seq_lens.clone()
    seq_lens[dst] = torch.where(ok, n_tokens, cache.seq_lens[dst])
    return PagedKVCache(pool, k_pages, v_pages, page_tables, seq_lens), ok


def gather_kv(cache: PagedKVCache, seq_id: int, max_len: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize a sequence's K/V up to max_len (reference path / tests).

    Production attention reads pages directly via the kernel; this is
    the plain oracle.  Returns (k, v [n_pages * psz, kv_heads,
    head_dim], valid bool[n_pages * psz])."""
    psz = page_size(cache)
    n_pages = -(-max_len // psz)   # round UP: a partial page still holds
    table = cache.page_tables[seq_id, :n_pages]   # live tokens; masking
    safe = table.clamp(min=0)                     # trims the tail
    k = cache.k_pages[safe].reshape(n_pages * psz, *cache.k_pages.shape[2:])
    v = cache.v_pages[safe].reshape(n_pages * psz, *cache.v_pages.shape[2:])
    pos = torch.arange(n_pages * psz, device=table.device)
    valid = ((pos < cache.seq_lens[seq_id]) & (pos < max_len)
             & torch.repeat_interleave(table >= 0, psz))
    return k, v, valid
