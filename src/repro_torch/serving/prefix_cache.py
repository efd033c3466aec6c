"""Prefix sharing: host-side radix trie + device-side share/COW step,
and the continuation store that drafts speculative tokens.

Counterpart of the JAX package's ``serving/prefix_cache.py`` for live
donors.  Identical prompt prefixes of concurrent requests map onto the
same physical KV pages, so a hot system prompt is stored once, not once
per slot.

* :class:`PrefixCache` — a host-side radix trie over the prompts of
  live slots, one level per ``page_size`` tokens.  It answers with a
  donor slot and a token count, never a page id: page ids stay on the
  device, and the host never reads tables back.
* :func:`share_prefix_step` — one device step per admission with a
  match, off the per-token path: copy the donor's full-page table
  entries into the new slot's row, add one reference to each, and
  copy-on-write the one partial page the new slot will append into.
* :class:`SpeculationStore` — the continuation history of hot
  prefixes, the host-side draft model of speculative decoding.

Pinned prefixes keep a finished prefix's pages alive by giving the
cache its own reference on each page: :func:`pin_prefix_step` copies
the first ``n_pages`` of a live slot's table into a device pin-table
row and adds one reference to each, so the slot's release drops them
to refcount 1 (cache-owned) instead of 0.  The trie holds pinned rows
as donors under negative pseudo-slot ids, and :func:`share_pinned_step`
maps one into a new slot exactly as :func:`share_prefix_step` maps a
live donor, COW copy included.  :func:`unpin_step` drops the cache's
references (eviction); :class:`PinnedPrefixes` is the host ledger (LRU
order, per-shard page budget, row assignment) the scheduler drives.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import classed_pool
from ..core.block_pool import I32, NULL
from ..core.classed_pool import CLS_KV


# ------------------------------------------------------------- host trie

#: Pinned entries live in the same trie as live slots, keyed by
#: negative pseudo-slot ids: pin_id 0, 1, 2, ... <-> -2, -3, -4, ...
#: (-1 reads as NULL on the device).
PIN_BASE = -2


def pin_pseudo_slot(pin_id: int) -> int:
    return PIN_BASE - pin_id


def pin_id_of(pseudo_slot: int) -> int:
    return PIN_BASE - pseudo_slot


@dataclasses.dataclass
class Match:
    slot: int        # donor slot (engine-global index; < 0 = pinned row)
    shard: int       # DP shard both slots must live on
    n_tokens: int    # shareable prefix length (tokens, host-verified)

    @property
    def pinned(self) -> bool:
        return self.slot < 0


class _Node:
    __slots__ = ("children", "slots")

    def __init__(self):
        self.children: Dict[tuple, _Node] = {}
        self.slots: set = set()


class PrefixCache:
    """Radix trie of live prompt prefixes, one level per page.

    ``completed[slot]`` tracks how many prompt tokens of a slot are
    in device KV (fed through completed steps); matches never exceed
    it, so a donor mid-prefill only donates what it has written.
    Entries leave the trie when their request finishes — pages a sharer
    still maps stay alive through their refcount, and the sharer itself
    remains a donor for the common prefix.
    """

    def __init__(self, page_size: int):
        self.psz = int(page_size)
        self.roots: Dict[int, _Node] = {}
        self.tokens: Dict[int, List[int]] = {}
        self.shard_of: Dict[int, int] = {}
        self.completed: Dict[int, int] = {}
        #: set by the engine: the Telemetry facade (trie hit/miss
        #: counters); None keeps the cache usable standalone
        self.telemetry = None

    def _pages(self, tokens: Sequence[int]):
        for i in range(len(tokens) // self.psz):
            yield tuple(tokens[i * self.psz:(i + 1) * self.psz])

    def insert(self, slot: int, shard: int, tokens: Sequence[int]) -> None:
        self.tokens[slot] = list(tokens)
        self.shard_of[slot] = shard
        self.completed[slot] = 0
        node = self.roots.setdefault(shard, _Node())
        for key in self._pages(tokens):
            node = node.children.setdefault(key, _Node())
            node.slots.add(slot)

    def update_progress(self, slot: int, n_in_kv: int) -> None:
        if slot in self.completed:
            n = min(int(n_in_kv), len(self.tokens[slot]))
            self.completed[slot] = max(self.completed[slot], n)

    def remove(self, slot: int) -> None:
        tokens = self.tokens.pop(slot, None)
        if tokens is None:
            return
        shard = self.shard_of.pop(slot)
        self.completed.pop(slot, None)
        node = self.roots.get(shard)
        path = []
        for key in self._pages(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.slots.discard(slot)
            path.append((node, key, child))
            node = child
        for parent, key, child in reversed(path):   # prune empty branches
            if not child.slots and not child.children:
                del parent.children[key]

    def live_slots(self) -> int:
        return len(self.tokens)

    def pin_insert(self, pin_id: int, shard: int,
                   tokens: Sequence[int]) -> None:
        """Register a pinned prefix as a donor.  ``tokens`` is the exact
        whole-page prefix the pin row holds, resident by construction,
        so its completion is its length."""
        pseudo = pin_pseudo_slot(pin_id)
        self.insert(pseudo, shard, tokens)
        self.completed[pseudo] = len(tokens)

    def pin_remove(self, pin_id: int) -> None:
        self.remove(pin_pseudo_slot(pin_id))

    def match(self, tokens: Sequence[int],
              shard: Optional[int] = None) -> Optional[Match]:
        """Longest shareable prefix of ``tokens`` among live prompts.

        Walks the trie page by page, then extends into the donor's
        partial page token by token.  The result is capped at the
        donor's completed (in-KV) length and at ``len(tokens) - 1``: the
        last prompt token is always fed, so the new slot has a position
        to take its first output from.  None below one full page.

        ``shard`` restricts the search to that shard's sub-trie: page
        ids are private to a DP shard, so a donor on another shard is
        unusable even on an exact key match.  The scheduler always
        restricts; ``shard=None`` (best across shards) is a diagnostic.
        """
        limit = len(tokens) - 1
        if limit < self.psz:
            return None
        best: Optional[Match] = None
        if shard is None:
            roots = self.roots.items()
        else:
            root = self.roots.get(shard)
            roots = [] if root is None else [(shard, root)]
        for shard, root in roots:
            depth_of: Dict[int, int] = {}       # slot -> deepest page match
            node = root
            for i, key in enumerate(self._pages(tokens)):
                node = node.children.get(key)
                if node is None:
                    break
                for s in node.slots:
                    depth_of[s] = i + 1
            for s, d in depth_of.items():
                ent = self.tokens[s]
                n = d * self.psz
                while n < len(tokens) and n < len(ent) and tokens[n] == ent[n]:
                    n += 1
                n = min(n, self.completed[s], limit)
                if (best is None or n > best.n_tokens
                        or (n == best.n_tokens and best.slot < 0 <= s)):
                    # a tie prefers a live donor over a pinned row (the
                    # same pages either way)
                    best = Match(slot=s, shard=shard, n_tokens=n)
        if best is None or best.n_tokens < self.psz:
            if self.telemetry is not None:
                self.telemetry.inc("trie_misses")
            return None
        if self.telemetry is not None:
            self.telemetry.inc("trie_hits")
        return best


# ---------------------------------------------- speculative continuations

class SpeculationStore:
    """Continuation history of hot prefixes: the host-side draft model
    of speculative decoding.

    A *key* is a whole-page prompt prefix.  Each finished request whose
    prompt starts with the key records its continuation (prompt tail
    beyond the key plus every generated token), and a later slot at
    context ``key + suffix`` drafts the next ``k`` tokens from the
    newest recorded stream consistent with its suffix.  Drafting never
    reads device state, and a wrong draft costs only the rejected
    lane's rolled-back pages.  Bounded: ``keep`` streams per key (newest
    win), ``max_keys`` keys (LRU).
    """

    def __init__(self, page_size: int, keep: int = 4, max_keys: int = 64,
                 ngram: int = 3, ewma_alpha: float = 0.3):
        self.psz = int(page_size)
        self.keep = int(keep)
        self.max_keys = int(max_keys)
        self.ngram = int(ngram)
        self.ewma_alpha = float(ewma_alpha)
        self.streams: Dict[tuple, List[tuple]] = {}
        self._accept: Dict[tuple, float] = {}   # per-key accept-rate EWMA
        self._lru: Dict[tuple, int] = {}
        self._clock = itertools.count()

    def key_of(self, prompt: Sequence[int]) -> Optional[tuple]:
        """The whole-page prefix key of a prompt (None below one page)."""
        n = (len(prompt) // self.psz) * self.psz
        return tuple(prompt[:n]) if n >= self.psz else None

    def record(self, key: tuple, continuation: Sequence[int]) -> None:
        rows = self.streams.setdefault(key, [])
        cont = tuple(continuation)
        if cont in rows:
            rows.remove(cont)
        rows.append(cont)                       # newest last (wins lookup)
        del rows[:-self.keep]
        self._lru[key] = next(self._clock)
        while len(self.streams) > self.max_keys:
            cold = min(self._lru, key=self._lru.get)
            del self.streams[cold], self._lru[cold]
            self._accept.pop(cold, None)

    def observe(self, key: tuple, drafted: int, accepted: int) -> None:
        """Fold one verified lane's accept fraction into the key's EWMA
        (the engine's break-even gate reads it)."""
        if drafted <= 0:
            return
        r = min(max(accepted / drafted, 0.0), 1.0)
        prev = self._accept.get(key)
        self._accept[key] = r if prev is None else (
            (1.0 - self.ewma_alpha) * prev + self.ewma_alpha * r)

    def accept_rate(self, key: tuple) -> Optional[float]:
        """EWMA accept rate for a key, or None before any observation."""
        return self._accept.get(key)

    def draft(self, key: tuple, suffix: Sequence[int],
              k: int) -> List[int]:
        """Up to ``k`` draft tokens for a slot at context key+suffix.

        Exact-suffix replay first: the newest stream whose continuation
        starts with the slot's whole suffix wins.  Otherwise an n-gram
        fallback matches the suffix's last g tokens (g = ngram down to
        1) anywhere in a recorded stream, newest stream first,
        rightmost occurrence first, and drafts what followed there.  No
        history drafts nothing.
        """
        if k <= 0:
            return []
        rows = self.streams.get(key)
        if not rows:
            return []
        suffix = tuple(suffix)
        n = len(suffix)
        for cont in reversed(rows):
            if cont[:n] == suffix and len(cont) > n:
                self._lru[key] = next(self._clock)
                return list(cont[n:n + k])
        for g in range(min(self.ngram, n), 0, -1):
            tail = suffix[-g:]
            for cont in reversed(rows):
                for i in range(len(cont) - g, -1, -1):
                    if cont[i:i + g] == tail and i + g < len(cont):
                        self._lru[key] = next(self._clock)
                        return list(cont[i + g:i + g + k])
        return []

    # -- warm restart (engine.save_warm / restore_warm) ------------------
    def to_state(self) -> list:
        """JSON-able snapshot, LRU-coldest key first, so that
        ``load_state``'s re-recording reproduces the eviction order;
        carries the accept-rate EWMA, so the gate stays warm."""
        keys = sorted(self.streams, key=lambda k: self._lru[k])
        return [[[int(t) for t in k],
                 [[int(t) for t in c] for c in self.streams[k]],
                 self._accept.get(k)]
                for k in keys]

    def load_state(self, rows: list) -> None:
        self.streams.clear()
        self._lru.clear()
        self._accept.clear()
        for row in rows:
            key, conts = row[0], row[1]
            kt = tuple(int(t) for t in key)
            for c in conts:
                self.record(kt, tuple(int(t) for t in c))
            if len(row) > 2 and row[2] is not None:
                self._accept[kt] = float(row[2])


# --------------------------------------------------- pinned host ledger

class PinnedPrefixes:
    """Host ledger of cache-owned (pinned) prefixes.

    Bookkeeping only: the pages live behind the device pin table and the
    pool's refcounts.  It answers the scheduler's policy questions (a
    free row, the LRU pin, the pages the cache holds on a shard) when it
    pins, evicts under the per-shard ``budget_pages``, or sheds pins on
    pool pressure.  pin_id = shard * rows_per_shard + row, unique and
    stable for a pin's lifetime.
    """

    def __init__(self, n_shards: int, rows_per_shard: int,
                 budget_pages: int):
        self.n_shards = n_shards
        self.npin = int(rows_per_shard)
        self.budget = int(budget_pages)
        self.entries: Dict[int, dict] = {}          # pin_id -> entry
        self.free_rows = {s: set(range(self.npin)) for s in range(n_shards)}
        self.by_key: Dict[Tuple[int, tuple], int] = {}
        self._clock = itertools.count()

    def pages_on(self, shard: int) -> int:
        return sum(e["pages"] for e in self.entries.values()
                   if e["shard"] == shard)

    def total_pages(self) -> int:
        return sum(e["pages"] for e in self.entries.values())

    def lookup(self, shard: int, tokens: Sequence[int]) -> Optional[int]:
        return self.by_key.get((shard, tuple(tokens)))

    def lru(self, shard: int) -> Optional[int]:
        cands = [(e["used"], pid) for pid, e in self.entries.items()
                 if e["shard"] == shard]
        return min(cands)[1] if cands else None

    def fits(self, shard: int, pages: int) -> bool:
        return self.pages_on(shard) + pages <= self.budget

    def add(self, shard: int, tokens: Sequence[int], pages: int) -> int:
        row = min(self.free_rows[shard])            # caller checked free
        self.free_rows[shard].discard(row)
        pin_id = shard * self.npin + row
        self.entries[pin_id] = {"shard": shard, "row": row,
                                "tokens": tuple(tokens), "pages": pages,
                                "used": next(self._clock)}
        self.by_key[(shard, tuple(tokens))] = pin_id
        return pin_id

    def has_free_row(self, shard: int) -> bool:
        return bool(self.free_rows[shard])

    def remove(self, pin_id: int) -> Tuple[int, int]:
        e = self.entries.pop(pin_id)
        self.free_rows[e["shard"]].add(e["row"])
        self.by_key.pop((e["shard"], e["tokens"]), None)
        return e["shard"], e["row"]

    def touch(self, pin_id: int) -> None:
        if pin_id in self.entries:
            self.entries[pin_id]["used"] = next(self._clock)

    def to_state(self) -> list:
        """JSON-able snapshot, LRU-coldest entry first."""
        ents = sorted(self.entries.items(), key=lambda kv: kv[1]["used"])
        return [{"pin_id": int(pid), "shard": int(e["shard"]),
                 "row": int(e["row"]),
                 "tokens": [int(t) for t in e["tokens"]],
                 "pages": int(e["pages"])} for pid, e in ents]

    def load_state(self, entries: list) -> None:
        """Rebuild the ledger at its exact rows: a restored pin table
        references those rows, so a pin comes back where its pages
        are."""
        self.entries.clear()
        self.by_key.clear()
        self.free_rows = {s: set(range(self.npin))
                          for s in range(self.n_shards)}
        for e in entries:                       # LRU-coldest first
            shard, row = int(e["shard"]), int(e["row"])
            toks = tuple(int(t) for t in e["tokens"])
            pid = shard * self.npin + row
            self.free_rows[shard].discard(row)
            self.entries[pid] = {"shard": shard, "row": row,
                                 "tokens": toks, "pages": int(e["pages"]),
                                 "used": next(self._clock)}
            self.by_key[(shard, toks)] = pid


# --------------------------------------------------------- device steps

def share_prefix_step(psz: int, state, dst_oh, src_oh, n_tokens: int):
    """Map ``n_tokens`` of the src slot's prefix into the dst slot.

    dst_oh / src_oh: bool [DP, Bl] one-hots on the SAME shard; n_tokens
    (>= 1, host-capped at the donor's completed length and the
    page-table capacity).  Called once per admission with a match, off
    the per-token path.  Returns ``(state, ok)``, ok a 0-d bool tensor.

    Protocol (all or nothing, ``ok`` reports the outcome):
      1. full pages [0, n_tokens // psz) of the donor's table are
         copied into the dst row and each gains a reference;
      2. if the prefix ends mid-page, a fresh page comes from the
         SHARED pool (admission-time bulk; the slot's private lane
         keeps its >= ell stock, the §4.2 never-dry budget of its next
         chunk) and the donor's partial page is copied into it in every
         paged layer, in place (copy-on-write: the dst slot appends
         into its private copy, never into the shared page);
      3. seq_lens[dst] = n_tokens, so the engine feeds only the rest
         of the prompt.
    """
    src_row = torch.where(src_oh[..., None], state.page_tables, 0).sum(
        (0, 1), dtype=I32)                                        # [maxp]
    return _share_from_row(psz, state, dst_oh, src_row, n_tokens)


def share_pinned_step(psz: int, state, pin_tables, dst_oh, pin_oh,
                      n_tokens: int):
    """:func:`share_prefix_step` with a pinned row as the donor.

    pin_oh: bool [DP, Npin] one-hot on the dst shard.  The row's pages
    are live (cache-owned refcount >= 1) with their KV resident, and the
    row is NULL beyond its pinned pages, so the same protocol applies,
    COW copy included."""
    src_row = torch.where(pin_oh[..., None], pin_tables, 0).sum(
        (0, 1), dtype=I32)                                        # [maxp]
    return _share_from_row(psz, state, dst_oh, src_row, n_tokens)


def _share_from_row(psz: int, state, dst_oh, src_row, n_tokens: int):
    """Shared body: map a donor table row into the dst slot (see
    :func:`share_prefix_step` for the protocol).  The reference's
    dropped scatter of the COW copy (``mode="drop"``) writes to each
    shard's sink page here."""
    DP, Bl, maxp = state.page_tables.shape
    n = int(n_tokens)
    fp, partial = divmod(n, psz)                  # full pages, COW tokens
    k = torch.arange(maxp, dtype=I32, device=src_row.device)
    np_needed = -(-n // psz)
    donor_ok = src_row[min(max(np_needed - 1, 0), maxp - 1)] >= 0
    shard_mask = dst_oh.any(1)                                    # [DP]

    # COW page for the partial tail, from the SHARED pool
    want = dst_oh & donor_ok & (partial > 0)
    pool, fresh = classed_pool.alloc_from_shared_dp(
        state.pool, CLS_KV, want.to(I32), 1)
    fresh = fresh[..., 0]                                         # [DP, Bl]
    ok = donor_ok & ((partial == 0) | (fresh >= 0).any())

    # the extra references on the donor's full pages
    shared_ids = torch.where((k < fp) & ok, src_row, NULL)
    ids_dp = torch.where(shard_mask[:, None], shared_ids[None, :], NULL)
    pool = classed_pool.addref_dp(pool, CLS_KV, ids_dp)

    # dst table row: the donor's full pages, then the fresh partial copy
    row = torch.where(k < fp, src_row, state.page_tables)
    row = torch.where((k == fp) & (partial > 0) & (fresh[..., None] >= 0),
                      fresh[..., None], row)
    page_tables = torch.where(dst_oh[..., None] & ok, row, state.page_tables)

    if partial:
        # copy the donor's partial page into the fresh page, every
        # layer; shards without a copy write to their sink page
        src_pid = src_row[min(fp, maxp - 1)].clamp(min=0).long()
        fresh_shard = torch.where(want, fresh, NULL).max(1).values  # [DP]
        sink = classed_pool.pages_local(state.pool, CLS_KV)
        tgt = torch.where(shard_mask & ok & (fresh_shard >= 0),
                          fresh_shard, sink).long()
        d = torch.arange(DP, device=tgt.device)
        src = src_pid.expand(DP)
        for pages in state.kv_pages.values():
            for pg in pages:                      # [S, DP, P + 1, psz, KH, hd]
                pg[:, d, tgt] = pg[:, d, src]
    seq_lens = torch.where(dst_oh & ok, n, state.seq_lens)
    return state._replace(page_tables=page_tables, seq_lens=seq_lens,
                          pool=pool), ok


def pin_prefix_step(pool, pin_tables, page_tables, pin_oh, src_oh,
                    n_pages: int):
    """Pin the first ``n_pages`` of a live slot's table into a pin row.

    pin_oh: bool [DP, Npin] one-hot naming the (free) destination row;
    src_oh: bool [DP, Bl] one-hot naming the live source slot on the
    same shard; n_pages >= 1, whole pages only (a partial page is still
    appended into).  The cache takes one reference per pinned page, so
    the slot's later release leaves them at refcount 1: alive, content
    intact, donatable.  Returns ``(pool, pin_tables)``."""
    maxp = pin_tables.shape[2]
    k = torch.arange(maxp, dtype=I32, device=pin_tables.device)
    src_row = torch.where(src_oh[..., None], page_tables, 0).sum(
        (0, 1), dtype=I32)                                        # [maxp]
    row = torch.where(k < int(n_pages), src_row, NULL)
    shard_mask = pin_oh.any(1)                                    # [DP]
    ids_dp = torch.where(shard_mask[:, None], row[None, :], NULL)
    pool = classed_pool.addref_dp(pool, CLS_KV, ids_dp)
    pin_tables = torch.where(pin_oh[..., None], row[None, None, :],
                             pin_tables)
    return pool, pin_tables


def unpin_step(pool, pin_tables, pin_oh):
    """Evict pinned rows: drop the cache's references, clear the rows.

    pin_oh: bool [DP, Npin] (any rows, any shards).  Pages reaching
    refcount zero return to the shard's SHARED stack (pin rows belong to
    no lane; the per-step rebalance redistributes); pages a live sharer
    still maps just lose the cache's reference.  Returns ``(pool,
    pin_tables)``."""
    DP = pin_tables.shape[0]
    ids = torch.where(pin_oh[..., None], pin_tables, NULL)
    pool = classed_pool.free_shared_dp(pool, CLS_KV, ids.reshape(DP, -1))
    pin_tables = torch.where(pin_oh[..., None], NULL, pin_tables)
    return pool, pin_tables
