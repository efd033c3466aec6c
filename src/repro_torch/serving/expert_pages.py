"""Expert-paged MoE serving: the CLS_EXPERT plane.

Counterpart of the JAX package's ``serving/expert_pages.py``.  Expert
FFN weights are read-only pages in the classed pool's third size class.
Residency follows the addref/free_shared protocol pinned prefixes use
(serving/prefix_cache.py): an expert is a read-only shared object whose
refcount counts its owners,

* **one cache-owned reference** held by the host :class:`ExpertLedger`
  while the expert is resident (the pin analogue: it keeps the pages
  off the free stacks between requests);
* **one reference per active slot** whose admitted footprint contains
  the expert, taken in bulk at admission by :func:`expert_ref_step` and
  dropped after the step's status read when the slot releases, never
  inside the serve step, which stays one transfer.

Eviction (:func:`expert_evict_step`) is ``unpin_step`` shaped: drop the
cache's references and NULL the table row; a page some active slot
still references only loses one reference.  The ledger runs LRU over
*cold* experts (no active slot references).

Weight layout: one expert is ``EXPERT_PPE`` pages (w_gate, w_up,
w_down), each ``d_model * d_ff`` elements flat.  A load pulls its pages
from the class's shared stack in one bulk
:func:`~repro_torch.core.classed_pool.alloc_from_shared_dp` grant,
admission-time traffic covered by the class's §4.2 slack as long as
admission respects the page budget (``ServingEngine.expert_headroom``).

The device steps change the pages and the expert tables in place and
replace the pool, as the port's other steps do; none reads anything
back to the host.  The host backing store is a CPU tensor per table
position, pinned when the engine serves on a card, so a load is one
asynchronous copy per page from it.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch

from ..core import classed_pool
from ..core.block_pool import NULL
from ..core.classed_pool import CLS_EXPERT
from ..models.transformer import EXPERT_PPE, moe_positions

WEIGHTS = ("w_gate", "w_up", "w_down")


# ------------------------------------------------------------ host weights

def build_host_experts(cfg, params, pin: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Host copy of every MoE layer slot's expert weights, keyed by
    expert-table position: ``pos -> [S, E, EXPERT_PPE, d_model*d_ff]``
    (S = n_groups for pattern positions, 1 for remainder ones) on the
    CPU in the weights' dtype, page-locked when ``pin``.  This is the
    backing store expert pages load from.  Each expert page is copied
    on its own, so a copy off the card needs no staging buffer larger
    than one page."""
    pat, rem = moe_positions(cfg)
    pe = cfg.d_model * cfg.d_ff
    E = cfg.moe.num_experts
    ffns = {pos: params["groups"][pos]["ffn"] for pos in pat}
    ffns.update({pos: {k: w[None] for k, w in
                       params["rem"][f"pos{pos[len('rem'):]}"]["ffn"].items()}
                 for pos in rem})
    out: Dict[str, torch.Tensor] = {}
    for pos, ffn in ffns.items():
        S = ffn["w_gate"].shape[0]
        host = torch.empty((S, E, EXPERT_PPE, pe), dtype=ffn["w_gate"].dtype,
                           pin_memory=pin)
        for i, k in enumerate(WEIGHTS):
            w = ffn[k].reshape(S, E, pe)
            for g in range(S):
                for e in range(E):
                    host[g, e, i].copy_(w[g, e])
        out[pos] = host
    return out


def stub_expert_params(params):
    """Replace every MoE position's expert-weight leaves with [..., 1, 1]
    zeros (the leading stack dims kept).  The paged FFN reads its
    weights from CLS_EXPERT pages and never these leaves: keeping the
    dense [E, d, f] stacks on the card would forfeit the memory paging
    buys."""
    def stub_layers(layers):
        out = dict(layers)
        for pos, lp in layers.items():
            ffn = lp.get("ffn") if isinstance(lp, dict) else None
            if isinstance(ffn, dict) and "router" in ffn:
                ffn = dict(ffn)
                for k in WEIGHTS:
                    w = ffn[k]
                    ffn[k] = torch.zeros(w.shape[:-2] + (1, 1),
                                         dtype=w.dtype, device=w.device)
                out[pos] = dict(lp, ffn=ffn)
        return out

    new = dict(params)
    for part in ("groups", "rem"):
        if isinstance(params.get(part), dict):
            new[part] = stub_layers(params[part])
    return new


# ------------------------------------------------------------ device steps

def expert_load_step(pos: str, state, counts, w, shard_oh, g: int, e: int):
    """Load one expert's pages on the shards of ``shard_oh``.

    Pulls ``EXPERT_PPE`` pages from CLS_EXPERT's shared stack (a bulk
    grant, like prefill loading), writes the expert's weight pages into
    them and maps row ``(g, e)`` of ``pos``'s expert table.  counts:
    int32 [DP, Bl] (EXPERT_PPE at (shard, 0), else 0); w: [EXPERT_PPE,
    page_elems] on the card; shard_oh: bool [DP].  A shard not selected,
    or a page not granted, writes to the sink page NB2.  The caller
    (ledger-driven admission) has checked budget headroom, so the grant
    cannot dry the shared stack below its §4.2 slack."""
    pool, ids = classed_pool.alloc_from_shared_dp(
        state.pool, CLS_EXPERT, counts, EXPERT_PPE)
    pids = ids[:, 0, :]                                    # [DP, PPE]
    pages = state.expert_pages                             # [DP, NB2+1, pe]
    DP = pages.shape[0]
    sel = shard_oh[:, None]
    tgt = torch.where(sel & (pids >= 0), pids, pages.shape[1] - 1).long()
    dp_i = torch.arange(DP, device=pages.device)[:, None].expand_as(tgt)
    pages.index_put_((dp_i, tgt),
                     w.to(pages.dtype)[None].expand(DP, *w.shape))
    tab = state.expert_tables[pos]                         # [S, DP, E, PPE]
    tab[g, :, e] = torch.where(sel, pids, tab[g, :, e])
    return state._replace(pool=pool)


def expert_evict_step(pos: str, state, shard_oh, g: int, e: int):
    """Eviction (the ``unpin_step`` analogue): drop the cache-owned
    references on one expert's pages and NULL its table row.  Pages an
    active slot still references only lose one reference; a page
    reaching zero returns to the shard's shared stack."""
    tab = state.expert_tables[pos]                         # [S, DP, E, PPE]
    sel = shard_oh[:, None]
    pool = classed_pool.free_shared_dp(
        state.pool, CLS_EXPERT, torch.where(sel, tab[g, :, e], NULL))
    tab[g, :, e] = torch.where(sel, NULL, tab[g, :, e])
    return state._replace(pool=pool)


def expert_ref_step(free: bool, state, masks, shard_oh):
    """Bulk reference traffic for one slot's whole expert footprint:
    addref (admission) or free_shared (release) every page of every
    selected expert across every table position, in one call.

    masks: dict pos -> bool [S, E] (the footprint, broadcast over
    groups); shard_oh: bool [DP].  NULL table entries are no-ops on
    both paths, so a footprint larger than the resident set is
    harmless, but admission loads every footprint expert first."""
    cols = []
    for pos in sorted(state.expert_tables):
        tab = state.expert_tables[pos]                     # [S, DP, E, PPE]
        DP = tab.shape[1]
        m = masks[pos][:, None, :] & shard_oh[None, :, None]  # [S, DP, E]
        ids = torch.where(m[..., None], tab, NULL)
        cols.append(ids.movedim(1, 0).reshape(DP, -1))
    ids = torch.cat(cols, dim=1)
    op = classed_pool.free_shared_dp if free else classed_pool.addref_dp
    return state._replace(pool=op(state.pool, CLS_EXPERT, ids))


# ------------------------------------------------------------- host ledger

class ExpertLedger:
    """Host-side ledger of CLS_EXPERT residency (the
    :class:`~repro_torch.serving.prefix_cache.PinnedPrefixes` analogue).

    Pure bookkeeping: pages live behind the expert tables and the pool
    refcounts; this class answers admission's questions.  Is (shard,
    pos, group, expert) resident, how many pages does the cache hold on
    a shard, how many of those are *evictable* (no active slot routes
    through them), and which cold expert is least recently used.
    ``batch`` mirrors the per-slot references the pool carries; an
    expert with ``batch > 0`` is never an eviction candidate."""

    def __init__(self, n_shards: int, budget_pages: int):
        self.n_shards = int(n_shards)
        self.budget = int(budget_pages)
        #: (shard, pos, g, e) -> {"batch": int, "used": clock}
        self.entries: Dict[Tuple[int, str, int, int], dict] = {}
        self._clock = itertools.count()

    @staticmethod
    def key(shard: int, pos: str, g: int, e: int):
        return (int(shard), pos, int(g), int(e))

    # -- queries --------------------------------------------------------
    def resident(self, shard: int, pos: str, g: int, e: int) -> bool:
        return self.key(shard, pos, g, e) in self.entries

    def pages_on(self, shard: int) -> int:
        return EXPERT_PPE * sum(1 for k in self.entries if k[0] == shard)

    def evictable_pages(self, shard: int) -> int:
        return EXPERT_PPE * sum(1 for k, e in self.entries.items()
                                if k[0] == shard and e["batch"] == 0)

    def lru(self, shard: int):
        """The least recently used *cold* expert on a shard (None if
        every resident expert has active references)."""
        cands = [(e["used"], k) for k, e in self.entries.items()
                 if k[0] == shard and e["batch"] == 0]
        return min(cands)[1] if cands else None

    def resident_count(self) -> int:
        return len(self.entries)

    # -- mutation -------------------------------------------------------
    def add(self, shard: int, pos: str, g: int, e: int) -> None:
        self.entries[self.key(shard, pos, g, e)] = {
            "batch": 0, "used": next(self._clock)}

    def remove(self, key) -> None:
        ent = self.entries.pop(key)
        assert ent["batch"] == 0, "evicting an expert with active refs"

    def addref(self, key) -> None:
        ent = self.entries[key]
        ent["batch"] += 1
        ent["used"] = next(self._clock)

    def deref(self, key) -> None:
        ent = self.entries.get(key)
        if ent is not None and ent["batch"] > 0:
            ent["batch"] -= 1

    def touch(self, key) -> None:
        if key in self.entries:
            self.entries[key]["used"] = next(self._clock)

    def drop_shard(self, shard: int) -> None:
        """A dead shard's expert pages are unreachable: they leave the
        ledger with the shard."""
        for k in [k for k in self.entries if k[0] == shard]:
            del self.entries[k]

    def clear(self) -> None:
        """Crash recovery: the pool reconcile reclaimed every CLS_EXPERT
        page (no keep rows survive a recovery), so the ledger starts
        empty and experts load again at the next admissions."""
        self.entries.clear()
