"""The page-grouped work schedule of the verify attention (K3).

:func:`build_verify_schedule` is the counterpart of the JAX package's
``kernels/verify_attention/kernel.py::build_verify_schedule``;
:func:`build_verify_units` cuts its runs of equal pages into the
64-row work units of K3's wgmma route.  Both are torch ops on the
table's device: no value of the table goes to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DEAD_KEY = 2 ** 30
#: query rows of a work unit: one wgmma tile
UNIT_ROWS = 64


def build_verify_schedule(page_table: torch.Tensor, base_lens: torch.Tensor,
                          T: int, psz: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Sort the step's (page, lane, slot) work items by physical page.

    page_table: int32 [B, maxp] (< 0 dead); base_lens: int32 [B], the
    lengths before the verify window; T: the verify width.  Returns
    (pages, lanes, slots), each int32 [B * maxp]: item (lane, slot) is
    live iff its page is resident and its first kv position is inside
    the lane's causal window (slot * psz <= base + T - 1).  Live items
    come first, ascending by page id, so lanes that share a page are
    neighbours; the sort is stable, so equal pages keep lane order.
    Dead items follow with page -1.
    """
    B, maxp = page_table.shape
    dev = page_table.device
    flat = page_table.reshape(-1).to(torch.int32)
    idx = torch.arange(B * maxp, dtype=torch.int32, device=dev)
    lanes = idx // maxp
    slots = idx % maxp
    needed = (flat >= 0) & (slots * psz
                            <= base_lens.to(torch.int32)[lanes.long()] + T - 1)
    key = torch.where(needed, flat, _DEAD_KEY)
    order = torch.argsort(key, stable=True)
    return (torch.where(needed, flat, -1)[order], lanes[order],
            slots[order])


def units_capacity(n_items: int, T: int, G: int) -> int:
    """Rows of the unit list for ``n_items`` schedule items: a run of n
    items has ceil(n T G / 64) <= n ceil(T G / 64) units, so this many
    hold every run of any table."""
    return n_items * -(-T * G // UNIT_ROWS)


def build_verify_units(pages: torch.Tensor, T: int, G: int) -> torch.Tensor:
    """The work units of K3's wgmma route: int32 [units_capacity, 3].

    ``pages`` is the schedule's first tensor (page ids sorted, the dead
    tail -1).  A run is a maximal stretch of equal live pages; its rows
    are its items' T * G query rows (t, g) stacked item after item, cut
    into tiles of 64.  Row u is (first item of the run, items in the
    run, tile) of unit u, runs in schedule order and tiles in order
    within a run; the rows past the last unit are -1 (the dead tail).
    """
    n = pages.numel()
    dev = pages.device
    live = pages >= 0
    prev = torch.cat([pages.new_full((1,), -1), pages[:-1]])
    start = live & (pages != prev)
    run = torch.cumsum(start, 0) - 1                  # run of each item
    idx = torch.arange(n, device=dev)
    # scatter into slot n what belongs to no run, then drop it
    first = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    first.scatter_(0, torch.where(start, run, n), idx)
    count = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    count.scatter_add_(0, torch.where(live, run, n), torch.ones_like(idx))
    first, count = first[:n], count[:n]
    tiles = (count * (T * G) + UNIT_ROWS - 1) // UNIT_ROWS   # 0: no run
    end = torch.cumsum(tiles, 0)                 # units up to each run
    u = torch.arange(units_capacity(n, T, G), device=dev)
    r = torch.searchsorted(end, u, right=True).clamp(max=n - 1)
    units = torch.stack([first[r], count[r], u - end[r] + tiles[r]], 1)
    return torch.where((u < end[-1])[:, None], units,
                       -1).to(torch.int32).contiguous()
