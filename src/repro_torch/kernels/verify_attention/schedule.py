"""The page-grouped work schedule of the verify attention (K3).

Counterpart of the JAX package's
``kernels/verify_attention/kernel.py::build_verify_schedule``, as torch
ops on the table's device: no value of the table goes to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DEAD_KEY = 2 ** 30


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
