"""Decode-state construction: the empty state and the serving registers.

Counterpart of the JAX package's ``models/decode_init.py``
(``empty_decode_state`` and ``empty_serve_arrays``; prefill-cache
loading comes with the port's prefill path).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import classed_pool
from ..core.block_pool import I32, NULL
from .layers import tree_map
from .transformer import DecodeState, decode_state_defs, pool_class_specs


def empty_decode_state(cfg, dp: int, b_local: int, max_len: int,
                       chunk: Optional[int] = None, size_classes: int = 1,
                       expert_budget: Optional[int] = None,
                       device="cuda") -> DecodeState:
    """Concrete zero state on ``device``: zero KV pages, rings, recurrent
    state and expert pages, empty page, state and expert tables, and a
    per-shard pool vector with one private lane per slot per class
    (``chunk`` sizes the KV lane batch ``ell``, ``size_classes`` the
    class vector, ``expert_budget`` the expert class)."""
    defs = decode_state_defs(cfg, dp, b_local, max_len, chunk=chunk,
                             size_classes=size_classes,
                             expert_budget=expert_budget)

    def zeros(d):
        return torch.zeros(d.shape, dtype=d.dtype, device=device)

    def empty_table(d):
        return torch.full(d.shape, NULL, dtype=I32, device=device)

    specs = pool_class_specs(cfg, b_local, max_len, chunk, size_classes,
                             expert_budget)
    state_tables = expert_pages = expert_tables = None
    if defs.state_tables is not None:
        state_tables = empty_table(defs.state_tables)
    if defs.expert_pages is not None:
        expert_pages = zeros(defs.expert_pages)
        expert_tables = tree_map(empty_table, defs.expert_tables)
    return DecodeState(
        kv_pages={pos: tuple(map(zeros, kv))
                  for pos, kv in defs.kv_pages.items()},
        rings={pos: tuple(map(zeros, kv)) for pos, kv in defs.rings.items()},
        rec=tree_map(zeros, defs.rec),
        page_tables=torch.full(defs.page_tables.shape, NULL, dtype=I32,
                               device=device),
        seq_lens=torch.zeros(defs.seq_lens.shape, dtype=I32, device=device),
        pool=classed_pool.create_dp(dp, specs, device),
        state_tables=state_tables, expert_pages=expert_pages,
        expert_tables=expert_tables)


def empty_serve_arrays(dp: int, b_local: int, device="cuda"):
    """Per-slot serving registers on ``device``: (last_tok, out_count,
    budget), each int32[dp, b_local] zeros.  last_tok feeds the next
    decode step without a host round-trip; out_count and budget drive
    the on-device done-detection."""
    return tuple(torch.zeros((dp, b_local), dtype=I32, device=device)
                 for _ in range(3))
