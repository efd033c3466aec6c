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
from .transformer import DecodeState, decode_state_defs, pool_class_specs


def empty_decode_state(cfg, dp: int, b_local: int, max_len: int,
                       chunk: Optional[int] = None, size_classes: int = 1,
                       device="cuda") -> DecodeState:
    """Concrete zero state on ``device``: zero KV pages, empty page
    tables, and a per-shard pool with one private lane per slot
    (``chunk`` sizes the lane batch ``ell``)."""
    defs = decode_state_defs(cfg, dp, b_local, max_len, chunk=chunk,
                             size_classes=size_classes)
    kv_pages = {pos: tuple(torch.zeros(d.shape, dtype=d.dtype, device=device)
                           for d in kv)
                for pos, kv in defs.kv_pages.items()}
    specs = pool_class_specs(cfg, b_local, max_len, chunk, size_classes)
    return DecodeState(
        kv_pages=kv_pages,
        page_tables=torch.full(defs.page_tables.shape, NULL, dtype=I32,
                               device=device),
        seq_lens=torch.zeros(defs.seq_lens.shape, dtype=I32, device=device),
        pool=classed_pool.create_dp(dp, specs, device))


def empty_serve_arrays(dp: int, b_local: int, device="cuda"):
    """Per-slot serving registers on ``device``: (last_tok, out_count,
    budget), each int32[dp, b_local] zeros.  last_tok feeds the next
    decode step without a host round-trip; out_count and budget drive
    the on-device done-detection."""
    return tuple(torch.zeros((dp, b_local), dtype=I32, device=device)
                 for _ in range(3))
