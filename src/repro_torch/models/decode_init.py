"""Decode-state construction: the empty state, prefill-cache loading
and the serving registers.

Counterpart of the JAX package's ``models/decode_init.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import classed_pool
from ..core.block_pool import I32, NULL
from ..core.classed_pool import CLS_KV
from .layers import tree_map
from .transformer import DecodeState, decode_state_defs, pool_class_specs


def empty_decode_state(cfg, dp: int, b_local: int, max_len: int,
                       chunk: Optional[int] = None, size_classes: int = 1,
                       expert_budget: Optional[int] = None,
                       device="cuda") -> DecodeState:
    """Concrete zero state on ``device``: zero KV pages, rings, recurrent
    state, expert pages and an encoder-decoder's ``enc_kv``, empty page,
    state and expert tables, and a
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
        expert_tables=expert_tables,
        enc_kv=None if defs.enc_kv is None else tuple(map(zeros,
                                                          defs.enc_kv)))


def empty_serve_arrays(dp: int, b_local: int, device="cuda"):
    """Per-slot serving registers on ``device``: (last_tok, out_count,
    budget), each int32[dp, b_local] zeros.  last_tok feeds the next
    decode step without a host round-trip; out_count and budget drive
    the on-device done-detection."""
    return tuple(torch.zeros((dp, b_local), dtype=I32, device=device)
                 for _ in range(3))


def load_prefill(cfg, state: DecodeState, caches, prompt_len: int
                 ) -> DecodeState:
    """Scatter dense prefill caches into the paged, ring and recurrent
    state: ``caches`` is :func:`repro_torch.models.transformer.
    forward_prefill`'s, over B = DP * B_local sequences that all hold
    ``prompt_len`` tokens.

    Every slot's ``ceil(prompt_len / page_size)`` KV pages come from its
    shard's shared stack in one :func:`classed_pool.alloc_from_shared_dp`
    grant, as in the reference (bulk admission: a whole prompt never
    fits a 3 * ell lane), also where no layer is paged; a grant that
    comes up short raises.  Dense K/V go into the granted pages, the
    last ``min(W, prompt_len)`` positions of a local layer into ring
    slot ``s % W``, the final recurrent states into ``state.rec``, and
    an encoder-decoder's cross K/V (each layer's cache is ``(self,
    (k_x, v_x))``) into ``state.enc_kv`` in layer order: pattern
    positions interleaved back by group, then the remainder, as in the
    reference.  The payloads are written in place by index ops on their
    device (the sink page and the sink slot are left alone); the page
    tables, lengths and pool are replaced; the state tables and the
    expert state pass through unchanged."""
    dp, b_local, max_pages = state.page_tables.shape
    psz = cfg.page_size
    n_pages = -(-prompt_len // psz)
    if n_pages > max_pages:
        raise ValueError(f"a {prompt_len}-token prompt needs {n_pages} "
                         f"pages; the page table holds {max_pages}")
    dev = state.seq_lens.device
    counts = torch.full((dp, b_local), n_pages, dtype=I32, device=dev)
    pool, ids = classed_pool.alloc_from_shared_dp(state.pool, CLS_KV, counts,
                                                  max(n_pages, 1))
    ids = ids[..., :n_pages]
    if not bool((ids >= 0).all()):
        raise RuntimeError(f"prefill: the KV pool cannot grant {n_pages} "
                           f"pages to each of {b_local} slots a shard")
    tables = torch.full_like(state.page_tables, NULL)
    tables[..., :n_pages] = ids
    shard = torch.arange(dp, device=dev)[:, None, None].expand_as(ids)
    page = ids.long()

    def by_slot(dense):
        """[n, B, S, ...] -> [n, DP, B_local, S, ...]"""
        return dense.reshape(dense.shape[0], dp, b_local, *dense.shape[2:])

    encdec = cfg.arch_kind == "encdec"

    def self_cache(pos):
        return caches[pos][0] if encdec else caches[pos]

    for pos, pages in state.kv_pages.items():
        for buf, dense in zip(pages, self_cache(pos)):
            n, _, S, KH, hd = dense.shape
            pad = n_pages * psz - S
            if pad:
                dense = torch.cat([dense, dense.new_zeros(
                    (n, dp * b_local, pad, KH, hd))], dim=2)
            buf[:, shard, page] = by_slot(dense).reshape(
                n, dp, b_local, n_pages, psz, KH, hd).to(buf.dtype)

    src = torch.arange(prompt_len, device=dev)
    for pos, rings in state.rings.items():
        for buf, dense in zip(rings, self_cache(pos)):
            W = buf.shape[3] - 1                    # slot W is the sink
            s = src[max(prompt_len - W, 0):]
            buf[:, :, :, s % W] = by_slot(dense)[:, :, :, s].to(buf.dtype)

    for pos, st in state.rec.items():
        for name, leaf in st.items():
            leaf.copy_(self_cache(pos)[name].reshape(leaf.shape))

    if encdec:
        pat = [caches[f"pos{j}"][1] for j in range(len(cfg.pattern))
               if cfg.n_groups]
        rem = [caches[f"rem{j}"][1] for j in range(len(cfg.remainder))]
        for i, buf in enumerate(state.enc_kv):
            # [n_groups, P, B, ...] -> layer order g * P + j
            parts = ([torch.stack([c[i] for c in pat], 1).flatten(0, 1)]
                     if pat else []) + [c[i] for c in rem]
            dense = torch.cat(parts, 0)
            want = (buf.shape[0], dp * b_local) + tuple(buf.shape[3:])
            if tuple(dense.shape) != want:
                raise ValueError(f"load_prefill: cross K/V of shape "
                                 f"{tuple(dense.shape)}, the state holds "
                                 f"{want} (enc_len {cfg.enc_len})")
            buf.copy_(by_slot(dense))

    return state._replace(
        page_tables=tables, pool=pool,
        seq_lens=torch.full((dp, b_local), prompt_len, dtype=I32,
                            device=dev))
