"""Plain PyTorch versions of the paged chunk attention (K1) and the
single-token paged decode attention (K2).

Gather the pages, mask, softmax: the same functions as the CUDA kernels
in ``csrc/`` and as the JAX package's
``kernels/paged_attention/ref.py::paged_attention_chunk_ref`` and
``paged_attention_ref``.  The CPU tests run them, and ``chip_smoke.py``
holds each kernel against its version on the card.  Neither is on the
serving path when a card is present.

K2's TMA route (``csrc/paged_decode_tma.cu``) splits each lane's pages
over several blocks and merges their partial softmax states:
:func:`decode_splits` is its schedule and :func:`paged_attention_split_ref`
its arithmetic in torch ops, for the tests only.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_chunk_ref(q, k_pages, v_pages, page_table, base_lens):
    """q: [B, T, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (entries < 0 are dead); base_lens: int32 [B], the lengths
    BEFORE the chunk.

    Query token t of sequence b sits at position base_lens[b] + t and
    attends to kv positions <= base_lens[b] + t on resident pages.  A
    row that sees no valid key outputs zeros.  Returns [B, T, H, hd] in
    q's dtype; scores and accumulation in float32.
    """
    B, T, H, hd = q.shape
    P, psz, KH, _ = k_pages.shape
    maxp = page_table.shape[1]
    L = maxp * psz
    safe = page_table.clamp(min=0).long()
    k = k_pages[safe].reshape(B, L, KH, hd).float()
    v = v_pages[safe].reshape(B, L, KH, hd).float()
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    kvpos = torch.arange(L, device=q.device)
    qpos = base_lens[:, None].long() + torch.arange(T, device=q.device)
    resident = (page_table >= 0).repeat_interleave(psz, dim=1)   # [B, L]
    valid = (kvpos[None, None, :] <= qpos[:, :, None]) & resident[:, None]
    s = torch.einsum("bthd,bkhd->bhtk", q.float(), k) / (hd ** 0.5)
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid[:, None].any(-1, keepdim=True), p, 0.0)
    o = torch.einsum("bhtk,bkhd->bthd", p, v)
    return o.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                        zero_empty: bool = False):
    """Single-token paged decode attention (K2's plain version, the
    twin of the JAX package's ``paged_attention_ref``).

    q: [B, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (entries < 0 are dead and gather page 0); seq_lens: int32
    [B].  Position p of sequence b is a valid key iff p < seq_lens[b]
    and its page is resident.  A row with no valid key returns the
    uniform mean of the V rows it gathered, as the reference's oracle
    and its Pallas kernel do, or zeros with ``zero_empty`` (K1's
    convention).  Returns [B, H, hd] in q's dtype; scores and
    accumulation in float32.
    """
    B, H, hd = q.shape
    P, psz, KH, _ = k_pages.shape
    maxp = page_table.shape[1]
    L = maxp * psz
    safe = page_table.clamp(min=0).long()
    k = k_pages[safe].reshape(B, L, KH, hd).float()
    v = v_pages[safe].reshape(B, L, KH, hd).float()
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    pos = torch.arange(L, device=q.device)
    valid = ((pos[None] < seq_lens[:, None].long())
             & (page_table >= 0).repeat_interleave(psz, dim=1))   # [B, L]
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) / (hd ** 0.5)
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if zero_empty:
        p = torch.where(valid[:, None].any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhk,bkhd->bhd", p, v).to(q.dtype)


def decode_splits(page_table, seq_lens, psz: int, zero_empty: bool,
                  pages_per_split: int):
    """K2's TMA schedule, as each block computes it on the device: per
    lane (n_pages, splits, empty), int64 [B] each.  A lane reads its
    live pages, ceil(seq / psz) of them (dead ones skipped inside);
    when none of them is resident it has no valid key (``empty``) and
    reads none with ``zero_empty`` (one block writes its zeros) or all
    maxp for the uniform mean.  Its pages are cut into ``splits`` runs
    of ``pages_per_split``; blocks past them exit at once."""
    maxp = page_table.shape[1]
    seq = seq_lens.long().clamp(min=0)
    n_live = ((seq + psz - 1) // psz).clamp(max=maxp)
    live = torch.arange(maxp, device=page_table.device)[None] < n_live[:, None]
    empty = ~((page_table >= 0) & live).any(1)
    n_pages = torch.where(empty, 0 if zero_empty else maxp, n_live)
    splits = (n_pages + pages_per_split - 1) // pages_per_split
    return n_pages, splits, empty


def paged_attention_split_ref(q, k_pages, v_pages, page_table, seq_lens,
                              zero_empty: bool, pages_per_split: int):
    """K2 as the TMA route computes it: each lane's pages
    (:func:`decode_splits`) cut into splits, each split's partial
    softmax state (m and the scores in log2 units, l, acc) over its
    resident pages, then the splits merged in split order.  A lane
    without a valid key gets zeros (``zero_empty``) or the uniform mean
    of all maxp pages, dead entries gathering page 0.  The function of
    :func:`paged_attention_ref`; shapes and result as there."""
    B, H, hd = q.shape
    P, psz, KH, _ = k_pages.shape
    G = H // KH
    sl2 = 1.4426950408889634 / hd ** 0.5
    n_pages, splits, empty = decode_splits(page_table, seq_lens, psz,
                                           zero_empty, pages_per_split)
    out = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    for b in range(B):
        seq = max(int(seq_lens[b]), 0)
        parts = []
        for z in range(int(splits[b])):
            pis = range(z * pages_per_split,
                        min((z + 1) * pages_per_split, int(n_pages[b])))
            pages = [int(page_table[b, pi]) for pi in pis]
            keep = [(pi, pg if pg >= 0 else 0) for pi, pg in zip(pis, pages)
                    if pg >= 0 or empty[b]]
            if not keep:
                parts.append((torch.full((H,), float("-inf")),
                              torch.zeros(H), torch.zeros(H, hd)))
                continue
            idx = torch.tensor([pg for _, pg in keep])
            pos = torch.cat([pi * psz + torch.arange(psz) for pi, _ in keep])
            k = k_pages[idx].reshape(-1, KH, hd).float()
            v = v_pages[idx].reshape(-1, KH, hd).float()
            k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
            s = torch.einsum("hd,khd->hk", q[b].float(), k) * sl2
            if empty[b]:
                s = torch.zeros_like(s)
            else:
                s = s.masked_fill(pos[None] >= seq, float("-inf"))
            m = s.max(-1).values
            p = torch.exp2(s - torch.where(m == float("-inf"), 0.0,
                                           m)[:, None])
            parts.append((m, p.sum(-1), torch.einsum("hk,khd->hd", p, v)))
        if not parts:
            continue
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        Mr = torch.where(M == float("-inf"), 0.0, M)
        lsum, o = 0.0, 0.0
        for m, l, acc in parts:
            w = torch.exp2(m - Mr)
            lsum = lsum + w * l
            o = o + w[:, None] * acc
        out[b] = o / lsum[:, None]
    return out.to(q.dtype)
