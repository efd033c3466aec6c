"""Plain PyTorch versions of the paged chunk attention (K1) and the
single-token paged decode attention (K2).

Gather the pages, mask, softmax: the same functions as the CUDA kernels
in ``csrc/paged_attention.cu`` and ``csrc/paged_decode.cu`` and as the
JAX package's ``kernels/paged_attention/ref.py::paged_attention_chunk_ref``
and ``paged_attention_ref``.  The CPU tests run them, and
``chip_smoke.py`` holds each kernel against its version on the card.
Neither is on the serving path when a card is present.
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
