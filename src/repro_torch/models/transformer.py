"""Decoder stack, paged decode state and the chunked decode forward.

Counterpart of the JAX package's ``models/transformer.py``, limited to
this slice of the port: decoders whose layers are all global attention
over **paged KV** with a dense SwiGLU FFN (olmo-1b, llama3.2-1b,
phi4-mini).  Pages come from the two-level size-classed pool
(:mod:`repro_torch.core.classed_pool`, one KV class) exactly as in the
reference: per-slot private lanes over a per-shard shared stack.

Decode batch layout is [DP, B_local, ...]; DP stays a leading axis on
one device, as in the reference's single-device fallback.

Where the port departs from the reference's pure functions: the KV
pages are updated in place (a copy of every layer's pages per step is
what a functional update would cost).  Each shard's page array carries
one extra page, index ``pages_local``, that the allocator never grants:
masked tokens are written there, which is how this port expresses
JAX's out-of-range ``mode="drop"`` scatter.  Everything else in
:class:`DecodeState` (tables, lengths, pool) is replaced, not mutated.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import base_kind, is_moe_kind
from ..core import block_pool, classed_pool
from ..core.block_pool import I32, NULL
from ..core.classed_pool import CLS_KV, ClassSpec
from ..kernels.paged_attention.ops import paged_attention_chunk
from .layers import (ParamDef, apply_norm, embed_apply, embed_defs,
                     ffn_apply, ffn_defs, norm_defs, rope_tables, rotate,
                     tree_map)


# ===================================================================== defs

def _check_slice(cfg) -> None:
    """Raise for a configuration outside this slice of the port."""
    kinds = set(cfg.pattern) | set(cfg.remainder)
    if kinds != {"global"} or cfg.arch_kind != "decoder" or not cfg.d_ff:
        raise NotImplementedError(
            f"{cfg.name}: this slice of the port serves decoders of paged "
            f"global-attention layers with a dense FFN (pattern "
            f"{cfg.pattern}, arch_kind {cfg.arch_kind!r})")


def attn_defs(cfg):
    d, H, KH, hd, dt = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.tdtype)
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim"), dt),
        "wk": ParamDef((d, KH, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamDef((d, KH, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed"), dt),
    }


def _stack(defs, n: int):
    if isinstance(defs, dict):
        return {k: _stack(v, n) for k, v in defs.items()}
    return ParamDef((n,) + defs.shape, ("layers",) + defs.axes, defs.dtype,
                    defs.init)


def layer_defs(cfg, kind: str):
    if base_kind(kind) != "global" or is_moe_kind(kind):
        raise NotImplementedError(f"layer kind {kind!r}")
    return {"norm1": norm_defs(cfg), "attn": attn_defs(cfg),
            "norm2": norm_defs(cfg), "ffn": ffn_defs(cfg)}


def model_defs(cfg):
    """The reference's parameter tree for this slice's decoders:
    ``embed``, ``final_norm`` (RMS configs), ``groups`` (the pattern
    groups stacked on a leading layers axis) and ``rem``."""
    _check_slice(cfg)
    defs = {"embed": embed_defs(cfg)}
    fn = norm_defs(cfg)
    if fn:
        defs["final_norm"] = fn
    group = {f"pos{j}": layer_defs(cfg, k) for j, k in enumerate(cfg.pattern)}
    if cfg.n_groups:
        defs["groups"] = _stack(group, cfg.n_groups)
    if cfg.remainder:
        defs["rem"] = {f"pos{j}": layer_defs(cfg, k)
                       for j, k in enumerate(cfg.remainder)}
    return defs


# ============================================================== decode state

class DecodeState(NamedTuple):
    """Per-sequence serving state, [DP, B_local, ...] layouts.

    kv_pages:    dict pos -> (k, v) [n_stack, DP, pages_local + 1, psz,
                 KH, hd]; the last page of each shard is the write sink
                 of masked tokens, never granted and never read
    page_tables: int32 [DP, Bl, max_pages]   (shared by all paged layers)
    seq_lens:    int32 [DP, Bl]
    pool:        ClassedPool with leading-[DP] leaves, one KV class:
                 per-slot private lanes of capacity 3*ell over a
                 per-shard shared stack

    The reference's ring, recurrent, encoder, state-class and expert
    fields belong to layers later slices of the port bring in.
    """
    kv_pages: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    page_tables: torch.Tensor
    seq_lens: torch.Tensor
    pool: classed_pool.ClassedPool


class TensorDef(NamedTuple):
    """Shape and dtype of a state leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def pool_ell(cfg, chunk: Optional[int] = None) -> int:
    """Lane batch size: ell >= ceil(chunk / page_size), the most pages
    one step can demand, so the §4.2 never-dry invariant holds by
    construction."""
    chunk = chunk if chunk is not None else 2 * cfg.page_size
    return max(-(-int(chunk) // cfg.page_size), 2)


def pool_class_specs(cfg, b_local: int, max_len: int,
                     chunk: Optional[int] = None,
                     size_classes: int = 1) -> Tuple[ClassSpec, ...]:
    """The class vector: one coarse paged-KV class sized for every
    local slot at max length PLUS fully-stocked lanes (3*ell per
    slot), the §4.2 slack."""
    if size_classes != 1:
        raise NotImplementedError("size_classes > 1: the fine state and "
                                  "expert classes are later slices")
    psz = cfg.page_size
    max_pages = max(max_len // psz, 1)
    ell = pool_ell(cfg, chunk)
    return (ClassSpec(page_size=psz,
                      num_blocks=b_local * max_pages + 3 * ell * b_local,
                      num_lanes=b_local, ell=ell),)


def decode_state_defs(cfg, dp: int, b_local: int, max_len: int,
                      chunk: Optional[int] = None,
                      size_classes: int = 1) -> DecodeState:
    """TensorDef tree of the decode state (pool leaves included)."""
    _check_slice(cfg)
    psz, KH, hd, dt = cfg.page_size, cfg.n_kv_heads, cfg.hd, cfg.tdtype
    max_pages = max(max_len // psz, 1)
    (spec,) = pool_class_specs(cfg, b_local, max_len, chunk, size_classes)
    P = spec.num_blocks
    kv_pages = {}
    for j in range(len(cfg.pattern)):
        shp = (cfg.n_groups, dp, P + 1, psz, KH, hd)
        kv_pages[f"pos{j}"] = (TensorDef(shp, dt),) * 2
    for j in range(len(cfg.remainder)):
        shp = (1, dp, P + 1, psz, KH, hd)
        kv_pages[f"rem{j}"] = (TensorDef(shp, dt),) * 2
    m, L, cap = spec.num_blocks, spec.num_lanes, 3 * spec.ell
    hp = classed_pool.HierPool(
        shared=block_pool.BlockPool(
            free_ids=TensorDef((dp, m), I32), top=TensorDef((dp,), I32),
            refcount=TensorDef((dp, m), torch.int16)),
        private_ids=TensorDef((dp, L, cap), I32),
        private_top=TensorDef((dp, L), I32))
    return DecodeState(
        kv_pages=kv_pages,
        page_tables=TensorDef((dp, b_local, max_pages), I32),
        seq_lens=TensorDef((dp, b_local), I32),
        pool=classed_pool.ClassedPool(classes=(hp,)))


# ======================================================= chunked decode path

class _StepIndex(NamedTuple):
    """What every layer of one chunked step shares, computed once per
    step: the RoPE tables, the KV write coordinates and the kernel's
    DP-folded page table and base lengths."""
    cos: torch.Tensor         # float32 [DP*Bl, T, 1, hd/2]
    sin: torch.Tensor
    write: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # [DP, Bl, T]
    tables: torch.Tensor      # int32 [DP*Bl, maxp], shard d offset d*(P+1)
    base: torch.Tensor        # int32 [DP*Bl]


def _step_index(cfg, state: DecodeState, positions, tok_valid, base,
                n_pages: int) -> _StepIndex:
    """Per-step indices.  A token is written iff it is valid and its
    page is mapped; masked tokens go to the sink page ``n_pages``.  The
    kernel sees all DP shards as one batch: shard-local page ids are
    offset by d * (n_pages + 1)."""
    DP, Bl, T = positions.shape
    psz = cfg.page_size
    maxp = state.page_tables.shape[2]
    pid = block_pool.take(state.page_tables,
                          (positions // psz).clamp(max=maxp - 1))
    pid = torch.where(tok_valid & (pid >= 0), pid, n_pages).long()
    d = torch.arange(DP, device=pid.device)[:, None, None].expand_as(pid)
    off = (torch.arange(DP, dtype=I32, device=pid.device)
           * (n_pages + 1))[:, None, None]
    tables = torch.where(state.page_tables >= 0, state.page_tables + off,
                         NULL).reshape(DP * Bl, maxp)
    cos, sin = rope_tables(positions.reshape(DP * Bl, T), cfg.hd,
                           cfg.rope_theta)
    return _StepIndex(cos, sin, (d, pid, (positions % psz).long()),
                      tables.contiguous(), base.reshape(DP * Bl).contiguous())


def _paged_write_chunk(k_pages, v_pages, k_new, v_new, write) -> None:
    """In place: k_pages [DP, P + 1, psz, KH, hd]; k_new [DP, Bl, T, KH,
    hd]; write: the (shard, page, slot) coordinates [DP, Bl, T] of each
    token, masked tokens on the sink page P.  One scatter of Bl*T
    tokens per shard."""
    k_pages.index_put_(write, k_new.to(k_pages.dtype))
    v_pages.index_put_(write, v_new.to(v_pages.dtype))


def _paged_attn_chunk(q, k_pages, v_pages, idx: _StepIndex):
    """q: [DP, Bl, T, H, hd]; pages: [DP, P + 1, psz, KH, hd].  Folds DP
    into the kernel batch so one kernel launch covers all shards."""
    DP, Bl, T, H, hd = q.shape
    kg = k_pages.reshape((-1,) + k_pages.shape[2:])
    vg = v_pages.reshape((-1,) + v_pages.shape[2:])
    o = paged_attention_chunk(q.reshape(DP * Bl, T, H, hd).contiguous(),
                              kg, vg, idx.tables, idx.base)
    return o.reshape(DP, Bl, T, H, hd)


def _mix_decode_chunk(cfg, lp, x, kv, idx: _StepIndex):
    """One global-attention layer with its dense FFN over a chunk of up
    to T tokens per sequence: write the chunk's K/V into its pages,
    attend over the pages, add the FFN.  x: [DP, Bl, T, d]."""
    DP, Bl, T, d = x.shape
    h = apply_norm(cfg, lp["norm1"], x)
    hf = h.reshape(DP * Bl, T, d)
    a = lp["attn"]
    q = rotate(torch.einsum("bsd,dhk->bshk", hf, a["wq"]), idx.cos, idx.sin)
    k = rotate(torch.einsum("bsd,dhk->bshk", hf, a["wk"]), idx.cos, idx.sin)
    v = torch.einsum("bsd,dhk->bshk", hf, a["wv"])
    kp, vp = kv
    _paged_write_chunk(kp, vp, k.reshape(DP, Bl, T, cfg.n_kv_heads, cfg.hd),
                       v.reshape(DP, Bl, T, cfg.n_kv_heads, cfg.hd),
                       idx.write)
    o = _paged_attn_chunk(q.reshape(DP, Bl, T, cfg.n_heads, cfg.hd), kp, vp,
                          idx)
    x = x + torch.einsum("xbthk,hkd->xbtd", o, a["wo"])
    h2 = apply_norm(cfg, lp["norm2"], x)
    f = ffn_apply(cfg, lp["ffn"], h2.reshape(DP * Bl, T, d))
    return x + f.reshape(DP, Bl, T, d)


def forward_decode_chunk(cfg, params, tokens, state: DecodeState, lens,
                         active=None):
    """Chunked decode/prefill: up to T tokens per sequence per call.

    tokens: int32 [DP, Bl, T]; lens: int32 [DP, Bl] — valid tokens per
    sequence this call (ragged tails are inert: written to no page).
    Returns (hidden [DP, Bl, T, d], new DecodeState) with seq_lens
    advanced by lens.

    Pages for the whole chunk come from each slot's private lane in one
    :func:`hier_pool.alloc_n_or_shared` call, all-or-nothing per
    sequence: a chunk that would overflow the page table, or whose
    pages the pool denies, appends nothing.  The reference's
    ``lax.scan`` over layer groups is a Python loop over layers.
    """
    _check_slice(cfg)
    DP, Bl, T = tokens.shape
    if active is None:
        active = torch.ones((DP, Bl), dtype=torch.bool, device=tokens.device)
    lens = torch.where(active, lens.to(I32).clamp(0, T), 0)
    base = state.seq_lens
    x = embed_apply(params["embed"], tokens).to(cfg.tdtype)

    # --- page allocation for the whole chunk (once, all paged layers)
    psz = cfg.page_size
    maxp = state.page_tables.shape[2]
    kmax = -(-T // psz)
    lens, pages_before, counts = block_pool.chunk_page_plan(
        base, lens, psz, maxp)
    pool, got = classed_pool.alloc_n_or_shared_dp(state.pool, CLS_KV,
                                                  counts, kmax)
    lens = torch.where(block_pool.granted_mask(got, counts), lens, 0)
    kk = torch.arange(kmax, dtype=I32, device=tokens.device)
    new_page = (kk < counts[..., None]) & (got >= 0)
    slot = torch.where(new_page, pages_before[..., None] + kk, maxp)
    tables = block_pool.put(state.page_tables, slot, got)
    state = state._replace(page_tables=tables, pool=pool)

    positions = base[..., None] + torch.arange(T, dtype=I32,
                                               device=tokens.device)
    tok_valid = torch.arange(T, device=tokens.device) < lens[..., None]
    n_pages = classed_pool.pages_local(state.pool, CLS_KV)
    idx = _step_index(cfg, state, positions, tok_valid, base, n_pages)

    def layer(lp, pos, g, x):
        kv = tuple(t[g] for t in state.kv_pages[pos])
        return _mix_decode_chunk(cfg, lp, x, kv, idx)

    for g in range(cfg.n_groups):
        for j in range(len(cfg.pattern)):
            pos = f"pos{j}"
            lp = tree_map(lambda a: a[g], params["groups"][pos])
            x = layer(lp, pos, g, x)
    for j in range(len(cfg.remainder)):
        x = layer(params["rem"][f"pos{j}"], f"rem{j}", 0, x)

    state = state._replace(seq_lens=base + lens)
    return apply_norm(cfg, params.get("final_norm", {}), x), state
