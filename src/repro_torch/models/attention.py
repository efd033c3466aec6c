"""Full-sequence attention of the training path: projections with RoPE,
flash attention (K6, causal or bidirectional) for global layers, the
decoder's cross-attention over an encoder's K/V, and the blockwise and
sliding-window forms in plain torch ops.

Counterpart of the JAX package's ``models/attention.py`` for training.
Tensors keep the reference's [B, S, H, hd] layout here; K6's wrapper
takes [B, H, S, hd], and the transposes between the two are views (the
kernel reads strided inputs).  The reference has no kernel for a
window: :func:`local_attention` and :func:`blockwise_attention` serve
``local`` layers, and the tests use them as oracles.  Nor for
cross-attention, whose queries and keys differ in length (K6 takes one
S for both): :func:`cross_attention` runs :func:`blockwise_attention`,
as the reference's runs its jnp form.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import base_kind
from ..kernels.flash_attention.ops import flash_attention
from ..parallel import partition
from ..parallel.partition import BATCH, MODEL
from .layers import rope_tables, rotate

NEG_INF = -1e30


def qkv(cfg, params, x, positions=None):
    """x [B, S, d] -> q [B, S, H, hd], k and v [B, S, KH, hd], with RoPE
    over ``positions`` ([B or 1, S]; 0..S-1 by default) on q and k."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None]
    cos, sin = rope_tables(positions, q.shape[-1], cfg.rope_theta)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


def _expand_kv(k, n_heads: int):
    """GQA: repeat kv heads to match q heads."""
    KH = k.shape[2]
    if KH == n_heads:
        return k
    return k.repeat_interleave(n_heads // KH, dim=2)


def blockwise_attention(q, k, v, causal: bool = True,
                        window: Optional[int] = None, block_q: int = 512,
                        block_k: int = 1024, q_offset: int = 0):
    """Streaming softmax attention; q, k, v: [B, S, H, hd] (kv
    pre-expanded).  Loops over query blocks and, inside, over KV blocks
    with an online-softmax accumulator; padded KV positions are masked
    and padded query rows sliced off, as in the reference."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    block_q, block_k = min(block_q, Sq), min(block_k, Sk)
    scale = 1.0 / hd ** 0.5
    dev = q.device
    outs = []
    for i0 in range(0, Sq, block_q):
        qi = q[:, i0:i0 + block_q]
        bq = qi.shape[1]
        if bq < block_q:                    # the reference pads q with 0
            qi = torch.cat([qi, qi.new_zeros(B, block_q - bq, H, hd)], 1)
        qpos = q_offset + i0 + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, H, block_q), device=dev)
        acc = torch.zeros((B, H, block_q, hd), device=dev)
        for j0 in range(0, Sk, block_k):
            ki, vi = k[:, j0:j0 + block_k], v[:, j0:j0 + block_k]
            kpos = j0 + torch.arange(block_k, device=dev)
            if ki.shape[1] < block_k:
                pad = block_k - ki.shape[1]
                ki = torch.cat([ki, ki.new_zeros(B, pad, H, hd)], 1)
                vi = torch.cat([vi, vi.new_zeros(B, pad, H, hd)], 1)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, ki) * scale
            mask = (kpos[None, :] < Sk).expand(block_q, block_k)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s.float(), NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qi.dtype), vi).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype)[:, :bq])
    return torch.cat(outs, 1)


def local_attention(q, k, v, window: int, block_q: int = 512,
                    q_offset: int = 0):
    """Sliding-window causal attention with FLOPs ~ O(S * window): each
    query block reads only the [start, start + window + block_q) KV
    slice.  Falls back to :func:`blockwise_attention` where the
    reference does (the span covers the keys, or block_q does not
    divide S)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    block_q = min(block_q, Sq)
    span = window + block_q
    if span >= Sk or Sq % block_q:
        return blockwise_attention(q, k, v, causal=True, window=window,
                                   q_offset=q_offset)
    scale = 1.0 / hd ** 0.5
    outs = []
    for i0 in range(0, Sq, block_q):
        q0 = q_offset + i0
        start = min(max(q0 - window + 1, 0), Sk - span)
        ks, vs = k[:, start:start + span], v[:, start:start + span]
        qpos = q0 + torch.arange(block_q, device=q.device)
        kpos = start + torch.arange(span, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i0:i0 + block_q], ks) * scale
        mask = (qpos[:, None] >= kpos[None, :]) & (
            qpos[:, None] - kpos[None, :] < window)
        p = torch.softmax(torch.where(mask, s.float(), NEG_INF), dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), vs))
    return torch.cat(outs, 1)


# Sharding boundaries (``partition.local_map``): each attention form
# runs on its shard's block, the batch over the batch axes and the heads
# over "model" where they divide, S and hd whole; the output is laid out
# as q.  K6 takes [B, H, S, hd]; the plain forms [B, S, H, hd].
_HEADS_1 = (BATCH, MODEL, None, None)
_HEADS_2 = (BATCH, None, MODEL, None)
_flash_shards = partition.local_map(
    flash_attention, (_HEADS_1, _HEADS_1, _HEADS_1, None), partition.like(0))
_local_shards = partition.local_map(
    local_attention, (_HEADS_2, _HEADS_2, _HEADS_2, None), partition.like(0))
_blockwise_shards = partition.local_map(
    blockwise_attention, (_HEADS_2, _HEADS_2, _HEADS_2, None),
    partition.like(0))


def _kv_like_q(q, k, head_dim: int):
    """GQA on shards: kv heads that "model" cannot shard as it shards
    q's heads are expanded to q's heads first, so that each shard holds
    the kv heads of its query heads."""
    if (partition.is_sharded(k) and partition.divides(q, head_dim, "model")
            and not partition.divides(k, head_dim, "model")):
        return k.repeat_interleave(q.shape[head_dim] // k.shape[head_dim],
                                   dim=head_dim)
    return k


def runs_flash(cfg, kind: str) -> bool:
    """Whether :func:`attention_train` runs a layer of ``kind``
    ("global_moe" as "global") on K6: every attention layer but a local
    one under a window."""
    bk = base_kind(kind)
    return bk == "global" or (bk == "local" and cfg.window is None)


def attention_train(cfg, params, x, kind: str, causal: bool = True):
    """Full-sequence attention layer: returns (out [B, S, d], (k, v)).
    Global layers run K6 on grouped kv heads without expanding them,
    causal or, for an encoder's layers, bidirectional; local layers the
    plain sliding-window form."""
    q, k, v = qkv(cfg, params, x)
    if not runs_flash(cfg, kind):
        o = _local_shards(q, _expand_kv(k, cfg.n_heads),
                          _expand_kv(v, cfg.n_heads), cfg.window)
    else:
        kq, vq = _kv_like_q(q, k, 2), _kv_like_q(q, v, 2)
        o = _flash_shards(q.transpose(1, 2), kq.transpose(1, 2),
                          vq.transpose(1, 2), causal).transpose(1, 2)
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return out, (k, v)


def cross_attention(cfg, params, x, enc_kv):
    """Decoder cross-attention over precomputed encoder K/V: x [B, S, d],
    enc_kv (k, v) [B, L, KH, hd] -> [B, S, d].  No RoPE on either side,
    every query sees all L keys."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k, v = enc_kv
    o = _blockwise_shards(q, _expand_kv(k, cfg.n_heads),
                          _expand_kv(v, cfg.n_heads), False)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])
