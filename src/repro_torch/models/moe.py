"""Mixture-of-Experts FFN with sort-based (MegaBlocks-style) dispatch.

Counterpart of the JAX package's ``models/moe.py``.  Two dispatch
paths, as in the reference, both without GShard's one-hot dispatch
tensor:

* ``per-row`` (train and prefill chunks, S > 1): each sequence row sorts
  its (token, slot) pairs by expert id; capacity per row C =
  ceil(top_k * S / E * cf); assignments past an expert's capacity are
  dropped;
* ``flat`` (decode, S == 1): all B tokens are sorted as one row;
  C = ceil(top_k * B / E * cf).

Both are one routine here: R rows of N tokens each (R = B, N = S per
row; R = 1, N = B flat), every row sorted at once.  The meters and the
drop order are held exactly against the reference, so routing
reproduces its integer decisions step for step:

* the sort by expert id is stable (``jnp.argsort`` is);
* ``jax.lax.top_k`` puts the lower index first among equal logits, and
  masked logits are all :data:`MASK_NEG`, so the port takes the first k
  of a stable descending sort (``torch.topk`` orders ties arbitrarily
  on the card);
* the router runs in float32 from ``x``'s dtype, as the reference's
  ``dot_general(..., preferred_element_type=float32)`` does: each
  product of two bf16 values is exact in float32;
* the reference's ``mode="drop"`` scatter into the [E*C] bucket writes
  dropped assignments to a sink row E*C that no expert reads;
* the combine sums each token's k weighted expert outputs in a fixed
  order (slot 0 first), onto zeros, with no atomics: the card gives the
  same bits every run (with top_k = 2 the reference's two adds onto
  zero commute exactly).

The expert products are plain batched matmuls (the reference computes
them outside any Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel import partition
from ..parallel.partition import BATCH, constrain_batch
from .layers import ParamDef

#: router-logit fill for experts outside a row's admitted footprint.
#: Large but finite: an all-masked row still softmaxes to finite gates
#: instead of NaN (its output is discarded anyway).
MASK_NEG = -1e30


def moe_defs(cfg) -> Dict[str, ParamDef]:
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.moe.num_experts, cfg.tdtype
    return {
        "router": ParamDef((d, E), ("embed", None), torch.float32),
        "w_gate": ParamDef((E, d, f), ("experts", "embed", "mlp"), dt),
        "w_up": ParamDef((E, d, f), ("experts", "embed", "mlp"), dt),
        "w_down": ParamDef((E, f, d), ("experts", "mlp", "embed"), dt),
    }


def _capacity(top_k: int, tokens: int, E: int, cf: float) -> int:
    c = math.ceil(top_k * tokens / E * cf)
    return max(8, min(c, top_k * tokens))   # clamp; pad to a useful floor


def _dispatch_indices(eids, E: int, C: int):
    """Sort-based routing of R token rows at once.

    eids: int64 [R, N, k].  Returns (keep, dest, t_s, e_s, order), each
    [R, N*k] in sorted order: ``order`` the stable sort of the flat
    (token, slot) pairs by expert id, ``t_s``/``e_s`` their token and
    expert, ``keep`` whether the pair fits its expert's capacity and
    ``dest`` its bucket row (E*C for a dropped pair)."""
    R, N, k = eids.shape
    dev = eids.device
    e_all = eids.reshape(R, N * k)
    order = torch.argsort(e_all, dim=1, stable=True)
    e_s = e_all.gather(1, order)
    t_s = torch.div(order, k, rounding_mode="floor")   # repeat(arange(N), k)
    idx = torch.arange(N * k, device=dev)
    start = torch.searchsorted(
        e_s, torch.arange(E, device=dev).expand(R, E).contiguous())
    pos = idx - start.gather(1, e_s)
    keep = pos < C
    dest = torch.where(keep, e_s * C + pos, E * C)
    return keep, dest, t_s, e_s, order


def _experts(params, buf):
    """SwiGLU of every expert over its bucket: buf [R, E, C, d] ->
    [R, E, C, d], one batched matmul per weight over the E experts."""
    R, E, C, d = buf.shape
    xb = buf.transpose(0, 1).reshape(E, R * C, d)
    h = (F.silu(torch.bmm(xb, params["w_gate"]))
         * torch.bmm(xb, params["w_up"]))
    y = torch.bmm(h.to(buf.dtype), params["w_down"]).to(buf.dtype)
    return y.reshape(E, R, C, d).transpose(0, 1)


def _route(x, gates, eids, E: int, C: int):
    """Sort-based dispatch of R rows into the experts' buckets: x [R, N,
    d], gates and eids [R, N, k] -> (buf [R, E, C, d], keep, dest, t_s,
    e_s, order, g_s), the routing of :func:`_dispatch_indices` and the
    gates in sorted order."""
    R, N, d = x.shape
    k = eids.shape[-1]
    keep, dest, t_s, e_s, order = _dispatch_indices(eids, E, C)
    g_s = gates.reshape(R, N * k).gather(1, order)
    r = torch.arange(R, device=x.device)[:, None].expand_as(dest)
    buf = x.new_zeros((R, E * C + 1, d))         # row E*C: the sink
    buf[r, dest] = x[r, t_s]
    return (buf[:, :E * C].reshape(R, E, C, d), keep, dest, t_s, e_s, order,
            g_s)


def _combine(y, keep, dest, order, g_s, k: int):
    """The experts' outputs y [R, E, C, d] back to the tokens: each
    token's k kept outputs weighted by their gates, summed in slot
    order onto zeros -> [R, N, d]."""
    R, E, C, d = y.shape
    N = order.shape[1] // k
    y = y.reshape(R, E * C, d)
    r = torch.arange(R, device=y.device)[:, None].expand_as(dest)
    gathered = torch.where(keep[..., None], y[r, dest.clamp(max=E * C - 1)],
                           0.0)
    contrib = gathered * g_s[..., None].to(y.dtype)
    # back to (token, slot) order: pair i sits at sorted position inv[i]
    inv = torch.argsort(order, dim=1)
    c = contrib.gather(1, inv[..., None].expand(R, N * k, d)).reshape(
        R, N, k, d)
    out = y.new_zeros((R, N, d))
    for j in range(k):
        out = out + c[:, :, j]
    return out


#: sharding boundaries: routing and combining run on each row shard
#: (the batch over the batch axes, the rest whole); the expert products
#: between them are sharded ops over the experts' placements
_ROW3 = (BATCH, None, None)
_route_shards = partition.local_map(
    _route, (_ROW3, _ROW3, _ROW3, None, None), partition.like(0))
_combine_shards = partition.local_map(
    _combine, ((BATCH, None, None, None), (BATCH, None), (BATCH, None),
               (BATCH, None), (BATCH, None), None), partition.like(0))


def _dispatch_compute(params, x, gates, eids, C: int):
    """Sort-based dispatch of R rows: x [R, N, d], gates [R, N, k] ->
    (out [R, N, d], (keep, t_s, e_s)), the routing meta feeding the
    capacity-drop and expert-touch meters."""
    k = eids.shape[-1]
    E = params["router"].shape[1]
    buf, keep, dest, t_s, e_s, order, g_s = _route_shards(x, gates, eids,
                                                          E, C)
    buf = constrain_batch(buf)
    y = constrain_batch(_experts(params, buf))
    return _combine_shards(y, keep, dest, order, g_s, k), (keep, t_s, e_s)


def moe_apply(cfg, params, x, *, expert_mask=None, token_valid=None,
              metered: bool = False):
    """x: [B, S, d] -> [B, S, d], or ``(out, dropped, routed)`` when
    ``metered``: ``dropped`` int32[B] counts the capacity-dropped
    (token, expert) assignments of valid tokens per row, ``routed``
    int32[B, E] the valid kept assignments per expert.

    ``expert_mask`` (bool [B, E]) restricts each row's routing to its
    admitted expert footprint: logits outside it become
    :data:`MASK_NEG` before the top-k, so a row never routes to an
    expert that is not resident; an all-True mask selects exactly the
    unmasked logits.  ``token_valid`` (bool [B, S]) marks the real
    tokens for the meters (padding tokens route and take capacity as
    before, but never count as drops or touches)."""
    B, S, d = x.shape
    k, E, cf = cfg.moe.top_k, cfg.moe.num_experts, cfg.moe.capacity_factor
    logits = x.float() @ params["router"].to(x.dtype).float()   # [B, S, E]
    if expert_mask is not None:
        logits = torch.where(expert_mask[:, None, :], logits, MASK_NEG)
    top, eids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[..., :k], dim=-1)
    eids = eids[..., :k]
    valid = (partition.constant(
        torch.ones((B, S), dtype=torch.bool, device=x.device), x)
        if token_valid is None else token_valid.bool())

    if S == 1:     # flat: one row of B tokens
        C = _capacity(k, B, E, cf)
        out, (keep, t_s, e_s) = _dispatch_compute(
            params, x.reshape(1, B, d), gates.reshape(1, B, k),
            eids.reshape(1, B, k), C)
        out = out.reshape(B, S, d)
        if not metered:
            return out
        return (out,) + _flat_meters_shards(valid.reshape(1, B), t_s, e_s,
                                            keep, E)

    C = _capacity(k, S, E, cf)
    out, (keep, t_s, e_s) = _dispatch_compute(params, x, gates, eids, C)
    if not metered:
        return out
    return (out,) + _row_meters_shards(valid, t_s, e_s, keep, E)


def _flat_meters(valid, t_s, e_s, keep, E: int):
    """(dropped int32 [B], routed int32 [B, E]) of the flat path's one
    row of B tokens: valid [1, B]; t_s, e_s, keep [1, B*k]."""
    B = valid.shape[1]
    t_s, e_s, keep = t_s[0], e_s[0], keep[0]
    v_s = valid[0][t_s]
    dropped = torch.zeros(B, dtype=torch.int32, device=valid.device)
    dropped.index_add_(0, t_s, (v_s & ~keep).to(torch.int32))
    routed = torch.zeros((B, E), dtype=torch.int32, device=valid.device)
    routed.index_put_((t_s, e_s), (v_s & keep).to(torch.int32),
                      accumulate=True)
    return dropped, routed


def _row_meters(valid, t_s, e_s, keep, E: int):
    """(dropped int32 [B], routed int32 [B, E]) of B rows: valid [B, S];
    t_s, e_s, keep [B, S*k]."""
    v_s = valid.gather(1, t_s)
    dropped = (v_s & ~keep).sum(1, dtype=torch.int32)
    routed = torch.zeros((valid.shape[0], E), dtype=torch.int32,
                         device=valid.device)
    routed.scatter_add_(1, e_s, (v_s & keep).to(torch.int32))
    return dropped, routed


#: the meters on each row shard; the flat path's one row is whole
_flat_meters_shards = partition.local_map(
    _flat_meters, (None,) * 5, partition.whole)
_row_meters_shards = partition.local_map(
    _row_meters, ((BATCH,),) * 4 + (None,), partition.like(0))
