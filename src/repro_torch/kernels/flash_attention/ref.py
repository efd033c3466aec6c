"""Plain PyTorch versions of causal flash attention (K6), forward and
backward.

The forward is the same function as the CUDA kernels in
``csrc/flash_attention.cu`` and as the JAX package's
``kernels/flash_attention/ref.py::flash_attention_ref``: dense softmax
attention in float32, with grouped kv heads.  The backward is the same
function as ``csrc/flash_attention_bwd.cu``: the gradient from the
forward's output and log-sum-exp, which the JAX package gets from
``jax.grad`` of its jnp ``blockwise_attention``;
:func:`flash_attention_bwd_tiled_ref` takes it tile by tile in the order
of ``csrc/flash_attention_bwd_wgmma.cu``.  The CPU path of the
dispatcher runs the first two, and ``chip_smoke.py`` holds the kernels
against them on the card; with a card present the training path never
calls them.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)


def flash_attention_fwd_ref(q, k, v, causal: bool = True):
    """q: [B, H, S, hd]; k, v: [B, KH, S, hd] with H = G * KH (query
    head h reads kv head h // G).  Returns (o [B, H, S, hd] in q's
    dtype, lse float32 [B, H, S]): scores ``q k^T / sqrt(hd)`` in
    float32, keys above the diagonal at -1e30 in causal mode, and the
    log-sum-exp of each row's scores."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    qf = q.float().unflatten(1, (KH, H // KH))           # [B, KH, G, S, hd]
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = qf @ kf.transpose(-1, -2) * (1.0 / hd ** 0.5)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.softmax(s, dim=-1) @ vf
    return o.flatten(1, 2).to(q.dtype), lse.flatten(1, 2)


def flash_attention_ref(q, k, v, causal: bool = True):
    """:func:`flash_attention_fwd_ref` without the log-sum-exp."""
    return flash_attention_fwd_ref(q, k, v, causal)[0]


#: query rows a step of the plain backward (its float32 score block is
#: B x H x 256 x S)
BWD_BLOCK = 256


def attention_delta_ref(o, do):
    """delta = rowsum(dO * O) in float32 [B, H, S]: the term of dS that
    the softmax's normalisation contributes."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd_ref` in
    torch ops, float32 inside, one ``BWD_BLOCK``-row query block at a
    time, from the forward's output and log-sum-exp; never holds a [B,
    H, S, S] tensor.  dk and dv sum over the G query heads of each kv
    head."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    grp = (KH, H // KH)
    scale = 1.0 / hd ** 0.5
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    delta = attention_delta_ref(o, do).unflatten(1, grp)
    lse = lse.unflatten(1, grp)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i0 in range(0, S, BWD_BLOCK):
        i1 = min(S, i0 + BWD_BLOCK)
        n = i1 if causal else S                      # keys any row can see
        qb = q[:, :, i0:i1].float().unflatten(1, grp)     # [B, KH, G, bq, hd]
        dob = do[:, :, i0:i1].float().unflatten(1, grp)
        kb, vb = kf[..., :n, :], vf[..., :n, :]
        s = qb @ kb.transpose(-1, -2) * scale
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)[:, None]
            seen = torch.arange(n, device=q.device)[None] <= qpos
            s = torch.where(seen, s, -torch.inf)
        p = torch.exp(s - lse[..., i0:i1, None])
        dv[:, :, :n] += (p.transpose(-1, -2) @ dob).sum(2)
        ds = p * (dob @ vb.transpose(-1, -2) - delta[..., i0:i1, None])
        dq[:, :, i0:i1] = (ds @ kb).flatten(1, 2) * scale
        dk[:, :, :n] += (ds.transpose(-1, -2) @ qb).sum(2) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: rows of a query tile and of a key tile in the wgmma backward's walk
#: (a consumer warpgroup's rows, and a stage of the other side)
TILE = 64


def flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, causal: bool = True,
                                  bf16_operands: bool = True, drop=None):
    """The walk of ``csrc/flash_attention_bwd_wgmma.cu`` in float32 on
    any device: the same function as :func:`flash_attention_bwd_ref`,
    taken tile by tile in the kernels' order.  P and dS are rebuilt per
    (64-query, 64-key) tile from the log-sum-exp in base 2
    (exp2(s scale log2 e - lse log2 e)); dV and dK of each 64-key tile
    sum P^T dO and dS^T Q over the kv head's G query heads in head
    order, and over each head's query tiles in order; dQ of each
    64-query tile sums dS K over its key tiles in order; tiles wholly
    above the diagonal are skipped.  With ``bf16_operands``, P and dS
    are rounded to bf16 where the kernels round them (as the A operand
    of the products that take them).  ``drop``, a (query tile, key
    tile) pair, leaves that pair out of every sum: a fault confined to
    one tile, the control that shows a check against this walk would
    see one.  Returns float32 (dq, dk, dv)."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    G = H // KH
    sl2 = 1.0 / hd ** 0.5 * LOG2E
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    delta = attention_delta_ref(o, do)
    l2 = lse.float() * LOG2E
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if bf16_operands
           else (lambda x: x))
    n = -(-S // TILE)
    kq, vq = kf.repeat_interleave(G, 1), vf.repeat_interleave(G, 1)
    # P and dS of every tile (i, j) that holds a visible pair, all heads
    tiles = {}
    for i in range(n):
        qi = slice(i * TILE, min(S, (i + 1) * TILE))
        for j in range(i + 1 if causal else n):
            if (i, j) == drop:
                continue
            kj = slice(j * TILE, min(S, (j + 1) * TILE))
            s = qf[:, :, qi] @ kq[:, :, kj].transpose(-1, -2)
            p = torch.exp2(s * sl2 - l2[:, :, qi, None])
            if causal:
                qpos = torch.arange(qi.start, qi.stop, device=q.device)
                kpos = torch.arange(kj.start, kj.stop, device=q.device)
                p = torch.where(kpos[None] <= qpos[:, None], p, 0.0)
            dp = dof[:, :, qi] @ vq[:, :, kj].transpose(-1, -2)
            tiles[i, j] = (p, p * (dp - delta[:, :, qi, None]))
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for j in range(n):                      # dK/dV: a 64-key tile
        kj = slice(j * TILE, min(S, (j + 1) * TILE))
        for g in range(G):                  # head kh * G + g of each kv head
            for i in range(j if causal else 0, n):
                if (i, j) == drop:
                    continue
                qi = slice(i * TILE, min(S, (i + 1) * TILE))
                p, ds = (t[:, g::G] for t in tiles[i, j])
                dv[:, :, kj] += rnd(p).transpose(-1, -2) @ dof[:, g::G, qi]
                dk[:, :, kj] += rnd(ds).transpose(-1, -2) @ qf[:, g::G, qi]
    for i in range(n):                      # dQ: a 64-query tile
        qi = slice(i * TILE, min(S, (i + 1) * TILE))
        for j in range(i + 1 if causal else n):
            if (i, j) == drop:
                continue
            kj = slice(j * TILE, min(S, (j + 1) * TILE))
            dq[:, :, qi] += rnd(tiles[i, j][1]) @ kq[:, :, kj]
    scale = 1.0 / hd ** 0.5
    return dq * scale, dk * scale, dv


#: the limit of :func:`row_scaled_err` between the wgmma backward and
#: :func:`flash_attention_bwd_tiled_ref` with bf16 operands: above the
#: kernel's readings (its bf16 outputs, and the rare P or dS that rounds
#: the other way), below those of the walk's controls (``drop``, and
#: delta left out); ``chip_smoke.py`` prints all three on the card
BWD_ROW_TOL = 2.0 ** -5


def row_scaled_err(got, want) -> float:
    """The largest error of a gradient's row (its hd entries) over the
    row's own largest |entry|: each query's or key's row is held to its
    own scale, so a fault in the late rows, whose entries are small
    under the causal mask, shows as plainly as one in the early rows.
    A row whose gradient nearly cancels (dq's first row under the
    causal mask is P (dP - delta) = 0 in exact arithmetic) is held
    against a hundredth of the median row's largest entry instead."""
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    floor = 1e-2 * scale.flatten().median()
    return (err / torch.maximum(scale, floor)).max().item()
