"""Plain PyTorch versions of causal flash attention (K6), forward and
backward.

The forward is the same function as the CUDA kernels in
``csrc/flash_attention.cu`` and as the JAX package's
``kernels/flash_attention/ref.py::flash_attention_ref``: dense softmax
attention in float32, with grouped kv heads.  The backward is the same
function as ``csrc/flash_attention_bwd.cu``: the gradient from the
forward's output and log-sum-exp, which the JAX package gets from
``jax.grad`` of its jnp ``blockwise_attention``.  The CPU path of the
dispatcher runs them, and ``chip_smoke.py`` holds the kernels against
them on the card; with a card present the training path never calls
them.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
