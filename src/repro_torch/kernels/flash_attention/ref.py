"""Plain PyTorch version of causal flash attention (K6).

The same function as the CUDA kernel in ``csrc/flash_attention.cu`` and
as the JAX package's ``kernels/flash_attention/ref.py::
flash_attention_ref``: dense softmax attention in float32, with grouped
kv heads.  The CPU path of the dispatcher runs it, and ``chip_smoke.py``
holds the kernel against it on the card; with a card present the
training path never calls it.
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
