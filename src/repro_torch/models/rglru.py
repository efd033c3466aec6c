"""Griffin RG-LRU recurrent block [arXiv:2402.19427], chunk form for
serving.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Counterpart of the JAX package's ``models/rglru.py``.  The reference
serves an RG-LRU layer as T single-token ``rglru_decode_step`` updates
in a ``lax.scan``, each gated by the token's validity.  Here the gates
of the whole chunk are computed at once and the recurrence runs in one
K5 launch (:func:`repro_torch.kernels.rg_lru.ops.rg_lru`) from the
carried state, with ``a = 1, b = 0`` on the ragged tail so that the
state after T tokens is the state after the valid ones, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rg_lru.ops import rg_lru
from .layers import ParamDef, causal_conv, gelu

_C = 8.0


def rglru_defs(cfg):
    d = cfg.d_model
    dt = cfg.tdtype
    return {
        "w_x": ParamDef((d, d), ("embed", "mlp"), dt),
        "w_gate": ParamDef((d, d), ("embed", "mlp"), dt),
        "conv_w": ParamDef((cfg.rglru_conv, d), (None, "mlp"), dt),
        "w_r": ParamDef((d, d), ("mlp", "mlp"), dt),
        "w_i": ParamDef((d, d), ("mlp", "mlp"), dt),
        "lam": ParamDef((d,), ("mlp",), torch.float32, "ones"),
        "w_out": ParamDef((d, d), ("mlp", "embed"), dt),
    }


def _gates(params, x):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32."""
    r = torch.sigmoid(x @ params["w_r"]).float()
    i = torch.sigmoid(x @ params["w_i"]).float()
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x.float())
    return a, gated


def rglru_block_apply(cfg, params, x, h, conv, lens, tok_valid):
    """One Griffin recurrent block over a chunk: x [B, T, d] -> [B, T, d].

    h: float32 [B, d], the carried RG-LRU state, updated in place by K5;
    conv: [B, rglru_conv - 1, d], the carried conv inputs, overwritten
    with those that end at each sequence's last valid token; lens: [B]
    valid tokens; tok_valid: bool [B, T] (t < lens).
    """
    gate = gelu(x @ params["w_gate"])
    u, new_conv = causal_conv(x @ params["w_x"], params["conv_w"], conv,
                              lens)
    conv.copy_(new_conv)
    a, b = _gates(params, u)
    v = tok_valid[..., None]
    hs, _ = rg_lru(torch.where(v, a, 1.0).contiguous(),
                   torch.where(v, b, 0.0).contiguous(), h)
    return (hs.to(x.dtype) * gate) @ params["w_out"]
