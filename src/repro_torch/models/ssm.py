"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060], chunk
form for serving.

Counterpart of the JAX package's ``models/ssm.py``.  The reference
serves an SSD layer as T single-token ``ssd_decode_step`` updates in a
``lax.scan``, each gated by the token's validity.  Here a chunk of T
tokens runs as one pass: in_proj, the depthwise conv over the carried
conv state and the chunk, then the SSD recurrence over the whole chunk
in one K4 launch (:func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`)
from the carried state, with ``dt = 0`` on the ragged tail so that the
state after T tokens is the state after the valid ones, bit for bit.
Outputs at invalid positions differ from the reference's (which runs
ungated updates there); nothing reads them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan
from .layers import ParamDef, causal_conv, rmsnorm


def ssd_defs(cfg):
    d = cfg.d_model
    di = cfg.ssd_expand * d
    N = cfg.ssd_state
    H = di // cfg.ssd_head_dim
    dt = cfg.tdtype
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * N + H), ("embed", "mlp"), dt),
        "conv_w": ParamDef((4, di + 2 * N), (None, None), dt),
        "A_log": ParamDef((H,), (None,), torch.float32, "zeros"),
        "D": ParamDef((H,), (None,), torch.float32, "ones"),
        "dt_bias": ParamDef((H,), (None,), torch.float32, "zeros"),
        "norm_scale": ParamDef((di,), ("mlp",), torch.float32, "zeros"),
        "out_proj": ParamDef((di, d), ("mlp", "embed"), dt),
    }


def _split_proj(cfg, z):
    """in_proj's output -> (x, z gate, B, C, dt) along the last axis."""
    di = cfg.ssd_expand * cfg.d_model
    N = cfg.ssd_state
    H = di // cfg.ssd_head_dim
    return z.split([di, di, N, N, H], dim=-1)


def ssd_block_apply(cfg, params, x, h, conv, lens, tok_valid):
    """One SSD block over a chunk: x [B, T, d] -> y [B, T, d].

    h: float32 [B, H, P, N], the carried SSD state, updated in place by
    K4; conv: [B, 3, di + 2N], the carried conv inputs, overwritten with
    the three that end at each sequence's last valid token; lens: [B]
    valid tokens; tok_valid: bool [B, T] (t < lens).
    """
    di = cfg.ssd_expand * cfg.d_model
    N = cfg.ssd_state
    P = cfg.ssd_head_dim
    H = di // P
    Bsz, T, _ = x.shape
    z = x @ params["in_proj"]
    xin, zgate, Bc, Cc, dtr = _split_proj(cfg, z)
    conv_out, new_conv = causal_conv(torch.cat([xin, Bc, Cc], dim=-1),
                                     params["conv_w"], conv, lens)
    conv.copy_(new_conv)
    xin, Bc, Cc = F.silu(conv_out).split([di, N, N], dim=-1)
    dt = F.softplus(dtr.float() + params["dt_bias"])
    dt = torch.where(tok_valid[..., None], dt, 0.0)     # inert tail
    A = -torch.exp(params["A_log"])
    y, _ = ssd_scan(xin.reshape(Bsz, T, H, P).contiguous(), dt.contiguous(),
                    A, Bc.contiguous(), Cc.contiguous(), params["D"], h)
    y = rmsnorm(y.reshape(Bsz, T, di) * F.silu(zgate), params["norm_scale"])
    return y.to(x.dtype) @ params["out_proj"]
