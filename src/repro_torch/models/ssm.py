"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060]: the
full-sequence form of training and prefill, and the chunk form of
serving.

Counterpart of the JAX package's ``models/ssm.py``.  Training and
prefill run :func:`ssd_chunked`, the reference's chunked SSD in plain
torch ops under autograd (the reference differentiates its jnp form
too; K4 has no backward): an attention-like term within each chunk of
Q tokens, and the state carried between chunks by a Python loop over
the S / Q chunks where the reference has a ``lax.scan``.  The reference
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


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int = 128, h0=None):
    """SSD scan over a full sequence. x: [B, S, H, P]; dt: float32 [B, S,
    H]; A: [H]; Bm, Cm: [B, S, N]; h0: optional float32 [B, H, P, N].

    Returns (y [B, S, H, P], h_final float32 [B, H, P, N]).  The casts
    are the reference's, which set the numbers in bf16: the diagonal
    term's weights and the chunk states' decays cast to x's dtype, the
    inter-chunk recurrence in float32, the carried states and their
    decays cast to x's dtype for the off-diagonal term.  Where the
    reference requires S to be a multiple of the chunk, the port pads
    the last chunk with dt = 0 tokens, which decay nothing and add
    nothing to the state, and drops their outputs."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        y, h = ssd_chunked(*(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                             for t in (x, dt)), A,
                           *(F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm)),
                           D, chunk, h0)
        return y[:, :S], h
    N = Bm.shape[-1]
    nc = S // Q
    a = dt * A[None, None, :]                           # [B, S, H] (< 0)
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(a.reshape(Bsz, nc, Q, H), dim=2)  # [B, nc, Q, H]
    a_total = cum[:, :, -1]                             # [B, nc, H]

    # within-chunk (diagonal) term.  Above the diagonal seg > 0 and
    # exp(seg) overflows: mask BEFORE the exponential, or the masked
    # branch's gradient is inf * 0 = NaN
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # cum_i - cum_j
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()[
        None, None, :, :, None]
    L = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)         # [B, nc, Q, Q]
    w = cb[..., None] * L * dtc[:, :, None, :, :]        # [B, nc, Q, Q, H]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w.to(x.dtype), xc)

    # each chunk's contribution to the carried state
    decay_out = torch.exp(a_total[:, :, None, :] - cum)  # [B, nc, Q, H]
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                          (decay_out * dtc).to(x.dtype), Bc, xc).float()

    # inter-chunk recurrence, float32: the state entering each chunk
    h = (h0 if h0 is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=x.device))
    decay = torch.exp(a_total)[..., None, None]          # [B, nc, H, 1, 1]
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * decay[:, c] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # [B, nc, H, P, N]

    # off-diagonal (carried state) term
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs.to(x.dtype)) \
        * torch.exp(cum)[..., None].to(x.dtype)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    return y + x * D[None, None, :, None], h


def ssd_block_full(cfg, params, x, h0=None, conv0=None):
    """One SSD block over a full sequence (training and prefill): x [B,
    S, d] -> (y [B, S, d], (h_final, conv_state)), from the optional
    carried SSD state h0 (float32 [B, H, P, N]) and conv inputs conv0
    ([B, 3, di + 2N]); the conv starts from zeros without one."""
    di = cfg.ssd_expand * cfg.d_model
    N = cfg.ssd_state
    P = cfg.ssd_head_dim
    H = di // P
    Bsz, S, _ = x.shape
    z = x @ params["in_proj"]
    xin, zgate, Bc, Cc, dtr = _split_proj(cfg, z)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    if conv0 is None:
        conv0 = conv_in.new_zeros((Bsz, params["conv_w"].shape[0] - 1,
                                   conv_in.shape[-1]))
    conv_out, conv_state = causal_conv(
        conv_in, params["conv_w"], conv0,
        torch.full((Bsz,), S, dtype=torch.int32, device=x.device))
    xin, Bc, Cc = F.silu(conv_out).split([di, N, N], dim=-1)
    dt = F.softplus(dtr.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h = ssd_chunked(xin.reshape(Bsz, S, H, P), dt, A, Bc, Cc,
                       params["D"], h0=h0)
    y = rmsnorm(y.reshape(Bsz, S, di) * F.silu(zgate), params["norm_scale"])
    return y.to(x.dtype) @ params["out_proj"], (h, conv_state)


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
