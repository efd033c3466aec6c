"""Griffin RG-LRU recurrent block [arXiv:2402.19427]: the full-sequence
form of training and prefill, and the chunk form of serving.

Real-Gated Linear Recurrent Unit:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Counterpart of the JAX package's ``models/rglru.py``.  Training and
prefill run :func:`rglru_scan`, the reference's associative scan in
plain torch ops under autograd (the reference differentiates its jnp
form too; K5 has no backward): :func:`associative_scan` repeats
``jax.lax.associative_scan``'s odd/even recursion step for step, about
2 log2 S levels of elementwise passes over O(S) elements in all.  The
reference
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


def _interleave(a, b, dim: int):
    """a's elements at the even positions of ``dim``, b's at the odd
    ones; a is as long as b or one longer."""
    n = b.shape[dim]
    ab = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1).flatten(
        dim, dim + 1)
    if a.shape[dim] > n:
        ab = torch.cat([ab, a.narrow(dim, n, 1)], dim=dim)
    return ab


def associative_scan(fn, elems, dim: int = 1):
    """Inclusive scan of the tuple of tensors ``elems`` along ``dim``
    under the associative ``fn(left, right)``, in
    ``jax.lax.associative_scan``'s order of operations: combine the
    pairs (0, 1), (2, 3), ...; scan those; combine each odd result with
    the next even element; put the first element in front; interleave.
    Each level combines the same operands as the reference's, so the
    result is bit-equal to its eager form in float32."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _combine(left, right):
    """(a, b) pairs of h -> a h + b: the left map, then the right."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def rglru_scan(params, x, h0=None):
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, h_final float32 [B,
    d]), from the optional carried state h0 (float32 [B, d]), which
    enters as the reference folds it: b_0 += a_0 h0."""
    a, b = _gates(params, x)                            # [B, S, d] f32
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h = associative_scan(_combine, (a, b), dim=1)
    return h.to(x.dtype), h[:, -1]


def rglru_block_full(cfg, params, x, h0=None, conv0=None):
    """One Griffin recurrent block over a full sequence (training and
    prefill): x [B, S, d] -> (y [B, S, d], (h_final, conv_state)), from
    the optional carried RG-LRU state h0 (float32 [B, d]) and conv
    inputs conv0 ([B, rglru_conv - 1, d]); the conv starts from zeros
    without one."""
    Bsz, S, d = x.shape
    gate = gelu(x @ params["w_gate"])
    u = x @ params["w_x"]
    if conv0 is None:
        conv0 = u.new_zeros((Bsz, params["conv_w"].shape[0] - 1, d))
    u, conv_state = causal_conv(
        u, params["conv_w"], conv0,
        torch.full((Bsz,), S, dtype=torch.int32, device=x.device))
    y, h = rglru_scan(params, u, h0)
    return (y * gate) @ params["w_out"], (h, conv_state)


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
