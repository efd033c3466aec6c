"""Plain PyTorch versions of the Mamba-2 SSD scan (K4).

:func:`ssd_scan_ref` is the direct sequential recurrence: the same
function as the CUDA kernels in ``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_wgmma.cu`` and as the JAX package's
``kernels/ssd_scan/ref.py::ssd_scan_ref``, which starts from a zero
state; this one also takes the carried state ``h0``.  The CPU tests run
it, and ``chip_smoke.py`` holds both kernels against it on the card.
It is never on the serving path when a card is present.

:func:`ssd_scan_chunked_ref` is the wgmma route's arithmetic written in
torch ops (chunks of 64 tokens, the decay masked before its exponent,
the float32 operands of the products cut into bf16 terms), for the
tests only.
"""

from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, A, Bm, Cm, D, h0=None):
    """x: [B, S, H, P]; dt: [B, S, H]; A, D: [H]; Bm, Cm: [B, S, N]; h0:
    float32 [B, H, P, N] or None (zeros).

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t + D x_t

    Returns (y [B, S, H, P] in x's dtype, h_final float32 [B, H, P, N]);
    everything is computed in float32 and ``h0`` is not modified.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t] * A[None, :])                    # [B, H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t], xf[:, t])
        h = h * a[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, 1) + xf * D[None, None, :, None]
    return y.to(x.dtype), h


def bf16_terms(v, terms: int):
    """``v`` (float32) as ``terms`` float32 tensors of bf16 values whose
    sum is ``v`` to about 2^(-8 terms): hi = bf16(v), then the bf16 of
    what is left, as the wgmma route feeds a float32 operand to the
    tensor cores."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def ssd_scan_chunked_ref(x, dt, A, Bm, Cm, D, h0=None, chunk: int = 64,
                         terms: int = 3):
    """The chunked dual form of the wgmma route (``csrc/ssd_scan_wgmma.cu``,
    the TPU kernel's algebra) from the carried state ``h0``, in the
    kernel's order of operations.  Per chunk of ``chunk`` tokens, the
    last one padded with zeros and dt = 0:

        cum = cumsum(dt A);  S1 = C B^T;  W = S1 o L o dt_j, where
        L_ij = exp(cum_i - cum_j) for i >= j and 0 above the diagonal,
        masked before the exponent;
        Y = (C h^T) o exp(cum_i) + W X;  y = Y + D x;
        h <- exp(a_total) h + X^T (B o exp(a_total - cum) dt)

    W, h and B_w, the float32 operands of the products, enter them as
    ``terms`` bf16 terms (:func:`bf16_terms`).  Shapes and result as
    :func:`ssd_scan_ref`; ``h0`` is not modified.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    pad = -S % Q
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    ys = []
    for s0 in range(0, S + pad, Q):
        xc, dtc = xf[:, s0:s0 + Q], dtf[:, s0:s0 + Q]        # [B,Q,H,P], [B,Q,H]
        Bc, Cc = Bf[:, s0:s0 + Q], Cf[:, s0:s0 + Q]          # [B, Q, N]
        cum = torch.cumsum(dtc * A[None, None, :], dim=1)    # [B, Q, H]
        a_tot = cum[:, -1]                                   # [B, H]
        s1 = torch.einsum("bin,bjn->bij", Cc, Bc)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # [B, i, j, H]
        L = torch.exp(seg.masked_fill(~below[None, :, :, None],
                                      float("-inf")))
        w = s1[..., None] * L * dtc[:, None, :, :]           # [B, i, j, H]
        y = sum(torch.einsum("bin,bhpn->bihp", Cc, t)
                for t in bf16_terms(h, terms))
        y = y * torch.exp(cum)[..., None]
        y = y + sum(torch.einsum("bijh,bjhp->bihp", t, xc)
                    for t in bf16_terms(w, terms))
        ys.append(y + xc * D[None, None, :, None])
        bw = Bc[:, :, None, :] * (torch.exp(a_tot[:, None] - cum)
                                  * dtc)[..., None]          # [B, Q, H, N]
        h = h * torch.exp(a_tot)[..., None, None] + sum(
            torch.einsum("bjhp,bjhn->bhpn", xc, t)
            for t in bf16_terms(bw, terms))
    return torch.cat(ys, 1)[:, :S].to(x.dtype), h
