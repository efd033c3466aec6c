"""Plain PyTorch version of the Mamba-2 SSD scan (K4).

The direct sequential recurrence: the same function as the CUDA kernel
in ``csrc/ssd_scan.cu`` and as the JAX package's
``kernels/ssd_scan/ref.py::ssd_scan_ref``, which starts from a zero
state; this one also takes the carried state ``h0``.  The CPU tests run
it, and ``chip_smoke.py`` holds the kernel against it on the card.  It
is never on the serving path when a card is present.
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
