"""Plain PyTorch version of the RG-LRU linear recurrence (K5).

The same function as the CUDA kernel in ``csrc/rg_lru.cu`` and as the
JAX package's ``kernels/rg_lru/ref.py::rg_lru_ref``.  The CPU tests run
it, and ``chip_smoke.py`` holds the kernel against it on the card.  It
is never on the serving path when a card is present.
"""

from __future__ import annotations

import torch


def rg_lru_ref(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t, sequential.  a, b: [B, S, d]; h0:
    [B, d] or None (zeros).  Returns (h float32 [B, S, d], h_final
    float32 [B, d]); ``h0`` is not modified."""
    B, S, d = a.shape
    h = (torch.zeros((B, d), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    hs = []
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h
