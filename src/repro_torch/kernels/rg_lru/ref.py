"""Plain PyTorch version of the RG-LRU linear recurrence (K5).

The same function as the CUDA kernels in ``csrc/rg_lru.cu`` and
``csrc/rg_lru_tma.cu`` and as the JAX package's
``kernels/rg_lru/ref.py::rg_lru_ref``; :func:`rg_lru_tiled_ref` takes
it in the tma kernel's order.  The CPU tests run them, and
``chip_smoke.py`` holds the kernels against :func:`rg_lru_ref` on the
card.  Neither is on the serving path when a card is present.
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


#: the tma kernel's channels a tile, tokens a stage and stages a ring
TILE, CHUNK, STAGES = 64, 8, 8


def rg_lru_tiled_ref(a, b, h0=None):
    """The walk of ``csrc/rg_lru_tma.cu``: the same function as
    :func:`rg_lru_ref`, bit for bit.  Channels in tiles of ``TILE`` (the
    last one ragged), each tile's tokens through a ring of ``STAGES``
    buffers of [``CHUNK`` tokens, ``TILE`` channels] (zeros past S and
    past d, as the TMA boxes arrive), a buffer refilled once its chunk
    is done; per token the product and the sum rounded apart, in token
    order.  Returns (h float32 [B, S, d], h_final float32 [B, d])."""
    tile, chunk, stages = TILE, CHUNK, STAGES
    B, S, d = a.shape
    h = (torch.zeros((B, d), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float().clone())
    af, bf = a.float(), b.float()
    hs = torch.empty((B, S, d), dtype=torch.float32, device=a.device)
    n_ch = -(-S // chunk)
    ring = torch.zeros((stages, 2, B, chunk, tile), dtype=torch.float32,
                       device=a.device)
    for c0 in range(0, d, tile):
        w = min(tile, d - c0)

        def fill(ch):
            buf, t0 = ring[ch % stages], ch * chunk
            n = min(chunk, S - t0)
            buf.zero_()
            buf[0, :, :n, :w] = af[:, t0:t0 + n, c0:c0 + w]
            buf[1, :, :n, :w] = bf[:, t0:t0 + n, c0:c0 + w]

        for ch in range(min(n_ch, stages)):
            fill(ch)
        hv = h[:, c0:c0 + w]
        for ch in range(n_ch):
            buf, t0 = ring[ch % stages], ch * chunk
            for u in range(min(chunk, S - t0)):
                hv = buf[0, :, u, :w] * hv + buf[1, :, u, :w]
                hs[:, t0 + u, c0:c0 + w] = hv
            if ch + stages < n_ch:
                fill(ch + stages)
        h[:, c0:c0 + w] = hv
    return hs, h
