"""Gradient compression: int8 quantization with error feedback.

Counterpart of the JAX package's ``parallel/compress.py``: gradients
are quantized to int8 with a per-tensor scale before the data-parallel
all-reduce, and the quantization error is carried in an error-feedback
buffer and added to the next step's gradients (8-bit symmetric).  The
port has one device, so ``--compress-grads`` runs the round trip the
all-reduce payload would take (:func:`compressed_grads`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..models.layers import tree_map


class EFState(NamedTuple):
    residual: Any        # same tree as grads, float32


def init_error_feedback(grads_like: Any) -> EFState:
    return EFState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale) with g ~ payload * scale; rounding
    half to even, as ``jnp.round``."""
    scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any, ef: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (q_tree, scale_tree, new_ef).  g' = g + residual; the
    dequantization error goes back into the residual."""
    def one(g, r):
        g = g.float() + r
        q, s = quantize(g)
        return q, s, g - dequantize(q, s)

    out = tree_map(one, grads, ef.residual)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), pick(1), EFState(pick(2))


def decompress_tree(qs: Any, ss: Any) -> Any:
    return tree_map(dequantize, qs, ss)


def compressed_grads(grads: Any, ef: EFState) -> Tuple[Any, EFState]:
    """Round-trip compress (models the all-reduce payload); returns the
    dequantized gradients the optimizer sees plus the new EF state."""
    qs, ss, ef = compress_tree(grads, ef)
    return decompress_tree(qs, ss), ef
