"""Top-level model API of the port: parameters and decode steps.

Counterpart of the JAX package's ``models/model.py`` for the paged
decode path.
"""

from __future__ import annotations

import torch

from .layers import init_tree, logits_apply
from .transformer import DecodeState, forward_decode_chunk, model_defs


def param_defs(cfg):
    return model_defs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed``: the reference's tree, shapes and
    dtypes, drawn with a ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_tree(model_defs(cfg), gen, device)


def decode_step(cfg, params, tokens, state: DecodeState, active=None):
    """One decode step: (logits [DP, Bl, V], new state) — a width-1
    token lane through :func:`forward_decode_chunk`; inactive slots
    feed a zero-length lane and stay inert."""
    if active is None:
        active = torch.ones(tokens.shape, dtype=torch.bool,
                            device=tokens.device)
    x, state = forward_decode_chunk(cfg, params, tokens[:, :, None], state,
                                    active.to(torch.int32), active=active)
    return logits_apply(cfg, params["embed"], x[:, :, 0]), state


def decode_step_chunk(cfg, params, tokens, state: DecodeState, lens,
                      active=None):
    """Chunked decode/prefill step: (logits [DP, Bl, T, V], new state,
    ok bool[DP, Bl]).  ok is False where the chunk was denied whole
    (page-table overflow or pool exhaustion: nothing appended)."""
    T = tokens.shape[2]
    if active is None:
        active = torch.ones(tokens.shape[:2], dtype=torch.bool,
                            device=tokens.device)
    asked = torch.where(active, lens.to(torch.int32).clamp(0, T), 0)
    base = state.seq_lens
    x, state = forward_decode_chunk(cfg, params, tokens, state, lens,
                                    active=active)
    logits = logits_apply(cfg, params["embed"], x)
    return logits, state, state.seq_lens - base == asked
