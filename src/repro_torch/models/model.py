"""Top-level model API of the port: parameters and their counts, the
training loss, prefill and decode steps.

Counterpart of the JAX package's ``models/model.py`` for the training,
prefill and paged decode paths.
"""

from __future__ import annotations

import math

import torch

from ..parallel import partition
from .layers import (chunked_softmax_xent, init_tree, logits_apply,
                     tree_leaves, tree_map)
from .transformer import (DecodeState, forward_decode_chunk,
                          forward_prefill, forward_train, model_defs)


def param_defs(cfg):
    return model_defs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random parameters from ``seed``: the reference's tree, shapes and
    dtypes, drawn with a ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_tree(model_defs(cfg), gen, device)


def param_shapes(cfg):
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no allocation."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), model_defs(cfg))


def count_params(cfg) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(model_defs(cfg)))


def count_active_params(cfg) -> int:
    """Parameters a token uses: a mixture of experts' expert weights
    scaled by top_k / E (the router counts whole)."""
    if cfg.moe is None:
        return count_params(cfg)

    def walk(tree) -> int:
        if not isinstance(tree, dict):
            return math.prod(tree.shape)
        if "router" not in tree:
            return sum(walk(v) for v in tree.values())
        total = 0                                   # a MoE FFN subtree
        for k, v in tree.items():
            n = sum(math.prod(d.shape) for d in tree_leaves(v))
            if k.startswith("w_"):                  # expert weights
                n = n * cfg.moe.top_k // cfg.moe.num_experts
            total += n
        return total

    return walk(model_defs(cfg))


# ------------------------------------------------------------------- train

def loss_fn(cfg, params, batch, remat: bool = True):
    """Causal LM loss: the mean cross-entropy of ``batch["labels"]``
    after ``batch["tokens"]``, chunked (never holds [B, S, V] logits).
    The batch also carries a VLM's ``img_embeds``, whose positions the
    loss leaves out, or an encoder-decoder's ``enc_embeds``."""
    x = forward_train(cfg, params, batch["tokens"], extra=batch,
                      remat=remat)
    if cfg.arch_kind == "vlm" and "img_embeds" in batch:
        x = x[:, batch["img_embeds"].shape[1]:]     # text positions only
    return chunked_softmax_xent(cfg, params["embed"], x, batch["labels"])


# ------------------------------------------------------------------- serve

def prefill(cfg, params, batch):
    """Prompt processing: (last-token logits [B, V], caches) of
    :func:`forward_prefill` over ``batch["tokens"]`` [B, S], with a
    VLM's ``img_embeds`` or an encoder-decoder's ``enc_embeds`` where
    the batch holds them."""
    x, caches = forward_prefill(cfg, params, batch["tokens"], extra=batch)
    with torch.no_grad():
        return logits_apply(cfg, params["embed"], x[:, -1]), caches


def decode_step(cfg, params, tokens, state: DecodeState, active=None):
    """One decode step: (logits [DP, Bl, V], new state) — a width-1
    token lane through :func:`forward_decode_chunk`; inactive slots
    feed a zero-length lane and stay inert."""
    if active is None:
        active = partition.constant(
            torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device),
            tokens)
    x, state, _ = forward_decode_chunk(cfg, params, tokens[:, :, None],
                                       state, active.to(torch.int32),
                                       active=active)
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
    x, state, _ = forward_decode_chunk(cfg, params, tokens, state, lens,
                                       active=active)
    logits = logits_apply(cfg, params["embed"], x)
    return logits, state, state.seq_lens - base == asked
