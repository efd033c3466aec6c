"""AdamW with cosine schedule, global-norm clipping, bf16-param support.

Counterpart of the JAX package's ``optim/adamw.py``.  The state keeps
float32 master copies of the parameters and float32 moments; the
parameters stay in the model's dtype.  Where the reference is pure and
returns new trees, :func:`apply` updates the parameters, moments and
master copies in place under ``torch.no_grad()``: at olmo-1b a second
set of them would be some 18 GB.  The clip scale stays on the device
(no ``.item()``); the step counter lives on the host, so the learning
rate and the bias corrections are Python floats and a step reads
nothing back from the card.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from ..models.layers import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the host
    mu: Any
    nu: Any
    master: Any              # float32 master parameters


class AdamWConfig(NamedTuple):
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warm-up to ``lr_peak``, then a cosine decay to ``lr_min``."""
    if step < cfg.warmup_steps:
        return cfg.lr_peak * (step + 1) / max(cfg.warmup_steps, 1)
    prog = min(max((step - cfg.warmup_steps)
                   / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    return cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + math.cos(math.pi * prog))


def init(params: Any) -> AdamWState:
    zeros = lambda: tree_map(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    return AdamWState(torch.zeros((), dtype=torch.int32), zeros(), zeros(),
                      master)


def global_norm(tree: Any) -> torch.Tensor:
    """The float32 norm of all leaves together, on their device."""
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32)
        for g in tree_leaves(tree)]))


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, grads: Any,
          params: Any) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step, in place: returns (params, new state, metrics)
    with the same parameter, moment and master tensors updated."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = int(state.step)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step + 1)
    bc2 = 1 - b2 ** (step + 1)
    def upd(p, g, m, v, master):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        master.sub_(u.add_(master, alpha=cfg.weight_decay).mul_(lr))
        p.copy_(master)

    # leaves matched by key, not by order: trees that came through jax
    # have their keys sorted
    tree_map(upd, params, grads, state.mu, state.nu, state.master)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state._replace(step=state.step + 1), metrics
