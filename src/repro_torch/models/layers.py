"""Parameter definitions, norms, RoPE, embeddings, dense FFN.

Counterpart of the JAX package's ``models/layers.py``, limited to what
the paged decode path calls.  Parameters live in nested dicts of
tensors declared by :class:`ParamDef` trees, with the same tree,
shapes and dtypes as the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis names, len == ndim
    dtype: torch.dtype = torch.float32
    init: str = "normal"               # normal | zeros | ones


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def init_tree(defs, generator: torch.Generator, device="cuda") -> Any:
    """Initialize a tree of ParamDefs: normal leaves are N(0, 1) /
    sqrt(fan_in) drawn in float32 from ``generator`` (on ``device``),
    then cast.  torch's generator cannot reproduce ``jax.random``, so
    parity with the reference runs on bridged weights (``bridge.py``)."""
    def one(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[0] if d.shape else 1
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * (1.0 / math.sqrt(max(fan_in, 1)))).to(d.dtype)
    return tree_map(one, defs)


# ----------------------------------------------------------------- norms

def rmsnorm(x, scale=None, eps: float = 1e-6):
    """RMSNorm: the variance reduction in float32, the normalize and
    scale in x's dtype (the reference's bf16 primal chain)."""
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    if scale is not None:
        y = y * (1.0 + scale).to(x.dtype)
    return y


def ln_nonparam(x, eps: float = 1e-5):
    """OLMo-style non-parametric LayerNorm."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    rs = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mu.to(x.dtype)) * rs


def norm_defs(cfg):
    if cfg.norm == "ln_nonparam":
        return {}
    return {"scale": ParamDef((cfg.d_model,), ("embed",), torch.float32,
                              "zeros")}


def apply_norm(cfg, params, x):
    if cfg.norm == "ln_nonparam":
        return ln_nonparam(x)
    return rmsnorm(x, params["scale"])


# ----------------------------------------------------------------- rope

def rope_frequencies(head_dim: int, theta: float, device="cuda"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles for ``positions`` [..., seq]:
    float32 [..., seq, 1, head_dim / 2], shared by every layer of a step."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., :, None].float() * freqs     # [..., S, hd/2]
    return (torch.cos(angles)[..., :, None, :],
            torch.sin(angles)[..., :, None, :])


def rotate(x, cos, sin):
    """Apply RoPE tables from :func:`rope_tables` to x [..., seq, heads,
    head_dim] in float32; the result in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ----------------------------------------------------------------- ffn

def ffn_defs(cfg):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act={cfg.act!r}: this slice of the "
                                  f"port serves the dense SwiGLU FFN")
    return {
        "w_gate": ParamDef((d, f), ("embed", "mlp"), dt),
        "w_up": ParamDef((d, f), ("embed", "mlp"), dt),
        "w_down": ParamDef((f, d), ("mlp", "embed"), dt),
    }


def ffn_apply(cfg, params, x):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ----------------------------------------------------------------- embeds

def embed_defs(cfg):
    dt = cfg.tdtype
    out = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), dt)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef(
            (cfg.d_model, cfg.vocab), ("embed", "vocab"), dt)
    return out


def embed_apply(params, tokens):
    """Token embedding; ids are clamped into the vocabulary as a JAX
    gather clamps them."""
    tok = params["tok"]
    return tok[tokens.clamp(0, tok.shape[0] - 1).long()]


def logits_apply(cfg, params, x):
    w = params.get("lm_head")
    if w is None:
        w = params["tok"].T
    return x @ w
