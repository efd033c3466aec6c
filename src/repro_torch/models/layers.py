"""Parameter definitions, norms, RoPE, embeddings, dense FFN, the causal
convolution of the recurrent blocks.

Counterpart of the JAX package's ``models/layers.py``, limited to what
the decode and training paths call.  Parameters live in nested dicts of
tensors declared by :class:`ParamDef` trees, with the same tree,
shapes and dtypes as the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import partition


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis names, len == ndim
    dtype: torch.dtype = torch.float32
    init: str = "normal"               # normal | zeros | ones


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of nested dicts, and to the
    leaves at the same keys of the trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def init_tree(defs, generator: torch.Generator, device="cuda") -> Any:
    """Initialize a tree of ParamDefs: normal leaves are N(0, 1) /
    sqrt(fan_in) drawn in float32 from ``generator`` (on ``device``),
    scaled in place (one float32 buffer a leaf: llama4-maverick's expert
    leaf alone is 21.5 GB in float32), then cast.  torch's generator
    cannot reproduce ``jax.random``, so parity with the reference runs
    on bridged weights (``bridge.py``)."""
    def one(d: ParamDef):
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[0] if d.shape else 1
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(d.dtype)
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
    head_dim] in float32; the result in x's dtype.  The tables are
    constants of the step: beside a sharded x they enter replicated."""
    cos, sin = partition.constant(cos, x), partition.constant(sin, x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ----------------------------------------------------------------- ffn

def ffn_defs(cfg):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    if cfg.act == "swiglu":
        return {
            "w_gate": ParamDef((d, f), ("embed", "mlp"), dt),
            "w_up": ParamDef((d, f), ("embed", "mlp"), dt),
            "w_down": ParamDef((f, d), ("mlp", "embed"), dt),
        }
    return {
        "w_up": ParamDef((d, f), ("embed", "mlp"), dt),
        "w_down": ParamDef((f, d), ("mlp", "embed"), dt),
    }


def gelu(x):
    """GeLU in its tanh form, which ``jax.nn.gelu`` computes by default
    (torch's default, the erf form, differs by more than 1e-4)."""
    return F.gelu(x, approximate="tanh")


def ffn_apply(cfg, params, x):
    if cfg.act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]


# ----------------------------------------------------------------- conv

def causal_conv(x, w, state, lens):
    """Depthwise causal convolution of a chunk, kernel K = w.shape[0].

    x: [B, T, C]; w: [K, C]; state: [B, K - 1, C], the K - 1 inputs
    before the chunk; lens: [B] valid tokens of the chunk.  Returns
    (y [B, T, C], new_state [B, K - 1, C]): the new state is the K - 1
    inputs that end at each sequence's last valid token, so a ragged
    tail leaves it as token-by-token updates would (lens = 0 keeps the
    old state)."""
    B, T, C = x.shape
    K = w.shape[0]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + T] * w[i] for i in range(K))
    idx = lens.long()[:, None] + torch.arange(K - 1, device=x.device)
    return y, xp.gather(1, idx[..., None].expand(B, K - 1, C))


# ----------------------------------------------------------------- embeds

def embed_defs(cfg):
    dt = cfg.tdtype
    out = {"tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), dt)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef(
            (cfg.d_model, cfg.vocab), ("embed", "vocab"), dt)
    return out


def _lookup_shard(tok, ids, v0: int):
    """A vocabulary shard's share of the lookup: rows ``ids - v0`` of a
    table holding vocabulary rows [v0, v0 + len(tok)), zeros for ids
    outside them."""
    local = ids.long() - v0
    hit = (local >= 0) & (local < tok.shape[0])
    return torch.where(hit[..., None],
                       tok[local.clamp(0, tok.shape[0] - 1)], 0)


def _embed_out(mesh, parts):
    """The rows: the ids' batch shard, partial sums over "model" where
    the table's vocabulary is sharded there."""
    from torch.distributed.tensor import Partial
    plc = list(partition.placements((parts[1][0], None, None), mesh))
    if parts[0][0] == "model":
        plc[mesh.mesh_dim_names.index("model")] = Partial()
    return (tuple(plc),)


#: the vocabulary-parallel lookup: the table's vocabulary shard over
#: "model" (its embed dim gathered), the ids' batch shard
_embed_shards = partition.local_map(
    _lookup_shard, ((partition.MODEL, None), (partition.BATCH, None), None),
    _embed_out)


def embed_apply(params, tokens):
    """Token embedding; ids are clamped into the vocabulary as a JAX
    gather clamps them.  A sharded table is looked up shard by shard
    (:data:`_embed_shards`)."""
    tok = params["tok"]
    ids = tokens.clamp(0, tok.shape[0] - 1)
    if not partition.is_sharded(tok):
        # F.embedding, not tok[ids]: indexing's backward accumulates
        # repeated ids with atomic adds on a multi-threaded CPU, so the
        # table's gradient would change from run to run
        return F.embedding(ids.long(), tok)
    v0 = partition.shard_offset(tok, 0, "model")
    return _embed_shards(tok, ids, v0)


def logits_apply(cfg, params, x):
    w = params.get("lm_head")
    if w is None:
        w = params["tok"].T
    return x @ w


def logits_argmax_chunked(cfg, params, x, chunk: int = 1024):
    """``argmax(logits_apply(cfg, params, x), -1)`` as int32 without
    building the [..., V] logits: a running (max, argmax) over
    vocabulary chunks.  Each candidate logit is the dot product the
    full projection computes, and ascending chunk order with a strict
    ``>`` keeps the first maximum, as a full argmax does.  The
    speculative verify path scores its positions with it."""
    w = params.get("lm_head")
    if w is None:
        w = params["tok"].T
    V = w.shape[1]
    chunk = min(chunk, V)
    best = torch.full(x.shape[:-1], -torch.inf, dtype=torch.float32,
                      device=x.device)
    arg = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for off in range(0, V, chunk):
        lg = (x @ w[:, off:off + chunk]).float()
        m, a = lg.amax(-1), lg.argmax(-1)        # argmax: first maximum
        upd = m > best
        best = torch.where(upd, m, best)
        arg = torch.where(upd, a.to(torch.int32) + off, arg)
    return arg


def _gold_shard(logits, labels, v0: int):
    """A vocabulary shard's share of the gold logits: ``logits[...,
    label - v0]`` where the label lies in the shard's columns [v0, v0 +
    V_local), zero elsewhere."""
    local = labels.long() - v0
    hit = (local >= 0) & (local < logits.shape[-1])
    g = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None])
    return torch.where(hit, g[..., 0], 0.0)


def _gold_out(mesh, parts):
    """The gold logits: the labels' batch shard, partial sums over
    "model" where the logits' vocabulary is sharded there."""
    from torch.distributed.tensor import Partial
    plc = list(partition.placements((parts[1][0], None), mesh))
    if parts[0][2] == "model":
        plc[mesh.mesh_dim_names.index("model")] = Partial()
    return (tuple(plc),)


#: the gold logits of vocabulary-sharded logits [B, c, V], shard by shard
_gold_shards = partition.local_map(
    _gold_shard, ((partition.BATCH, None, partition.MODEL),
                  (partition.BATCH, None), None), _gold_out)


def _minus_gold_shard(p, labels, v0: int):
    """``p`` minus the one-hot of the labels on a vocabulary shard's
    columns [v0, v0 + V_local): the softmax's gradient of the
    cross-entropy, shard by shard."""
    local = labels.long() - v0
    hit = (local >= 0) & (local < p.shape[-1])
    onehot = torch.zeros_like(p).scatter_(
        -1, local.clamp(0, p.shape[-1] - 1)[..., None],
        hit[..., None].to(p.dtype))
    return p - onehot


_minus_gold_shards = partition.local_map(
    _minus_gold_shard, ((partition.BATCH, None, partition.MODEL),
                        (partition.BATCH, None), None), partition.like(0))


class _ShardedXent(torch.autograd.Function):
    """Summed cross-entropy of vocabulary-sharded float32 logits [B, c,
    V]: the log-sum-exp from the shards' maxima and sums (two small
    reductions over "model"), the gold logits from the shard that holds
    each label; the gradient (softmax - one-hot) is formed in the
    logits' own layout, shard by shard, so the backward needs no
    reshard of [B, c, V]."""

    @staticmethod
    def forward(ctx, logits, labels, v0):
        m = logits.amax(-1, keepdim=True)
        e = torch.exp(logits - m)
        s = e.sum(-1, keepdim=True)
        lse = torch.log(s)[..., 0] + m[..., 0]
        ctx.save_for_backward(e, s, labels)
        ctx.v0 = v0
        return (lse - _gold_shards(logits, labels, v0)).sum()

    @staticmethod
    def backward(ctx, g):
        e, s, labels = ctx.saved_tensors
        return _minus_gold_shards(e / s, labels, ctx.v0) * g, None, None


def _xent_sum(xc, yc, w):
    """Summed cross-entropy of one chunk: logits in float32.  Sharded
    logits go through :class:`_ShardedXent`."""
    logits = (xc @ w).float()
    if not partition.is_sharded(logits):
        gold = logits.gather(-1, yc[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()
    return _ShardedXent.apply(logits, yc,
                              partition.shard_offset(logits, 2, "model"))


def chunked_softmax_xent(cfg, embed_params, x, labels, chunk: int = 512):
    """Mean cross-entropy over tokens without holding [B, S, V] logits:
    sequence chunks in order, the ``S % chunk`` remainder last, each
    under ``torch.utils.checkpoint`` so the backward pass recomputes its
    float32 logits instead of keeping them."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    w = embed_params.get("lm_head")
    if w is None:
        w = embed_params["tok"].T
    w = partition.unshard(w, 0)      # the FSDP gather of the embed dim
    x = partition.gather_model(x)    # the sequence shard of "sp" gathered
    total = 0.0
    for off in range(0, S, chunk):
        total = total + checkpoint(_xent_sum, x[:, off:off + chunk],
                                   labels[:, off:off + chunk], w,
                                   use_reentrant=False)
    return total / (B * S)
