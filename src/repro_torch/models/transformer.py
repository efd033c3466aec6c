"""Decoder stack, the training and prefill forwards, decode state and
the chunked decode forward.

Counterpart of the JAX package's ``models/transformer.py``.  Training
(:func:`forward_train`) and prefill (:func:`forward_prefill`) cover
decoders of global and local attention, SSD and RG-LRU layers with a
dense or MoE FFN: global layers run K6, recurrent layers their
full-sequence forms in torch ops (``models/ssm.py``,
``models/rglru.py``).  An encoder-decoder (whisper) runs a stack of
bidirectional global layers over stubbed frame embeddings first (K6
with ``causal=False``) and gives each decoder layer a cross-attention
over the encoder's output; its decode state carries each layer's cross
K/V in ``enc_kv``.  A VLM (phi-3-vision) prepends stubbed image patch
embeddings to the text and is a decoder from there on.  Serving covers decoders of
global attention over **paged KV** (olmo-1b, llama3.2-1b, phi4-mini),
sliding-window attention over per-slot **ring** slabs (gemma3's local layers,
recurrentgemma's, mixtral's), and recurrent **SSD** (mamba2) and
**RG-LRU** (recurrentgemma) layers over per-slot state slabs, with a
dense SwiGLU or GeLU FFN or a mixture of experts (:mod:`.moe`).  Pages
come from the two-level size-classed pool
(:mod:`repro_torch.core.classed_pool`) exactly as in the reference:
per-slot private lanes over a per-shard shared stack; a two-class pool
adds the fine ``CLS_STATE`` class that bounded ring and recurrent state
is admitted against, and a three-class pool the ``CLS_EXPERT`` class
whose read-only pages hold expert weights (expert-paged MoE serving:
each MoE layer reads its experts through a per-layer page table).

Decode batch layout is [DP, B_local, ...]; DP stays a leading axis on
one device, as in the reference's single-device fallback.

Where the port departs from the reference's pure functions: KV pages,
rings and recurrent state are updated in place (a copy of every
layer's state per step is what a functional update would cost).  Each
shard's page array carries one extra page, index ``pages_local``, that
the allocator never grants, and each ring one extra slot, index W:
masked tokens are written there, which is how this port expresses
JAX's out-of-range ``mode="drop"`` scatter; the expert pages carry a
sink page too, index NB2, where a load addressed to another shard
writes.  Page and state tables, lengths and the pool are replaced, not
mutated; expert pages and expert tables change in place, by loads and
evictions only (``serving/expert_pages.py``).  The reference runs a
recurrent layer over a chunk as T gated single-token updates; the port
runs it as one chunk pass through the scan kernels K4 and K5, with the
ragged tail made inert inside the scan (``models/ssm.py``,
``models/rglru.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import base_kind, is_moe_kind
from ..core import block_pool, classed_pool
from ..core.block_pool import I32, NULL
from ..core.classed_pool import CLS_EXPERT, CLS_KV, ClassSpec
from ..kernels.paged_attention.ops import (paged_attention,
                                          paged_attention_chunk)
from ..kernels.paged_attention.ref import NEG_INF
from ..kernels.verify_attention.ops import (verify_attention, verify_route,
                                            workspace_numel)
from ..kernels.verify_attention.schedule import (build_verify_schedule,
                                                 build_verify_units)
from ..parallel import partition
from ..parallel.partition import (BATCH, KEEP, MODEL, constrain_batch,
                                  gather_model)
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .attention import _expand_kv
from .layers import (ParamDef, apply_norm, embed_apply, embed_defs,
                     ffn_apply, ffn_defs, norm_defs, rope_tables, rotate,
                     tree_leaves, tree_map)


# ===================================================================== defs

def _check_slice(cfg) -> None:
    """Raise for a configuration the port does not cover: a layer kind
    outside global, local, ssd and rglru, an ``arch_kind`` outside
    decoder, encdec and vlm, or an encoder-decoder whose pattern is
    longer than one layer (the reference's decode asserts that too:
    ``enc_kv`` is indexed by pattern group)."""
    kinds = set(map(base_kind, cfg.pattern + cfg.remainder))
    if (not kinds <= {"global", "local", "ssd", "rglru"}
            or cfg.arch_kind not in ("decoder", "encdec", "vlm")
            or (cfg.arch_kind == "encdec" and len(cfg.pattern) != 1)):
        raise NotImplementedError(
            f"{cfg.name}: the port serves decoders, VLMs and "
            f"encoder-decoders of pattern length 1, of global, local, ssd "
            f"and rglru layers with a dense or MoE FFN (pattern "
            f"{cfg.pattern}, arch_kind {cfg.arch_kind!r})")


def attn_defs(cfg):
    d, H, KH, hd, dt = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.tdtype)
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim"), dt),
        "wk": ParamDef((d, KH, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamDef((d, KH, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed"), dt),
    }


def _stack(defs, n: int):
    if isinstance(defs, dict):
        return {k: _stack(v, n) for k, v in defs.items()}
    return ParamDef((n,) + defs.shape, ("layers",) + defs.axes, defs.dtype,
                    defs.init)


def layer_defs(cfg, kind: str, with_xattn: bool = False):
    """One layer's parameters; ``with_xattn`` adds an encoder-decoder's
    cross-attention (``norm_x``, ``xattn``)."""
    bk = base_kind(kind)
    if bk not in ("global", "local", "ssd", "rglru"):
        raise NotImplementedError(f"layer kind {kind!r}")
    d = {"norm1": norm_defs(cfg)}
    if bk in ("global", "local"):
        d["attn"] = attn_defs(cfg)
    elif bk == "ssd":
        d["ssd"] = ssm_mod.ssd_defs(cfg)
    else:
        d["rglru"] = rglru_mod.rglru_defs(cfg)
    if with_xattn:
        d["norm_x"] = norm_defs(cfg)
        d["xattn"] = attn_defs(cfg)
    if bk != "ssd" and cfg.d_ff:
        d["norm2"] = norm_defs(cfg)
        d["ffn"] = (moe_mod.moe_defs(cfg) if is_moe_kind(kind)
                    else ffn_defs(cfg))
    return d


def model_defs(cfg):
    """The reference's parameter tree: ``embed``, ``final_norm`` (RMS
    configs), ``groups`` (the pattern groups stacked on a leading layers
    axis) and ``rem``; an encoder-decoder adds cross-attention to every
    decoder layer, ``encoder`` (``enc_layers`` global layers, stacked)
    and ``enc_final_norm``."""
    _check_slice(cfg)
    encdec = cfg.arch_kind == "encdec"
    defs = {"embed": embed_defs(cfg)}
    fn = norm_defs(cfg)
    if fn:
        defs["final_norm"] = fn
    group = {f"pos{j}": layer_defs(cfg, k, encdec)
             for j, k in enumerate(cfg.pattern)}
    if cfg.n_groups:
        defs["groups"] = _stack(group, cfg.n_groups)
    if cfg.remainder:
        defs["rem"] = {f"pos{j}": layer_defs(cfg, k, encdec)
                       for j, k in enumerate(cfg.remainder)}
    if encdec:
        defs["encoder"] = _stack(layer_defs(cfg, "global"), cfg.enc_layers)
        if fn:
            defs["enc_final_norm"] = norm_defs(cfg)
    return defs


# ================================================================ train path

#: sharding boundaries of the recurrent blocks over a full sequence: each
#: batch shard runs the whole block (its parameters gathered) on its rows
_ssd_full_shards = partition.local_map(
    ssm_mod.ssd_block_full, (None, None, (BATCH, None, None)),
    partition.like(-1))
_rglru_full_shards = partition.local_map(
    rglru_mod.rglru_block_full, (None, None, (BATCH, None, None)),
    partition.like(-1))


def _mix_train(cfg, lp, x, kind: str, enc_out=None, causal: bool = True):
    """One layer over the full sequence: returns (x, cache), the cache
    (k, v) for an attention layer and the final recurrent state {"h",
    "conv"} for an SSD or RG-LRU layer.  A layer with cross-attention,
    given the encoder's output ``enc_out`` [B, L, d], attends over its
    projections after the self-attention, and its cache is then
    ``(self_cache, (k, v))`` with the cross K/V [B, L, KH, hd].  An FFN
    with a router is the mixture of experts; an SSD layer has none."""
    bk = base_kind(kind)
    if partition.is_sharded(x):
        # the FSDP gather of the layer's embed-sharded parameters (under
        # remat it is recomputed in the backward, as FSDP re-gathers)
        lp = partition.unshard_axis(lp, layer_defs(cfg, kind, "xattn" in lp))
    h = gather_model(apply_norm(cfg, lp["norm1"], x))
    if bk in ("global", "local"):
        o, cache = attn.attention_train(cfg, lp["attn"], h, bk, causal)
    else:
        block = _ssd_full_shards if bk == "ssd" else _rglru_full_shards
        o, (hn, cn) = block(cfg, lp[bk], h)
        cache = {"h": hn, "conv": cn}
    x = constrain_batch(x + gather_model(o))
    if "xattn" in lp and enc_out is not None:
        hx = gather_model(apply_norm(cfg, lp["norm_x"], x))
        enc = gather_model(enc_out)
        k = torch.einsum("bsd,dhk->bshk", enc, lp["xattn"]["wk"])
        v = torch.einsum("bsd,dhk->bshk", enc, lp["xattn"]["wv"])
        x = constrain_batch(x + gather_model(attn.cross_attention(
            cfg, lp["xattn"], hx, (k, v))))
        cache = (cache, (k, v))
    if "ffn" in lp:
        h2 = gather_model(apply_norm(cfg, lp["norm2"], x))
        x = constrain_batch(x + gather_model(
            moe_mod.moe_apply(cfg, lp["ffn"], h2) if "router" in lp["ffn"]
            else ffn_apply(cfg, lp["ffn"], h2)))
    return x, cache


def _final_norm(cfg, params, x, name: str = "final_norm"):
    """``params[name]`` (a final norm's parameters, {} for a
    non-parametric norm), its embed dim gathered beside a sharded x."""
    p = params.get(name, {})
    return partition.unshard_axis(p, norm_defs(cfg)) if (
        partition.is_sharded(x)) else p


def _unstack(stacked, n: int):
    """A stacked parameter tree (``groups``, ``encoder``) as n trees.
    Each stacked leaf is split once with ``torch.unbind``: indexing a
    stack inside the loop would make every index's backward write a
    zero tensor as large as the stack."""
    stacks = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda t: t[g], stacks) for g in range(n)]


def _group_params(cfg, params):
    """The stacked ``groups`` parameters as one tree per group."""
    return _unstack(params["groups"], cfg.n_groups)


def _encoder_apply(cfg, params, enc_embeds, remat: bool = True):
    """Whisper-style encoder over stubbed frame embeddings [B, L, d]:
    the ``encoder`` stack's global layers, bidirectional (K6 with
    ``causal=False``), each under ``torch.utils.checkpoint`` when
    ``remat`` (the reference remats each), then ``enc_final_norm``."""
    def layer(x, lp):
        x = constrain_batch(x)
        return _mix_train(cfg, lp, x, "global", causal=False)[0]

    x = enc_embeds
    n = tree_leaves(params["encoder"])[0].shape[0]
    for lp in _unstack(params["encoder"], n):
        x = (checkpoint(layer, x, lp, use_reentrant=False) if remat
             else layer(x, lp))
    if "enc_final_norm" in params:
        x = apply_norm(cfg, _final_norm(cfg, params, x, "enc_final_norm"), x)
    return x


def _embed_inputs(cfg, params, tokens, extra, remat: bool):
    """(x [B, S', d], enc_out): the token embeddings, after a VLM's
    ``extra["img_embeds"]`` [B, I, d] where given (S' = I + S), and an
    encoder-decoder's encoder output over ``extra["enc_embeds"]``."""
    x = embed_apply(params["embed"], tokens).to(cfg.tdtype)
    if cfg.arch_kind == "vlm" and extra and "img_embeds" in extra:
        x = torch.cat([extra["img_embeds"].to(cfg.tdtype), x], dim=1)
    x = constrain_batch(x)
    enc_out = None
    if cfg.arch_kind == "encdec":
        if not extra or "enc_embeds" not in extra:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             f"extra['enc_embeds'] [B, enc_len, d]")
        enc_out = constrain_batch(_encoder_apply(
            cfg, params, extra["enc_embeds"].to(cfg.tdtype), remat))
    return x, enc_out


def forward_train(cfg, params, tokens, extra=None, remat: bool = True):
    """tokens [B, S] (and, in ``extra``, a VLM's ``img_embeds`` or an
    encoder-decoder's ``enc_embeds``) -> hidden [B, S', d].

    The reference scans the stacked ``groups`` parameters and remats
    each pattern group (``jax.checkpoint``); here each group runs under
    ``torch.utils.checkpoint``, so its activations are recomputed in
    the backward pass (K6 runs twice a global layer a step).  The
    remainder layers run outside it, as in the reference."""
    _check_slice(cfg)
    x, enc_out = _embed_inputs(cfg, params, tokens, extra, remat)

    def group(x, gp, enc_out):
        x = constrain_batch(x)
        for j, kind in enumerate(cfg.pattern):
            x, _ = _mix_train(cfg, gp[f"pos{j}"], x, kind, enc_out)
        return constrain_batch(x)

    if cfg.n_groups:
        for gp in _group_params(cfg, params):
            x = (checkpoint(group, x, gp, enc_out, use_reentrant=False)
                 if remat else group(x, gp, enc_out))
    for j, kind in enumerate(cfg.remainder):
        x, _ = _mix_train(cfg, params["rem"][f"pos{j}"], x, kind, enc_out)
    return apply_norm(cfg, _final_norm(cfg, params, x), x)


def _stack_caches(caches):
    """Per-group caches (each a (k, v) tuple, an {"h", "conv"} dict or
    an encoder-decoder's ((k, v), (k_x, v_x))) stacked leaf by leaf on a
    new leading axis."""
    first = caches[0]
    if isinstance(first, tuple):
        return tuple(_stack_caches(list(leaf)) for leaf in zip(*caches))
    if isinstance(first, dict):
        return {k: _stack_caches([c[k] for c in caches]) for k in first}
    return torch.stack(caches)


@torch.no_grad()
def forward_prefill(cfg, params, tokens, extra=None):
    """Full-sequence forward that also returns every layer's cache:
    tokens [B, S] (and ``extra`` as for :func:`forward_train`) ->
    (hidden [B, S', d], caches).

    ``caches["pos{j}"]`` stacks pattern position j's caches over the
    groups, as the reference's ``lax.scan`` stacks them: attention
    layers dense (k, v) of [n_groups, B, S', KH, hd], recurrent layers
    their final {"h", "conv"} of [n_groups, B, ...], an
    encoder-decoder's layers ((k, v), (k_x, v_x)) with the cross K/V of
    [n_groups, B, L, KH, hd]; ``caches["rem{j}"]`` the remainder
    layers' with a leading axis of 1; ``caches["enc_out"]`` the
    encoder's output [B, L, d].
    :func:`repro_torch.models.decode_init.load_prefill` scatters them
    into a decode state.  No autograd, no remat."""
    _check_slice(cfg)
    x, enc_out = _embed_inputs(cfg, params, tokens, extra, remat=False)
    per_group = {f"pos{j}": [] for j in range(len(cfg.pattern))}
    if cfg.n_groups:
        for gp in _group_params(cfg, params):
            x = constrain_batch(x)
            for j, kind in enumerate(cfg.pattern):
                x, c = _mix_train(cfg, gp[f"pos{j}"], x, kind, enc_out)
                per_group[f"pos{j}"].append(c)
            x = constrain_batch(x)
    caches = {pos: _stack_caches(cs) for pos, cs in per_group.items() if cs}
    for j, kind in enumerate(cfg.remainder):
        x, c = _mix_train(cfg, params["rem"][f"pos{j}"], x, kind, enc_out)
        caches[f"rem{j}"] = _stack_caches([c])
    if enc_out is not None:
        caches["enc_out"] = enc_out
    return apply_norm(cfg, _final_norm(cfg, params, x), x), caches


# ============================================================== decode state

class DecodeState(NamedTuple):
    """Per-sequence serving state, [DP, B_local, ...] layouts.

    kv_pages:    dict pos -> (k, v) [n_stack, DP, pages_local + 1, psz,
                 KH, hd]; the last page of each shard is the write sink
                 of masked tokens, never granted and never read
    rings:       dict pos -> (k, v) [n_stack, DP, Bl, W + 1, KH, hd];
                 slot W of each ring is the write sink of masked tokens
    rec:         dict pos -> {"h", "conv"} recurrent state slabs
                 [n_stack, DP, Bl, ...] (:func:`_rec_state_defs`)
    page_tables: int32 [DP, Bl, max_pages]   (shared by all paged layers)
    seq_lens:    int32 [DP, Bl]
    pool:        ClassedPool with leading-[DP] leaves: class CLS_KV backs
                 the paged KV with per-slot private lanes of capacity
                 3*ell over a per-shard shared stack; a two-class pool
                 adds CLS_STATE, the fine class that meters each slot's
                 bounded ring and recurrent state
    state_tables: int32 [DP, Bl, state_blocks_per_slot] CLS_STATE grants
                 of each slot (granted at admission, freed at release),
                 or None in a single-class pool
    expert_pages: [DP, NB2 + 1, d_model * d_ff] CLS_EXPERT page payloads
                 (expert-paged MoE): each page holds one expert weight
                 matrix, flat; page NB2 of each shard is the write sink
                 of a load addressed to another shard.  Written only by
                 the expert loader; the step reads them by gathers
    expert_tables: dict pos -> int32 [stack, DP, E, EXPERT_PPE], the page
                 ids of each MoE layer slot's experts (w_gate, w_up,
                 w_down), NULL where not resident; changed only by
                 loads and evictions.  Both None without expert paging
    enc_kv:      an encoder-decoder's cross K/V, (k, v) [n_layers, DP,
                 Bl, enc_len, KH, hd] in layer order, written by
                 :func:`repro_torch.models.decode_init.load_prefill`;
                 metered in a two-class pool as ``enc_len`` tokens a
                 layer of CLS_STATE blocks (:func:`state_blocks_per_slot`).
                 None for other models
    """
    kv_pages: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    rings: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    rec: Dict[str, Dict[str, torch.Tensor]]
    page_tables: torch.Tensor
    seq_lens: torch.Tensor
    pool: classed_pool.ClassedPool
    state_tables: Optional[torch.Tensor] = None
    expert_pages: Optional[torch.Tensor] = None
    expert_tables: Optional[Dict[str, torch.Tensor]] = None
    enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


class TensorDef(NamedTuple):
    """Shape and dtype of a state leaf (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


#: pages per expert in the CLS_EXPERT class: one page per weight matrix
#: (w_gate, w_up, w_down), each exactly d_model * d_ff elements flat.
EXPERT_PPE = 3


def moe_positions(cfg) -> Tuple[list, list]:
    """(pattern MoE positions, remainder MoE positions) that carry an
    expert FFN: the layer slots the expert page tables index."""
    def moe(k):
        return is_moe_kind(k) and base_kind(k) != "ssd" and cfg.d_ff
    return ([f"pos{j}" for j, k in enumerate(cfg.pattern) if moe(k)],
            [f"rem{j}" for j, k in enumerate(cfg.remainder) if moe(k)])


def expert_layer_slots(cfg) -> int:
    """MoE layer slots: scanned groups x pattern MoE positions +
    remainder MoE positions (each slot owns E experts x EXPERT_PPE
    potential pages)."""
    pat, rem = moe_positions(cfg)
    return cfg.n_groups * len(pat) + len(rem)


def _state_kind(kind: str) -> str:
    """Layer kind -> the kind of state it keeps: 'paged', 'ring' or
    'rec'."""
    bk = base_kind(kind)
    return {"global": "paged", "local": "ring"}.get(bk, "rec")


def ring_window(cfg, max_len: int) -> int:
    """Slots W of a ring: the window, at most max_len."""
    return min(cfg.window or max_len, max_len)


def pool_ell(cfg, chunk: Optional[int] = None) -> int:
    """Lane batch size: ell >= ceil(chunk / page_size), the most pages
    one step can demand, so the §4.2 never-dry invariant holds by
    construction."""
    chunk = chunk if chunk is not None else 2 * cfg.page_size
    return max(-(-int(chunk) // cfg.page_size), 2)


def state_page_tokens(cfg) -> int:
    """Granularity (token-capacity units) of the fine CLS_STATE class: a
    quarter KV page."""
    return max(1, cfg.page_size // 4)


def enc_layers_kv(cfg) -> int:
    """Decoder layers that keep cross K/V in ``enc_kv`` (an
    encoder-decoder's pattern has one layer, so one a group)."""
    return cfg.n_groups + len(cfg.remainder)


def state_blocks_per_slot(cfg, max_len: int) -> int:
    """CLS_STATE blocks one slot's bounded state occupies, at
    :func:`state_page_tokens` granularity: a ring charges its window,
    a recurrent layer one block, an encoder-decoder's cross K/V its
    ``enc_len`` tokens a decoder layer.  The grants are real allocator
    traffic that meters state kept in dense slot-indexed slabs, so
    admission counts bounded state at its own granularity instead of
    rounding it up to KV pages."""
    psz_s = state_page_tokens(cfg)
    W = ring_window(cfg, max_len)
    per_kind = {"paged": 0, "ring": -(-W // psz_s), "rec": 1}
    blocks = (cfg.n_groups * sum(per_kind[_state_kind(k)]
                                 for k in cfg.pattern)
              + sum(per_kind[_state_kind(k)] for k in cfg.remainder))
    if cfg.arch_kind == "encdec":
        blocks += enc_layers_kv(cfg) * -(-cfg.enc_len // psz_s)
    return blocks


def pool_class_specs(cfg, b_local: int, max_len: int,
                     chunk: Optional[int] = None,
                     size_classes: int = 1,
                     expert_budget: Optional[int] = None
                     ) -> Tuple[ClassSpec, ...]:
    """The class vector.  Class 0 (CLS_KV) is the coarse paged-KV class,
    sized for every local slot at max length PLUS fully-stocked lanes
    (3*ell per slot), the §4.2 slack.  With ``size_classes`` >= 2, class
    1 (CLS_STATE) is the fine bounded-state class with the same slack
    rule at its own granularity and demand.  With ``size_classes`` 3,
    class 2 (CLS_EXPERT) is the read-only expert-weight class:
    ``expert_budget`` pages of ``d_model * d_ff`` elements (default:
    full residency, every expert of every MoE layer slot) plus the same
    3*ell slack."""
    if size_classes not in (1, 2, 3):
        raise ValueError(f"size_classes {size_classes}: 1, 2 or 3")
    psz = cfg.page_size
    max_pages = max(max_len // psz, 1)
    ell = pool_ell(cfg, chunk)
    specs = [ClassSpec(page_size=psz,
                       num_blocks=b_local * max_pages + 3 * ell * b_local,
                       num_lanes=b_local, ell=ell)]
    if size_classes >= 2:
        ell1 = 2       # in-step demand is frees only; keep the floor
        specs.append(ClassSpec(
            page_size=state_page_tokens(cfg),
            num_blocks=(b_local * state_blocks_per_slot(cfg, max_len)
                        + 3 * ell1 * b_local),
            num_lanes=b_local, ell=ell1))
    if size_classes == 3:
        if expert_budget is None:
            expert_budget = (expert_layer_slots(cfg) * cfg.moe.num_experts
                             * EXPERT_PPE)
        ell2 = 2       # loads and evictions are host-paced, not in-step
        specs.append(ClassSpec(
            page_size=cfg.d_model * cfg.d_ff,
            num_blocks=int(expert_budget) + 3 * ell2 * b_local,
            num_lanes=b_local, ell=ell2))
    return tuple(specs)


def _rec_state_defs(cfg, kind: str, stack: int, dp: int, b_local: int):
    if kind == "ssd":
        di = cfg.ssd_expand * cfg.d_model
        H = di // cfg.ssd_head_dim
        return {
            "h": TensorDef((stack, dp, b_local, H, cfg.ssd_head_dim,
                            cfg.ssd_state), torch.float32),
            "conv": TensorDef((stack, dp, b_local, 3, di + 2 * cfg.ssd_state),
                              cfg.tdtype),
        }
    return {
        "h": TensorDef((stack, dp, b_local, cfg.d_model), torch.float32),
        "conv": TensorDef((stack, dp, b_local, cfg.rglru_conv - 1,
                           cfg.d_model), cfg.tdtype),
    }


def decode_state_defs(cfg, dp: int, b_local: int, max_len: int,
                      chunk: Optional[int] = None,
                      size_classes: int = 1,
                      expert_budget: Optional[int] = None) -> DecodeState:
    """TensorDef tree of the decode state (pool leaves included); a
    three-class pool adds the expert pages and tables
    (``expert_budget`` pages, :func:`pool_class_specs`), an
    encoder-decoder its ``enc_kv``."""
    _check_slice(cfg)
    psz, KH, hd, dt = cfg.page_size, cfg.n_kv_heads, cfg.hd, cfg.tdtype
    max_pages = max(max_len // psz, 1)
    specs = pool_class_specs(cfg, b_local, max_len, chunk, size_classes,
                             expert_budget)
    P = specs[CLS_KV].num_blocks
    W = ring_window(cfg, max_len)
    kv_pages, rings, rec = {}, {}, {}

    def entry(pos, kind, stack):
        sk = _state_kind(kind)
        if sk == "paged":
            shp = (stack, dp, P + 1, psz, KH, hd)
            kv_pages[pos] = (TensorDef(shp, dt),) * 2
        elif sk == "ring":
            shp = (stack, dp, b_local, W + 1, KH, hd)
            rings[pos] = (TensorDef(shp, dt),) * 2
        else:
            rec[pos] = _rec_state_defs(cfg, base_kind(kind), stack, dp,
                                       b_local)

    for j, k in enumerate(cfg.pattern):
        entry(f"pos{j}", k, cfg.n_groups)
    for j, k in enumerate(cfg.remainder):
        entry(f"rem{j}", k, 1)

    def class_def(s: ClassSpec):
        m, L, cap = s.num_blocks, s.num_lanes, 3 * s.ell
        return classed_pool.HierPool(
            shared=block_pool.BlockPool(
                free_ids=TensorDef((dp, m), I32), top=TensorDef((dp,), I32),
                refcount=TensorDef((dp, m), torch.int16)),
            private_ids=TensorDef((dp, L, cap), I32),
            private_top=TensorDef((dp, L), I32))

    state_tables = None
    if size_classes >= 2:
        sbs = max(state_blocks_per_slot(cfg, max_len), 1)
        state_tables = TensorDef((dp, b_local, sbs), I32)
    expert_pages = expert_tables = None
    if size_classes == 3:
        E = cfg.moe.num_experts
        expert_pages = TensorDef(
            (dp, specs[CLS_EXPERT].num_blocks + 1, cfg.d_model * cfg.d_ff),
            dt)
        pat, rem = moe_positions(cfg)
        expert_tables = {
            pos: TensorDef((cfg.n_groups if pos in pat else 1, dp, E,
                            EXPERT_PPE), I32) for pos in pat + rem}
    enc_kv = None
    if cfg.arch_kind == "encdec":
        enc_kv = (TensorDef((enc_layers_kv(cfg), dp, b_local, cfg.enc_len,
                             KH, hd), dt),) * 2
    return DecodeState(
        kv_pages=kv_pages, rings=rings, rec=rec,
        page_tables=TensorDef((dp, b_local, max_pages), I32),
        seq_lens=TensorDef((dp, b_local), I32),
        pool=classed_pool.ClassedPool(
            classes=tuple(class_def(s) for s in specs)),
        state_tables=state_tables, expert_pages=expert_pages,
        expert_tables=expert_tables, enc_kv=enc_kv)


# ======================================================= chunked decode path

class _PagedIndex(NamedTuple):
    """The paged layers' share of a step: the KV write coordinates, the
    kernels' DP-folded page table and base lengths, and on a verify
    step K3's page-sorted schedule, partials workspace and, on its
    wgmma route, its unit list."""
    write: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # [DP, Bl, T]
    tables: torch.Tensor      # int32 [DP*Bl, maxp], shard d offset d*(P+1)
    base: torch.Tensor        # int32 [DP*Bl]
    verify: Optional[Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                           Optional[torch.Tensor]]]


class _RingIndex(NamedTuple):
    """The ring layers' share of a step: the ring write coordinates and
    the window mask over (ring slots, chunk tokens)."""
    write: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # [DP, Bl, T]
    valid: torch.Tensor       # bool [DP*Bl, 1, T, W + T]
    any_valid: torch.Tensor   # bool [DP*Bl, 1, T, 1]


class _StepIndex(NamedTuple):
    """What every layer of one chunked step shares, computed once per
    step: the RoPE tables (attention layers), the valid lengths and
    token mask (recurrent layers), and the paged and ring indices of
    the layer kinds the model has."""
    cos: Optional[torch.Tensor]   # float32 [DP*Bl, T, 1, hd/2]
    sin: Optional[torch.Tensor]
    lens: torch.Tensor            # int32 [DP, Bl]
    tok_valid: torch.Tensor       # bool [DP, Bl, T]
    paged: Optional[_PagedIndex]
    ring: Optional[_RingIndex]


def _paged_index(cfg, state: DecodeState, positions, tok_valid, base,
                 verify: bool) -> _PagedIndex:
    """A token is written iff it is valid and its page is mapped; masked
    tokens go to the sink page.  The kernel sees all DP shards as one
    batch: shard-local page ids are offset by d * (pages_local + 1)."""
    DP, Bl, T = positions.shape
    psz = cfg.page_size
    maxp = state.page_tables.shape[2]
    n_pages = classed_pool.pages_local(state.pool, CLS_KV)
    pid = block_pool.take(state.page_tables,
                          (positions // psz).clamp(max=maxp - 1))
    pid = torch.where(tok_valid & (pid >= 0), pid, n_pages).long()
    d = torch.arange(DP, device=pid.device)[:, None, None].expand_as(pid)
    off = (torch.arange(DP, dtype=I32, device=pid.device)
           * (n_pages + 1))[:, None, None]
    tables = torch.where(state.page_tables >= 0, state.page_tables + off,
                         NULL).reshape(DP * Bl, maxp).contiguous()
    base = base.reshape(DP * Bl).contiguous()
    vidx = None
    if verify:
        # every layer attends over the same table: one schedule, one
        # workspace and one unit list per step, not per layer
        sched = build_verify_schedule(tables, base, T, psz)
        G = cfg.n_heads // cfg.n_kv_heads
        units = (build_verify_units(sched[0], T, G)
                 if verify_route(cfg.tdtype, cfg.hd, psz, T, G) == "wgmma"
                 else None)
        vidx = (sched,
                torch.empty(workspace_numel(DP * Bl, T, cfg.n_heads, cfg.hd,
                                            maxp),
                            dtype=torch.float32, device=tables.device),
                units)
    return _PagedIndex((d, pid, (positions % psz).long()), tables, base,
                       vidx)


def _ring_index(cfg, W: int, positions, tok_valid, base, lens) -> _RingIndex:
    """Ring slot r holds absolute position r + W * floor((base - 1 - r) /
    W) before the chunk (negative: never written).  Query t (position
    base + t) sees ring tokens and chunk tokens t' <= t, both inside the
    window.  Only the last W valid tokens of a chunk can survive in a
    ring of W slots: the rest, and invalid tokens, go to the sink slot
    W, which also removes duplicate-slot writes when T > W."""
    DP, Bl, T = positions.shape
    dev = positions.device
    win = cfg.window or W
    r = torch.arange(W, device=dev)
    last = (base.long() - 1)[..., None]
    abs_ring = r + W * torch.div(last - r, W, rounding_mode="floor")
    t = torch.arange(T, device=dev)
    qpos = base.long()[..., None] + t                           # [DP,Bl,T]
    valid_ring = ((abs_ring[:, :, None, :] >= 0)
                  & (abs_ring[:, :, None, :] > qpos[..., None] - win))
    tp, tq = t[None, None, None, :], t[None, None, :, None]
    valid_chunk = ((tp <= tq) & (tp < lens[..., None, None])
                   & (tq - tp < win))
    valid = torch.cat([valid_ring, valid_chunk.expand(DP, Bl, T, T)],
                      dim=3).reshape(DP * Bl, 1, T, W + T)
    write = tok_valid & (t >= lens[..., None] - W)
    slot = torch.where(write, positions % W, W).long()
    dp_i = torch.arange(DP, device=dev)[:, None, None].expand_as(slot)
    bl_i = torch.arange(Bl, device=dev)[None, :, None].expand_as(slot)
    return _RingIndex((dp_i, bl_i, slot), valid,
                      valid.any(-1, keepdim=True))


def _step_index(cfg, state: DecodeState, positions, tok_valid, base, lens,
                verify: bool) -> _StepIndex:
    DP, Bl, T = positions.shape
    cos = sin = paged = ring = None
    if state.kv_pages or state.rings:
        cos, sin = rope_tables(positions.reshape(DP * Bl, T), cfg.hd,
                               cfg.rope_theta)
    if state.kv_pages:
        paged = _paged_index(cfg, state, positions, tok_valid, base, verify)
    if state.rings:
        W = next(iter(state.rings.values()))[0].shape[3] - 1
        ring = _ring_index(cfg, W, positions, tok_valid, base, lens)
    return _StepIndex(cos, sin, lens, tok_valid, paged, ring)


def _paged_write_chunk(k_pages, v_pages, k_new, v_new, write) -> None:
    """In place: k_pages [DP, P + 1, psz, KH, hd]; k_new [DP, Bl, T, KH,
    hd]; write: the (shard, page, slot) coordinates [DP, Bl, T] of each
    token, masked tokens on the sink page P.  One scatter of Bl*T
    tokens per shard."""
    k_pages.index_put_(write, k_new.to(k_pages.dtype))
    v_pages.index_put_(write, v_new.to(v_pages.dtype))


def _paged_attn_chunk(q, k_pages, v_pages, idx: _PagedIndex):
    """q: [DP, Bl, T, H, hd]; pages: [DP, P + 1, psz, KH, hd].  Folds DP
    into the kernel batch so one kernel launch covers all shards.  A
    verify step (``idx.verify`` set) attends through K3's page-grouped
    schedule: the same function, each hot shared page read once for
    all the lanes that map it.  A decode-only step (T = 1) attends
    through K2 over ``base + 1`` positions, the same function as K1 at
    T = 1; ``zero_empty`` keeps K1's zeros on lanes without a valid key
    (idle slots), where K2 would otherwise return the mean of page 0."""
    DP, Bl, T, H, hd = q.shape
    kg = k_pages.reshape((-1,) + k_pages.shape[2:])
    vg = v_pages.reshape((-1,) + v_pages.shape[2:])
    qf = q.reshape(DP * Bl, T, H, hd).contiguous()
    if idx.verify is not None:
        o = verify_attention(qf, kg, vg, idx.tables, idx.base, *idx.verify)
    elif T == 1:
        o = paged_attention(qf[:, 0], kg, vg, idx.tables, idx.base + 1,
                            zero_empty=True)
    else:
        o = paged_attention_chunk(qf, kg, vg, idx.tables, idx.base)
    return o.reshape(DP, Bl, T, H, hd)


def _ring_write_chunk(k_ring, v_ring, k_new, v_new, write) -> None:
    """In place: rings [DP, Bl, W + 1, KH, hd]; k_new [DP, Bl, T, KH,
    hd]; write: the (shard, slot, ring slot) coordinates [DP, Bl, T],
    masked tokens on the sink slot W."""
    k_ring.index_put_(write, k_new.to(k_ring.dtype))
    v_ring.index_put_(write, v_new.to(v_ring.dtype))


def _summed(s, group):
    """``s`` summed over the ranks of ``group`` (a shard's partial
    scores over its slice of the head dim); ``s`` itself without one."""
    if group is None:
        return s
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(s, "sum", group.group_name))


def _ring_attn_chunk(q, k_ring, v_ring, k_chunk, v_chunk, idx: _RingIndex,
                     group=None):
    """Chunked sliding-window attention over ring + in-chunk K/V, plain
    torch ops as in the reference.

    q: [DP, Bl, T, H, hd]; rings: [DP, Bl, W + 1, KH, hd] holding the
    PRE-chunk content (slot W is the sink); k/v_chunk: [DP, Bl, T, KH,
    hd].  Attention runs before the ring is overwritten, so early
    queries still see tokens that later chunk tokens evict.  Given a
    ``group``, the operands are a shard's slice of the head dim and
    the scores are summed over the group before the softmax."""
    DP, Bl, T, H, hd = q.shape
    W = k_ring.shape[2] - 1
    k = torch.cat([k_ring[:, :, :W], k_chunk.to(k_ring.dtype)], dim=2)
    v = torch.cat([v_ring[:, :, :W], v_chunk.to(v_ring.dtype)], dim=2)
    ke = _expand_kv(k.reshape(DP * Bl, W + T, -1, hd), H)
    ve = _expand_kv(v.reshape(DP * Bl, W + T, -1, hd), H)
    qf = q.reshape(DP * Bl, T, H, hd)
    hd_all = hd * (1 if group is None else group.size())
    s = _summed(torch.einsum("bthd,bkhd->bhtk", qf, ke), group) / (
        hd_all ** 0.5)
    s = torch.where(idx.valid, s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(idx.any_valid, p, 0.0)
    o = torch.einsum("bhtk,bkhd->bthd", p.to(q.dtype), ve)
    return o.reshape(DP, Bl, T, H, hd)


def _xattn_decode_chunk(cfg, lp, x, enc_kv_layer):
    """Cross-attention of a chunk of decode tokens over one layer's
    encoder K/V, plain torch ops as in the reference: x [DP, Bl, T, d],
    enc_kv_layer (k, v) [DP, Bl, enc_len, KH, hd], no mask.  The scores
    are an ``x.dtype`` product divided by sqrt(hd), then float32 for
    the softmax, and P goes back to ``x.dtype`` before the product with
    V: the reference's order, which in bf16 decides the tokens."""
    DP, Bl, T, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = apply_norm(cfg, lp["norm_x"], x)
    q = torch.einsum("xbtd,dhk->xbthk", h, lp["xattn"]["wq"])
    k, v = enc_kv_layer
    spec, group = _split_spec(k)
    o = _xattn_shards(spec)(q.reshape(DP, Bl, T, H, hd), k, v, group)
    return x + torch.einsum("xbthk,hkd->xbtd", gather_model(o),
                            lp["xattn"]["wo"])


def _xattn_core(q, k, v, group=None):
    """Attention of q [DP, Bl, T, H, hd] over every row of k, v [DP, Bl,
    L, KH, hd]: an ``q.dtype`` product divided by sqrt(hd), the
    softmax in float32, P back in ``q.dtype`` before the product with V
    (the reference's order).  Given a ``group``: a shard's slice of the
    head dim, the scores summed over the group (:func:`_summed`)."""
    DP, Bl, T, H, hd = q.shape
    L = k.shape[2]
    ke = _expand_kv(k.reshape(DP * Bl, L, -1, hd), H)
    ve = _expand_kv(v.reshape(DP * Bl, L, -1, hd), H)
    qf = q.reshape(DP * Bl, T, H, hd)
    hd_all = hd * (1 if group is None else group.size())
    s = _summed(torch.einsum("bthd,bkhd->bhtk", qf, ke), group) / (
        hd_all ** 0.5)
    p = torch.softmax(s.float(), dim=-1)
    o = torch.einsum("bhtk,bkhd->bthd", p.to(q.dtype), ve)
    return o.reshape(DP, Bl, T, H, hd)


def _xattn_shards(spec):
    return partition.local_map(_xattn_core, (spec,) * 3 + (None,),
                               partition.like(0))


# Sharding boundaries of a decode layer.  The KV writes run in place on
# each shard's block of the state (KEEP: a redistributed copy would take
# the write); attention reads the shard's pages, ring or encoder K/V,
# its kv heads over "model" where the state shards them there.  Where
# the state shards the head dim instead (the reference's GQA fallback),
# the plain forms (ring, cross) keep it sharded and sum each shard's
# partial scores (:func:`_split_spec`), while the paged kernels, which
# take whole head dims, get the pages gathered.  A recurrent block runs
# each batch shard's rows on copies of their state, which the caller
# writes back.
_ATT5 = (BATCH, None, None, None, None)
_paged_write_shards = partition.local_map(
    _paged_write_chunk, (KEEP,) * 5, lambda mesh, parts: ())
_ring_write_shards = partition.local_map(
    _ring_write_chunk, (KEEP,) * 5, lambda mesh, parts: ())


def _kv_heads_spec(kp) -> tuple:
    """Spec of a [DP, ., ., heads, hd] attention operand: the heads over
    "model" where the state ``kp`` shards its kv heads there."""
    if partition.is_sharded(kp) and partition.sharded_dim(kp, 3, "model"):
        return (BATCH, None, None, MODEL, None)
    return _ATT5


def _paged_attn_shards(heads):
    return partition.local_map(_paged_attn_chunk,
                               (heads, heads, heads, KEEP),
                               partition.like(0))


def _ring_attn_shards(spec):
    return partition.local_map(_ring_attn_chunk,
                               (spec,) * 5 + (KEEP, None), partition.like(0))


def _split_spec(kp):
    """(spec, group) of the plain attention forms (ring, cross): as
    :func:`_kv_heads_spec`, but where the state shards its head dim over
    "model" (the reference's GQA fallback) every operand keeps that
    shard and each shard's partial scores are all-reduced over "model"
    before the softmax, the reference's plan for it (a [B, H, T, L]
    all-reduce instead of a gathered state)."""
    if partition.is_sharded(kp) and partition.sharded_dim(kp, 4, "model"):
        return ((BATCH, None, None, None, MODEL),
                kp.device_mesh.get_group("model"))
    return _kv_heads_spec(kp), None


def _rec_apply(block, cfg, params, x, h, conv, lens, tok_valid):
    """A recurrent block over a chunk on copies of its state: (y, h,
    conv) after the chunk."""
    h, conv = h.clone(), conv.clone()
    return block(cfg, params, x, h, conv, lens, tok_valid), h, conv


_rec_apply_shards = partition.local_map(
    _rec_apply, (None, None, None, (BATCH,), (BATCH,), (BATCH,), (BATCH,),
                 (BATCH,)), partition.like(-1))


def _mix_decode_chunk(cfg, lp, x, kind: str, layer_state, idx: _StepIndex,
                      expert_buf=None, expert_mask=None, enc_kv_layer=None):
    """One layer over a chunk of up to T tokens per sequence, x: [DP,
    Bl, T, d].  Attention layers write the chunk's K/V once (pages or
    ring) and attend in one call; recurrent layers run the chunk in one
    scan-kernel launch from the carried state; an encoder-decoder's
    layer then attends over its ``enc_kv_layer``; then the FFN, where
    the layer has one.  Returns (x, moe_meta): ``moe_meta`` is None for
    a dense FFN, else ``(dropped [DP], routed [DP, E])``, the valid
    assignments capacity dropped per shard and kept per expert.

    ``expert_buf`` (EXPERT_PPE tensors [E, d*d_ff], the layer's expert
    pages gathered, DP == 1) replaces the resident expert weights: the
    same dispatch on the same values, so paged and resident serving are
    bit-identical.  ``expert_mask`` (bool [DP, Bl, E]) is each slot's
    admitted expert footprint."""
    DP, Bl, T, d = x.shape
    h = apply_norm(cfg, lp["norm1"], x)
    sk = _state_kind(kind)
    if sk in ("paged", "ring"):
        H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        hf = h.reshape(DP * Bl, T, d)
        a = lp["attn"]
        q = rotate(torch.einsum("bsd,dhk->bshk", hf, a["wq"]), idx.cos,
                   idx.sin).reshape(DP, Bl, T, H, hd)
        k = rotate(torch.einsum("bsd,dhk->bshk", hf, a["wk"]), idx.cos,
                   idx.sin).reshape(DP, Bl, T, KH, hd)
        v = torch.einsum("bsd,dhk->bshk", hf, a["wv"]).reshape(
            DP, Bl, T, KH, hd)
        kp, vp = layer_state
        k, v = partition.laid_out_as(k, kp), partition.laid_out_as(v, vp)
        if sk == "paged":
            _paged_write_shards(kp, vp, k, v, idx.paged.write)
            o = _paged_attn_shards(_kv_heads_spec(kp))(q, kp, vp, idx.paged)
        else:
            spec, group = _split_spec(kp)
            o = _ring_attn_shards(spec)(q, kp, vp, k, v, idx.ring, group)
            _ring_write_shards(kp, vp, k, v, idx.ring.write)
        x = constrain_batch(x + torch.einsum("xbthk,hkd->xbtd",
                                             gather_model(o), a["wo"]))
    else:
        st = {n: t.reshape((DP * Bl,) + t.shape[2:])
              for n, t in layer_state.items()}
        block = (ssm_mod.ssd_block_apply if base_kind(kind) == "ssd"
                 else rglru_mod.rglru_block_apply)
        args = (cfg, lp[base_kind(kind)], h.reshape(DP * Bl, T, d),
                st["h"], st["conv"], idx.lens.reshape(DP * Bl),
                idx.tok_valid.reshape(DP * Bl, T))
        if partition.is_sharded(x):
            o, hn, cn = _rec_apply_shards(block, *args)
            st["h"].copy_(hn)
            st["conv"].copy_(cn)
        else:
            o = block(*args)
        x = constrain_batch(x + o.reshape(DP, Bl, T, d))
    if "xattn" in lp and enc_kv_layer is not None:
        x = constrain_batch(_xattn_decode_chunk(cfg, lp, x, enc_kv_layer))
    moe_meta = None
    if "ffn" in lp:
        h2 = apply_norm(cfg, lp["norm2"], x).reshape(DP * Bl, T, d)
        if "router" in lp["ffn"]:
            E, ff = cfg.moe.num_experts, cfg.d_ff
            eff = lp["ffn"]
            if expert_buf is not None:
                # the stacked [E, ...] weights as views of the gathered
                # CLS_EXPERT pages; a non-resident expert reads page 0
                # (finite garbage no valid token routes to)
                wg, wu, wd = expert_buf
                eff = {"router": eff["router"], "w_gate": wg.view(E, d, ff),
                       "w_up": wu.view(E, d, ff), "w_down": wd.view(E, ff, d)}
            mask = (None if expert_mask is None
                    else expert_mask.reshape(DP * Bl, E))
            f, dropped, routed = moe_mod.moe_apply(
                cfg, eff, h2, expert_mask=mask,
                token_valid=idx.tok_valid.reshape(DP * Bl, T), metered=True)
            moe_meta = (dropped.reshape(DP, Bl).sum(1, dtype=I32),
                        routed.reshape(DP, Bl, E).sum(1, dtype=I32))
        else:
            f = ffn_apply(cfg, lp["ffn"], h2)
        x = constrain_batch(x + constrain_batch(f).reshape(DP, Bl, T, d))
    return x, moe_meta


def _gather_expert_pages(pages, tab):
    """One MoE layer slot's expert weights off the CLS_EXPERT pages:
    pages [DP, NB2 + 1, pe] (DP == 1), tab int32 [DP, E, EXPERT_PPE] ->
    EXPERT_PPE tensors [E, pe] (w_gate, w_up, w_down), each contiguous.
    NULL entries clamp to page 0, finite garbage the footprint mask
    keeps every valid token away from.  Like the reference, this copies
    every page of the layer's E experts, resident or not."""
    p = pages[0]
    ids = tab[0].clamp(0, p.shape[0] - 2).T.long()       # [PPE, E]
    return p[ids].unbind(0)


def _alloc_and_index(lens, state: DecodeState, cfg, T: int, verify: bool):
    """The step's bookkeeping before the layers, on one shard's rows (on
    plain tensors, on all): where the model has paged layers, pages for
    the whole chunk from each slot's private lane in one
    :func:`hier_pool.alloc_n_or_shared` call, all-or-nothing per
    sequence (a denied chunk appends nothing), then the step's index.
    Returns (page_tables, pool, lens, idx)."""
    base = state.seq_lens
    dev = lens.device
    if state.kv_pages:
        # page allocation for the whole chunk (once, all paged layers)
        psz = cfg.page_size
        maxp = state.page_tables.shape[2]
        kmax = -(-T // psz)
        lens, pages_before, counts = block_pool.chunk_page_plan(
            base, lens, psz, maxp)
        pool, got = classed_pool.alloc_n_or_shared_dp(state.pool, CLS_KV,
                                                      counts, kmax)
        lens = torch.where(block_pool.granted_mask(got, counts), lens, 0)
        kk = torch.arange(kmax, dtype=I32, device=dev)
        new_page = (kk < counts[..., None]) & (got >= 0)
        slot = torch.where(new_page, pages_before[..., None] + kk, maxp)
        tables = block_pool.put(state.page_tables, slot, got)
        state = state._replace(page_tables=tables, pool=pool)
    positions = base[..., None] + torch.arange(T, dtype=I32, device=dev)
    tok_valid = torch.arange(T, device=dev) < lens[..., None]
    idx = _step_index(cfg, state, positions, tok_valid, base, lens, verify)
    return state.page_tables, state.pool, lens, idx


#: sharding boundary of the bookkeeping: each DP shard allocates from
#: its own pool and indexes its own pages (the reference's per-shard
#: pool), every output laid out as ``lens`` (DP over the batch axes)
_alloc_and_index_shards = partition.local_map(
    _alloc_and_index, ((BATCH,), KEEP, None, None, None), partition.like(0))


def forward_decode_chunk(cfg, params, tokens, state: DecodeState, lens,
                         active=None, verify: bool = False,
                         expert_mask=None):
    """Chunked decode/prefill: up to T tokens per sequence per call.

    tokens: int32 [DP, Bl, T]; lens: int32 [DP, Bl] — valid tokens per
    sequence this call (ragged tails are inert: written to no page or
    ring slot, and no recurrent state).  Returns (hidden [DP, Bl, T,
    d], new DecodeState, meters) with seq_lens advanced by lens;
    ``meters`` is a dict of int32 [DP] MoE meters (``moe_dropped``,
    ``expert_hit_pages``, ``expert_miss_pages``,
    ``expert_prefetch_pages``), zeros for a model without experts.

    ``expert_mask`` (bool [DP, Bl, E]) restricts each slot's routing to
    its admitted expert footprint, at every MoE layer, paged or
    resident.  When ``state.expert_tables`` is set (expert-paged
    serving), each MoE layer gathers its experts' pages before its FFN.
    The reference gathers group g + 1's pages inside group g's scan
    iteration, one group ahead (and group 0's again after the last);
    ``expert_prefetch_pages`` counts those gathers as it does, the
    mapped entries of every group's tables once a step.

    Where the model has paged layers, pages for the whole chunk come
    from each slot's private lane in one
    :func:`hier_pool.alloc_n_or_shared` call, all-or-nothing per
    sequence: a chunk that would overflow the page table, or whose
    pages the pool denies, appends nothing.  The reference's
    ``lax.scan`` over layer groups is a Python loop over layers.
    ``verify`` routes paged attention through the verify kernel (K3),
    as the engine does on a step where any lane carries drafts.  An
    encoder-decoder's layer i attends over row i of ``state.enc_kv``: a
    group's layer g, a remainder layer n_groups + j.
    """
    _check_slice(cfg)
    DP, Bl, T = tokens.shape
    if active is None:
        active = partition.constant(
            torch.ones((DP, Bl), dtype=torch.bool, device=tokens.device),
            tokens)
    lens = torch.where(active, lens.to(I32).clamp(0, T), 0)
    base = state.seq_lens
    x = constrain_batch(embed_apply(params["embed"], tokens).to(cfg.tdtype))
    tables, pool, lens, idx = _alloc_and_index_shards(lens, state, cfg, T,
                                                      verify)
    state = state._replace(page_tables=tables, pool=pool)

    etabs = state.expert_tables or {}
    if etabs:
        # the paged FFN takes the shard's pages as the [E, ...] weights
        assert DP == 1, "expert paging requires shard-local DP == 1"
    meters = {k: partition.constant(
        torch.zeros(DP, dtype=I32, device=tokens.device), tokens)
              for k in ("moe_dropped", "expert_hit_pages",
                        "expert_miss_pages", "expert_prefetch_pages")}
    pat_moe, _ = moe_positions(cfg)
    for pos in pat_moe:
        if pos in etabs:
            meters["expert_prefetch_pages"] += (etabs[pos] >= 0).sum(
                (0, 2, 3), dtype=I32)

    def layer(lp, pos, g, kind, x, i):
        enc = None
        if state.enc_kv is not None:
            enc = (state.enc_kv[0][i], state.enc_kv[1][i])
        if pos in state.rec:
            ls = {n: t[g] for n, t in state.rec[pos].items()}
        else:
            ls = tuple(t[g] for t in (state.kv_pages.get(pos)
                                      or state.rings[pos]))
        tab = ebuf = None
        if pos in etabs:
            tab = etabs[pos][g]                          # [DP, E, PPE]
            ebuf = _gather_expert_pages(state.expert_pages, tab)
        x, meta = _mix_decode_chunk(cfg, lp, x, kind, ls, idx, ebuf,
                                    expert_mask, enc)
        if meta is not None:
            dropped, routed = meta
            meters["moe_dropped"] += dropped
            if tab is not None:
                # an expert is resident iff all its pages are mapped
                res = (tab >= 0).all(-1)                 # [DP, E]
                touched = routed > 0
                meters["expert_hit_pages"] += EXPERT_PPE * (
                    touched & res).sum(-1, dtype=I32)
                meters["expert_miss_pages"] += EXPERT_PPE * (
                    touched & ~res).sum(-1, dtype=I32)
        return x

    for g in range(cfg.n_groups):
        for j, kind in enumerate(cfg.pattern):
            lp = tree_map(lambda a: a[g], params["groups"][f"pos{j}"])
            x = layer(lp, f"pos{j}", g, kind, x, g)
    for j, kind in enumerate(cfg.remainder):
        x = layer(params["rem"][f"pos{j}"], f"rem{j}", 0, kind, x,
                  cfg.n_groups * len(cfg.pattern) + j)

    state = state._replace(seq_lens=base + lens)
    return apply_norm(cfg, params.get("final_norm", {}), x), state, meters
