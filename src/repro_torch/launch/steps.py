"""Step builders and input specs of every (arch x shape) cell, and the
serving state's DP layout.

Counterpart of the JAX package's ``launch/steps.py``.  The cell specs
(:func:`cell_specs`) are the dry run's: each (arch x shape) cell's step
function, its arguments as fake ``DTensor`` shards on a mesh of
``launch/mesh.py``, their placements and the donated arguments:

* train / prefill: tokens [B, S] sharded over the batch axes;
* decode: the [DP, B_local] layout with DP = min(#batch shards, B),
  every decode-state leaf sharded on its DP axis, KV heads (or, where
  they do not divide, the head dim) over "model".

The serving part (``serve_register_pspec``, ``serve_state_pspecs``,
``decode_layout``) follows.  Where the reference names the ``"dp"`` mesh axis
of each leaf in a ``PartitionSpec``, the port gives the leaf's DP axis
as an int: axis 1 for the stacked leaves (``kv_pages``, ``rings``,
``rec``, ``enc_kv``, ``expert_tables``: ``[stack, DP, ...]``), axis 0
for ``page_tables``, ``seq_lens``, every pool leaf, ``state_tables``,
``expert_pages`` and the per-slot registers.  A rank of a DP group
(:mod:`.mesh`) holds its shard of each leaf with that axis of size 1:
:func:`shard_state` cuts a whole state into a rank's shard and
:func:`gather_state` puts the ranks' shards back together.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as model_mod
from ..models import transformer as tfm
from ..models.layers import tree_leaves, tree_map
from ..models.transformer import DecodeState, TensorDef
from ..optim import adamw
from ..parallel import partition


def decode_layout(shape: ShapeConfig, dp_size: int) -> Tuple[int, int]:
    """``(DP, B_local)`` of a decode cell over ``dp_size`` DP shards (the
    reference reads ``dp_size`` off its mesh)."""
    dp = min(dp_size, shape.global_batch)
    return dp, shape.global_batch // dp


#: DP axis of the per-slot registers, masks and pin tables
#: (``[DP, Bl, ...]``, ``[DP, Npin, maxp]``)
SERVE_REGISTER_AXIS = 0


def serve_state_axes(state: DecodeState) -> DecodeState:
    """The DP axis of every leaf of a serving ``DecodeState``, as a
    tree of the same structure with ints for leaves."""
    def ax(a):
        return lambda tree: partition.tree_map_defs(lambda _: a, tree)
    return DecodeState(
        kv_pages=ax(1)(state.kv_pages),
        rings=ax(1)(state.rings),
        rec=ax(1)(state.rec),
        page_tables=0,
        seq_lens=0,
        pool=ax(0)(state.pool),
        state_tables=None if state.state_tables is None else 0,
        expert_pages=None if state.expert_pages is None else 0,
        expert_tables=ax(1)(state.expert_tables),
        enc_kv=ax(1)(state.enc_kv))


def shard_state(state: DecodeState, rank: int) -> DecodeState:
    """DP shard ``rank`` of a whole state: every leaf cut to size 1 on
    its DP axis (views of the whole state's tensors)."""
    return partition.tree_map_defs(lambda t, a: t.narrow(a, rank, 1),
                                   state, serve_state_axes(state))


def gather_state(local: DecodeState, group) -> DecodeState:
    """The whole state from the ranks' shards: every leaf all-gathered
    on its DP axis in rank order, on each leaf's own device.  A
    collective: every rank of ``group`` calls it at the same point."""
    return partition.tree_map_defs(
        lambda t, a: group.gather(t, a).to(t.device), local,
                serve_state_axes(local))


# ------------------------------------------------------------- input specs

def _maybe(mesh, dim: int, axis):
    """Shard ``dim`` over ``axis`` only if divisible (see partition.py)."""
    return axis if dim % partition.axis_size(mesh, axis) == 0 else None


def _batch_axis(mesh):
    ba = partition.batch_axes(mesh)
    return ba if len(ba) > 1 else ba[0]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(TensorDef tree, placement tree) of the data batch: int32 tokens
    and labels [B, S] over the batch axes; a VLM's ``img_embeds`` and an
    encoder-decoder's ``enc_embeds`` in the model's dtype; a decode
    cell's tokens [DP, B_local]."""
    ba = _batch_axis(mesh)
    B, S = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        rows = partition.placements((ba, None), mesh)
        specs = {"tokens": TensorDef((B, S), torch.int32)}
        shard = {"tokens": rows}
        if shape.mode == "train":
            specs["labels"] = TensorDef((B, S), torch.int32)
            shard["labels"] = rows
        extra = {"vlm": ("img_embeds", cfg.img_tokens),
                 "encdec": ("enc_embeds", cfg.enc_len)}.get(cfg.arch_kind)
        if extra is not None:
            name, n = extra
            specs[name] = TensorDef((B, n, cfg.d_model), cfg.tdtype)
            shard[name] = partition.placements((ba, None, None), mesh)
        return specs, shard
    dp, bl = decode_layout(shape, partition.dp_size(mesh))
    return (TensorDef((dp, bl), torch.int32),
            partition.placements((ba if dp > 1 else None, None), mesh))


def decode_state_shardings(cfg: ModelConfig, state_defs: DecodeState,
                           mesh) -> DecodeState:
    """Placements of every decode-state leaf: the DP axis over the batch
    axes (where DP > 1); KV pages, rings and ``enc_kv`` with their KV
    heads over "model", or, where the heads do not divide, their head
    dim (the reference's GQA fallback: no 16x replicated KV pool);
    recurrent state its axis 3 where divisible; pool leaves, tables and
    expert pages their DP axis only."""
    ba = _batch_axis(mesh)
    dpa = ba if state_defs.seq_lens.shape[0] > 1 else None
    kh_ax = _maybe(mesh, cfg.n_kv_heads, "model")
    hd_ax = None if kh_ax is not None else _maybe(mesh, cfg.hd, "model")

    def spec(parts):
        return partition.placements(parts, mesh)

    def kv_spec(d):
        # [stack, DP, pages|Bl, (psz|W), KH, hd]
        parts = [None] * len(d.shape)
        parts[1], parts[-2], parts[-1] = dpa, kh_ax, hd_ax
        return spec(parts)

    def rec_spec(d):
        parts = [None] * len(d.shape)
        parts[1] = dpa
        if len(d.shape) >= 4:
            parts[3] = _maybe(mesh, d.shape[3], "model")
        return spec(parts)

    def lead(d):
        return spec([dpa] + [None] * (len(d.shape) - 1))

    dm = partition.tree_map_defs
    return DecodeState(
        kv_pages=dm(kv_spec, state_defs.kv_pages),
        rings=dm(kv_spec, state_defs.rings),
        rec=dm(rec_spec, state_defs.rec),
        page_tables=lead(state_defs.page_tables),
        seq_lens=lead(state_defs.seq_lens),
        pool=dm(lead, state_defs.pool),
        state_tables=dm(lead, state_defs.state_tables),
        expert_pages=dm(lead, state_defs.expert_pages),
        expert_tables=dm(lambda d: spec((None, dpa, None, None)),
                         state_defs.expert_tables),
        enc_kv=dm(kv_spec, state_defs.enc_kv))


def _opt_shapes(pshapes):
    """The AdamW state's TensorDefs: float32 moments and master copies
    like the parameters; the step counter a host int (the reference's
    4-byte int32 scalar)."""
    f32 = partition.tree_map_defs(
        lambda d: TensorDef(tuple(d.shape), torch.float32), pshapes)
    return adamw.AdamWState(step=0, mu=f32, nu=f32, master=f32)


def _opt_shardings(pshard):
    return adamw.AdamWState(step=None, mu=pshard, nu=pshard, master=pshard)


# ------------------------------------------------------------ step builders

def build_train_step(cfg: ModelConfig,
                     opt_cfg: Optional[adamw.AdamWConfig] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss, its gradients by autograd and the AdamW update
    in one function, so one trace holds all three (the reference's
    ``jax.value_and_grad`` + ``adamw.apply``).  Parameters, moments and
    master copies are updated in place; ``opt_state.step`` is a host
    int or host tensor."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(live)
        loss = model_mod.loss_fn(cfg, tree_map(lambda _: next(it), params),
                                 batch)
        grads = iter(torch.autograd.grad(loss, live))
        grads = tree_map(lambda _: next(grads), params)
        params, opt_state, metrics = adamw.apply(opt_cfg, opt_state, grads,
                                                 params)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return model_mod.prefill(cfg, params, batch)
    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """The decode cell: one width-1 token lane per slot
    (``model.decode_step`` wraps ``forward_decode_chunk`` at T = 1)."""
    def serve_step(params, tokens, state):
        return model_mod.decode_step(cfg, params, tokens, state)
    return serve_step


# ---------------------------------------------------------------- assembly

def default_rules(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """The reference's choice: "fsdp" to train, "ep_serve" to serve a
    mixture of experts (experts not replicated), else "tp"."""
    if shape.mode == "train":
        return "fsdp"
    return "ep_serve" if cfg.moe is not None else "tp"


def fake_shards(defs, plc, mesh, fake_mode):
    """Fake DTensors of a TensorDef tree under a placement tree: each a
    ``DTensor`` over ``mesh`` whose local tensor is rank 0's shard, made
    under ``fake_mode`` (no memory).  Non-tensor leaves (the host step
    counter) pass through."""
    from torch.distributed.tensor import DTensor

    def one(d, p):
        if not partition.is_def(d):
            return d
        local = partition.local_shape(d.shape, p, mesh)
        with fake_mode:
            t = torch.empty(local, dtype=d.dtype)
        return DTensor.from_local(t, mesh, p, run_check=False,
                                  shape=torch.Size(d.shape),
                                  stride=torch.empty(d.shape,
                                                     device="meta").stride())
    return partition.tree_map_defs(one, defs, plc)


def cell_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: Optional[str] = None):
    """Everything one (arch x shape) cell needs to be traced: a dict
    with ``fn`` (the step), ``defs`` (TensorDef trees of its
    arguments), ``placements`` (a placement tree per argument),
    ``args`` (fake DTensor shards, made under ``fake_mode``),
    ``donate_argnums`` and ``rules``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rules = rules or default_rules(cfg, shape)
    pdefs = model_mod.param_defs(cfg)
    pshapes = partition.tree_map_defs(
        lambda d: TensorDef(tuple(d.shape), d.dtype), pdefs)
    pshard = partition.param_specs(pdefs, mesh, rules)
    if shape.mode == "train":
        bdefs, bshard = batch_specs(cfg, shape, mesh)
        defs = (pshapes, _opt_shapes(pshapes), bdefs)
        plc = (pshard, _opt_shardings(pshard), bshard)
        fn, donate = build_train_step(cfg), (0, 1)
    elif shape.mode == "prefill":
        bdefs, bshard = batch_specs(cfg, shape, mesh)
        defs, plc = (pshapes, bdefs), (pshard, bshard)
        fn, donate = build_prefill_step(cfg), ()
    else:
        dp, bl = decode_layout(shape, partition.dp_size(mesh))
        sdefs = tfm.decode_state_defs(cfg, dp, bl, max_len=shape.seq_len)
        tdef, tshard = batch_specs(cfg, shape, mesh)
        defs = (pshapes, tdef, sdefs)
        plc = (pshard, tshard, decode_state_shardings(cfg, sdefs, mesh))
        fn, donate = build_serve_step(cfg), (2,)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=False)
    args = tuple(fake_shards(d, p, mesh, fake_mode)
                 for d, p in zip(defs, plc))
    return dict(fn=fn, defs=defs, placements=plc, args=args,
                donate_argnums=donate, rules=rules, fake_mode=fake_mode)
