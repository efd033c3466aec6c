"""Logical-axis -> mesh-axis sharding rules, as DTensor placements.

Counterpart of the JAX package's ``parallel/partition.py``.  Every
parameter and state leaf declares logical axis names
(:class:`repro_torch.models.layers.ParamDef`); the rules map them onto
the axes of a ``torch.distributed.device_mesh.DeviceMesh``:

  vocab / heads / kv_heads / mlp / experts -> "model"   (TP / EP)
  batch                                    -> ("pod", "data") or "data"
  embed / head_dim / layers / state dims   -> replicated

A dimension is sharded only if the mesh axis size divides it, and a
mesh axis shards at most one dimension of a leaf.  Where the reference
gives a ``PartitionSpec`` (one entry per tensor dim: None, a mesh axis
name or a tuple of names), the port gives DTensor placements, one per
mesh dim: ``Shard(i)`` on each mesh dim that tensor dim ``i`` is
sharded over, ``Replicate()`` elsewhere.  A tuple axis such as
``("pod", "data")`` shards one tensor dim over both mesh dims, pod the
major one (DTensor shards over mesh dims in their order).

Rule sets:
  "tp"        the default above (tensor-parallel weights)
  "fsdp"      additionally shard the embed axis over "data"
              (ZeRO-3-style fully sharded parameters)
  "sp"        "fsdp" + sequence-sharded activations (:func:`constrain_batch`)
  "ep_serve"  serving a large MoE: experts over "data"

Beside the rules: the activation constraints the models call
(:func:`constrain_batch`, :func:`gather_model`, :func:`unshard_axis`,
:func:`constant`), which act only on DTensors while the dry run has a
mesh registered, and the sharding boundaries (:func:`local_map`) at
which a kernel wrapper, a scan or a masked lookup runs on each shard's
block.  On plain tensors every one of them returns its input or calls
its function as it is.

Nothing here touches ``torch.distributed`` or a device at import.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

RULE_SETS: Dict[str, Dict[str, Any]] = {
    "tp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "mlp": "model", "experts": "model",
        "embed": None, "head_dim": None, "layers": None,
    },
    "fsdp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "mlp": "model", "experts": "model",
        "embed": "data", "head_dim": None, "layers": None,
    },
}
RULE_SETS["sp"] = RULE_SETS["fsdp"]   # + seq-sharded activations
RULE_SETS["ep_serve"] = {
    "vocab": "model", "heads": "model", "kv_heads": "model",
    "mlp": "model", "experts": "data", "embed": None,
    "head_dim": None, "layers": None,
}


def is_def(x) -> bool:
    """Duck-typed ParamDef / TensorDef check."""
    return hasattr(x, "shape") and hasattr(x, "dtype") and not isinstance(
        x, torch.Tensor)


def _names(axis) -> Tuple[str, ...]:
    """A logical rule's mesh axes as a tuple (None -> ())."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def axis_size(mesh, axis) -> int:
    """Devices along ``axis``: a mesh axis name, a tuple of names, or
    None (1)."""
    out = 1
    for a in _names(axis):
        out *= mesh.size(mesh.mesh_dim_names.index(a))
    return out


def placements(parts: Sequence, mesh) -> tuple:
    """DTensor placements of a reference-style spec: ``parts`` holds one
    entry per tensor dim (None, a mesh axis name or a tuple of names)."""
    out = [Replicate()] * mesh.ndim
    for i, axis in enumerate(parts):
        for a in _names(axis):
            out[mesh.mesh_dim_names.index(a)] = Shard(i)
    return tuple(out)


def local_shape(shape: Sequence[int], plc: Sequence, mesh) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` under placements ``plc``
    (every sharded dim divisible, as the rules make them)."""
    out = list(shape)
    for md, p in enumerate(plc):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(md)
    return tuple(out)


def spec_parts(shape, axes, rules: Dict[str, Any], mesh) -> tuple:
    """The reference's ``spec_for`` as a tuple of per-dim entries."""
    parts, used = [], set()
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax) if ax else None
        if (mesh_ax is None or mesh_ax in used
                or dim % axis_size(mesh, mesh_ax) != 0):
            parts.append(None)
        else:
            parts.append(mesh_ax)
            used.add(mesh_ax)
    return tuple(parts)


def spec_for(defn, rules: Dict[str, Any], mesh) -> tuple:
    """Placements of one ParamDef under ``rules`` on ``mesh``."""
    return placements(spec_parts(defn.shape, defn.axes, rules, mesh), mesh)


def tree_map_defs(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, named tuples, tuples
    and lists, and over the entries at the same place in the trees
    ``rest``; a ParamDef or TensorDef is a leaf (not a tuple), and so
    are tensors and host ints; None stays None."""
    if tree is None:
        return None
    if is_def(tree) or not isinstance(tree, (dict, tuple, list)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_defs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    out = [tree_map_defs(fn, *xs) for xs in zip(tree, *rest)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


def param_specs(defs: Any, mesh, rules: str = "tp") -> Any:
    """Placements of every leaf of a ParamDef tree."""
    rr = RULE_SETS[rules]
    return tree_map_defs(lambda d: spec_for(d, rr, mesh), defs)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the batch: ("pod", "data") multi-pod, else
    ("data",)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _batch_axis(mesh):
    ba = batch_axes(mesh)
    return ba if len(ba) > 1 else ba[0]


def data_spec(mesh, ndim: int, batch_dim: int = 0) -> tuple:
    """Placements of an ``ndim`` tensor sharded on ``batch_dim`` over
    the batch axes."""
    parts = [None] * ndim
    parts[batch_dim] = _batch_axis(mesh)
    return placements(parts, mesh)


def dp_size(mesh) -> int:
    return axis_size(mesh, batch_axes(mesh))


# ------------------------------------------------- activation constraints
#
# The reference pins the residual stream's batch dim to the data axes so
# that GSPMD does not resolve mixed weight/activation shardings with
# full-batch activation all-reduces.  DTensor propagates placements op
# by op, so the same constraint here is a redistribute to the batch
# shard: weight shards' partial sums are reduced where the reference's
# constraint makes GSPMD reduce them.  The active mesh is registered by
# the dry run before tracing; with no mesh registered (every other
# caller) the constraints return their input unchanged.

_ACTIVE_MESH = None
_SEQ_SHARD: bool = False


def set_activation_mesh(mesh, seq_shard: bool = False) -> None:
    """Register the mesh for activation constraints (None clears it).

    ``seq_shard`` additionally shards the sequence dim of [B, S, d]
    residual activations over "model" (sequence parallelism, the "sp"
    rule set)."""
    global _ACTIVE_MESH, _SEQ_SHARD
    _ACTIVE_MESH = mesh
    _SEQ_SHARD = seq_shard


def gather_model(x):
    """DTensor ``x`` replicated over "model" (an all-gather of a
    sequence shard under "sp", the reduction of partial sums), its
    other placements kept: the input of a block's column-parallel
    projections.  ``x`` unchanged without a registered mesh or for a
    plain tensor."""
    mesh = _ACTIVE_MESH
    if (mesh is None or not isinstance(x, DTensor)
            or "model" not in x.device_mesh.mesh_dim_names):
        return x
    md = x.device_mesh.mesh_dim_names.index("model")
    if isinstance(x.placements[md], Replicate):
        return x
    plc = list(x.placements)
    plc[md] = Replicate()
    return x.redistribute(x.device_mesh, tuple(plc))


def constrain_batch(x, batch_dim: int = 0):
    """Redistribute a DTensor ``x`` to its batch dim sharded over the
    batch axes (and, under "sp", a [B, S, d] tensor's S over "model"),
    replicated elsewhere; ``x`` unchanged without a registered mesh, for
    a plain tensor, or where the batch axes do not divide the batch."""
    mesh = _ACTIVE_MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    ba = _batch_axis(mesh)
    if x.shape[batch_dim] % axis_size(mesh, ba) != 0:
        return x
    parts: list = [None] * x.ndim
    parts[batch_dim] = ba
    if (_SEQ_SHARD and x.ndim == 3 and batch_dim == 0
            and x.shape[1] % axis_size(mesh, "model") == 0):
        parts[1] = "model"
    return x.redistribute(x.device_mesh, placements(parts, mesh))


# ------------------------------------------------------ sharding boundaries
#
# Where DTensor has no sharding strategy for a function's ops (a kernel
# wrapper, a scan, a masked vocab-parallel lookup), the function runs on
# each shard's local block under torch's ``local_map``, as a Pallas call
# runs on its block inside the reference's sharded program.  A boundary
# states each argument's layout with logical entries per tensor dim:
# BATCH (the batch axes, where they divide the dim), MODEL ("model",
# where it divides the dim), None (replicated); a non-tensor argument,
# or a tensor that enters whole, takes None for its whole spec; KEEP
# takes a DTensor as it is laid out (a state leaf updated in place must
# not be redistributed: the update would land in a copy).

BATCH, MODEL, KEEP = "batch", "model", "keep"


def parts_of(plc, mesh, ndim: int) -> tuple:
    """The reference-style parts of placements ``plc`` on ``mesh`` (the
    inverse of :func:`placements` for Shard / Replicate)."""
    parts: list = [()] * ndim
    for md, p in enumerate(plc):
        if isinstance(p, Shard):
            parts[p.dim] = parts[p.dim] + (mesh.mesh_dim_names[md],)
    return tuple(None if not a else (a if len(a) > 1 else a[0])
                 for a in parts)


def _resolve(spec, shape, mesh) -> tuple:
    """Reference-style parts of a boundary spec for a tensor of
    ``shape``: each BATCH / MODEL entry kept only where it divides."""
    parts = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, e in zip(shape, spec):
        ax = {BATCH: _batch_axis(mesh), MODEL: "model"}.get(e)
        if (ax is None or any(a not in mesh.mesh_dim_names
                              for a in _names(ax))
                or dim % axis_size(mesh, ax)):
            ax = None
        parts.append(ax)
    return tuple(parts)


def local_map(fn, in_specs: Sequence, out_specs):
    """``fn`` as a sharding boundary.  On plain tensors it is ``fn``
    itself.  Given DTensors, each argument ``i`` is redistributed to
    ``in_specs[i]`` (a tuple of BATCH / MODEL / None, one per dim; KEEP:
    as it is; None: replicated, or a non-tensor; a tree argument takes
    one spec for every leaf), ``fn`` runs on the local blocks, and its
    tensor outputs become DTensors again with the placements
    ``out_specs(mesh, parts)`` gives: one placements tuple for every
    output, or a tuple of them, one per flattened output; ``parts`` are
    the resolved parts of the flattened arguments (None for
    non-tensors).  It does what torch's ``local_map``
    (``torch.distributed.tensor.experimental``) does, with the same
    DTensor calls (``redistribute``, ``to_local`` with the gradients'
    placements, ``from_local``), but decides the inputs' placements at
    the call, where the shapes are known, and the outputs' after the
    local call, where their number is.  Raises where a plain tensor
    comes beside DTensors: no leaf may be silently replicated."""
    from torch.distributed.tensor import Placement
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    from torch.utils import _pytree as pytree

    def call(*args):
        if not any(isinstance(a, DTensor) for a in args) and any(
                isinstance(a, torch.Tensor) for a in args):
            return fn(*args)          # plain tensors: no tree walk
        flat, tree = pytree.tree_flatten(args)
        mesh = next((a.device_mesh for a in flat if isinstance(a, DTensor)),
                    None)
        if mesh is None:
            return fn(*args)
        specs = []
        for a, s in zip(args, in_specs):
            specs += [s] * len(pytree.tree_leaves(a))
        in_plc, parts = [], []
        for a, s in zip(flat, specs):
            if isinstance(a, DTensor):
                p = (parts_of(a.placements, mesh, a.ndim) if s == KEEP
                     else _resolve(s or (None,) * a.ndim, a.shape, mesh))
                parts.append(p)
                in_plc.append(tuple(a.placements) if s == KEEP
                              else placements(p, mesh))
            elif isinstance(a, torch.Tensor):
                raise TypeError(
                    f"{getattr(fn, '__name__', fn)}: a plain tensor "
                    f"{tuple(a.shape)} beside DTensors at a sharding "
                    f"boundary")
            else:
                parts.append(None)
                in_plc.append(None)
        local = []
        for a, p, g in zip(flat, in_plc, _grad_placements(in_plc)):
            if isinstance(a, DTensor):
                if tuple(a.placements) != p:
                    a = a.redistribute(mesh, p)
                a = a.to_local(grad_placements=g)
                if isinstance(a, AsyncCollectiveTensor):
                    a = a.wait()
            local.append(a)
        out = fn(*pytree.tree_unflatten(local, tree))
        flat_out, out_tree = pytree.tree_flatten(out)
        plc = out_specs(mesh, parts)
        tensors = [o for o in flat_out if isinstance(o, torch.Tensor)]
        if plc and isinstance(plc[0], Placement):
            plc = (plc,) * len(tensors)
        if len(plc) != len(tensors):
            raise ValueError(f"{getattr(fn, '__name__', fn)}: "
                             f"{len(plc)} output placements for "
                             f"{len(tensors)} tensor outputs")
        it = iter(plc)
        return pytree.tree_unflatten(
            [DTensor.from_local(o, mesh, next(it), run_check=False)
             if isinstance(o, torch.Tensor) else o for o in flat_out],
            out_tree)

    call.__name__ = getattr(fn, "__name__", "local_map")
    call.__doc__ = fn.__doc__
    return call


def _grad_placements(in_plc) -> tuple:
    """Gradient layouts of a boundary's inputs: as the input, but on a
    mesh dim where another input is sharded, an input replicated there
    gets partial sums (each shard's block contributes its share of the
    gradient, as a weight's does from each batch shard)."""
    from torch.distributed.tensor import Partial
    sharded = {md for p in in_plc if p is not None
               for md, q in enumerate(p) if isinstance(q, Shard)}
    return tuple(None if p is None else tuple(
        Partial() if md in sharded and isinstance(q, Replicate) else q
        for md, q in enumerate(p)) for p in in_plc)


def like(i: int):
    """``out_specs`` of a boundary whose outputs all take the placements
    of its ``i``-th flattened argument (``-1``: the last): the outputs
    share that argument's sharded dims (its batch dim, its heads)."""
    def out(mesh, parts):
        return placements(parts[i], mesh)
    return out


def is_sharded(x) -> bool:
    """True for a DTensor."""
    return isinstance(x, DTensor)


def shard_offset(x, dim: int, axis: str) -> int:
    """Global index of the first element along ``dim`` of this rank's
    block of ``x`` where ``dim`` is sharded over mesh ``axis`` at a
    boundary (0 where it would not be)."""
    mesh = x.device_mesh
    if not divides(x, dim, axis):
        return 0
    n = axis_size(mesh, axis)
    return mesh.get_local_rank(axis) * (x.shape[dim] // n)


def constant(t, like):
    """A plain tensor made inside the step (a RoPE table, a mask, an
    ``arange``) for use beside ``like``: replicated on ``like``'s mesh
    where ``like`` is a DTensor, else ``t`` itself.  Parameters and
    state never pass here: they enter the step as DTensors with their
    placements."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh,
                              (Replicate(),) * like.device_mesh.ndim,
                              run_check=False)


def divides(x, dim: int, axis: str) -> bool:
    """True where DTensor ``x``'s mesh has ``axis`` and its size divides
    ``x.shape[dim]``."""
    mesh = x.device_mesh
    return (axis in mesh.mesh_dim_names
            and x.shape[dim] % axis_size(mesh, axis) == 0)


def laid_out_as(t, ref):
    """DTensor ``t`` redistributed to ``ref``'s placements (``t`` itself
    on plain tensors): a value about to be written into state ``ref``
    in place."""
    if not isinstance(ref, DTensor) or tuple(t.placements) == tuple(
            ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def sharded_dim(t, dim: int, axis: str) -> bool:
    """True where DTensor ``t`` is sharded over mesh ``axis`` on
    ``dim``."""
    mesh = t.device_mesh
    md = mesh.mesh_dim_names.index(axis) if axis in mesh.mesh_dim_names \
        else None
    return md is not None and t.placements[md] == Shard(dim % t.ndim)


def whole(mesh, parts) -> tuple:
    """``out_specs`` of a boundary whose outputs are replicated."""
    return (Replicate(),) * mesh.ndim


def unshard(t, dim: int):
    """DTensor ``t`` with its dim ``dim`` gathered (replicated on every
    mesh dim that shards it); ``t`` itself on plain tensors."""
    if not isinstance(t, DTensor):
        return t
    plc = tuple(Replicate() if p == Shard(dim % t.ndim) else p
                for p in t.placements)
    return t if plc == tuple(t.placements) else t.redistribute(
        t.device_mesh, plc)


def unshard_axis(tree, defs, axis: str = "embed", skip: int = 0):
    """The FSDP gather: every leaf of a parameter tree with the dims its
    ParamDef names ``axis`` gathered (the "fsdp" rules shard "embed"
    over "data"; the other rule sets shard no "embed" dim, and this is
    a no-op).  ``skip`` leading axes of the defs (a stack's "layers")
    are not in the leaves.  The gradient of the gather is the
    reduce-scatter back to the parameters' shards."""
    if isinstance(tree, dict):
        return {k: unshard_axis(v, defs[k], axis, skip)
                for k, v in tree.items()}
    for i, ax in enumerate(defs.axes[skip:]):
        if ax == axis:
            tree = unshard(tree, i)
    return tree
