"""Roofline terms of a traced step, at H100 data-sheet constants.

Counterpart of the JAX package's ``launch/roofline.py``.  Three terms
per (arch x shape x mesh) cell, in seconds, for one device:

  compute    = bf16 matmul flops / 989e12 + float32 matmul flops / 67e12
  memory     = bytes accessed / 3.35e12
  collective = collective bytes within a node / 450e9
               + collective bytes across nodes / 50e9

The reference walks the partitioned HLO of its compiled step.  The port
walks the FX graph that ``functorch.compile.aot_function`` traces of
the step over fake DTensor shards (:func:`trace`): rank 0's local
program, local shapes, and the ``_c10d_functional`` collectives DTensor
inserts; nothing runs.  Python loops are unrolled in the trace, so the
reference's while-loop trip counts have no counterpart; remat's
recompute is traced as it runs (:func:`trace` keeps
``torch.utils.checkpoint``'s saved-tensor hooks, which AOTAutograd
otherwise defers).  The mini cost model (:func:`analyze_graph`):

  * flops: ``aten.mm / bmm / addmm / baddbmm / convolution``, 2 x result
    x contracted dims (convolution: x input channels a group x kernel
    taps); a float32 product runs outside the tensor cores unless an
    operand is an upcast of bf16 values, as in the kernels' plain
    versions (:func:`_is_f32_product`);
  * bytes: per node, result + operand bytes; views and metadata ops
    (the reference's ``bitcast``, ``tuple``, ``get-tuple-element``) are
    skipped; gathers (``index``, ``gather``, ``embedding``, ...) are
    charged twice the data moved, scatters (``index_put``, ``scatter``,
    ``slice_scatter``, ...) twice the update, as the reference charges
    ``gather``/``dynamic-slice`` and ``dynamic-update-slice``;
  * collectives: ``all_reduce`` / ``all_gather_into_tensor`` /
    ``reduce_scatter_tensor`` / ``all_to_all_single`` /
    ``shard_dim_alltoall`` result bytes x the transfer factor (a ring
    all-reduce moves about 2x), a group within one node of
    :data:`NODE_GPUS` ranks at NVLink's rate, a group across nodes at
    InfiniBand's.  The production meshes keep the reference's 16-wide
    "model" axis, so on nodes of 8 GPUs it spans two nodes and its
    collectives go at InfiniBand's rate.

The device constants below are the NVIDIA H100 SXM data sheet's (dense,
no sparsity).  Every figure this module gives is a prediction.
"""

from __future__ import annotations

import contextlib
import math
import operator
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

#: bf16 dense tensor-core flop/s (H100 SXM data sheet)
PEAK_FLOPS = 989e12
#: float32 flop/s outside the tensor cores (H100 SXM data sheet)
PEAK_FLOPS_F32 = 67e12
#: HBM3 bytes/s (H100 SXM data sheet: 3.35 TB/s)
HBM_BW = 3.35e12
#: NVLink 4 bytes/s a direction a GPU (900 GB/s both directions)
NVLINK_BW = 450e9
#: InfiniBand bytes/s a GPU (one 400 Gb/s NDR port a GPU)
IB_BW = 50e9
#: GPUs a node joins by NVLink (an 8-GPU HGX H100 node)
NODE_GPUS = 8

_COLL_FACTOR = {
    "all_reduce": 2.0,
    "all_gather_into_tensor": 1.0,
    "reduce_scatter_tensor": 1.0,
    "all_to_all_single": 1.0,
    "shard_dim_alltoall": 1.0,
}
#: the namespaces of collective ops in a traced graph
_COLL_NS = ("_c10d_functional", "_dtensor")

#: nodes that move no bytes: views, metadata, the collectives' waits
#: (a collective's bytes are charged at the collective)
_VIEW_OPS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "alias", "detach",
    "as_strided", "split", "split_with_sizes", "unbind", "unflatten",
    "diagonal", "narrow", "view_as", "expand_as", "lift_fresh",
    "wait_tensor", "_reshape_alias", "unsafe_split",
}
_GATHER_OPS = {"index", "gather", "embedding", "index_select", "take",
               "take_along_dim", "_embedding_bag"}
#: scatter-like ops and the position of their update operand
_SCATTER_OPS = {"index_put": 2, "index_put_": 2, "_index_put_impl": 2,
                "_unsafe_index_put": 2, "scatter": 3, "scatter_add": 3,
                "scatter_reduce": 3, "index_add": 3, "index_copy": 3,
                "slice_scatter": 1, "select_scatter": 1,
                "diagonal_scatter": 1, "masked_scatter": 2}
_MM_OPS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}


def _op_name(node) -> Tuple[str, str]:
    """(namespace, op) of a call_function node, e.g. ("aten", "mm")."""
    t = node.target
    if t is operator.getitem:
        return "", "getitem"
    name = getattr(t, "name", None)
    if callable(name):
        ns, _, rest = t.name().partition("::")
        return ns, rest.split(".")[0]
    return "", getattr(t, "__name__", str(t))


def _vals(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _vals(x)]
    return []


def _nbytes(v) -> int:
    return sum(t.numel() * t.element_size() for t in _vals(v))


def _val(n):
    return n.meta.get("val") if hasattr(n, "meta") else None


def _arg_nodes(node) -> list:
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, (list, tuple)):
            out += [x for x in a if hasattr(x, "meta")]
        elif hasattr(a, "meta"):
            out.append(a)
    return out


def _mm_flops(op: str, node) -> float:
    a = [_val(x) for x in node.args[:3] if hasattr(x, "meta")]
    out = _val(node)
    if op in ("mm", "bmm"):
        k = a[0].shape[-1]
    elif op in ("addmm", "baddbmm"):
        k = a[1].shape[-1]
    else:                                   # convolution: [Cout, Cin/g, ...]
        w = a[1]
        k = math.prod(w.shape[1:])
    return 2.0 * out.numel() * k


def _upcast(node) -> bool:
    """True where ``node`` is, through views, a float32 copy of a 16-bit
    float tensor."""
    while node.op == "call_function":
        _, op = _op_name(node)
        args = _arg_nodes(node)
        if op in ("_to_copy", "to", "convert_element_type") and args:
            src = _vals(_val(args[0]))
            return bool(src) and src[0].dtype in (torch.bfloat16,
                                                  torch.float16)
        if op not in _VIEW_OPS or not args:
            return False
        node = args[0]
    return False


def _is_f32_product(node) -> bool:
    """A float32 product runs outside the tensor cores, unless one of
    its operands is an upcast of 16-bit values: the plain versions of
    the kernels upcast bf16 operands that the kernels feed to the tensor
    cores as they are (K6 takes bf16 q, k, v and rounds P to bf16 before
    P V), so such a product is charged at the bf16 rate."""
    out = _vals(_val(node))
    if not out or out[0].dtype != torch.float32:
        return False
    ops = [a for a in _arg_nodes(node)
           if _vals(_val(a)) and _vals(_val(a))[0].dim() >= 2]
    return not any(_upcast(a) for a in ops[-2:])


def _group_ranks(name) -> Tuple[int, ...]:
    """Global ranks of a functional collective's process group."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


@dataclass
class GraphCost:
    flops: float = 0.0               # bf16 (and other non-f32) matmul flops
    flops_f32: float = 0.0           # float32 matmul flops
    bytes: float = 0.0
    coll_bytes_weighted: float = 0.0
    coll_bytes_raw: float = 0.0
    coll_bytes_nvlink: float = 0.0   # weighted, groups within a node
    coll_bytes_ib: float = 0.0       # weighted, groups across nodes
    coll_counts: Dict[str, int] = field(default_factory=dict)
    largest_collective: Tuple[str, float] = ("", 0.0)


def analyze_graph(gm, node_gpus: int = NODE_GPUS) -> GraphCost:
    """The cost model of the module docstring over one FX graph."""
    cost = GraphCost()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        ns, op = _op_name(node)
        out = _val(node)
        if ns in _COLL_NS and op in _COLL_FACTOR:
            b = _nbytes(out)
            ranks = _group_ranks(node.args[-1])
            intra = len({r // node_gpus for r in ranks}) == 1
            w = b * _COLL_FACTOR[op]
            cost.coll_bytes_weighted += w
            cost.coll_bytes_raw += b
            if intra:
                cost.coll_bytes_nvlink += w
            else:
                cost.coll_bytes_ib += w
            cost.coll_counts[op] = cost.coll_counts.get(op, 0) + 1
            if b > cost.largest_collective[1]:
                shape = list(_vals(out)[0].shape) if _vals(out) else []
                cost.largest_collective = (
                    f"{op} {str(_vals(out)[0].dtype).split('.')[-1]}"
                    f"{shape} over {len(ranks)} "
                    f"({'NVLink' if intra else 'IB'})", b)
            cost.bytes += 2 * b
            continue
        if op in _MM_OPS:
            f = _mm_flops(op, node)
            if _is_f32_product(node):
                cost.flops_f32 += f
            else:
                cost.flops += f
        if op in _VIEW_OPS or op == "getitem" or ns in _COLL_NS:
            continue
        res_b = _nbytes(out)
        if op in _GATHER_OPS:
            cost.bytes += 2 * res_b
            continue
        if op in _SCATTER_OPS:
            upd = node.args[_SCATTER_OPS[op]] if len(
                node.args) > _SCATTER_OPS[op] else None
            cost.bytes += 2 * (_nbytes(_val(upd)) if hasattr(upd, "meta")
                               else _nbytes([_val(u) for u in upd or ()
                                             if hasattr(u, "meta")]))
            continue
        cost.bytes += res_b + sum(_nbytes(_val(a)) for a in _arg_nodes(node))
    return cost


def add_costs(costs: List[GraphCost]) -> GraphCost:
    out = GraphCost()
    for c in costs:
        for k in ("flops", "flops_f32", "bytes", "coll_bytes_weighted",
                  "coll_bytes_raw", "coll_bytes_nvlink", "coll_bytes_ib"):
            setattr(out, k, getattr(out, k) + getattr(c, k))
        for k, v in c.coll_counts.items():
            out.coll_counts[k] = out.coll_counts.get(k, 0) + v
        if c.largest_collective[1] > out.largest_collective[1]:
            out.largest_collective = c.largest_collective
    return out


def peak_temp_bytes(gm) -> int:
    """Peak bytes of the step's own tensors over one graph: each node's
    result is live from the node to its last use (a view keeps its
    base's storage live, a graph output to the end); arguments are not
    counted (they are the argument bytes).  In a traced train step the
    backward reads the forward's saved activations in the same graph,
    so they live from the forward to their use in the backward."""
    nodes = list(gm.graph.nodes)
    pos = {n: i for i, n in enumerate(nodes)}
    base = {}                # node -> the node owning its storage
    size = {}                # owning node -> bytes
    for n in nodes:
        if n.op == "placeholder":
            base[n] = n
            continue
        if n.op != "call_function":
            continue
        _, op = _op_name(n)
        args = _arg_nodes(n)
        if (op in _VIEW_OPS or op == "getitem") and args:
            base[n] = base.get(args[0], args[0])
        else:
            base[n] = n
            size[n] = _nbytes(_val(n))
    last = {}
    for n in nodes:
        for a in _arg_nodes(n):
            b = base.get(a, a)
            last[b] = max(last.get(b, -1), pos[n])
        if n.op == "output":
            for a in _arg_nodes(n):
                b = base.get(a, a)
                last[b] = len(nodes)
    frees: Dict[int, int] = {}
    for b, s in size.items():
        end = last.get(b, pos[b])
        frees[end] = frees.get(end, 0) + s
    live = peak = 0
    for i, n in enumerate(nodes):
        live += size.get(n, 0)
        peak = max(peak, live)
        live -= frees.get(i, 0)
    return peak


class _Traced(Exception):
    """Raised by the recording compilers: the graphs are kept and never
    run."""


@contextlib.contextmanager
def _keep_saved_tensor_hooks():
    """AOTAutograd defers saved-tensor hooks to run time while it
    traces, and ``torch.utils.checkpoint``'s recompute lives in those
    hooks: keep them, so a remat step's trace holds its recompute, as
    the reference's HLO does."""
    import torch._dynamo.utils as du
    saved = du._disable_saved_tensors_hooks_during_tracing
    du._disable_saved_tensors_hooks_during_tracing = contextlib.nullcontext
    try:
        yield
    finally:
        du._disable_saved_tensors_hooks_during_tracing = saved


def _all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all reshard (``Shard(i) -> Shard(j)``) as the
    all-to-all op that NCCL runs.  DTensor falls back to an all-gather
    and a chunk on a host mesh, because Gloo has no all-to-all; the fake
    group stands for NCCL on the cards, so the trace keeps the
    all-to-all."""
    from torch.distributed._functional_collectives import (
        _group_or_group_name, _resolve_group)
    group = _resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, _group_or_group_name(group))


@contextlib.contextmanager
def _nccl_collectives():
    """Trace DTensor's all-to-all reshards as all-to-alls
    (:func:`_all_to_all`)."""
    import torch.distributed.tensor.placement_types as pt
    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = _all_to_all
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


def trace(fn, args, fake_mode) -> list:
    """The FX graphs of ``fn(*args)``: ``aot_function``'s forward graph
    and, where an argument requires grad, its backward graph, recorded
    by compilers that never run them."""
    from functorch.compile import aot_function
    graphs = []

    def record(gm, _inputs):
        graphs.append(gm)
        raise _Traced

    with _keep_saved_tensor_hooks(), _nccl_collectives(), fake_mode:
        try:
            aot_function(fn, fw_compiler=record, bw_compiler=record)(*args)
        except _Traced:
            pass
    if not graphs:
        raise RuntimeError("trace: the step produced no graph")
    return graphs


@dataclass
class Roofline:
    chips: int
    flops: float                  # per-device bf16 (tensor-core) flops
    hbm_bytes: float              # per-device bytes accessed
    coll_bytes: float             # per-device weighted collective bytes
    model_flops: float = 0.0      # 6*N*D useful flops, whole step, global
    coll_counts: Dict[str, int] = field(default_factory=dict)
    largest_collective: str = ""
    flops_f32: float = 0.0        # per-device float32 matmul flops
    coll_bytes_nvlink: float = 0.0
    coll_bytes_ib: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS + self.flops_f32 / PEAK_FLOPS_F32

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_nvlink / NVLINK_BW + self.coll_bytes_ib / IB_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (global traced matmul flops)."""
        total = (self.flops + self.flops_f32) * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU upper bound: useful flops / (peak x time)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def as_dict(self) -> dict:
        return {
            "chips": self.chips,
            "hlo_flops_per_device": self.flops + self.flops_f32,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flop_fraction": self.useful_fraction,
            "mfu_bound": self.mfu_bound,
            "coll_counts": self.coll_counts,
            "largest_collective": self.largest_collective,
            "f32_flops_per_device": self.flops_f32,
            "collective_bytes_nvlink": self.coll_bytes_nvlink,
            "collective_bytes_ib": self.coll_bytes_ib,
        }


def from_graphs(graphs, chips: int, model_flops: float = 0.0) -> Roofline:
    cost = add_costs([analyze_graph(g) for g in graphs])
    return Roofline(
        chips=chips, flops=cost.flops, hbm_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes_weighted, model_flops=model_flops,
        coll_counts=cost.coll_counts,
        largest_collective=cost.largest_collective[0],
        flops_f32=cost.flops_f32, coll_bytes_nvlink=cost.coll_bytes_nvlink,
        coll_bytes_ib=cost.coll_bytes_ib)
