"""The serving state's DP layout: which axis of each leaf is the shard's.

Counterpart of the serving part of the JAX package's
``launch/steps.py`` (``serve_register_pspec``, ``serve_state_pspecs``,
``decode_layout``).  Where the reference names the ``"dp"`` mesh axis
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

from typing import Any, Callable, Tuple

from ..configs.base import ShapeConfig
from ..models.transformer import DecodeState


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of a tree of named tuples, tuples, lists
    and dicts (None stays None), with the leaves at the same place in
    ``rest``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


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
        return lambda tree: _map(lambda _: a, tree)
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
    return _map(lambda t, a: t.narrow(a, rank, 1), state,
                serve_state_axes(state))


def gather_state(local: DecodeState, group) -> DecodeState:
    """The whole state from the ranks' shards: every leaf all-gathered
    on its DP axis in rank order, on each leaf's own device.  A
    collective: every rank of ``group`` calls it at the same point."""
    return _map(lambda t, a: group.gather(t, a).to(t.device), local,
                serve_state_axes(local))
