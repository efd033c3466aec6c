"""Elastic scaling: re-mesh on device-membership change, and
serving-plane capacity planning on shard loss.

Carried over from the JAX package's ``runtime/elastic.py``, host-only.
On a membership change the trainer's policy (:func:`plan_for`) keeps
the model axis if it can (the tensor-parallel degree is
architecture-critical) and shrinks the data axis, raising gradient
accumulation so the global batch stays; the admission scheduler sheds
backlog against :func:`plan_serving_for` when serving shards are lost.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    grad_accum: int            # microbatches to keep the global batch
    note: str


def plan_for(n_devices: int, *, model_parallel: int = 16,
             full_data_parallel: int = 16,
             pods: int = 1) -> ElasticPlan:
    """Nearest valid (data, model) factorization for surviving devices."""
    mp = model_parallel
    while mp > 1 and n_devices % mp:
        mp //= 2
    data = n_devices // mp
    full_dp = full_data_parallel * pods
    # keep the global batch: accumulate if data-parallel ways were lost
    accum = max(1, -(-full_dp // max(data, 1)))
    note = ("full mesh" if mp == model_parallel and data == full_dp
            else f"degraded: model {model_parallel}->{mp}, data "
                 f"{full_dp}->{data}")
    if pods > 1 and data % pods == 0 and mp == model_parallel:
        return ElasticPlan((pods, data // pods, mp), ("pod", "data", "model"),
                           accum, note)
    return ElasticPlan((data, mp), ("data", "model"), accum, note)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    surviving: Tuple[int, ...]   # shard ids still serving
    page_budget: int             # per-shard admission budget (physical)
    capacity_pages: int          # total admission capacity across survivors
    shed_pages: int              # backlog pages beyond capacity to shed
    note: str


def plan_serving_for(n_shards: int, dead: Iterable[int], page_budget: int,
                     backlog_pages: int = 0) -> ServingPlan:
    """Serving-plane analogue of :func:`plan_for` for shard loss.

    The per-shard page budget is physical (each DP shard owns its own
    pool), so losing a shard cannot be absorbed by raising the others'
    budgets — total admission capacity simply shrinks with the
    surviving shard count.  Any worst-case queued backlog beyond that
    capacity must be shed; picking *which* requests to drop (lowest SLO
    class, queue tail first) is the caller's policy
    (serving/sched.py)."""
    dead = set(dead)
    surviving = tuple(s for s in range(n_shards) if s not in dead)
    capacity = len(surviving) * page_budget
    shed = max(0, int(backlog_pages) - capacity)
    note = ("full mesh" if not dead else
            f"degraded: {n_shards}->{len(surviving)} shards"
            + (f", shed {shed} backlog pages" if shed else ""))
    return ServingPlan(surviving, page_budget, capacity, shed, note)
