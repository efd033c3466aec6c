"""Serving-plane capacity planning on shard loss.

Carried over from the JAX package's ``runtime/elastic.py`` (the
serving half only): the admission scheduler sheds backlog against
this plan when shards are lost.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple


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
