"""Host-side sequential reference model of the two-level device pool.

Carried over from the JAX package's ``core/refpool.py``: the
differential-conformance half of the pool tests (the port's
``tests/test_torch_pool.py``, the reference's
``tests/test_multihost_pool.py``): every operation of
:mod:`repro_torch.core.hier_pool` has an executable sequential
specification here, in plain Python lists — the *sequential witness* that the P-SIM
construction guarantees exists for the shared pool's history (DESIGN.md
§2a: P-SIM linearizes every shared-pool op, so a conforming
implementation must behave like SOME sequential stack; the device pool
is stronger — it is deterministic, so it must behave like THIS one).

Fidelity contract: given the same op trace, :class:`RefShardPool`
returns *bit-identical grant ids* and reaches *identical final state*
(shared stack contents, lane stacks, refcounts) as the device pool —
the port's torch ops on one device with a leading [DP, ...] axis, or on
one rank per DP shard, and the reference's jax ops.  The
conformance test replays one randomized trace through all of them and
asserts the grant/free multisets match per shard, so any divergence in
stack discipline (pop order, spill order, prefix-grant feasibility,
refcount-zero release marking) fails loudly.

Ordering rules mirrored exactly from block_pool/hier_pool:

* stacks pop from the top (``free_ids[top-1]`` == end of the list);
* ``create`` carves one warm batch per lane off the shared top, lane i
  receiving reversed-row i of the carve;
* batch takes (``_take_n``) are prefix-feasible in slot order —
  the first infeasible slot denies itself and every later slot;
* ``free_n`` applies ALL refcount decrements first, then releases the
  first occurrence of each block whose count reached zero — lane rows
  keep what fits (column order) up to capacity, the rest spills to the
  shared stack in row-major order;
* drain pushes each draining lane's top ``ell`` blocks in pop order,
  lanes in lane order; refill places a granted batch bottom-up.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class RefShardPool:
    """Sequential spec of ONE shard's HierPool (see module docstring)."""

    def __init__(self, num_blocks: int, num_lanes: int, ell: int):
        assert num_blocks >= num_lanes * ell
        self.m = num_blocks
        self.ell = ell
        self.cap = 3 * ell
        # shared free stack: list end == stack top (free_ids[top-1])
        self.shared: List[int] = list(range(num_blocks - 1, -1, -1))
        self.refcount = [0] * num_blocks
        # warm-up carve: top num_lanes*ell entries, reversed rows
        n = num_lanes * ell
        carve = self.shared[self.m - n:]
        del self.shared[self.m - n:]
        rows = [carve[j * ell:(j + 1) * ell] for j in range(num_lanes)]
        self.lanes: List[List[int]] = [rows[num_lanes - 1 - i]
                                       for i in range(num_lanes)]

    # -- queries --------------------------------------------------------
    def free_total(self) -> int:
        return len(self.shared) + sum(len(x) for x in self.lanes)

    def num_live(self) -> int:
        return sum(1 for r in self.refcount if r > 0)

    def lane_tops(self) -> List[int]:
        return [len(x) for x in self.lanes]

    # -- user ops -------------------------------------------------------
    def alloc(self, want: Sequence[bool]) -> List[int]:
        """hier_pool.alloc: one lane-local pop per wanting lane."""
        ids = []
        for lane, w in zip(self.lanes, want):
            if w and lane:
                b = lane.pop()
                self.refcount[b] = 1
                ids.append(b)
            else:
                ids.append(-1)
        return ids

    def alloc_n(self, counts: Sequence[int],
                max_per_lane: int) -> List[List[int]]:
        """hier_pool.alloc_n: all-or-nothing per lane, lane-local."""
        out = []
        for lane, c in zip(self.lanes, counts):
            c = min(max(int(c), 0), max_per_lane)
            if c <= len(lane):
                got = [lane.pop() for _ in range(c)]
                for b in got:
                    self.refcount[b] = 1
            else:
                got = []
            out.append(got)
        return out

    def alloc_from_shared(self, counts: Sequence[int],
                          max_per_lane: int) -> List[List[int]]:
        """block_pool.alloc_n on the shared stack: prefix-feasible
        all-or-nothing grants in slot order."""
        out, cum = [], 0
        avail = len(self.shared)
        for c in counts:
            c = min(max(int(c), 0), max_per_lane)
            cum += c
            if cum <= avail:
                got = [self.shared.pop() for _ in range(c)]
                for b in got:
                    self.refcount[b] = 1
            else:
                got = []
                avail = -1          # a denied slot denies all later ones
            out.append(got)
        return out

    def addref(self, ids: Sequence[int]) -> None:
        for b in ids:
            if b >= 0:
                self.refcount[b] += 1

    def free_n(self, ids: Sequence[Sequence[int]]) -> int:
        """hier_pool.free_n: decrement everything first, release each
        zero-count block once (first occurrence, row-major), lane rows
        keep what fits in column order, the rest spills row-major.
        Returns the spill count — the sequential spec of
        :func:`hier_pool.free_n_metered`'s second output."""
        flat = [b for row in ids for b in row if b >= 0]
        for b in flat:
            self.refcount[b] -= 1
        seen = set()
        spill = []
        for lane, row in zip(self.lanes, ids):
            for b in row:
                if b < 0 or self.refcount[b] != 0 or b in seen:
                    continue
                seen.add(b)
                if len(lane) < self.cap:
                    lane.append(b)
                else:
                    spill.append(b)
        self.shared.extend(spill)
        return len(spill)

    def free_shared(self, ids: Sequence[int]) -> None:
        """hier_pool.free_shared: lane-less release to the SHARED stack."""
        valid = [b for b in ids if b >= 0]
        for b in valid:
            self.refcount[b] -= 1
        seen = set()
        for b in valid:
            if self.refcount[b] == 0 and b not in seen:
                seen.add(b)
                self.shared.append(b)

    # -- rebalance ------------------------------------------------------
    def rebalance_drain(self) -> None:
        for lane in self.lanes:
            if len(lane) > 2 * self.ell:
                for _ in range(self.ell):
                    self.shared.append(lane.pop())

    def rebalance_refill(self) -> None:
        need = [len(x) < self.ell for x in self.lanes]
        cum = 0
        avail = len(self.shared)
        for lane, n in zip(self.lanes, need):
            if not n:
                continue
            cum += self.ell
            if cum <= avail:
                lane.extend(self.shared.pop() for _ in range(self.ell))
            else:
                avail = -1          # prefix-feasible, like _take_n
        # (drained entries above were already on the shared stack and
        # may serve refills in the same rebalance call — same as the
        # device pool)

    def rebalance(self) -> None:
        self.rebalance_drain()
        self.rebalance_refill()


def create_dp(dp: int, num_blocks: int, num_lanes: int,
              ell: int) -> List[RefShardPool]:
    """One reference shard pool per DP shard — the host mirror of
    :func:`repro_torch.core.hier_pool.create_dp` (ids shard-local)."""
    return [RefShardPool(num_blocks, num_lanes, ell) for _ in range(dp)]


class RefClassedPool:
    """Sequential spec of ONE shard's size-classed pool vector
    (:mod:`repro_torch.core.classed_pool`): an independent
    :class:`RefShardPool` per class.  Classes never exchange blocks, so
    the witness is exactly the per-class witnesses side by side —
    every op takes the class index first and delegates; ids are
    class-local AND shard-local, mirroring the device plane.

    ``specs``: sequence of ``(num_blocks, num_lanes, ell)`` triples
    (or anything exposing those attributes, e.g.
    :class:`~repro_torch.core.classed_pool.ClassSpec`).
    """

    def __init__(self, specs):
        def triple(s):
            if hasattr(s, "num_blocks"):
                return (s.num_blocks, s.num_lanes, s.ell)
            return tuple(s)[-3:] if len(tuple(s)) == 4 else tuple(s)
        self.classes = [RefShardPool(*triple(s)) for s in specs]

    # -- queries (summed over classes, like classed_pool) ---------------
    def free_total(self) -> int:
        return sum(c.free_total() for c in self.classes)

    def num_live(self) -> int:
        return sum(c.num_live() for c in self.classes)

    # -- class-indexed ops ----------------------------------------------
    def alloc(self, cls: int, want):
        return self.classes[cls].alloc(want)

    def alloc_n(self, cls: int, counts, max_per_lane: int):
        return self.classes[cls].alloc_n(counts, max_per_lane)

    def alloc_from_shared(self, cls: int, counts, max_per_lane: int):
        return self.classes[cls].alloc_from_shared(counts, max_per_lane)

    def addref(self, cls: int, ids) -> None:
        self.classes[cls].addref(ids)

    def free_n(self, cls: int, ids) -> int:
        return self.classes[cls].free_n(ids)

    def free_shared(self, cls: int, ids) -> None:
        self.classes[cls].free_shared(ids)

    # -- rebalance: all classes (the serve step's fused form) or one
    # (the torn per-class windows the chaos plane injects) -------------
    def rebalance_drain(self, cls: Optional[int] = None) -> None:
        for c in self._sel(cls):
            c.rebalance_drain()

    def rebalance_refill(self, cls: Optional[int] = None) -> None:
        for c in self._sel(cls):
            c.rebalance_refill()

    def rebalance(self, cls: Optional[int] = None) -> None:
        self.rebalance_drain(cls)
        self.rebalance_refill(cls)

    def _sel(self, cls: Optional[int]):
        return self.classes if cls is None else [self.classes[cls]]


def create_classed_dp(dp: int, specs) -> List[RefClassedPool]:
    """One reference classed pool per DP shard — the host mirror of
    :func:`repro_torch.core.classed_pool.create_dp`."""
    return [RefClassedPool(specs) for _ in range(dp)]


def conforms_classed(ref: RefClassedPool, pool, shard: int
                     ) -> Optional[str]:
    """Compare a reference classed shard against shard ``shard`` of a
    :class:`~repro_torch.core.classed_pool.ClassedPool` (class by class,
    raw leaves, on any device).  Returns None on match, else a message
    naming the diverging class."""
    def host(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else t
    for c, (rc, hp) in enumerate(zip(ref.classes, pool.classes)):
        msg = conforms(rc,
                       host(hp.shared.free_ids[shard]),
                       host(hp.shared.top[shard]),
                       host(hp.private_ids[shard]),
                       host(hp.private_top[shard]),
                       host(hp.shared.refcount[shard]))
        if msg is not None:
            return f"class {c}: {msg}"
    return None


def conforms(ref: RefShardPool, shared_free_ids, shared_top,
             private_ids, private_top, refcount) -> Optional[str]:
    """Compare a reference shard against a device shard's raw leaves
    (host-side numpy views).  Returns None on match, else a message."""
    top = int(shared_top)
    if top != len(ref.shared):
        return f"shared top {top} != ref {len(ref.shared)}"
    got = [int(x) for x in shared_free_ids[:top]]
    if got != ref.shared:
        return f"shared stack {got} != ref {ref.shared}"
    for i, lane in enumerate(ref.lanes):
        t = int(private_top[i])
        if t != len(lane):
            return f"lane {i} top {t} != ref {len(lane)}"
        if [int(x) for x in private_ids[i][:t]] != lane:
            return (f"lane {i} stack {[int(x) for x in private_ids[i][:t]]}"
                    f" != ref {lane}")
    rc = [int(x) for x in refcount]
    if rc != ref.refcount:
        return f"refcounts diverge: {rc} != {ref.refcount}"
    return None
