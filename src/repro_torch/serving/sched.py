"""Traffic-aware serving frontend: admission, preemption, pin policy.

The paper gives the layers *below* this one constant-time alloc/free —
the allocator never stalls under load.  This module is the layer that
decides **who gets the pages**: a scheduler subsystem that treats
pages-in-use as the contended resource, in the spirit of production
allocators that pair fast alloc/free with an explicit reclamation
policy under a memory budget (DESIGN.md §8).

Three responsibilities, all host-side policy over the engine's O(1)
mechanisms (nothing here touches the per-token hot path):

* **Admission** — per-SLO-class priority queues (FIFO within a class,
  strict priority across classes), continuous batching, and per-shard
  page-budget accounting: a request is admitted only onto a shard
  whose worst-case committed pages (every active request at its full
  ``prompt + max_new`` demand) plus cache-pinned pages leave room for
  its own worst case.  The budget defaults to ``b_local * max_pages``
  — exactly the table capacity the pool was sized for — so the §4.2
  never-dry invariant stays intact even with pinned pages subtracting
  from the pool's slack.  Backpressure is explicit: ``submit`` rejects
  with a reason (``queue_full``, ``too_large``) instead of queueing
  unservable work, and a blocked head-of-line defers with a recorded
  reason (``slots`` / ``pages``).

* **Preemption** — when the head of a higher-priority queue cannot be
  placed, the scheduler evicts pinned pages first (cheapest — only
  cache state), then preempts a lower-priority victim: the engine
  releases the victim's pages through the normal refcounted path
  (``hier_pool.free_n_dp`` inside ``_release_slots``) and the request
  is requeued at the *front* of its class carrying prompt + generated
  tokens, so readmission re-prefills through the prefix cache (often
  nearly free: the victim's whole-page state is pinned before release
  when the pin budget allows).  Output identity is preserved: greedy
  decode is position-deterministic, and the sampler keys noise by
  ``(seed, out_count)`` (serving/sampling.py), so a resumed request
  draws exactly the tokens it would have drawn unpreempted.

* **Hardening** (DESIGN.md §11) — per-request deadlines (queued or
  running, a request past ``deadline_at`` fails with the typed reason
  ``"deadline"``), bounded-backoff retry parking for fault-failed
  requests, and graceful shard-loss degradation: a dead shard leaves
  the placement set, its evacuated work requeues at the front, and
  when the recovery backlog's worst case exceeds the surviving
  capacity (``runtime.elastic.plan_serving_for``) the lowest class
  sheds from the tail with reason ``"shed"``.

* **Pin policy** — which finished-or-finishing prefixes stay pinned
  (`serving/prefix_cache.py` holds the mechanism): pin at prompt
  completion and at preemption, deduplicated by exact token key, LRU
  eviction per shard when the pinned-pages budget is exceeded, on
  admission pressure, or when a shard's pool occupancy crosses the
  high-water mark (read from the packed per-step status row — no extra
  device sync).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class.  Higher ``priority`` admits first and may
    preempt strictly-lower-priority work (if ``preemptible``)."""
    name: str
    priority: int
    preemptible: bool = True


#: interactive preempts standard preempts batch; batch is the
#: background class that soaks up leftover capacity.
DEFAULT_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", 2),
    SLOClass("standard", 1),
    SLOClass("batch", 0),
)

#: every typed terminal failure a request can carry in ``req.rejected``
#: (DESIGN.md §11): admission backpressure (``too_large`` /
#: ``queue_full``), deadline expiry, a poisoned request out of retries,
#: and load shed under degraded capacity.
FAILURE_REASONS: Tuple[str, ...] = (
    "too_large", "queue_full", "deadline", "poisoned", "shed",
)


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    classes: Tuple[SLOClass, ...] = DEFAULT_CLASSES
    #: reject new submissions beyond this backlog (0 = unbounded)
    max_queue: int = 0
    #: admissible worst-case pages per shard (0 = the engine default,
    #: b_local * max_pages — the capacity the pool is provisioned for)
    page_budget: int = 0
    #: admissible worst-case CLS_STATE blocks per shard in a size-
    #: classed config (0 = the engine default, b_local *
    #: state_blocks_per_slot — what class 1 is provisioned for).  The
    #: second budget dimension of admission: a shard must have headroom
    #: in BOTH classes, since the classes never exchange blocks
    #: (DESIGN.md §14)
    state_budget: int = 0
    #: admissible CLS_EXPERT pages per shard in an expert-paged config
    #: (0 = the engine default, full residency).  The third budget
    #: dimension — but load-aware, not worst-case-static: a request
    #: whose expert footprint is already resident on a shard costs 0
    #: pages there, a cold fan-out costs EXPERT_PPE pages per expert
    #: per MoE layer slot, and the engine nets out what LRU eviction of
    #: cold experts can reclaim (engine.expert_headroom; DESIGN.md §15)
    expert_budget: int = 0
    preemption: bool = True
    max_preemptions_per_tick: int = 2
    #: pinned-prefix pages budget per shard (0 disables pinning)
    pin_pages: int = 0
    #: device pin-table rows per shard
    pin_rows: int = 4
    #: shed pins when a shard's pool occupancy crosses this fraction
    high_water: float = 0.9
    #: retries granted to a request that fails mid-flight for a
    #: retryable reason (poisoned step, injected fault) before it is
    #: terminally rejected
    retry_limit: int = 1
    #: scheduler ticks a retrying request parks before re-queueing;
    #: the wait grows linearly with the retry count (bounded backoff)
    retry_backoff: int = 2
    #: SLO-aware chunk sizing (DESIGN.md §10): the static set of prefill
    #: lane widths the engine may dispatch (each is one compiled step
    #: variant).  () disables adaptation — every prefill step runs the
    #: engine's full ``chunk_size``.  With buckets configured the
    #: scheduler shrinks the prefill lane to the smallest bucket
    #: whenever latency-class work is waiting on lower-priority prefill
    #: (prefill/decode interference control); the engine's full chunk
    #: is always a member, so an idle queue always runs full-width.
    chunk_buckets: Tuple[int, ...] = ()


@dataclasses.dataclass
class Admission:
    """submit() decision; ``reason`` is empty when accepted."""
    accepted: bool
    reason: str = ""


class AdmissionScheduler:
    """Queues + accounting.  The engine owns the mechanisms (slot
    alloc, share, pin, release); ``tick`` drives them once per engine
    step, before the feed build — entirely host-side, no device sync.
    """

    def __init__(self, config: SchedConfig, n_shards: int,
                 page_budget: int, state_budget: int = 0):
        self.config = config
        self.classes = sorted(config.classes, key=lambda c: -c.priority)
        self.by_name = {c.name: c for c in self.classes}
        # unknown slo names fall into the lowest class rather than jump
        # the queue
        self.default_class = self.classes[-1]
        self.queues: Dict[str, Deque] = {c.name: deque()
                                         for c in self.classes}
        self.n_shards = n_shards
        self.page_budget = (config.page_budget or page_budget)
        #: fine-class (CLS_STATE) block budget per shard; 0 when the
        #: engine runs a single class — the dimension then never binds
        self.state_budget = (config.state_budget or state_budget)
        self.committed = [0] * n_shards             # worst-case pages
        self.committed_state = [0] * n_shards       # worst-case blocks
        # slot -> (shard, est_pages, est_state_blocks)
        self.est_of: Dict[int, Tuple[int, int, int]] = {}
        self._seq = itertools.count()
        #: shards lost to failure (engine.lose_shard): excluded from
        #: placement; their budget leaves ``plan_serving_for`` capacity
        self.dead_shards: set = set()
        #: (ready_tick, req) retry parking — bounded-backoff staging
        #: area for fault-failed requests (engine.fail_active)
        self.parked: List[Tuple[int, object]] = []
        self._ticks = 0
        # preemptions are counted by the mechanism (engine.preempt /
        # engine.stats) — one ledger, not two that can drift
        self.stats = {"deferred": 0, "rejected": 0, "pins_evicted": 0,
                      "defer_slots": 0, "defer_pages": 0,
                      "defer_experts": 0, "shed": 0, "retried": 0}
        #: set by the engine: the §13 Telemetry facade; every counter
        #: below mirrors into its typed ``sched_*`` namespace
        self.telemetry = None

    def _count(self, name: str, n: int = 1) -> None:
        self.stats[name] = self.stats.get(name, 0) + n
        if self.telemetry is not None:
            self.telemetry.inc("sched_" + name, n)

    # ---------------------------------------------------------- intake
    def class_of(self, req) -> SLOClass:
        return self.by_name.get(getattr(req, "slo", ""),
                                self.default_class)

    def submit(self, req, est_pages: int) -> Admission:
        if est_pages > self.page_budget:
            self._count("rejected")
            req.rejected = "too_large"
            return Admission(False, "too_large")
        if self.config.max_queue and self.backlog() >= self.config.max_queue:
            self._count("rejected")
            req.rejected = "queue_full"
            return Admission(False, "queue_full")
        self.queues[self.class_of(req).name].append(req)
        return Admission(True)

    def backlog(self) -> int:
        # parked retries count: the engine's run/idle loops key
        # liveness on backlog, and a parked request is still owed work
        return sum(len(q) for q in self.queues.values()) + len(self.parked)

    def pending(self) -> List:
        """Queued + parked requests, admission order (priority then
        FIFO; parked retries last)."""
        return ([r for c in self.classes for r in self.queues[c.name]]
                + [r for _, r in self.parked])

    def requeue_front(self, req) -> None:
        """A preempted request resumes before its class peers."""
        self.queues[self.class_of(req).name].appendleft(req)

    def park(self, req, delay: int) -> None:
        """Stage a retrying request for ``delay`` scheduler ticks
        before it rejoins its class queue (bounded backoff)."""
        self._count("retried")
        self.parked.append((self._ticks + max(0, int(delay)), req))

    def _unpark(self) -> None:
        still = []
        for ready, req in self.parked:
            if ready <= self._ticks:
                # back of the class queue: a retry yields to peers that
                # have not failed, unlike a preempted request
                self.queues[self.class_of(req).name].append(req)
            else:
                still.append((ready, req))
        self.parked = still

    # ------------------------------------------------------ accounting
    def on_admitted(self, slot: int, shard: int, est: int,
                    est_state: int = 0) -> None:
        self.committed[shard] += est
        self.committed_state[shard] += est_state
        self.est_of[slot] = (shard, est, est_state)

    def on_released(self, slot: int) -> None:
        """Slot finished or was preempted: uncommit its worst case."""
        shard, est, est_state = self.est_of.pop(slot)
        self.committed[shard] -= est
        self.committed_state[shard] -= est_state

    def headroom(self, shard: int, pinned_on) -> int:
        return self.page_budget - self.committed[shard] - pinned_on(shard)

    def state_headroom(self, shard: int) -> int:
        """Fine-class admission headroom (no pinning in CLS_STATE —
        bounded state dies with its request)."""
        return self.state_budget - self.committed_state[shard]

    # ------------------------------------------------------------ tick
    def tick(self, engine) -> None:
        """One admission pass: shed pins above high water, then admit
        heads in priority order, evicting pins / preempting victims for
        a blocked head before deferring it (strict priority — a blocked
        head blocks lower classes; admitting around it would consume
        the very pages it is waiting for)."""
        self._ticks += 1
        self._unpark()
        self._expire_deadlines(engine)
        if self.dead_shards:
            self._shed_backlog(engine)
        self._shed_high_water(engine)
        preempted = 0
        while True:
            head = self._head()
            if head is None:
                return
            cls, req = head
            est = engine.est_pages(req)
            est_state = engine.est_state_blocks(req)
            match, shard, blocked = self._place(engine, req, est,
                                                est_state)
            if blocked is None:
                self.queues[cls.name].popleft()
                slot = engine.admit(req, match, shard)
                req._seq = next(self._seq)
                self.on_admitted(slot, slot // engine.bl, est, est_state)
                continue
            if blocked == "pages" and self._evict_pins_for(engine, est):
                continue
            if (self.config.preemption
                    and preempted < self.config.max_preemptions_per_tick):
                victim = self._pick_victim(engine, cls.priority)
                if victim is not None:
                    vreq = engine.preempt(victim)
                    self.requeue_front(vreq)
                    preempted += 1
                    continue
            self._count("deferred")
            self._count(f"defer_{blocked}")
            return

    def _head(self):
        for cls in self.classes:
            if self.queues[cls.name]:
                return cls, self.queues[cls.name][0]
        return None

    # ------------------------------------------------------- hardening
    def _reject(self, engine, req, reason: str) -> None:
        req.rejected = reason
        self._count("rejected")
        engine._jrec("reject", rid=req.rid, reason=reason)
        engine._trace_terminal(req, reason)

    def _expire_deadlines(self, engine) -> None:
        """Fail every request past its absolute deadline — queued,
        parked, or running.  ``deadline_at`` is stamped at first submit
        and survives preemption/recovery, so a request cannot reset its
        own clock by failing (DESIGN.md §11)."""
        now = engine._clock()

        def expired(r):
            return 0.0 < getattr(r, "deadline_at", 0.0) < now

        for q in self.queues.values():
            for r in [r for r in q if expired(r)]:
                q.remove(r)
                engine.telemetry.inc("deadline_expired")
                self._reject(engine, r, "deadline")
        still = []
        for ready, r in self.parked:
            if expired(r):
                engine.telemetry.inc("deadline_expired")
                self._reject(engine, r, "deadline")
            else:
                still.append((ready, r))
        self.parked = still
        for slot in [s for s, r in engine.active.items() if expired(r)]:
            engine.fail_active(slot, "deadline")

    def lose_shard(self, shard: int) -> None:
        """Remove a shard from the placement set (engine.lose_shard
        owns the evacuation mechanics)."""
        self.dead_shards.add(shard)

    def _shed_backlog(self, engine) -> None:
        """Degraded-capacity load shedding: when the queued backlog's
        worst-case pages exceed the surviving shards' budget
        (``plan_serving_for``), drop from the lowest class's tail with
        the typed reason ``"shed"`` rather than queue unservable work."""
        from ..runtime.elastic import plan_serving_for
        backlog_pages = sum(engine.est_pages(r) for r in self.pending())
        plan = plan_serving_for(self.n_shards, self.dead_shards,
                                self.page_budget, backlog_pages)
        to_shed = plan.shed_pages
        for cls in reversed(self.classes):          # lowest class first
            q = self.queues[cls.name]
            while to_shed > 0 and q:
                victim = q.pop()                    # tail: newest work
                to_shed -= engine.est_pages(victim)
                victim.rejected = "shed"
                self._count("shed")
                engine._jrec("reject", rid=victim.rid, reason="shed")
                engine._trace_terminal(victim, "shed")
            if to_shed <= 0:
                break

    # ------------------------------------------------- lane-width policy
    def buckets(self, full_chunk: int) -> Tuple[int, ...]:
        """The static compile set: configured buckets clipped to the
        engine's full chunk, plus the full chunk itself (ascending)."""
        bs = {b for b in self.config.chunk_buckets
              if 1 <= b <= full_chunk}
        bs.add(int(full_chunk))
        return tuple(sorted(bs))

    def pick_chunk(self, engine, full_chunk: int) -> int:
        """Prefill lane width for this step (DESIGN.md §10).

        The engine dispatches exactly one step shape per step, so a
        long prefill chunk holds every decode lane in the batch hostage
        for its whole wall-clock — the prefill/decode interference the
        ROADMAP item names.  Policy: when work of the top latency class
        is *waiting* on strictly-lower-priority prefill — queued for a
        slot, or already decoding in a batch whose prompt feeds belong
        to lower classes — shrink to the smallest bucket; otherwise run
        the full chunk.  Width never affects output tokens (chunking is
        token-invariant), only step latency, so the policy is free to
        flip per step; each bucket is one compiled variant, chosen from
        the static :meth:`buckets` set.
        """
        bs = self.buckets(full_chunk)
        if len(bs) == 1:
            return bs[-1]
        top = self.classes[0]
        waiting = bool(self.queues[top.name])
        decoding_top = prefill_lower = False
        for slot, req in engine.active.items():
            cls = self.class_of(req)
            if engine.pending_tokens.get(slot):
                if cls.priority < top.priority:
                    prefill_lower = True
            elif cls.priority >= top.priority:
                decoding_top = True
        if (waiting or decoding_top) and prefill_lower:
            return bs[0]
        return bs[-1]

    def _place(self, engine, req, est, est_state: int = 0):
        """(match, shard, blocked): a shard-local prefix match, an
        admissible shard holding a free slot, or why not.

        Cross-host placement policy (DESIGN.md §9): page ids never
        alias across shards, so the trie is queried PER admissible
        shard and the request lands where its longest shard-local
        donor lives — a donor on an inadmissible (or foreign) shard is
        worthless even on an exact key match, and the returned match is
        always on the returned shard by construction.  With no donor
        anywhere, the shard with the most committed/pinned headroom
        takes the request (spread the worst case across hosts)."""
        slots = engine.free_slot_shards()
        if not slots:
            return None, None, "slots"
        pinned = engine.pinned_pages_on
        fits = [s for s in sorted(slots)
                if s not in self.dead_shards
                and est <= self.headroom(s, pinned)
                and (est_state <= 0
                     or est_state <= self.state_headroom(s))]
        if not fits:
            return None, None, "pages"
        # load-aware expert admission (DESIGN.md §15): the cost of a
        # request's expert footprint is per-shard — 0 where the experts
        # are hot (resident), EXPERT_PPE pages per cold (pos, group,
        # expert) slot — and headroom counts LRU-evictable cold experts
        # as reclaimable.  Skew in the footprint mix is therefore what
        # the scheduler learns: hot-expert traffic admits freely while
        # cold fan-outs wait for (or migrate to) a shard with paging
        # room, keeping every bulk load inside the class budget §4.2
        # is provisioned for.
        est_exp = getattr(engine, "est_expert_pages", None)
        if est_exp is not None:
            fits = [s for s in fits
                    if est_exp(req, s) <= engine.expert_headroom(s)]
            if not fits:
                return None, None, "experts"
        best = None                       # (n_tokens, shard, match)
        for s in fits:
            m = engine.prefix_match(req, shard=s)
            if m is not None and (best is None or m.n_tokens > best[0]):
                best = (m.n_tokens, s, m)
        if best is not None:
            return best[2], best[1], None
        # most headroom first: spread the worst case
        shard = max(fits, key=lambda s: self.headroom(s, pinned))
        return None, shard, None

    # ------------------------------------------------------ preemption
    def _pick_victim(self, engine, admit_priority: int) -> Optional[int]:
        """Lowest-priority, most-recently-admitted active slot strictly
        below the admitting priority (least progress lost), from a
        preemptible class."""
        cands = []
        for slot, vreq in engine.active.items():
            vcls = self.class_of(vreq)
            if vcls.priority < admit_priority and vcls.preemptible:
                cands.append((vcls.priority, -getattr(vreq, "_seq", 0),
                              slot))
        if not cands:
            return None
        return min(cands)[2]

    # ------------------------------------------------------ pin policy
    def _evict_pins_for(self, engine, est: int) -> bool:
        """Evict LRU pins until some free-slot shard can commit ``est``
        more worst-case pages.  Returns True on success."""
        if engine.pins is None:
            return False
        progressed = False
        for shard in sorted(engine.free_slot_shards()):
            while (self.headroom(shard, engine.pinned_pages_on) < est
                   and engine.pins.pages_on(shard) > 0):
                pin_id = engine.pins.lru(shard)
                engine.evict_pin(pin_id)
                self._count("pins_evicted")
                progressed = True
            if self.headroom(shard, engine.pinned_pages_on) >= est:
                return True
        return progressed and any(
            self.headroom(s, engine.pinned_pages_on) >= est
            for s in engine.free_slot_shards())

    def _shed_high_water(self, engine) -> None:
        """Pool-pressure eviction: the per-step status row carries each
        shard's pages-in-use; above ``high_water`` occupancy the cache
        gives pages back before they are forced out."""
        if engine.pins is None:
            return
        hw = self.config.high_water * engine.pages_local
        for shard in range(self.n_shards):
            while (engine.pages_used_shard[shard] > hw
                   and engine.pins.pages_on(shard) > 0):
                pin_id = engine.pins.lru(shard)
                pages = engine.pins.entries[pin_id]["pages"]
                engine.evict_pin(pin_id)
                self._count("pins_evicted")
                # the status row is one step stale — account the evicted
                # pages here so the loop terminates without a sync
                engine.pages_used_shard[shard] -= pages

    def may_pin(self, engine, shard: int, pages: int) -> bool:
        """Pin admission control: respect the pin budget (evicting LRU
        to make room) and never let pins squeeze committed work."""
        if engine.pins is None or pages <= 0:
            return False
        if pages > engine.pins.budget:
            return False
        while not engine.pins.fits(shard, pages):
            pin_id = engine.pins.lru(shard)
            if pin_id is None:
                return False
            engine.evict_pin(pin_id)
            self._count("pins_evicted")
        if not engine.pins.has_free_row(shard):
            pin_id = engine.pins.lru(shard)
            if pin_id is None:
                return False
            engine.evict_pin(pin_id)
            self._count("pins_evicted")
        return (self.committed[shard] + engine.pinned_pages_on(shard)
                + pages <= self.page_budget)
