"""One-sync observability plane: typed counters, device counter block,
Prometheus exposition, and the crash flight recorder (DESIGN.md §13).

The paper's guarantees are quantitative — O(1) worst-case per op and
the §4.2 never-dry invariant ``min(private_top) >= ell`` — so the
serving plane treats the *margin* on those invariants as first-class
observable state, the way production allocators expose occupancy and
fragmentation.  Three pieces:

* :class:`Telemetry` — the single facade every host-side subsystem
  (engine, scheduler, prefix cache, chaos/recovery) emits through.
  Scalar counters live in a typed schema (:data:`COUNTER_SCHEMA`;
  unknown names raise), histograms in :data:`HIST_SCHEMA`, and the
  per-shard device counters in numpy accumulators.  ``counters`` is a
  plain dict so ``engine.stats`` can remain a live, backward-compatible
  view of it.

* the **device counter block** — a small int32 ``[N_CTR, DP]`` block
  computed *inside* the jitted serve step from allocator state the
  step already holds (pool free levels before/after the forward pass,
  the rollback mask, the drain/refill deltas, the post-rebalance lane
  floors) and harvested by widening the packed status rows the host
  already syncs on.  Zero extra transfers, zero extra collectives: the
  block rides the same status all_gather (DESIGN.md §13 zero-sync
  argument).  :meth:`Telemetry.absorb_counter_block` accumulates it
  host-side after the step's one ``np.asarray``.

* :class:`FlightRecorder` — a bounded ring of the last N step records
  (status rows, counter block, gate decisions, watchdog verdicts) that
  dumps to disk on crash / watchdog timeout / ``audit_and_reconcile``,
  giving the §11 recovery path a forensic artifact.  Dumps are atomic
  (temp + rename) and optionally periodic, so even a SIGKILLed process
  leaves a readable record behind.
"""

from __future__ import annotations

import json
import os
import signal
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

# --------------------------------------------------- device counter block
#
# Row layout of the int32[N_CTR, DP] block the jitted serve step appends
# to the packed status (after the T token rows and the emitted/done/
# pages bookkeeping rows).  Each row holds one per-shard value,
# broadcast over the Bl axis exactly like the PAGES row, so the block
# crosses shards inside the step's single status all_gather.
#
# Counters (host sums across steps):
CTR_ALLOC = 0        # pages granted by this step's forward pass
CTR_FREED = 1        # pages returned free this step (release + rollback)
CTR_ROLLBACK = 2     # spec whole-page rollback (subset of CTR_FREED)
CTR_DRAIN = 3        # pages drained lane -> shared by this rebalance
CTR_REFILL = 4       # pages refilled shared -> lane by this rebalance
CTR_SPILL = 5        # released pages that overflowed a full lane stack
#                      and landed on the SHARED stack (free_n_metered) —
#                      the row that makes the shared-free telescoping
#                      shared' - shared == drain - refill + spill EXACT
# Gauges (host min-accumulates across steps):
CTR_SHARED_FREE = 6  # shared free-stack size after the step (low-water)
CTR_MARGIN = 7       # §4.2 never-dry margin min(private_top) - ell
# Expert-paged MoE rows (DESIGN.md §15).  The rows exist in every
# class's block (the block stays class-major rectangular); the engine
# emits the page rows on the expert class (`_c2` keys) and the drop row
# on class 0 (unsuffixed key) so non-paged MoE engines meter drops too:
CTR_EHIT = 8         # expert pages routed-to AND resident this step
CTR_EMISS = 9        # expert pages routed-to but NOT resident — the
#                      admission contract makes this an invariant 0;
#                      any nonzero is a residency bug detector
CTR_EPREF = 10       # expert pages prefetched one layer ahead
CTR_EDROP = 11       # MoE capacity-overflow dropped valid token slots
N_CTR = 12

#: counter-block row names, index-aligned with the CTR_* constants
CTR_NAMES = ("alloc_pages", "freed_pages", "spec_rollback_pages",
             "rebalance_drain_pages", "rebalance_refill_pages",
             "spill_pages", "shared_free", "never_dry_margin",
             "expert_hit_pages", "expert_miss_pages",
             "expert_prefetch_pages", "moe_dropped_tokens")
#: which rows accumulate by summation (the rest are min-gauges)
CTR_SUM_ROWS = (CTR_ALLOC, CTR_FREED, CTR_ROLLBACK, CTR_DRAIN, CTR_REFILL,
                CTR_SPILL, CTR_EHIT, CTR_EMISS, CTR_EPREF, CTR_EDROP)
CTR_MIN_ROWS = (CTR_SHARED_FREE, CTR_MARGIN)


def ctr_key(row: int, cls: int = 0) -> str:
    """Accumulator key for counter-block row ``row`` of size class
    ``cls``.  Class 0 keeps the historical un-suffixed names (single-
    class snapshots stay bit-identical); class c >= 1 suffixes ``_c<c>``
    — the telemetry class axis of DESIGN.md §14."""
    name = CTR_NAMES[row]
    return name if cls == 0 else f"{name}_c{cls}"


# -------------------------------------------------------- counter schema
#
# Every scalar counter any subsystem may emit.  The engine's historical
# ``stats`` keys are all here (engine.stats is a live view of
# Telemetry.counters), plus the observability plane's own counters and
# the scheduler/prefix-cache mirrors.  `max`-kind counters keep a
# high-water instead of a running sum.

COUNTER_SCHEMA: Dict[str, str] = {
    # engine serving counters (pre-existing stats keys)
    "steps": "dispatched engine steps",
    "tokens_out": "generated tokens emitted",
    "admitted": "requests admitted to a slot",
    "prompt_tokens": "prompt tokens prefilled",
    "alloc_steps_max": "worst-case host allocator op steps (O(1) bound)",
    "prefix_shared_tokens": "prompt tokens mapped onto donor pages",
    "prefix_shared_reqs": "requests admitted with a shared prefix",
    "pages_peak": "peak pages-in-use across shards",
    "pages_sum": "sum of per-step pages-in-use (mean = /steps)",
    "idle_steps": "steps skipped on the idle fast-path",
    "preemptions": "requests preempted",
    "pins_created": "prefix pins created",
    "pin_hit_reqs": "admissions served from a pinned prefix",
    "pin_hit_tokens": "prompt tokens served from pinned pages",
    "spec_drafted": "speculative tokens drafted",
    "spec_accepted": "speculative tokens accepted",
    "spec_lanes": "draft+verify lanes dispatched",
    "spec_pages_rolled_back": "whole pages rolled back off rejected drafts",
    "spec_gate_skips": "draft proposals zeroed by the accept-rate gate",
    "spec_mixed_steps": "mixed prompt/decode steps carrying drafts",
    "stragglers": "steps classified straggler by the watchdog",
    "step_timeouts": "steps past the watchdog hard timeout",
    "recoveries": "in-place engine recoveries",
    "deadline_expired": "requests failed on an expired deadline",
    "failed": "requests terminally failed (typed reason)",
    "retries": "bounded-backoff retries granted",
    "shards_lost": "shards retired from service",
    # observability plane
    "cow_copies": "copy-on-write page copies at share admission",
    "flight_dumps": "flight-recorder dumps written",
    "trace_drops": "trace events dropped by the bounded buffer",
    # scheduler mirrors (AdmissionScheduler emits through the facade)
    "sched_deferred": "head-of-line admissions deferred",
    "sched_defer_slots": "deferrals blocked on a free slot",
    "sched_defer_pages": "deferrals blocked on the page budget",
    "sched_rejected": "submissions rejected with backpressure",
    "sched_retried": "parked retries re-queued",
    "sched_shed": "requests shed under degraded capacity",
    "sched_pins_evicted": "pins evicted by scheduler policy",
    # prefix-cache mirrors
    "trie_hits": "prefix-trie lookups that found a donor",
    "trie_misses": "prefix-trie lookups that found nothing",
    # size-classed allocation plane (DESIGN.md §14)
    "state_blocks_granted": "bounded-state blocks granted at admission",
    # expert-paged MoE serving (DESIGN.md §15)
    "expert_admit_hits": "footprint experts already resident at admission",
    "expert_admit_misses": "footprint experts loaded cold at admission",
    "expert_load_pages": "expert pages loaded into the pool (3/expert)",
    "expert_evictions": "experts evicted from the ledger LRU",
    "expert_evict_pages": "expert pages freed by ledger eviction",
    "expert_pages_resident_peak": "peak expert pages resident (ledger)",
    "sched_defer_experts": "deferrals blocked on the expert-page budget",
}

#: counters that keep a running max instead of a sum
MAX_COUNTERS = ("alloc_steps_max", "pages_peak",
                "expert_pages_resident_peak")

HIST_SCHEMA = ("chunk_hist", "accept_hist")


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


class Telemetry:
    """The one facade host subsystems emit through.

    ``counters`` is a plain dict (typed: :meth:`inc` validates names
    against :data:`COUNTER_SCHEMA`) — the engine exposes it verbatim as
    the backward-compatible ``engine.stats`` view, histograms included.
    Per-shard device counters accumulate in numpy from the counter
    block the jitted step appends to the status rows.
    """

    def __init__(self, dp: int = 1, tracer=None,
                 flight: Optional["FlightRecorder"] = None,
                 n_classes: int = 1):
        self.dp = int(dp)
        self.n_classes = int(n_classes)
        self.counters: Dict = {name: 0 for name in COUNTER_SCHEMA}
        for h in HIST_SCHEMA:
            self.counters[h] = {}
        # per-shard sums from the device counter block, one set of rows
        # per size class (class 0 keeps the historical key names)
        self.shard = {ctr_key(r, c): np.zeros(self.dp, np.int64)
                      for c in range(self.n_classes) for r in CTR_SUM_ROWS}
        # per-shard min-gauges (low-water marks); None until first step
        self.low: Dict[str, Optional[np.ndarray]] = {
            ctr_key(r, c): None
            for c in range(self.n_classes) for r in CTR_MIN_ROWS}
        self.last_block: Optional[np.ndarray] = None
        if tracer is None:
            from .trace import Tracer
            tracer = Tracer(enabled=False)
        self.tracer = tracer
        self.flight = flight

    # ------------------------------------------------------ typed emits
    def inc(self, name: str, n: int = 1) -> None:
        if name not in COUNTER_SCHEMA:
            raise KeyError(f"unknown telemetry counter {name!r}")
        self.counters[name] += n

    def set_max(self, name: str, v: int) -> None:
        if name not in COUNTER_SCHEMA:
            raise KeyError(f"unknown telemetry counter {name!r}")
        if v > self.counters[name]:
            self.counters[name] = v

    def observe_hist(self, name: str, key, n: int = 1) -> None:
        if name not in HIST_SCHEMA:
            raise KeyError(f"unknown telemetry histogram {name!r}")
        h = self.counters[name]
        h[key] = h.get(key, 0) + n

    # ------------------------------------------------ device counter block
    def absorb_counter_block(self, block) -> None:
        """Accumulate one step's int32[n_classes*N_CTR, DP] counter
        block (already host-side — sliced off the packed status after
        the step's one sync).  Rows are class-major: class c's N_CTR
        rows start at ``c * N_CTR``."""
        blk = np.asarray(block, np.int64)
        assert blk.shape == (self.n_classes * N_CTR, self.dp), blk.shape
        for c in range(self.n_classes):
            base = c * N_CTR
            for r in CTR_SUM_ROWS:
                self.shard[ctr_key(r, c)] += blk[base + r]
            for r in CTR_MIN_ROWS:
                name = ctr_key(r, c)
                cur = self.low[name]
                self.low[name] = (blk[base + r].copy() if cur is None
                                  else np.minimum(cur, blk[base + r]))
        self.last_block = blk

    def never_dry_margin_min(self, cls: Optional[int] = None
                             ) -> Optional[int]:
        """Worst §4.2 margin seen on any shard at any step (>= 0 means
        the never-dry invariant held with that much slack to spare).
        Default: min over ALL classes — the invariant is per class, so
        the worst class bounds the pool vector; pass ``cls`` for one."""
        classes = range(self.n_classes) if cls is None else (cls,)
        vals = [self.low[ctr_key(CTR_MARGIN, c)] for c in classes]
        vals = [v for v in vals if v is not None]
        return None if not vals else int(min(v.min() for v in vals))

    def shared_low_water(self, cls: int = 0) -> Optional[int]:
        m = self.low[ctr_key(CTR_SHARED_FREE, cls)]
        return None if m is None else int(m.min())

    def expert_hit_rate(self) -> Optional[float]:
        """Admission-time expert residency hit rate (None before any
        MoE admission).  Derived from the host admission counters, not
        the in-step CTR_EMISS row — that row is an invariant detector
        (residency is guaranteed by admission, so it must stay 0)."""
        h = self.counters["expert_admit_hits"]
        m = self.counters["expert_admit_misses"]
        return None if h + m == 0 else h / (h + m)

    # ------------------------------------------------------------ exports
    def snapshot(self) -> dict:
        """JSON-ready snapshot: scalar counters, histograms, per-shard
        device-counter sums, and the invariant low-water gauges.  What
        the benches embed in BENCH_serving.json."""
        scalars = {k: v for k, v in self.counters.items()
                   if k not in HIST_SCHEMA}
        hists = {k: {str(b): c for b, c in sorted(self.counters[k].items())}
                 for k in HIST_SCHEMA}
        return {
            "counters": scalars,
            "hists": hists,
            "per_shard": {k: v.tolist() for k, v in self.shard.items()},
            "low_water": {k: (None if v is None else v.tolist())
                          for k, v in self.low.items()},
            "never_dry_margin_min": self.never_dry_margin_min(),
            "shared_free_low_water": self.shared_low_water(),
            "expert_hit_rate": self.expert_hit_rate(),
        }

    def render_prom(self, prefix: str = "repro") -> str:
        """Prometheus text exposition (one scrape-shaped snapshot)."""
        lines = []

        def emit(name, help_, kind, samples):
            lines.append(f"# HELP {prefix}_{name} {help_}")
            lines.append(f"# TYPE {prefix}_{name} {kind}")
            for labels, val in samples:
                lab = ("{" + ",".join(f'{k}="{v}"' for k, v in labels)
                       + "}") if labels else ""
                lines.append(f"{prefix}_{name}{lab} {val}")

        for name, help_ in COUNTER_SCHEMA.items():
            kind = "gauge" if name in MAX_COUNTERS else "counter"
            emit(name, help_, kind, [((), self.counters[name])])
        for h in HIST_SCHEMA:
            emit(h, f"{h} buckets", "counter",
                 [((("bucket", b),), c)
                  for b, c in sorted(self.counters[h].items())])
        for c in range(self.n_classes):
            for r in CTR_SUM_ROWS:
                name = ctr_key(r, c)
                emit(name, f"device counter block: {name}", "counter",
                     [((("shard", s),), int(v))
                      for s, v in enumerate(self.shard[name])])
            for r in CTR_MIN_ROWS:
                name = ctr_key(r, c) + "_min"
                vals = self.low[ctr_key(r, c)]
                if vals is not None:
                    emit(name, f"low-water gauge: {name}", "gauge",
                         [((("shard", s),), int(v))
                          for s, v in enumerate(vals)])
        m = self.never_dry_margin_min()
        if m is not None:
            emit("never_dry_margin_min_all", "worst §4.2 margin, any "
                 "shard any step", "gauge", [((), m)])
        r = self.expert_hit_rate()
        if r is not None:
            emit("expert_hit_rate", "fraction of footprint experts "
                 "already resident at admission", "gauge",
                 [((), round(r, 6))])
        return "\n".join(lines) + "\n"


def parse_prom(text: str) -> Dict[str, Dict[tuple, float]]:
    """Minimal Prometheus text-format parser (the CI smoke check and
    the tests round-trip :meth:`Telemetry.render_prom` through it).
    Returns {metric: {labels_tuple: value}}."""
    out: Dict[str, Dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, val = line.rsplit(" ", 1)
        if "{" in body:
            name, rest = body.split("{", 1)
            assert rest.endswith("}"), f"malformed sample: {line!r}"
            labels = []
            for pair in filter(None, rest[:-1].split(",")):
                k, v = pair.split("=", 1)
                assert v.startswith('"') and v.endswith('"'), line
                labels.append((k, v[1:-1]))
            key = tuple(labels)
        else:
            name, key = body, ()
        out.setdefault(name, {})[key] = float(val)
    return out


# --------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded ring of the last ``capacity`` step records, dumped to
    disk when something goes wrong.

    Each record is whatever the engine hands :meth:`record` — by
    convention the packed status rows, the counter block, the step's
    gate decisions, and the watchdog verdict.  ``dump`` writes the ring
    atomically (temp + rename, the checkpointer's discipline) with a
    typed reason; with ``sync_every`` set the recorder also dumps
    periodically, so a force-killed process (SIGKILL — no handler runs)
    still leaves its most recent window on disk.
    """

    def __init__(self, capacity: int = 64, path: Optional[str] = None,
                 sync_every: int = 0):
        self.capacity = int(capacity)
        self.ring: deque = deque(maxlen=self.capacity)
        self.path = path
        self.sync_every = int(sync_every)
        self.dumps = 0
        self._since_sync = 0
        self.meta: dict = {}

    def record(self, **rec) -> None:
        self.ring.append(rec)
        if self.sync_every and self.path:
            self._since_sync += 1
            if self._since_sync >= self.sync_every:
                self.dump("periodic")

    def adopt(self, other: "FlightRecorder") -> None:
        """Carry a crashed engine's ring (and path) into the recovered
        engine — the forensic window survives the recovery."""
        for rec in other.ring:
            self.ring.append(rec)
        if self.path is None:
            self.path = other.path
        if self.sync_every == 0:
            self.sync_every = other.sync_every

    def dump(self, reason: str, extra: Optional[dict] = None,
             path: Optional[str] = None) -> Optional[str]:
        p = path or self.path
        if p is None:
            return None
        payload = {
            "reason": reason,
            "dumped_at": time.time(),
            "n_records": len(self.ring),
            "meta": _jsonable(self.meta),
            "extra": _jsonable(extra) if extra is not None else None,
            "records": [_jsonable(r) for r in self.ring],
        }
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, p)          # atomic: readers never see a torn file
        self.dumps += 1
        self._since_sync = 0
        return p

    @staticmethod
    def load(path: str) -> dict:
        with open(path) as fh:
            return json.load(fh)


def install_signal_dump(flight: FlightRecorder,
                        signals=(signal.SIGTERM,)) -> None:
    """Dump the flight ring on SIGTERM before dying — ``timeout``-style
    supervisors send TERM first, so an orderly force-kill still yields
    a forensic record (SIGKILL is covered by ``sync_every`` instead)."""
    def _handler(signum, frame):
        flight.dump(f"signal_{signum}")
        raise SystemExit(128 + signum)
    for s in signals:
        signal.signal(s, _handler)
