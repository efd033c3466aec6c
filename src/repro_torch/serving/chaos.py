"""Fault injection and crash recovery for the serving plane.

Counterpart of the JAX package's ``serving/chaos.py``.  The paper's
allocator is built so that a process can die anywhere -- mid-allocate,
mid-free, even mid-rebalance -- and the pool stays sound.  This module
makes the serving engine honor the same contract at host granularity:

* :class:`ServingFailureInjector` deterministically injects host
  crashes, shard loss, step stragglers, generic step errors, and
  poisoned requests at named ``engine.step()`` phase boundaries
  (:data:`PHASES`), including a *torn* crash that lands inside the
  rebalance's drain/refill window;
* :class:`ServingJournal` is the host-side admission/completion log —
  the only host state recovery trusts.  Everything else is rebuilt from
  the device-resident arrays (kv pages, pin rows, pool refcounts);
* :func:`recover_engine` performs the recovery: reconcile the pool via
  :func:`classed_pool.audit_and_reconcile` (host-side, the rebuilt pool
  back on the engine's device), restore journaled pins with
  their KV content, and requeue every in-flight request through the
  existing preemption-resume path.  Because the sampler keys its noise
  by ``fold_in(seed, out_count)``, replay regenerates exactly the
  tokens the crash lost — recovery is token-identical for greedy and
  sampled decode alike.

Under a DP group (one rank per shard, ``launch/mesh.py``) every rank
holds the same schedule and runs the same host control, so each fault
fires on every rank at the same (step, phase): a crash on every rank
(:func:`recover_engine` then runs on every rank, each adopting its own
shard), an ``error`` recovered in place on every rank, a shard's loss
retired by every rank while the lost shard's rank stays in the group.
A schedule that not every rank holds fails only its own rank; the
engine tells the others through its status gather
(:class:`RankFailure`).
"""

from __future__ import annotations

import dataclasses
import json
import time
import zlib
from typing import Any, Dict, IO, List, Optional, Tuple

import numpy as np
import torch

from ..core import NULL, classed_pool

#: ``engine.step()`` phase boundaries, in execution order.  ``pre_tick``
#: and ``post_admission`` fire every step; the rest only when the step
#: dispatches work.  ``feed`` fires BEFORE any per-slot feed mutation,
#: so a fault there leaves host and device consistent; ``post_sync``
#: fires after the device round-trip but BEFORE bookkeeping/journaling —
#: a crash there loses the step's tokens and replay must regenerate
#: them.
PHASES = ("pre_tick", "post_admission", "feed", "dispatched",
          "post_sync", "post_step")


class HostCrash(RuntimeError):
    """The serving host died: all host state is lost; the device-resident
    tensors and the journal survive.  Recover with :func:`recover_engine`."""


class StepError(RuntimeError):
    """A step failed without killing the host (a software bug, a transient
    device error).  ``ServingEngine.run`` recovers in place."""


class RankFailure(RuntimeError):
    """A rank of a DP group failed after a status gather (or in a step
    that gathered nothing), or in its recovery (in place, or a crash's
    rebuild), when the ranks' host state may already differ: no in-place
    recovery is tried.  Raised on every rank at the group's next gather,
    naming the failing rank, where it failed and the serve step."""


class PoisonedRequest(RuntimeError):
    """A specific request deterministically fails the step that feeds it."""

    def __init__(self, rid: int, slot: int):
        super().__init__(f"poisoned request rid={rid} (slot {slot})")
        self.rid = rid
        self.slot = slot


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    ``step`` is a floor, not an exact match: the fault fires at the
    first step >= ``step`` whose execution reaches ``phase`` (idle steps
    never reach the dispatch phases).  ``poison`` faults instead fire at
    the first reached ``feed`` whose batch contains ``rid``.
    """

    step: int
    phase: str
    kind: str                    # crash | shard_loss | straggler | poison | error
    shard: int = 0               # shard_loss: which shard dies
    rid: Optional[int] = None    # poison: which request
    delay: float = 0.0           # straggler: injected seconds
    torn: bool = False           # crash: plant a torn mid-rebalance pool first
    fired: bool = False

    def __post_init__(self):
        assert self.phase in PHASES, f"unknown phase {self.phase!r}"
        assert self.kind in ("crash", "shard_loss", "straggler", "poison",
                             "error"), f"unknown fault kind {self.kind!r}"


class ServingFailureInjector:
    """Deterministic fault schedule keyed on (step, phase).

    The engine calls :meth:`fire` at every phase boundary; the injector
    counts steps itself (``pre_tick`` opens a new step) so the schedule
    survives engine recovery — the recovered engine keeps the same
    injector object and later faults still fire.
    """

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self.step = -1
        self.log: List[Tuple[int, str, str]] = []

    def pending(self) -> int:
        return sum(1 for f in self.faults if not f.fired)

    def digest(self) -> int:
        """A 31-bit checksum of the schedule as given (not of its firing
        state): the ranks of a DP group compare theirs to learn whether
        every rank holds the same schedule."""
        sched = [(f.step, f.phase, f.kind, f.shard, f.rid, f.delay, f.torn)
                 for f in self.faults]
        return zlib.crc32(json.dumps(sched).encode()) & 0x7FFFFFFF

    def fire(self, engine: Any, phase: str,
             rids: Optional[Dict[int, int]] = None,
             alone: bool = False) -> None:
        """Fire the faults due at ``phase``.  ``alone``: the schedule is
        this rank's alone, so a shard's loss, which only the whole
        group can decide, is raised as this rank's :class:`StepError`."""
        if phase == "pre_tick":
            self.step += 1
        for f in self.faults:
            if f.fired or f.phase != phase:
                continue
            if f.kind == "poison":
                if rids and f.rid in rids and self.step >= f.step:
                    f.fired = True
                    self.log.append((self.step, phase, "poison"))
                    raise PoisonedRequest(f.rid, rids[f.rid])
                continue
            if self.step < f.step:
                continue
            f.fired = True
            self.log.append((self.step, phase, f.kind))
            if f.kind == "straggler":
                time.sleep(f.delay)
            elif f.kind == "shard_loss":
                if alone:
                    raise StepError(
                        f"shard_loss of shard {f.shard} scheduled on one "
                        f"rank only @ step {self.step}:{phase}")
                engine.lose_shard(f.shard)
            elif f.kind == "error":
                raise StepError(
                    f"injected step error @ step {self.step}:{phase}")
            elif f.kind == "crash":
                if f.torn:
                    # leave the pool mid-rebalance: drain ran, refill
                    # did not — the torn window reconcile must handle
                    engine.state = engine.state._replace(
                        pool=classed_pool.rebalance_drain_dp(engine.state.pool))
                raise HostCrash(
                    f"injected host crash @ step {self.step}:{phase}"
                    + (" (torn rebalance)" if f.torn else ""))


def parse_faults(spec: str) -> ServingFailureInjector:
    """Parse a CLI fault schedule: ``kind@step:phase[:extra],...``

    ``extra`` is the shard for ``shard_loss``, the rid for ``poison``,
    the seconds for ``straggler``, and the literal ``torn`` for a
    mid-rebalance ``crash``.  Example::

        crash@3:post_sync,shard_loss@5:post_admission:1,
        straggler@2:pre_tick:0.05,poison@1:feed:7,crash@9:dispatched:torn
    """
    faults = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, rest = part.split("@", 1)
        pieces = rest.split(":")
        step, phase = int(pieces[0]), pieces[1]
        extra = pieces[2] if len(pieces) > 2 else None
        f = Fault(step=step, phase=phase, kind=kind)
        if kind == "shard_loss":
            f.shard = int(extra or 0)
        elif kind == "poison":
            assert extra is not None, "poison needs a rid"
            f.rid = int(extra)
        elif kind == "straggler":
            f.delay = float(extra or 0.05)
        elif kind == "crash":
            f.torn = extra == "torn"
        faults.append(f)
    return ServingFailureInjector(faults)


# ------------------------------------------------------------------ journal


class ServingJournal:
    """Host-side admission/completion log — recovery's source of truth.

    The engine appends one event per state transition it performs
    *after* the corresponding device work completed (write-ahead for
    admission, write-behind for emission), so after a crash:

    * a journaled pin whose device row survived keeps its pages;
      a device pin the journal never saw is reclaimed (the crash landed
      between the device op and the journal write — the pages would
      otherwise leak);
    * an in-flight request replays from its journaled token prefix; the
      tokens of a step whose ``post_sync`` bookkeeping never ran are
      regenerated deterministically by the ``fold_in(seed, out_count)``
      sampler keying.

    With ``path`` set, events are additionally appended to a JSONL file
    (``load`` replays it), modeling a durable log.  Under a DP group
    every rank records the same events in its own journal, and only rank
    0's is given a ``path``.
    """

    def __init__(self, path: Optional[str] = None):
        self.events: List[dict] = []
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "a") if path else None

    def record(self, kind: str, **fields: Any) -> None:
        ev = {"kind": kind, **fields}
        self.events.append(ev)
        if self._fh is not None:
            self._fh.write(json.dumps(ev, default=int) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @classmethod
    def load(cls, path: str) -> "ServingJournal":
        j = cls()
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    j.events.append(json.loads(line))
        return j

    # --------------------------------------------------------- replays
    def in_flight(self) -> List[dict]:
        """Submitted-but-unfinished request specs, in submit order, with
        the accumulated journaled token stream."""
        flight: Dict[int, dict] = {}
        order: List[int] = []
        for ev in self.events:
            k = ev["kind"]
            if k == "submit":
                rid = ev["rid"]
                spec = dict(ev)
                spec["out_tokens"] = list(ev.get("out_tokens", []))
                flight[rid] = spec
                if rid not in order:
                    order.append(rid)
            elif k == "tokens" and ev["rid"] in flight:
                flight[ev["rid"]]["out_tokens"].extend(ev["toks"])
            elif k in ("finish", "reject"):
                flight.pop(ev["rid"], None)
        return [flight[r] for r in order if r in flight]

    def outputs(self) -> Dict[int, List[int]]:
        """Latest known emitted stream per rid (finished or not)."""
        outs: Dict[int, List[int]] = {}
        for ev in self.events:
            if ev["kind"] == "submit":
                outs[ev["rid"]] = list(ev.get("out_tokens", []))
            elif ev["kind"] == "tokens" and ev["rid"] in outs:
                outs[ev["rid"]].extend(ev["toks"])
        return outs

    def finished(self) -> set:
        return {ev["rid"] for ev in self.events if ev["kind"] == "finish"}

    def digest(self) -> int:
        """A 31-bit checksum of the events: the ranks of a DP group
        compare theirs at recovery."""
        return zlib.crc32(json.dumps(self.events, default=int).encode()
                          ) & 0x7FFFFFFF

    def live_pins(self) -> List[dict]:
        """Pin entries still live at the end of the log (pins on lost
        shards are dropped — their pages died with the shard)."""
        pins: Dict[int, dict] = {}
        for ev in self.events:
            if ev["kind"] == "pin":
                pins[ev["pin_id"]] = dict(ev)
            elif ev["kind"] == "unpin":
                pins.pop(ev["pin_id"], None)
            elif ev["kind"] == "shard_lost":
                pins = {p: e for p, e in pins.items()
                        if e["shard"] != ev["shard"]}
        return list(pins.values())

    def lost_shards(self) -> set:
        return {ev["shard"] for ev in self.events
                if ev["kind"] == "shard_lost"}


# ----------------------------------------------------------------- recovery


def recover_engine(factory, crashed, journal: ServingJournal):
    """Rebuild a serving engine after a :class:`HostCrash`.

    ``factory`` constructs a fresh engine with the same topology
    (normally closing over the same journal and injector, so the
    recovered engine keeps journaling and later scheduled faults still
    fire).  ``crashed`` is the dead engine: its host state is
    untrusted, but its device-resident tensors (DecodeState, pin tables)
    survive and are the ground truth together with the journal.

    Under a DP group every rank calls it at the same point: the ranks'
    journals are compared first (one gather of their digests, outside
    any serve step; a difference raises on every rank), the factory
    builds over the same group, and each rank adopts its own crashed
    shard against its own pin row.  A rank whose rebuild raises before
    its engine's construction gather tells the others at that gather
    (:func:`~.engine.tell_rebuild_failure`); one whose adoption raises
    holds the failure and goes on in step.  Either way every rank raises
    :class:`RankFailure` at the group's next gather.

    Returns ``(engine, report)`` where ``report`` extends the
    :func:`classed_pool.audit_and_reconcile` report (of this rank's
    shard under a group) with ``requeued``, ``pins_restored``,
    ``finished_at_crash`` and the requeued ``requests`` (for
    token-identity checks).
    """
    from .engine import FAIL_REBUILD, Request, tell_rebuild_failure

    mesh = getattr(crashed, "mesh", None)
    if mesh is not None:
        mine = torch.tensor([journal.digest(), len(journal.events)],
                            dtype=torch.int64)
        got = mesh.gather(mine).reshape(mesh.size, 2).tolist()
        if any(g != got[0] for g in got):
            raise RuntimeError(
                f"recover_engine: the ranks' journals differ (digest, "
                f"events by rank: {got}): the shards cannot recover alike")
    try:
        eng = factory()
    except RankFailure:
        raise                       # another rank's failure, told here
    except Exception as e:
        if mesh is None:
            raise
        tell_rebuild_failure(mesh, crashed.bl, crashed.stats["steps"], e)
    assert eng.dp == crashed.dp and eng.bl == crashed.bl, \
        "recovery requires an identical topology"

    # observability survives the crash: the dead engine's flight ring
    # and trace buffer carry into the recovered engine, so the pre-crash
    # window stays in the next dump and spans opened before the crash
    # close correctly after it
    eng.flight.adopt(crashed.flight)
    eng.telemetry.tracer = eng.tracer = crashed.telemetry.tracer
    eng.tracer.begin("recover", kind="host_crash")

    # journal-trusted pin rows: mask the device pin tables (this rank's
    # row under a group) down to rows the journal confirms; everything
    # else is reclaimed by reconcile
    pins_live = journal.live_pins() if eng.pins is not None else []
    pin_np = None
    if crashed.pin_tables is not None:
        pin_np = crashed.pin_tables.cpu().numpy().copy()
        ok = np.zeros(pin_np.shape[:2], bool)
        for e in pins_live:
            r = eng._own(e["shard"])
            if r is not None:
                ok[r, e["row"]] = True
        pin_np[~ok] = NULL

    try:
        report = eng.adopt_crashed_state(crashed.state, pin_np)
        if eng.pins is not None and pins_live:
            eng.pins.load_state(pins_live)
            if eng.prefix_cache is not None:
                for pid, e in eng.pins.entries.items():
                    eng.prefix_cache.pin_insert(pid, e["shard"],
                                                list(e["tokens"]))
    except Exception as e:
        if mesh is None:
            raise
        # told at the next gather, which this rank still joins
        eng._hold(e, FAIL_REBUILD, crashed.stats["steps"])
        report = {}

    for s in sorted(journal.lost_shards()):
        eng.lose_shard(s)            # fresh engine: just retires the shard

    # requeue every journaled in-flight request through the admission
    # path — the preemption-resume contract (out_count = len(out_tokens)
    # keys both the budget check and the sampler stream) makes replay
    # token-identical
    requeued: List[Request] = []
    finished_now = 0
    for spec in journal.in_flight():
        req = Request(rid=spec["rid"], prompt=list(spec["prompt"]),
                      max_new_tokens=int(spec["max_new_tokens"]),
                      temperature=float(spec.get("temperature", 0.0)),
                      top_k=int(spec.get("top_k", 0)),
                      seed=int(spec.get("seed", 0)),
                      slo=spec.get("slo", "standard"),
                      out_tokens=list(spec["out_tokens"]))
        req.preemptions = int(spec.get("preemptions", 0)) + 1
        req.deadline_at = float(spec.get("deadline_at", 0.0))
        if (len(req.out_tokens) >= req.max_new_tokens
                or (eng.eos_id is not None and req.out_tokens
                    and req.out_tokens[-1] == eng.eos_id)):
            # finished on device; only the journal's finish record was
            # lost in the crash — close it out instead of replaying
            req.done = True
            journal.record("finish", rid=req.rid)
            finished_now += 1
            continue
        eng.submit(req)
        requeued.append(req)

    report["requeued"] = len(requeued)
    report["finished_at_crash"] = finished_now
    report["pins_restored"] = len(pins_live)
    report["requests"] = requeued
    # the reconcile report through the tracer (pages rebuilt, refcount
    # deltas, journal replay length), then one flight dump that records
    # the recovery next to the pre-crash window
    eng.tracer.instant(
        "reconcile", kind="host_crash",
        reclaimed=int(report.get("reclaimed", 0)),
        resurrected=int(report.get("resurrected", 0)),
        never_dry=bool(report.get("never_dry", True)),
        conserved=bool(report.get("conserved", True)),
        requeued=len(requeued), finished_at_crash=finished_now,
        pins_restored=len(pins_live),
        journal_events=len(journal.events))
    eng.tracer.end("recover")
    if eng.flight.dump("recover_engine", {
            "report": {k: v for k, v in report.items()
                       if k != "requests"},
            "journal_events": len(journal.events)}):
        eng.telemetry.inc("flight_dumps")
    return eng, report
