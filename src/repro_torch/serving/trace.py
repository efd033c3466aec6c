"""Request-lifecycle tracer: chrome-trace / JSONL span export.

Every externally visible event in a request's life — submit, admit,
prefill chunk, first token, preempt, resume, pin, share, spec-accept,
finish — is recorded as a span or instant with a monotonic host
timestamp.  The buffer is bounded (drops are counted, never blocking),
and exports either as chrome-trace JSON (``trace_event`` format —
loadable in Perfetto / chrome://tracing) or as JSONL for ad-hoc
analysis.  The span taxonomy is documented in DESIGN.md §13.

Span model: ``pid`` is constant 0 (one engine process), ``tid`` is the
request id, so Perfetto renders one row per request with its "request"
(queued+active) and nested "active" (slot residency) spans; scheduler-
and recovery-level events use the reserved ``tid`` = -1 engine row.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional

#: tid for engine-level (not per-request) events
ENGINE_TID = -1

#: the span/instant taxonomy (DESIGN.md §13) — names outside this set
#: raise, keeping the trace vocabulary closed and greppable.
SPAN_NAMES = frozenset({
    "request",        # B submit .. E finish/terminal-fail
    "active",         # B admit .. E preempt/finish/fail (slot residency)
    "step",           # engine step span (engine row, sampled)
    "recover",        # recovery / reconcile window (engine row)
})
INSTANT_NAMES = frozenset({
    "submit", "admit", "resume", "prefill_chunk", "first_token",
    "preempt", "pin", "unpin", "pin_hit", "share", "cow_copy",
    "spec_accept", "spec_rollback", "finish", "reject", "defer",
    "fail", "retry", "deadline_expired", "shed",
    "watchdog", "crash", "reconcile", "flight_dump", "shard_loss",
})


class Tracer:
    """Bounded in-memory trace buffer with chrome-trace export."""

    def __init__(self, capacity: int = 200_000, enabled: bool = True,
                 clock=time.perf_counter):
        self.enabled = enabled
        self.capacity = int(capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        self._clock = clock
        self._t0 = clock()
        self._open: dict = {}       # (name, tid) -> open-span depth

    def _ts_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    # ------------------------------------------------------------- emits
    def is_open(self, name: str, tid: int = ENGINE_TID) -> bool:
        """Whether a ``begin(name, tid)`` has no matching end yet — the
        engine's idempotence guard for spans that may re-enter through
        requeue/resubmit paths (crash recovery, warm restart)."""
        return self._open.get((name, int(tid)), 0) > 0

    def begin(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        if not self.enabled:
            return
        assert name in SPAN_NAMES, f"unknown span {name!r}"
        key = (name, int(tid))
        self._open[key] = self._open.get(key, 0) + 1
        self._push({"name": name, "ph": "B", "ts": self._ts_us(),
                    "pid": 0, "tid": int(tid), "args": args})

    def end(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        if not self.enabled:
            return
        assert name in SPAN_NAMES, f"unknown span {name!r}"
        key = (name, int(tid))
        self._open[key] = max(self._open.get(key, 0) - 1, 0)
        self._push({"name": name, "ph": "E", "ts": self._ts_us(),
                    "pid": 0, "tid": int(tid), "args": args})

    def instant(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        if not self.enabled:
            return
        assert name in INSTANT_NAMES, f"unknown instant {name!r}"
        self._push({"name": name, "ph": "i", "ts": self._ts_us(),
                    "pid": 0, "tid": int(tid), "s": "t", "args": args})

    # ----------------------------------------------------------- exports
    def to_chrome(self) -> dict:
        """The chrome-trace JSON object (trace_event format)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
        return path

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as fh:
            for ev in self.events:
                fh.write(json.dumps(ev) + "\n")
        return path


def validate_chrome(doc: dict) -> None:
    """Assert a chrome-trace document is schema-valid and that B/E
    spans nest correctly per (pid, tid) row.  Used by the tests and the
    CI obs-smoke check; raises AssertionError with a specific message
    on the first violation."""
    assert isinstance(doc, dict) and "traceEvents" in doc
    stacks: dict = {}
    last_ts: Optional[float] = None
    for ev in doc["traceEvents"]:
        for key in ("name", "ph", "ts", "pid", "tid"):
            assert key in ev, f"event missing {key!r}: {ev}"
        assert ev["ph"] in ("B", "E", "i", "X"), ev["ph"]
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if last_ts is not None:
            assert ev["ts"] >= last_ts, "timestamps not monotonic"
        last_ts = ev["ts"]
        key = (ev["pid"], ev["tid"])
        stack = stacks.setdefault(key, [])
        if ev["ph"] == "B":
            stack.append(ev["name"])
        elif ev["ph"] == "E":
            assert stack, f"E {ev['name']!r} with empty stack on {key}"
            top = stack.pop()
            assert top == ev["name"], (
                f"mis-nested span on {key}: E {ev['name']!r} closes "
                f"B {top!r}")
    for key, stack in stacks.items():
        assert not stack, f"unclosed spans on {key}: {stack}"
