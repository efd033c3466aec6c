"""Linearizability / safety checkers.

Three checkers:

1. :func:`check_alloc_history` — allocator-specific safety on a recorded
   history: a linearizable fixed-size allocator must admit a sequential
   witness where every ``allocate`` returns an *available* block and every
   ``free`` targets a *live* block.  For allocate/free this reduces to
   interval conditions on each block's alternating alloc/free timeline
   (allocations of a block must strictly interleave with its frees), which
   we verify directly — no exponential search needed.

2. :func:`check_batch_alloc_history` — the batch-granular variant for
   the device pool's ``alloc_n`` / ``free_n`` (and rebalance) histories:
   a batch grant linearizes iff the per-block expansion does — an
   ``alloc_n`` returning K blocks is K allocations sharing one
   invocation/response interval, a ``free_n`` is the symmetric batch of
   frees (:func:`expand_batch_history` performs the expansion).
   ``preempt`` ops (the serving scheduler force-releasing a victim
   lane's blocks, arg = victim pid, result = released ids) expand
   exactly like ``free_n``.

3. :func:`check_preemption_history` — batch safety plus preemption
   *completeness*: when a ``preempt`` of victim v responds, every block
   granted to v and not yet freed must be in the preempt's released set
   — a preempted lane may not retain pages (the scheduler's page-budget
   accounting depends on it).

4. :func:`check_speculative_history` — speculative-episode completeness
   (DESIGN.md §10): a rejected draft must free exactly its whole-page
   over-allocation (granted − kept), on its own shard — leak and theft
   detection over ``spec``-tagged alloc_n / spec_rollback ops, on top
   of the sharded batch checks.

5. :class:`WGStackChecker` — a small Wing & Gong style exhaustive
   linearizability checker for stack histories (used on the P-SIM shared
   stack with small histories).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

from .sim import OpRecord


def check_alloc_history(history: Sequence[OpRecord]) -> List[str]:
    """Safety check for allocate/free histories.

    Uses invocation/response *steps* as the real-time order.  Returns a
    list of violation strings (empty == pass).

    Conditions (each implies no sequential witness exists if violated):
      * a block returned by two allocations with no free of that block
        whose interval could linearize between them;
      * a free of a block that was never allocated, or whose latest
        possible allocation responds after the free's invocation window
        closes without overlap.
    """
    errs: List[str] = []
    per_block: Dict[Any, List[OpRecord]] = {}
    for op in history:
        if not op.completed:
            continue
        if op.name == "allocate":
            per_block.setdefault(op.result, []).append(op)
        elif op.name == "free":
            per_block.setdefault(op.arg, []).append(op)

    for block, ops in per_block.items():
        # Sort by response step: a valid linearization must alternate
        # alloc, free, alloc, free ... when ops on one block are totally
        # ordered in real time.  With overlap we only flag definite
        # violations: two allocs both *responding* before any free of the
        # block *invokes* in between.
        ops_sorted = sorted(ops, key=lambda o: (o.response_step, o.invoke_step))
        live = False
        prev = None
        for op in ops_sorted:
            if op.name == "allocate":
                if live and prev is not None and prev.response_step < op.invoke_step:
                    # prev alloc strictly precedes this alloc; no free of
                    # this block linearized in between.
                    errs.append(
                        f"block {block}: double allocation "
                        f"(ops {prev.opid} then {op.opid})")
                live = True
                prev = op
            else:  # free
                if not live and prev is not None and prev.response_step < op.invoke_step:
                    errs.append(
                        f"block {block}: free while available (op {op.opid})")
                live = False
                prev = op
    return errs


# ------------------------------------------------------------- batch ops

def expand_batch_history(history: Sequence[OpRecord]) -> List[OpRecord]:
    """Expand batch operations into per-block ops for the safety check.

    * ``alloc_n`` (result = iterable of granted block ids) becomes one
      ``allocate`` per id;
    * ``free_n`` (arg = iterable of released block ids) becomes one
      ``free`` per id;
    * ``preempt`` (arg = victim pid, result = iterable of released
      block ids) becomes one ``free`` per released id — a preemption IS
      a batch free performed on the victim's behalf, so the interval
      reasoning is identical;
    * ``spec_rollback`` (arg = iterable of released block ids; the
      serving step returning a rejected draft's whole-page
      over-allocation) becomes one ``free`` per id — a rollback IS a
      batch free of same-step grants, so it must linearize like one
      (the episode-completeness conditions are a separate check,
      :func:`check_speculative_history`);
    * ``reconcile`` (arg = iterable of reclaimed block ids; crash
      recovery's :func:`hier_pool.audit_and_reconcile` returning a dead
      episode's pages to the free set) becomes one ``free`` per id —
      reclamation IS a batch free performed on the crashed processes'
      behalf, so post-recovery re-grants of those pages must not look
      like double allocation (the exactly-the-orphans condition is a
      separate check, :func:`check_recovery_history`);
    * ``crash`` (arg = iterable of crashed pids) passes through — it
      moves no blocks; only the recovery checker interprets it;
    * ``allocate`` / ``free`` pass through unchanged.

    Every expanded op inherits the batch op's invocation/response
    interval (the grant is one atomic step of the lane), so the
    interval reasoning of :func:`check_alloc_history` applies verbatim:
    batch grants must linearize exactly like their sequential
    expansion.  Rebalance moves *free* blocks between stacks and is
    invisible to the allocate/free history — conservation checks cover
    it (see tests).
    """
    out: List[OpRecord] = []
    serial = 10 ** 6      # expanded opids stay unique and ordered
    for op in history:
        if op.name == "alloc_n":
            ids = [b for b in (op.result or []) if b is not None and b >= 0]
            for j, b in enumerate(ids):
                out.append(OpRecord(
                    opid=op.opid * serial + j, pid=op.pid, name="allocate",
                    arg=None, invoke_step=op.invoke_step, steps=op.steps,
                    result=b, response_step=op.response_step))
        elif op.name in ("free_n", "spec_rollback"):
            ids = [b for b in (op.arg or []) if b is not None and b >= 0]
            for j, b in enumerate(ids):
                out.append(OpRecord(
                    opid=op.opid * serial + j, pid=op.pid, name="free",
                    arg=b, invoke_step=op.invoke_step, steps=op.steps,
                    result=None, response_step=op.response_step))
        elif op.name == "preempt":
            ids = [b for b in (op.result or []) if b is not None and b >= 0]
            for j, b in enumerate(ids):
                out.append(OpRecord(
                    opid=op.opid * serial + j, pid=op.pid, name="free",
                    arg=b, invoke_step=op.invoke_step, steps=op.steps,
                    result=None, response_step=op.response_step))
        elif op.name == "reconcile":
            ids = [b for b in (op.arg or []) if b is not None and b >= 0]
            for j, b in enumerate(ids):
                out.append(OpRecord(
                    opid=op.opid * serial + j, pid=op.pid, name="free",
                    arg=b, invoke_step=op.invoke_step, steps=op.steps,
                    result=None, response_step=op.response_step))
        else:
            out.append(op)
    return out


def check_batch_alloc_history(history: Sequence[OpRecord]) -> List[str]:
    """Safety check for histories containing batch ``alloc_n``/``free_n``
    ops (the two-level device pool's operations): expand batches to
    per-block ops, then run :func:`check_alloc_history`."""
    return check_alloc_history(expand_batch_history(history))


def check_preemption_history(history: Sequence[OpRecord]) -> List[str]:
    """Batch safety plus preemption completeness.

    On top of :func:`check_batch_alloc_history` (double-grant /
    free-while-available on the per-block expansion, with ``preempt``
    expanding to frees), replays the completed ops in response order
    and tracks each pid's held blocks: when a ``preempt`` op (arg =
    victim pid, result = released ids) responds, the victim must hold
    exactly the released set — a block the victim still held that the
    preempt did not release is a *leak* (the slot's pages survived its
    eviction), and a released block the victim never held is a
    *theft* (another lane's live page was force-freed).  Both break the
    serving scheduler's page-budget accounting even when the pure
    alloc/free history linearizes, which is why this is a separate
    check.
    """
    errs = check_batch_alloc_history(history)
    held: Dict[int, set] = {}
    owner: Dict[Any, int] = {}
    done = [op for op in history if op.completed]
    for op in sorted(done, key=lambda o: (o.response_step, o.invoke_step)):
        if op.name == "allocate":
            if op.result is not None and op.result >= 0:
                held.setdefault(op.pid, set()).add(op.result)
                owner[op.result] = op.pid
        elif op.name == "alloc_n":
            for b in (op.result or []):
                if b is not None and b >= 0:
                    held.setdefault(op.pid, set()).add(b)
                    owner[b] = op.pid
        elif op.name == "free":
            held.get(owner.pop(op.arg, op.pid), set()).discard(op.arg)
        elif op.name == "free_n":
            for b in (op.arg or []):
                if b is not None and b >= 0:
                    held.get(owner.pop(b, op.pid), set()).discard(b)
        elif op.name == "preempt":
            victim = op.arg
            released = {b for b in (op.result or [])
                        if b is not None and b >= 0}
            holding = held.get(victim, set())
            leaked = holding - released
            stolen = released - holding
            if leaked:
                errs.append(f"preempt op {op.opid}: victim {victim} "
                            f"retained blocks {sorted(leaked)}")
            if stolen:
                errs.append(f"preempt op {op.opid}: released blocks "
                            f"{sorted(stolen)} not held by victim {victim}")
            for b in released:
                owner.pop(b, None)
            held[victim] = set()
    return errs


def check_recovery_history(history: Sequence[OpRecord]) -> List[str]:
    """Batch safety plus crash-recovery completeness.

    On top of :func:`check_batch_alloc_history` (with ``reconcile``
    expanding to frees), replays the completed ops in response order
    tracking each pid's held blocks:

    * a ``crash`` op (arg = iterable of crashed pids) orphans every
      block those pids hold — the dead episodes can never free them;
    * the next ``reconcile`` op (arg = iterable of reclaimed block ids)
      must reclaim *exactly* the orphaned set: an orphan it misses is a
      **leak** (a dead request's page never returns to the free
      stacks), a reclaimed block nobody orphaned is a **double free**
      (a surviving holder's live page was pushed back while still
      mapped — the next grant hands one physical page to two lanes);
    * orphans still outstanding when the history ends are leaks too.

    Single id space — shard-split a multi-shard history with
    :func:`split_history_by_shard` first, as for the other checkers.
    Mirrors :func:`check_preemption_history`: both verify that a batch
    release performed *on behalf of* a lane (eviction there, reconcile
    here) matches exactly what the lane held.
    """
    errs = check_batch_alloc_history(history)
    held: Dict[int, set] = {}
    owner: Dict[Any, int] = {}
    orphaned: Dict[Any, int] = {}          # block -> crashed pid
    done = [op for op in history if op.completed]
    for op in sorted(done, key=lambda o: (o.response_step, o.invoke_step)):
        if op.name == "allocate":
            if op.result is not None and op.result >= 0:
                held.setdefault(op.pid, set()).add(op.result)
                owner[op.result] = op.pid
        elif op.name == "alloc_n":
            for b in (op.result or []):
                if b is not None and b >= 0:
                    held.setdefault(op.pid, set()).add(b)
                    owner[b] = op.pid
        elif op.name == "free":
            held.get(owner.pop(op.arg, op.pid), set()).discard(op.arg)
        elif op.name == "free_n":
            for b in (op.arg or []):
                if b is not None and b >= 0:
                    held.get(owner.pop(b, op.pid), set()).discard(b)
        elif op.name == "crash":
            for pid in (op.arg or []):
                for b in held.get(pid, set()):
                    orphaned[b] = pid
                held[pid] = set()
        elif op.name == "reconcile":
            reclaimed = {b for b in (op.arg or [])
                         if b is not None and b >= 0}
            leaked = set(orphaned) - reclaimed
            double = reclaimed - set(orphaned)
            if leaked:
                errs.append(
                    f"reconcile op {op.opid}: leaked blocks "
                    f"{sorted(leaked)} (orphaned by crashed pids "
                    f"{sorted({orphaned[b] for b in leaked})}, "
                    f"never reclaimed)")
            if double:
                errs.append(
                    f"reconcile op {op.opid}: blocks {sorted(double)} "
                    f"reclaimed but not orphaned (double free of a "
                    f"live holder's pages)")
            for b in reclaimed:
                owner.pop(b, None)
            orphaned.clear()
    if orphaned:
        errs.append(
            f"end of history: blocks {sorted(orphaned)} orphaned by "
            f"crashed pids {sorted(set(orphaned.values()))} were never "
            f"reclaimed (leak)")
    return errs


# ------------------------------------------------------------- sharded ops

def split_history_by_shard(history: Sequence[OpRecord]
                           ) -> Dict[int, List[OpRecord]]:
    """Partition a multi-shard history by ``op.meta["shard"]``.

    The multi-host pool keeps one id space PER SHARD (block ids are
    shard-local — shard 0's block 7 and shard 1's block 7 are different
    physical pages), so the per-block interval checks are only sound on
    a single shard's sub-history: running them on the merged history
    would flag legitimate concurrent grants of the same id on two
    shards as double allocation.  Ops missing the shard tag default to
    shard 0 (single-shard histories pass through unchanged).
    """
    out: Dict[int, List[OpRecord]] = {}
    for op in history:
        out.setdefault(op.meta.get("shard", 0), []).append(op)
    return out


def check_cross_shard_frees(history: Sequence[OpRecord]) -> List[str]:
    """Cross-shard theft check: a grant observed on shard i must be
    freed on shard i.

    Replays the completed ops in response order, tracking per-(shard,
    block) live-grant counts.  A ``free``/``free_n``/``preempt``
    release naming block b on shard j while b has no live grant on j
    but does on some i != j is a *cross-shard theft*: somebody freed a
    foreign shard's page through their own shard's allocator — the
    exact failure mode shard_map is supposed to make impossible
    (shard-local id spaces mean the free would corrupt an unrelated
    page on shard j while leaking the real one on shard i).
    """
    errs: List[str] = []
    live: Dict[Tuple[int, Any], int] = {}

    def grant(shard, b):
        live[(shard, b)] = live.get((shard, b), 0) + 1

    def release(shard, b, op):
        if live.get((shard, b), 0) > 0:
            live[(shard, b)] -= 1
            return
        holders = [s for (s, blk), n in live.items() if blk == b and n > 0]
        if holders:
            errs.append(
                f"op {op.opid} ({op.name}): block {b} freed on shard "
                f"{shard} but granted on shard(s) {sorted(holders)} — "
                f"cross-shard theft")

    done = [op for op in history if op.completed]
    for op in sorted(done, key=lambda o: (o.response_step, o.invoke_step)):
        shard = op.meta.get("shard", 0)
        if op.name == "allocate":
            if op.result is not None and op.result >= 0:
                grant(shard, op.result)
        elif op.name == "alloc_n":
            for b in (op.result or []):
                if b is not None and b >= 0:
                    grant(shard, b)
        elif op.name == "free":
            release(shard, op.arg, op)
        elif op.name in ("free_n", "spec_rollback"):
            for b in (op.arg or []):
                if b is not None and b >= 0:
                    release(shard, b, op)
        elif op.name == "preempt":
            for b in (op.result or []):
                if b is not None and b >= 0:
                    release(shard, b, op)
    return errs


def check_speculative_history(history: Sequence[OpRecord]) -> List[str]:
    """Speculative-episode completeness on top of the sharded batch
    checks (DESIGN.md §10 draft-page ownership).

    A speculative *episode* is one slot's draft lane in one serving
    step: an ``alloc_n`` grant of the lane's whole-page over-allocation
    (``meta["spec"] = episode id``), the verify decision recording the
    pages the accepted prefix keeps (``meta["kept"]`` on the rollback
    op), and a ``spec_rollback`` releasing the rejected tail
    (``meta["spec"]`` matching, arg = released ids).  On top of
    :func:`check_sharded_batch_history` (double-grant /
    free-while-available per shard, cross-shard theft, with rollbacks
    expanding to frees) this enforces, per episode:

    * **same shard** — every op of an episode carries one shard tag
      (a draft's pages come from its own slot's lane and must return
      there; crossing shards would corrupt a foreign id space);
    * **kept ⊆ granted** — the verify step cannot keep a page the
      grant never handed out (kept-set theft);
    * **released == granted − kept**, exactly:
        - a granted, unkept page missing from the release is a *leak*
          (the rejected draft retained its over-allocation — the §4.2
          slack and the scheduler's budget both silently shrink);
        - a released page outside granted − kept is a *theft* (the
          rollback freed a kept page, or another lane's live page).
      A missing rollback op is fine only for a full accept
      (granted == kept).
    """
    errs = check_sharded_batch_history(history)
    episodes: Dict[Any, dict] = {}
    for op in history:
        if not op.completed or "spec" not in op.meta:
            continue
        ep = episodes.setdefault(
            op.meta["spec"],
            {"granted": set(), "kept": set(), "freed": set(),
             "shards": set(), "ops": []})
        ep["shards"].add(op.meta.get("shard", 0))
        ep["ops"].append(op.opid)
        if op.name in ("alloc_n", "allocate"):
            ids = op.result if op.name == "alloc_n" else [op.result]
            ep["granted"] |= {b for b in (ids or [])
                              if b is not None and b >= 0}
            ep["kept"] |= {b for b in op.meta.get("kept", [])
                           if b is not None and b >= 0}
        elif op.name in ("spec_rollback", "free_n", "free"):
            ids = op.arg if op.name != "free" else [op.arg]
            ep["freed"] |= {b for b in (ids or [])
                            if b is not None and b >= 0}
            ep["kept"] |= {b for b in op.meta.get("kept", [])
                           if b is not None and b >= 0}
    for eid, ep in sorted(episodes.items(), key=lambda kv: str(kv[0])):
        if len(ep["shards"]) > 1:
            errs.append(f"spec episode {eid}: ops span shards "
                        f"{sorted(ep['shards'])} — a draft's pages must "
                        f"live and die on its own shard")
        stolen_kept = ep["kept"] - ep["granted"]
        if stolen_kept:
            errs.append(f"spec episode {eid}: kept blocks "
                        f"{sorted(stolen_kept)} never granted to the "
                        f"draft lane")
        expect = ep["granted"] - ep["kept"]
        leaked = expect - ep["freed"]
        theft = ep["freed"] - expect
        if leaked:
            errs.append(f"spec episode {eid}: rejected draft retained "
                        f"blocks {sorted(leaked)} (leak)")
        if theft:
            errs.append(f"spec episode {eid}: rollback released blocks "
                        f"{sorted(theft)} outside its over-allocation "
                        f"(theft)")
    return errs


def check_sharded_batch_history(history: Sequence[OpRecord]) -> List[str]:
    """Multi-shard safety: the cross-shard theft check on the whole
    history, plus the per-block batch checks on every shard's
    sub-history independently (:func:`split_history_by_shard`)."""
    errs = check_cross_shard_frees(history)
    for shard, ops in sorted(split_history_by_shard(history).items()):
        errs += [f"shard {shard}: {e}"
                 for e in check_batch_alloc_history(ops)]
    return errs


# ---------------------------------------------------------- classed ops

def split_history_by_class(history: Sequence[OpRecord]
                           ) -> Dict[int, List[OpRecord]]:
    """Partition a size-classed history by ``op.meta["cls"]``.

    The classed pool keeps one id space PER CLASS per shard (class 0's
    block 7 and class 1's block 7 are different physical blocks on the
    same shard — DESIGN.md §14), so per-block interval checks are only
    sound on a single class's sub-history, exactly as for shards.  Ops
    missing the class tag default to class 0 (single-class histories
    pass through unchanged)."""
    out: Dict[int, List[OpRecord]] = {}
    for op in history:
        out.setdefault(op.meta.get("cls", 0), []).append(op)
    return out


def check_cross_class_frees(history: Sequence[OpRecord]) -> List[str]:
    """Cross-class theft check: a grant observed in class i must be
    freed in class i (on its own shard).

    The class-axis mirror of :func:`check_cross_shard_frees`: id spaces
    are class-local, so a release naming block b under (class j, shard
    s) while b has no live grant there but does under (class i != j,
    shard s) freed a foreign class's block through its own class's
    allocator — corrupting class j's stack while leaking class i's
    block.  The classes never exchange blocks, so this can never be
    legitimate."""
    errs: List[str] = []
    live: Dict[Tuple[int, int, Any], int] = {}   # (cls, shard, block)

    def key(op, b):
        return (op.meta.get("cls", 0), op.meta.get("shard", 0), b)

    def grant(op, b):
        k = key(op, b)
        live[k] = live.get(k, 0) + 1

    def release(op, b):
        k = key(op, b)
        if live.get(k, 0) > 0:
            live[k] -= 1
            return
        cls, shard, _ = k
        holders = [c for (c, s, blk), n in live.items()
                   if blk == b and s == shard and n > 0 and c != cls]
        if holders:
            errs.append(
                f"op {op.opid} ({op.name}): block {b} freed in class "
                f"{cls} (shard {shard}) but granted in class(es) "
                f"{sorted(holders)} — cross-class theft")

    done = [op for op in history if op.completed]
    for op in sorted(done, key=lambda o: (o.response_step, o.invoke_step)):
        if op.name == "allocate":
            if op.result is not None and op.result >= 0:
                grant(op, op.result)
        elif op.name == "alloc_n":
            for b in (op.result or []):
                if b is not None and b >= 0:
                    grant(op, b)
        elif op.name == "free":
            release(op, op.arg)
        elif op.name in ("free_n", "spec_rollback"):
            for b in (op.arg or []):
                if b is not None and b >= 0:
                    release(op, b)
        elif op.name == "preempt":
            for b in (op.result or []):
                if b is not None and b >= 0:
                    release(op, b)
    return errs


def check_classed_batch_history(history: Sequence[OpRecord]) -> List[str]:
    """Size-classed multi-shard safety (DESIGN.md §14): the cross-class
    theft check on the whole history, then every class's sub-history
    through the full sharded batch checks independently — conservation
    and interval safety are per class per shard, because both the id
    spaces and the §4.2 argument are."""
    errs = check_cross_class_frees(history)
    for cls, ops in sorted(split_history_by_class(history).items()):
        errs += [f"class {cls}: {e}"
                 for e in check_sharded_batch_history(ops)]
    return errs


# ---------------------------------------------------------------- WG checker

@dataclass
class Event:
    pid: int
    op: str          # 'push' | 'pop'
    arg: Any
    result: Any
    invoke: int
    response: int


class WGStackChecker:
    """Exhaustive linearizability check for small stack histories."""

    def __init__(self, events: Sequence[Event]):
        self.events = list(events)

    def check(self) -> bool:
        events = sorted(self.events, key=lambda e: e.invoke)
        n = len(events)
        if n > 14:
            raise ValueError("exhaustive checker limited to small histories")

        def search(done: frozenset, stack: Tuple, memo: set) -> bool:
            if (done, stack) in memo:
                return False
            if len(done) == n:
                return True
            # an op may linearize now if it hasn't, and every op whose
            # response precedes its invocation has already linearized
            min_resp = min(
                (events[i].response for i in range(n) if i not in done),
                default=float("inf"))
            for i in range(n):
                if i in done:
                    continue
                e = events[i]
                if e.invoke > min_resp:
                    continue   # must linearize someone responding earlier
                new_stack = None
                if e.op == "push":
                    new_stack = stack + (e.arg,)
                else:
                    if stack:
                        if e.result == stack[-1]:
                            new_stack = stack[:-1]
                    else:
                        if e.result is None or e.result == -1:
                            new_stack = stack
                if new_stack is not None:
                    if search(done | {i}, new_stack, memo):
                        return True
            memo.add((done, stack))
            return False

        return search(frozenset(), tuple(), set())
