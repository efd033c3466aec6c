"""Continuous-batching serving engine on the paper's allocator.

Counterpart of the JAX package's ``serving/engine.py``, limited to this
slice of the port: greedy, non-speculative serving of one size class
(paged KV) on one device, DP kept as a leading axis.

Two allocator integrations, as in the reference:

* **host (faithful)**: admission runs through the wait-free
  :class:`~repro_torch.core.allocator.WaitFreeAllocator` — sequence
  *slots* are the fixed-size blocks, scheduler lanes are the processes;
* **device**: KV pages come from the two-level pool threaded through
  :class:`~repro_torch.models.transformer.DecodeState` — one private
  lane per serving slot over a shared stack per DP shard, and one
  deamortized drain/refill rebalance inside every step.

Each step feeds a variable-width token lane per active slot (a prefill
chunk or one decode token read from the device-resident ``last_tok``
register) through :func:`_serve_step`, which runs the forward pass,
greedy argmax, EOS/budget/length done-detection, page release of
finished slots, the rebalance and the telemetry counter block, and
returns one packed int32 status.  The host copies that status in
:meth:`ServingEngine._status_to_host`, the step's ONE device-to-host
transfer (counted in ``host_transfers``); the step's inputs go up in
one non-blocking copy from pinned memory.

Options of the reference that later slices bring (speculation,
sampling, prefix sharing, size classes, expert paging, a mesh, chaos
injection and journaling, preemption) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import NULL, SimContext, WaitFreeAllocator, classed_pool
from ..core.block_pool import I32
from ..core.classed_pool import CLS_KV
from ..models.decode_init import empty_decode_state, empty_serve_arrays
from ..models.layers import logits_apply
from ..models.transformer import (DecodeState, forward_decode_chunk,
                                  pool_class_specs)
from ..runtime.fault import StepWatchdog
from .sched import Admission, AdmissionScheduler, SchedConfig
from .telemetry import (CTR_ALLOC, CTR_DRAIN, CTR_FREED, CTR_MARGIN,
                        CTR_REFILL, CTR_SHARED_FREE, CTR_SPILL, N_CTR,
                        FlightRecorder, Telemetry)
from .trace import Tracer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    # sampling (temperature 0 = greedy, the only mode of this slice)
    temperature: float = 0.0
    # scheduling
    slo: str = "standard"
    experts: Optional[Tuple[int, ...]] = None
    deadline_s: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    rejected: Optional[str] = None     # typed failure reason, terminal
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    _seq: int = 0                      # admission order


def _release_slots(state: DecodeState, mask):
    """Release all pages of masked slots (mask bool[DP, Bl]) and zero
    their tables and lengths.  Each page loses one reference; pages
    reaching zero return to the slot's lane, overflow spilling to the
    shared stack.  Returns ``(state, spill int32[C, DP])``."""
    tables = state.page_tables
    to_free = torch.where(mask[..., None], tables, NULL)
    pool, spill = classed_pool.free_n_metered_dp(state.pool, CLS_KV, to_free)
    state = state._replace(
        pool=pool, page_tables=torch.where(mask[..., None], NULL, tables),
        seq_lens=torch.where(mask, 0, state.seq_lens))
    return state, spill[None]


# Packed per-step status (the step's single device->host transfer),
# int32[T + 3 + C*N_CTR, DP, Bl] for a width-T step over C size classes:
# rows [0, T) carry each slot's emitted tokens (-1 padding), then three
# bookkeeping rows addressed relative to T, then the class-major
# telemetry counter blocks (per-shard values broadcast over Bl).
STATUS_EMITTED = 0   # + T: emitted-token count this step
STATUS_DONE = 1      # + T: 1 iff the slot finished (pages released)
STATUS_PAGES = 2     # + T: KV pages-in-use on the slot's DP shard


def _serve_step(cfg, max_len, eos_id, params, state, last_tok, out_count,
                budget, prompt_toks, feed_lens, is_prompt, emit):
    """One device-resident greedy token-lane step.

    prompt_toks: int32[DP, Bl, T] host-provided lane tokens (a prompt
    chunk; a generating lane reads its token from ``last_tok``);
    feed_lens: tokens fed per slot (0 = idle, 1 = decode); is_prompt:
    the slot consumes prompt tokens; emit: the slot emits a token this
    step.  Returns ``(state, last_tok, out_count, status)``.
    """
    DP, Bl, T = prompt_toks.shape
    C = len(state.pool.classes)
    gen_lane = prompt_toks.clone()
    gen_lane[:, :, 0] = last_tok
    toks = torch.where(is_prompt[..., None], prompt_toks, gen_lane)
    active = feed_lens > 0

    def free_all(pool):
        return [classed_pool.free_per_shard(pool, c) for c in range(C)]

    free_in = free_all(state.pool)
    hidden, state = forward_decode_chunk(cfg, params, toks, state, feed_lens,
                                         active=active)
    free_fwd = free_all(state.pool)
    ctr_alloc = [free_in[c] - free_fwd[c] for c in range(C)]
    idx = (feed_lens - 1).clamp(min=0).long()
    emit = emit & active
    h_last = hidden.gather(
        2, idx[:, :, None, None].expand(DP, Bl, 1, hidden.shape[-1]))[:, :, 0]
    logits = logits_apply(cfg, params["embed"], h_last)
    nxt = torch.argmax(logits, dim=-1).to(I32)      # first maximum
    out_count = out_count + emit.to(I32)
    seq_full = state.seq_lens >= max_len - 1
    done = active & ((out_count >= budget) | seq_full | (emit & (nxt == eos_id)))
    last_tok = torch.where(emit, nxt, last_tok)
    n_emit = emit.to(I32)
    tok_rows = torch.full((DP, Bl, T), -1, dtype=I32, device=nxt.device)
    tok_rows[:, :, 0] = torch.where(emit, nxt, -1)
    state, spill = _release_slots(state, done)
    ctr_freed = [classed_pool.free_per_shard(state.pool, c) - free_fwd[c]
                 for c in range(C)]
    # deamortized shared<->lane traffic, once per step, phases run
    # separately so the counter block meters each
    lane0 = [state.pool.classes[c].private_top.sum(-1, dtype=I32)
             for c in range(C)]
    pool = classed_pool.rebalance_drain_dp(state.pool)
    lane_drained = [pool.classes[c].private_top.sum(-1, dtype=I32)
                    for c in range(C)]
    pool = classed_pool.rebalance_refill_dp(pool)
    state = state._replace(pool=pool)

    kv = pool.classes[CLS_KV]
    pages_local = kv.shared.free_ids.shape[1]
    pages_used = (pages_local - classed_pool.free_per_shard(pool, CLS_KV)
                  ).to(I32)                                      # [DP]
    ctrs = []
    for c in range(C):
        hp = pool.classes[c]
        ctr = torch.zeros((N_CTR, DP), dtype=I32, device=nxt.device)
        ctr[CTR_ALLOC] = ctr_alloc[c]
        ctr[CTR_FREED] = ctr_freed[c]
        ctr[CTR_DRAIN] = lane0[c] - lane_drained[c]
        ctr[CTR_REFILL] = hp.private_top.sum(-1, dtype=I32) - lane_drained[c]
        ctr[CTR_SPILL] = spill[c]
        ctr[CTR_SHARED_FREE] = hp.shared.top
        ctr[CTR_MARGIN] = (hp.private_top.min(-1).values
                           - classed_pool.lane_ell(pool, c))
        ctrs.append(ctr)
    ctr = torch.cat(ctrs)                                # [C * N_CTR, DP]
    status = torch.cat(
        [tok_rows.permute(2, 0, 1), n_emit[None], done.to(I32)[None],
         pages_used[None, :, None].expand(1, DP, Bl),
         ctr[:, :, None].expand(C * N_CTR, DP, Bl)])
    return state, last_tok, out_count, status


class ServingEngine:
    def __init__(self, cfg, params, dp: int = 1, b_local: int = 4,
                 max_len: int = 512, scheduler_lanes: int = 2,
                 greedy: bool = True, chunk_size: int = 8,
                 eos_id: Optional[int] = None,
                 prefix_sharing: bool = False,
                 speculate: bool = False,
                 sched: Optional[SchedConfig] = None,
                 mesh=None, size_classes: int = 1,
                 expert_paging: bool = False,
                 journal=None, injector=None,
                 watchdog: Optional[StepWatchdog] = None,
                 clock=None,
                 telemetry: Optional[Telemetry] = None,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 device="cuda"):
        unsupported = {
            "greedy=False": not greedy,
            "prefix_sharing": prefix_sharing,
            "speculate": speculate,
            "mesh": mesh is not None,
            "size_classes > 1": size_classes != 1,
            "expert_paging": expert_paging,
            "journal": journal is not None,
            "injector": injector is not None,
        }
        for name, on in unsupported.items():
            if on:
                raise NotImplementedError(
                    f"ServingEngine({name}): a later slice of the port")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.dp, self.bl = dp, b_local
        if telemetry is None:
            telemetry = Telemetry(dp, tracer=tracer, flight=flight)
        self.telemetry = telemetry
        self.tracer = telemetry.tracer
        if telemetry.flight is None:
            telemetry.flight = FlightRecorder()
        self.flight = telemetry.flight
        self.chunk = max(int(chunk_size), 1)
        self.state = empty_decode_state(cfg, dp, b_local, max_len,
                                        chunk=self.chunk, device=self.device)
        self.n_classes = len(self.state.pool.classes)
        assert self.telemetry.n_classes == self.n_classes
        self.last_tok, self.out_count, self.budget = empty_serve_arrays(
            dp, b_local, self.device)
        maxp = self.state.page_tables.shape[2]
        # sequences can never outgrow the page table
        self.capacity = min(max_len, maxp * cfg.page_size)
        self.pages_local = classed_pool.pages_local(self.state.pool, CLS_KV)
        # plan-time §4.2 validation: the pool must carry 3*ell*L slack
        # over the worst-case live pages, or lanes can run dry mid-step
        classed_pool.validate_specs(
            pool_class_specs(cfg, b_local, max_len, self.chunk),
            [b_local * maxp])
        self._fed: Dict[int, int] = {}       # host shadow of seq_lens
        self.eos_id = eos_id
        self._eos = -1 if eos_id is None else int(eos_id)
        self.host_transfers = 0
        self.sched_config = sched or SchedConfig()
        self.scheduler = AdmissionScheduler(
            self.sched_config, n_shards=dp, page_budget=b_local * maxp)
        self.pins = None                     # pinning: a later slice
        self.pages_used_shard: List[int] = [0] * dp

        # host-side wait-free slot allocator: slots are fixed-size blocks
        n_slots = dp * b_local
        self.lane_ctx = SimContext(scheduler_lanes, seed=0)
        self.slot_alloc = WaitFreeAllocator(
            self.lane_ctx, ell=max(3 * scheduler_lanes, 4),
            shared_batches=max(2, n_slots), allow_os_growth=True)
        self._slot_of_block: Dict[int, int] = {}
        self._block_of_slot: Dict[int, int] = {}
        self._free_slots = deque(range(n_slots))
        self.lanes = itertools.cycle(range(scheduler_lanes))

        self.watchdog = watchdog or StepWatchdog()
        self._clock = clock or time.time
        self.active: Dict[int, Request] = {}     # slot -> request
        self.pending_tokens: Dict[int, List[int]] = {}
        self._latencies: List[float] = []
        self._ft_latencies: List[float] = []
        self.scheduler.telemetry = self.telemetry
        self.flight.meta.update(
            dp=dp, b_local=b_local, page_size=int(cfg.page_size),
            pages_local=int(self.pages_local),
            lane_ell=classed_pool.lane_ell(self.state.pool, CLS_KV),
            size_classes=self.n_classes, arch=getattr(cfg, "name", "?"))

    @property
    def stats(self):
        """Live view of the typed telemetry counters."""
        return self.telemetry.counters

    # ---------------------------------------------------------- tracing
    def _tr_begin(self, name: str, tid: int, **args) -> None:
        if not self.tracer.is_open(name, tid):
            self.tracer.begin(name, tid, **args)

    def _tr_end(self, name: str, tid: int, **args) -> None:
        if self.tracer.is_open(name, tid):
            self.tracer.end(name, tid, **args)

    def _trace_terminal(self, req, reason: str) -> None:
        name = ("deadline_expired" if reason == "deadline"
                else "shed" if reason == "shed" else "reject")
        self.tracer.instant(name, tid=req.rid, reason=reason)
        self._tr_end("active", req.rid)
        self._tr_end("request", req.rid)

    def _jrec(self, kind: str, **fields) -> None:
        """Journaling is a later slice; the scheduler calls this hook."""

    # ------------------------------------------------------------ control
    def _host_alloc_slot(self, shard: Optional[int] = None
                         ) -> Optional[int]:
        """O(1) wait-free admission through the paper's allocator,
        restricted to ``shard`` when given."""
        if not self._free_slots:
            return None
        if shard is not None:
            for s in self._free_slots:
                if s // self.bl == shard:
                    self._free_slots.remove(s)
                    self._free_slots.appendleft(s)
                    break
            else:
                return None
        lane = next(self.lanes)
        gen = self.slot_alloc.allocate(lane)
        try:
            while True:
                next(gen)
        except StopIteration as e:
            block = e.value
        op = self.lane_ctx.history[-1]
        self.telemetry.set_max("alloc_steps_max", op.steps)
        slot = self._free_slots.popleft()
        self._slot_of_block[block] = slot
        self._block_of_slot[slot] = block
        return slot

    def _host_free_slot(self, slot: int) -> None:
        lane = next(self.lanes)
        block = self._block_of_slot.pop(slot)
        self._slot_of_block.pop(block)
        gen = self.slot_alloc.free(lane, block)
        try:
            while True:
                next(gen)
        except StopIteration:
            pass
        self._free_slots.append(slot)

    # ------------------------------------------------ scheduler interface
    def submit(self, req: Request) -> Admission:
        """Enqueue (or reject, with a reason) through the admission
        scheduler.  The return value is the backpressure signal."""
        for name, on in {"temperature > 0": req.temperature > 0,
                         "experts": req.experts is not None,
                         "deadline_s": req.deadline_s > 0}.items():
            if on:
                raise NotImplementedError(
                    f"Request({name}): a later slice of the port")
        now = self._clock()
        req.submitted_at = now
        self._tr_begin("request", req.rid, slo=req.slo,
                       prompt_len=len(req.prompt))
        self.tracer.instant("submit", tid=req.rid, slo=req.slo)
        adm = self.scheduler.submit(req, self.est_pages(req))
        if not adm.accepted:
            self._trace_terminal(req, adm.reason)
        return adm

    def est_pages(self, req: Request) -> int:
        """Worst-case page demand: prompt plus the whole output budget,
        capped at the per-slot capacity."""
        toks = len(req.prompt) + int(req.max_new_tokens)
        toks = min(max(toks, 1), self.capacity)
        return -(-toks // self.cfg.page_size)

    def est_state_blocks(self, req: Request) -> int:
        return 0          # one size class: the state dimension never binds

    def free_slot_shards(self) -> set:
        return {s // self.bl for s in self._free_slots}

    def prefix_match(self, req: Request, shard: Optional[int] = None):
        return None       # prefix sharing: a later slice

    def pinned_pages_on(self, shard: int) -> int:
        return 0

    def admit(self, req: Request, match, shard: int) -> int:
        """Place a request on ``shard`` (the scheduler chose the order
        and the shard and verified budget and slot availability)."""
        toks = (list(req.prompt) + list(req.out_tokens)) or [1]
        slot = self._host_alloc_slot(shard)
        assert slot is not None, "scheduler admitted without a free slot"
        d, b = divmod(slot, self.bl)
        req.slot = slot
        self.active[slot] = req
        self.pending_tokens[slot] = toks
        self._fed[slot] = 0
        self.budget[d, b] = int(req.max_new_tokens)
        self.out_count[d, b] = len(req.out_tokens)
        self.telemetry.inc("admitted")
        self._tr_begin("active", req.rid, slot=slot, shard=d)
        self.tracer.instant("admit", tid=req.rid, slot=slot, shard=d,
                            shared_tokens=0)
        return slot

    def preempt(self, slot: int) -> Request:
        """The scheduler preempts for a higher SLO class; preemption
        comes with prefix sharing in a later slice of the port."""
        raise NotImplementedError("preemption: a later slice of the port")

    # -------------------------------------------------------------- step
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host -> device without a sync: a non-blocking copy from pinned
        memory on a card, a plain tensor on the CPU."""
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _status_to_host(self, status: torch.Tensor) -> np.ndarray:
        """The step's one device -> host transfer, counted."""
        self.host_transfers += 1
        return status.cpu().numpy()

    def step(self) -> bool:
        """One engine step.  Returns True iff device work was dispatched
        (False = idle fast-path: nothing active after admission)."""
        t0 = time.perf_counter()
        self.scheduler.tick(self)
        if not self.active:
            self.telemetry.inc("idle_steps")
            return False

        any_prompt = any(self.pending_tokens[s] for s in self.active)
        T = self.scheduler.pick_chunk(self, self.chunk) if any_prompt else 1
        # one host buffer, one upload: [DP, Bl, T + 3] holds the lane
        # tokens, then feed_lens, is_prompt and emit
        feed = np.zeros((self.dp, self.bl, T + 3), np.int32)
        prompt_toks, feed_lens = feed[..., :T], feed[..., T]
        is_prompt, emit = feed[..., T + 1], feed[..., T + 2]
        for slot, req in self.active.items():
            d, b = divmod(slot, self.bl)
            pend = self.pending_tokens[slot]
            if pend:
                # never feed past the page-table capacity — a slot that
                # reaches it finishes via the on-device length check
                n = min(len(pend), T, self.capacity - self._fed[slot])
                prompt_toks[d, b, :n] = pend[:n]
                del pend[:n]
                feed_lens[d, b] = n
                is_prompt[d, b] = 1
                emit[d, b] = not pend
                self.telemetry.inc("prompt_tokens", n)
                self.tracer.instant("prefill_chunk", tid=req.rid,
                                    tokens=n, fed=self._fed[slot] + n)
                self._fed[slot] += n
            else:
                feed_lens[d, b] = 1
                emit[d, b] = 1

        dev = self._to_device(feed)
        self.state, self.last_tok, self.out_count, status = _serve_step(
            self.cfg, self.capacity, self._eos, self.params, self.state,
            self.last_tok, self.out_count, self.budget, dev[..., :T],
            dev[..., T], dev[..., T + 1].bool(), dev[..., T + 2].bool())
        self.telemetry.inc("steps")
        self.telemetry.observe_hist("chunk_hist", T)
        status = self._status_to_host(status)
        n_emit = status[T + STATUS_EMITTED]
        done_row = status[T + STATUS_DONE]
        pages_row = status[T + STATUS_PAGES]
        ctr_block = status[T + 3:, :, 0]
        self.telemetry.absorb_counter_block(ctr_block)

        self.pages_used_shard = [int(x) for x in pages_row[:, 0]]
        pages_now = int(pages_row[:, 0].sum())
        self.telemetry.set_max("pages_peak", pages_now)
        self.telemetry.inc("pages_sum", pages_now)

        now = self._clock()
        for slot, req in list(self.active.items()):
            d, b = divmod(slot, self.bl)
            ne = int(n_emit[d, b])
            if ne:
                toks = [int(status[j, d, b]) for j in range(ne)]
                req.out_tokens.extend(toks)
                self.telemetry.inc("tokens_out", ne)
                if req.first_token_at == 0.0:
                    req.first_token_at = now
                    self._ft_latencies.append(now - req.submitted_at)
                    self.tracer.instant("first_token", tid=req.rid)
            if not is_prompt[d, b]:
                self._fed[slot] += ne
            if done_row[d, b]:
                # pages were already released inside the step
                req.done = True
                req.finished_at = now
                self._latencies.append(now - req.submitted_at)
                self.active.pop(slot)
                self.pending_tokens.pop(slot, None)
                self._host_free_slot(slot)
                self.scheduler.on_released(slot)
                self.tracer.instant("finish", tid=req.rid,
                                    tokens=len(req.out_tokens))
                self._tr_end("active", req.rid)
                self._tr_end("request", req.rid)
        dt = time.perf_counter() - t0
        verdict = self.watchdog.observe(self.stats["steps"], dt)
        if verdict == "straggler":
            self.telemetry.inc("stragglers")
        elif verdict == "timeout":
            self.telemetry.inc("step_timeouts")
        if verdict is not None:
            self.tracer.instant("watchdog", verdict=verdict,
                                step=self.stats["steps"])
        self.flight.record(
            step=self.stats["steps"], t=now, T=T, spec=False,
            status=status.tolist(), ctr=ctr_block.tolist(), drafts={},
            rids={int(s): int(r.rid) for s, r in self.active.items()},
            watchdog=verdict, dt_ms=round(dt * 1e3, 3))
        return True

    def idle(self) -> bool:
        """Nothing running and nothing admissible."""
        return not self.active and self.scheduler.backlog() == 0

    def run(self, max_steps: int = 10_000) -> None:
        """Step until idle or ``max_steps``.  A failing step raises: the
        reference's in-place recovery is a later slice of the port."""
        for _ in range(max_steps):
            if self.idle():
                break
            self.step()

    # ------------------------------------------------------------ metrics
    def pages_in_use(self) -> int:
        """Physical KV pages currently referenced across shards."""
        total = self.pages_local * self.dp
        return total - int(classed_pool.total_free(self.state.pool))

    def page_occupancy(self) -> float:
        return self.pages_in_use() / (self.pages_local * self.dp)

    def leak_free(self) -> bool:
        """Zero live pages on every shard (the post-drain invariant)."""
        live = classed_pool.live_per_shard(self.state.pool, CLS_KV)
        return bool((live == 0).all())

    def latency_quantiles(self) -> Dict[str, float]:
        """p50/p99 end-to-end and first-token latency (seconds)."""
        def q(xs, f):
            if not xs:
                return 0.0
            s = sorted(xs)
            return s[min(len(s) - 1, int(round(f * (len(s) - 1))))]
        return {"p50_s": q(self._latencies, 0.50),
                "p99_s": q(self._latencies, 0.99),
                "first_token_p50_s": q(self._ft_latencies, 0.50),
                "first_token_p99_s": q(self._ft_latencies, 0.99)}
