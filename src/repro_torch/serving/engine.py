"""Continuous-batching serving engine on the paper's allocator.

Counterpart of the JAX package's ``serving/engine.py``: greedy or
sampled serving on one device, DP kept as a leading axis, of paged,
ring and recurrent decoders with dense or MoE FFNs, VLMs and
encoder-decoders (whose cross K/V a two-class pool meters as CLS_STATE
blocks; the engine takes no encoder input, so an encoder-decoder's
slots decode over zero cross K/V, as in the reference) over one, two or
three size classes (paged KV, the fine bounded-state class, and the
read-only expert-weight class of expert-paged MoE serving), with prefix
sharing from live donors and from pinned prefixes, preemption,
speculative decoding over shared prefixes for fully paged models, and
crash recovery.

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
greedy argmax or per-request temperature/top-k sampling
(:mod:`.sampling`; on a step that carries drafts, draft verification
and the rollback of the rejected tail), EOS/budget/length
done-detection, page release of finished slots, the rebalance and the
telemetry counter block, and returns one packed int32 status.  The host
copies that status in :meth:`ServingEngine._status_to_host`, the step's
ONE device-to-host transfer (counted in ``host_transfers``); the step's
inputs go up in one non-blocking copy from pinned memory.  Admission
with a prefix match reads the share step's ``ok`` flag, a transfer
outside the step (counted in ``admission_transfers``).

The admission scheduler (``serving/sched.py``) owns the policy:
priority classes, page budgets, preemption of lower classes and the
pin budget.  The engine carries out its decisions: :meth:`admit`,
:meth:`preempt` (pin the victim's whole pages, release, requeue) and
:meth:`evict_pin`, over a device pin table whose rows hold the cache's
own reference on each pinned page.

Expert-paged MoE (serving/expert_pages.py): each request may carry an
admitted expert footprint (``Request.experts``), a per-slot router mask
register applied before the top-k in resident and paged engines alike.
With ``expert_paging`` the expert weights stay on the host and the card
holds a budget of them as ``CLS_EXPERT`` pages: admission makes a
footprint resident (LRU eviction of cold experts for room) and takes
one reference per expert page for the slot, release drops them after
the status read, and the scheduler's third budget dimension prices a
request by the pages it would load on each shard.

Fault tolerance (serving/chaos.py): an optional journal records every
admission, emission and pin; an optional injector fires faults at the
named phase boundaries of :meth:`ServingEngine.step`; :meth:`run`
recovers a failed step in place (pool reconciled, active work
requeued), and :func:`~repro_torch.serving.chaos.recover_engine`
rebuilds an engine after a host crash from the surviving device state
and the journal.  Per-request deadlines and bounded retry parking are
the scheduler's.

The reference's multi-device plane is ``mesh=`` a
:class:`~repro_torch.launch.mesh.DPGroup`: one process (a rank) per DP
shard, each holding only its shard's device state (pool, lanes,
refcounts, pin rows, expert and KV pages, registers) as ``[1, Bl, ...]``
tensors on its own device, while every rank runs the same host control
on the same requests.  A rank uploads only its shard's row of each host
buffer, runs the device steps of the slots it owns, and ends each serve
step in one device-to-host copy and one collective, the gather of the
packed status (counted in ``host_transfers`` and ``collectives``); a
share step's verdict is agreed in one more (``agreements``).  The wall
clock that host decisions read (deadlines, the speculation gate's step
cost, the watchdog) is rank 0's, carried in trailing rows of that same
gather; an engine with nothing owed runs no serve step, so a submit to
it first gathers the clock rows alone (``clock_syncs``).

Faults under a group: every rank holds the same fault schedule and runs
the same host control, so an injected fault fires on every rank at the
same (step, phase) and each rank recovers as one process does, on its
own shard: a crash through ``recover_engine`` on every rank, a step
error in place on every rank, a shard's loss retired by every rank
(the lost shard's rank stays in the group, owning no slot).  A failure
of one rank alone (a device error in the step or in admission's device
work, or a schedule that not every rank holds) is held while the rank's
host control goes on in step, and rides the trailing rows of the next
gather: raised before the step's status gather, every rank recovers in
place at it; after it, every rank raises :class:`~.chaos.RankFailure`
at the next one, as it does when a rank's crash rebuild through
``recover_engine`` raises.  Every in-place recovery ends in a gather
of the trailing rows, where a rank whose recovery raised makes every
rank raise :class:`~.chaos.RankFailure` at once.  A warm save writes
each rank's shard file, rank 0's sidecar, and the completion marker
once every file has landed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import NULL, SimContext, WaitFreeAllocator, classed_pool
from ..core.block_pool import I32
from ..core import hier_pool
from ..core.classed_pool import CLS_EXPERT, CLS_KV, CLS_STATE
from ..launch.mesh import DPGroup
from ..models.decode_init import empty_decode_state, empty_serve_arrays
from ..models.layers import logits_apply, logits_argmax_chunked, tree_map
from ..models.transformer import (EXPERT_PPE, DecodeState,
                                  expert_layer_slots, forward_decode_chunk,
                                  pool_class_specs, state_blocks_per_slot)
from ..runtime.fault import StepWatchdog
from .chaos import HostCrash, PoisonedRequest, RankFailure, StepError
from .expert_pages import (ExpertLedger, build_host_experts,
                           expert_evict_step, expert_load_step,
                           expert_ref_step, stub_expert_params)
from .prefix_cache import (PinnedPrefixes, PrefixCache, SpeculationStore,
                           pin_id_of, pin_prefix_step, share_pinned_step,
                           share_prefix_step, unpin_step)
from .sampling import sample_lane, sample_tokens
from .sched import Admission, AdmissionScheduler, SchedConfig
from .telemetry import (CTR_ALLOC, CTR_DRAIN, CTR_EDROP, CTR_EHIT,
                        CTR_EMISS, CTR_EPREF, CTR_FREED, CTR_MARGIN,
                        CTR_REFILL, CTR_ROLLBACK, CTR_SHARED_FREE,
                        CTR_SPILL, N_CTR, FlightRecorder, Telemetry)
from .trace import Tracer


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    # sampling (the defaults are greedy)
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    # scheduling
    slo: str = "standard"
    # admitted expert footprint (MoE serving): the experts this request
    # may route to, enforced before the top-k by the router mask in both
    # resident and expert-paged engines, so the two are token-identical
    # by construction.  None = all experts
    experts: Optional[Tuple[int, ...]] = None
    # deadline: seconds from submission (0 = none); the engine stamps
    # the absolute ``deadline_at`` at the first submission, so that it
    # survives preemption, crash requeue and warm restart
    deadline_s: float = 0.0
    deadline_at: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    rejected: Optional[str] = None     # typed failure reason, terminal
    preemptions: int = 0
    retries: int = 0                   # fault retries consumed
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    _seq: int = 0                      # admission order
    _spec_key: Optional[tuple] = None  # whole-page prefix (speculation)


def _release_slots(state: DecodeState, mask):
    """Release all pages of masked slots (mask bool[DP, Bl]), and in a
    two-class pool their CLS_STATE grants, and zero their tables,
    lengths, rings and recurrent state (in place).  Each page loses one
    reference; pages reaching zero return to the slot's lane, overflow
    spilling to the shared stack.  Returns ``(state, spill int32[C,
    DP])``."""
    tables = state.page_tables
    to_free = torch.where(mask[..., None], tables, NULL)
    pool, spill_kv = classed_pool.free_n_metered_dp(state.pool, CLS_KV,
                                                    to_free)
    spills = [spill_kv] + [torch.zeros_like(spill_kv)] * (
        len(pool.classes) - 1)
    if state.state_tables is not None:
        st = state.state_tables
        pool, spills[CLS_STATE] = classed_pool.free_n_metered_dp(
            pool, CLS_STATE, torch.where(mask[..., None], st, NULL))
        state = state._replace(
            state_tables=torch.where(mask[..., None], NULL, st))
    dp, bl = mask.shape
    for leaf in ([t for kv in state.rings.values() for t in kv]
                 + [t for r in state.rec.values() for t in r.values()]):
        leaf.masked_fill_(mask.view((1, dp, bl) + (1,) * (leaf.dim() - 3)),
                          0)
    state = state._replace(
        pool=pool, page_tables=torch.where(mask[..., None], NULL, tables),
        seq_lens=torch.where(mask, 0, state.seq_lens))
    return state, torch.stack(spills)


def _alloc_state_step(state: DecodeState, counts):
    """Admission-time CLS_STATE grant: pull ``counts[d, b]`` fine blocks
    per slot from class 1's shared stack in one bulk call (off the
    serve step's path) and write them into the slot's ``state_tables``
    row.  While admission respects the class budget, the class's §4.2
    slack guarantees the shared stack covers every grant."""
    kmax = state.state_tables.shape[2]
    pool, ids = classed_pool.alloc_from_shared_dp(state.pool, CLS_STATE,
                                                  counts, kmax)
    tables = torch.where(counts[..., None] > 0, ids, state.state_tables)
    return state._replace(pool=pool, state_tables=tables)


# Packed per-step status (the step's single device->host transfer),
# int32[T + 3 + C*N_CTR, DP, Bl] for a width-T step over C size classes:
# rows [0, T) carry each slot's emitted tokens (-1 padding), then three
# bookkeeping rows addressed relative to T, then the class-major
# telemetry counter blocks (per-shard values broadcast over Bl).
STATUS_EMITTED = 0   # + T: emitted-token count this step
STATUS_DONE = 1      # + T: 1 iff the slot finished (pages released)
STATUS_PAGES = 2     # + T: KV pages-in-use on the slot's DP shard

# Under a DP group the status gathered each step carries TRAIL_ROWS more
# rows at its end, stripped on the host before anything reads the
# status: the sending rank's wall clock (microseconds, high and low
# 32 bits) and its wall time of the previous serve step (microseconds,
# -1 for none), of which host decisions read rank 0's, so the ranks
# agree; then the rank's failure flag (0 or a FAIL_ kind) and the
# serve step it names; then the checksum of the rank's fault schedule
# (0 without an injector).
CLOCK_ROWS = 3
TRAIL_FAIL, TRAIL_FAIL_STEP, TRAIL_SCHEDULE = 3, 4, 5
TRAIL_ROWS = 6
FAIL_IN_STEP = 1   # failed in the step this status gather closes
FAIL_LATE = 2      # failed after an earlier gather, or in a step with none
FAIL_RECOVERY = 3  # failed in its in-place recovery (run)
FAIL_REBUILD = 4   # failed in chaos.recover_engine's rebuild or adoption
FAIL_WHERE = {FAIL_IN_STEP: "in serve step {} before its status gather",
              FAIL_LATE: "in serve step {} after its status gather",
              FAIL_RECOVERY: "in its in-place recovery after serve step {}",
              FAIL_REBUILD: "in recover_engine's rebuild after serve step {}"}


def _trail_rows(now: float, dt: Optional[float], fail: int, fail_step: int,
                schedule: int, bl: int) -> np.ndarray:
    """The trailing status rows of one rank (see TRAIL_ROWS)."""
    us = int(round(now * 1e6))
    rows = np.zeros((TRAIL_ROWS, 1, bl), np.int64)
    rows[:, 0, 0] = (us >> 32, us & 0xFFFFFFFF,
                     -1 if dt is None else min(int(dt * 1e6), 2**31 - 1),
                     fail, fail_step, schedule)
    return rows.astype(np.int32)


def _raise_told(trail: np.ndarray, size: int, in_step: bool,
                cause: Optional[BaseException]) -> None:
    """Raise if the gathered trailing rows carry a rank's failure: a
    :class:`~.chaos.StepError` (recovered in place by ``run`` on every
    rank) when each failing rank failed before this status gather, in
    the step it closes, and :class:`~.chaos.RankFailure` otherwise,
    naming each failing rank, where it failed and the serve step.  This
    rank's own error, if it held one, is the cause."""
    fails = [(r, int(trail[TRAIL_FAIL, r, 0]),
              int(trail[TRAIL_FAIL_STEP, r, 0]))
             for r in range(size) if int(trail[TRAIL_FAIL, r, 0])]
    if not fails:
        return
    told = "; ".join(f"rank {r} failed {FAIL_WHERE[k].format(s)}"
                     for r, k, s in fails)
    if in_step and all(k == FAIL_IN_STEP for _, k, _ in fails):
        raise StepError(told) from cause
    raise RankFailure(told) from cause


def tell_rebuild_failure(mesh: DPGroup, bl: int, step: int,
                         cause: BaseException) -> None:
    """A rank whose engine rebuild (``chaos.recover_engine``'s factory)
    raised before its construction gather: join the gather that the
    other ranks' new engines make at construction with a FAIL_REBUILD
    flag, so that every rank raises :class:`~.chaos.RankFailure` there
    at once; this one raises it too."""
    rows = _trail_rows(time.time(), None, FAIL_REBUILD, step, 0, bl)
    got = mesh.gather_status(torch.from_numpy(rows))
    _raise_told(got, mesh.size, False, cause)


def _read_clock(rows: np.ndarray) -> Tuple[float, Optional[float]]:
    """(now, dt) of rank 0 from the gathered trailing rows."""
    hi, lo, dt = (int(x) for x in rows[:CLOCK_ROWS, 0, 0])
    now = ((hi << 32) | (lo & 0xFFFFFFFF)) / 1e6
    return now, (None if dt < 0 else dt / 1e6)


def _serve_step(cfg, max_len, eos_id, use_sampler, spec, n_verify, params,
                state, last_tok, out_count, budget, temps, topks, seeds,
                prompt_toks, feed_lens, is_prompt, emit, expert_mask):
    """One device-resident token-lane step.

    prompt_toks: int32[DP, Bl, T] host-provided lane tokens (a prompt
    chunk; a generating lane reads its first token from ``last_tok``
    and, when ``spec``, carries drafted tokens at positions 1..k);
    feed_lens: tokens fed per slot (0 = idle, 1 = decode, > 1 on a
    generating lane = draft + verify); is_prompt: the slot consumes
    prompt tokens; emit: the slot emits this step.  temps/topks/seeds:
    the per-slot sampling registers written at admission (temperature
    <= 0 is greedy).

    ``expert_mask`` (bool [DP, Bl, E]) is a per-slot register like the
    sampling ones: each slot's admitted expert footprint, applied before
    the top-k at every MoE layer (all-True rows are bit-identical to no
    mask).  The forward's MoE meters (capacity drops, expert page
    hit/miss/prefetch) ride the counter block: the page rows on the
    expert class, the drop row on class 0, so resident MoE engines
    meter drops too.

    ``use_sampler`` (the host knows whether any active request samples):
    tokens come from :func:`~.sampling.sample_tokens`, keyed by
    ``(seed, out_count)``; off, from the plain argmax, so an all-greedy
    step runs no sort and no Gumbel draw.

    ``spec`` (the host knows whether any lane carries drafts): attention
    runs through the verify kernel (K3); only the ``n_verify`` (draft
    length + 1) verify positions of each lane are scored, with the
    chunked-vocabulary argmax, or with :func:`~.sampling.sample_lane`
    and key ``out_count + i`` at position i when sampling; draft i is
    accepted iff it equals the candidate of position i - 1 and every
    earlier draft was accepted, so the accepted stream is the one plain
    decode would emit, key for key.
    A lane emits its accepted prefix plus one token, keeps exactly that
    many KV positions, and returns the whole pages of the rejected tail
    to its own lane (:func:`classed_pool.free_n_metered_dp`) before the
    release of finished slots and the rebalance.

    Returns ``(state, last_tok, out_count, status)``.
    """
    DP, Bl, T = prompt_toks.shape
    C = len(state.pool.classes)
    dev = prompt_toks.device
    gen_lane = prompt_toks.clone()
    gen_lane[:, :, 0] = last_tok
    toks = torch.where(is_prompt[..., None], prompt_toks, gen_lane)
    active = feed_lens > 0
    base = state.seq_lens

    def free_all(pool):
        return [classed_pool.free_per_shard(pool, c) for c in range(C)]

    free_in = free_all(state.pool)
    hidden, state, fwd_meta = forward_decode_chunk(
        cfg, params, toks, state, feed_lens, active=active, verify=spec,
        expert_mask=expert_mask if cfg.moe is not None else None)
    free_fwd = free_all(state.pool)
    ctr_alloc = [free_in[c] - free_fwd[c] for c in range(C)]
    idx = (feed_lens - 1).clamp(min=0)
    emit = emit & active
    if spec:
        # score only the verify positions: a generating lane's are lane
        # positions 0..Tv-1, a prompt lane needs its emitting position
        Tv = min(T, n_verify) if n_verify > 0 else T
        j = torch.arange(Tv, dtype=I32, device=dev)
        vpos = torch.where(is_prompt[..., None], idx[..., None],
                           j.clamp(max=T - 1)[None, None])   # [DP, Bl, Tv]
        hidden_v = hidden.gather(2, vpos[..., None].long().expand(
            DP, Bl, Tv, hidden.shape[-1]))
        if use_sampler:
            # output index of each position: a generating lane emits
            # from position 0 on (key out_count + i), a prompt lane's
            # one emitting position is output index 0
            cnt = out_count[..., None] + torch.where(
                is_prompt[..., None], 0, j[None, None])
            nxt_all = sample_lane(
                logits_apply(cfg, params["embed"], hidden_v), temps, topks,
                seeds, cnt)
        else:
            nxt_all = logits_argmax_chunked(cfg, params["embed"], hidden_v)
        # a prompt lane's rows all hold position idx, so row 0 is its
        # candidate; a generating lane's last fed position is feed - 1
        vidx = torch.where(is_prompt, 0, idx.clamp(max=Tv - 1))
        last_pos = nxt_all.gather(2, vidx[..., None].long())[..., 0]
        etoks = torch.where(is_prompt[..., None], last_pos[..., None],
                            nxt_all)
        dmatch = ((nxt_all[..., :-1] == toks[..., 1:Tv])
                  & (j[None, None, 1:] < feed_lens[..., None]))
        accepted = torch.cumprod(dmatch.to(I32), -1).sum(-1, dtype=I32)
        n_cand = torch.where(is_prompt, 1, accepted + 1) * emit.to(I32)
        # EOS and budget cut the emission stream (an emitted EOS is
        # included, then the slot finishes)
        is_e = (etoks == eos_id) & (j[None, None] < n_cand[..., None])
        eos_cut = torch.where(is_e.any(-1), is_e.to(I32).argmax(-1) + 1,
                              Tv + 1).to(I32)
        room = (budget - out_count).clamp(min=0)
        n_emit = torch.minimum(n_cand, torch.minimum(room, eos_cut))
        hit_eos = (is_e & (j[None, None] < n_emit[..., None])).any(-1)
        # rollback: keep last_tok + the accepted drafts, free the whole
        # pages of the rejected tail to the slot's own lane (refcount-1
        # pages granted this very step)
        adv = state.seq_lens - base
        n_keep = torch.where(is_prompt, adv, torch.minimum(n_emit, adv))
        psz = cfg.page_size
        maxp = state.page_tables.shape[2]
        keep_pages = (base + n_keep + psz - 1) // psz
        have_pages = (base + adv + psz - 1) // psz
        kidx = torch.arange(maxp, dtype=I32, device=dev)
        roll = ((kidx >= keep_pages[..., None])
                & (kidx < have_pages[..., None]))
        pool, spill_roll = classed_pool.free_n_metered_dp(
            state.pool, CLS_KV, torch.where(roll, state.page_tables, NULL))
        state = state._replace(
            pool=pool, page_tables=torch.where(roll, NULL, state.page_tables),
            seq_lens=base + n_keep)
        ctr_roll = [classed_pool.free_per_shard(state.pool, CLS_KV)
                    - free_fwd[CLS_KV]]
        ctr_roll += [torch.zeros_like(ctr_roll[0]) for _ in range(C - 1)]
        out_count = out_count + n_emit
        seq_full = state.seq_lens >= max_len - 1
        done = active & ((out_count >= budget) | seq_full | hit_eos)
        last_emitted = etoks.gather(
            2, (n_emit - 1).clamp(min=0)[..., None].long())[..., 0]
        last_tok = torch.where(n_emit > 0, last_emitted, last_tok)
        tok_rows = torch.full((DP, Bl, T), -1, dtype=I32, device=dev)
        tok_rows[..., :Tv] = torch.where(j[None, None] < n_emit[..., None],
                                         etoks, -1)
    else:
        ctr_roll = [torch.zeros_like(f) for f in free_in]
        spill_roll = torch.zeros_like(free_in[CLS_KV])
        h_last = hidden.gather(2, idx[:, :, None, None].long().expand(
            DP, Bl, 1, hidden.shape[-1]))[:, :, 0]
        logits = logits_apply(cfg, params["embed"], h_last)
        if use_sampler:
            nxt = sample_tokens(logits, temps, topks, seeds, out_count)
        else:
            nxt = torch.argmax(logits, dim=-1).to(I32)  # first maximum
        out_count = out_count + emit.to(I32)
        seq_full = state.seq_lens >= max_len - 1
        done = active & ((out_count >= budget) | seq_full
                         | (emit & (nxt == eos_id)))
        last_tok = torch.where(emit, nxt, last_tok)
        n_emit = emit.to(I32)
        tok_rows = torch.full((DP, Bl, T), -1, dtype=I32, device=dev)
        tok_rows[:, :, 0] = torch.where(emit, nxt, -1)
    state, spill = _release_slots(state, done)
    # everything freed since the forward pass: rollback plus release
    ctr_freed = [classed_pool.free_per_shard(state.pool, c) - free_fwd[c]
                 for c in range(C)]
    ctr_spill = [spill[c] + (spill_roll if c == CLS_KV else 0)
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
        ctr = torch.zeros((N_CTR, DP), dtype=I32, device=dev)
        ctr[CTR_ALLOC] = ctr_alloc[c]
        ctr[CTR_FREED] = ctr_freed[c]
        ctr[CTR_ROLLBACK] = ctr_roll[c]
        ctr[CTR_DRAIN] = lane0[c] - lane_drained[c]
        ctr[CTR_REFILL] = hp.private_top.sum(-1, dtype=I32) - lane_drained[c]
        ctr[CTR_SPILL] = ctr_spill[c]
        ctr[CTR_SHARED_FREE] = hp.shared.top
        ctr[CTR_MARGIN] = (hp.private_top.min(-1).values
                           - classed_pool.lane_ell(pool, c))
        if c == CLS_EXPERT:
            ctr[CTR_EHIT] = fwd_meta["expert_hit_pages"]
            ctr[CTR_EMISS] = fwd_meta["expert_miss_pages"]
            ctr[CTR_EPREF] = fwd_meta["expert_prefetch_pages"]
        if c == CLS_KV:
            ctr[CTR_EDROP] = fwd_meta["moe_dropped"]
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
                 prefix_sharing: bool = True,
                 speculate: bool = False, draft_len: int = 4,
                 spec_gate: bool = True,
                 sched: Optional[SchedConfig] = None,
                 mesh=None, size_classes: int = 1,
                 expert_paging: bool = False,
                 expert_budget: Optional[int] = None,
                 journal=None, injector=None,
                 watchdog: Optional[StepWatchdog] = None,
                 clock=None, max_restarts: int = 0,
                 telemetry: Optional[Telemetry] = None,
                 tracer: Optional[Tracer] = None,
                 flight: Optional[FlightRecorder] = None,
                 device="cuda"):
        self.sched_config = sched or SchedConfig()
        if mesh is not None:
            if not isinstance(mesh, DPGroup):
                raise TypeError("ServingEngine(mesh=...) takes a DPGroup "
                                "(launch.mesh.make_dp_group) or None")
            if mesh.size != dp:
                raise ValueError(f"a DP group of {mesh.size} ranks serves "
                                 f"dp={mesh.size}, not dp={dp}")
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} for a rank on "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh: Optional[DPGroup] = mesh
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.dp, self.bl = dp, b_local
        # the DP shards this process holds on its device: all of them,
        # or its own under a group
        self._dp_dev = dp if mesh is None else 1
        # expert-paged MoE serving: expert FFN weights through the pool's
        # third size class, on an MoE config with expert layer slots; the
        # class vector widens to three before telemetry and the pool are
        # built, so every consumer of n_classes sees the expert class
        self._elayer_n = expert_layer_slots(cfg)
        self.expert_paging = bool(
            (expert_paging or int(size_classes) > CLS_EXPERT)
            and cfg.moe is not None and self._elayer_n > 0)
        if self.expert_paging:
            size_classes = CLS_EXPERT + 1
        else:
            # the expert class means nothing without paged MoE slots
            size_classes = min(max(int(size_classes), 1), CLS_EXPERT)
        # CLS_EXPERT page budget a shard's ledger holds (full residency
        # when unset); the pool is provisioned at budget + lane stock,
        # so admission within the budget keeps every bulk grant inside
        # the §4.2 slack
        self.expert_budget = 0
        if self.expert_paging:
            if dp != 1 and mesh is None:
                raise ValueError("expert paging needs shard-local DP == 1: "
                                 "run dp=1, or one rank per shard (a DP "
                                 "group)")
            full = self._elayer_n * cfg.moe.num_experts * EXPERT_PPE
            self.expert_budget = int(expert_budget
                                     or self.sched_config.expert_budget
                                     or full)
        if telemetry is None:
            telemetry = Telemetry(dp, tracer=tracer, flight=flight,
                                  n_classes=size_classes)
        self.telemetry = telemetry
        self.tracer = telemetry.tracer
        if telemetry.flight is None:
            telemetry.flight = FlightRecorder()
        self.flight = telemetry.flight
        self.chunk = max(int(chunk_size), 1)
        self.draft_len = max(int(draft_len), 0)
        # lanes cover the widest lane the engine dispatches: the prefill
        # chunk or a draft + verify lane (§4.2: ell >= per-step demand)
        lane_tokens = self.chunk
        if speculate:
            lane_tokens = max(lane_tokens, self.draft_len + 1)
        self.state = empty_decode_state(
            cfg, self._dp_dev, b_local, max_len, chunk=lane_tokens,
            size_classes=size_classes,
            expert_budget=self.expert_budget if self.expert_paging else None,
            device=self.device)
        self.n_classes = len(self.state.pool.classes)
        assert self.telemetry.n_classes == self.n_classes
        self.last_tok, self.out_count, self.budget = empty_serve_arrays(
            self._dp_dev, b_local, self.device)
        # per-slot sampling registers (written at admission, read by the
        # step; all zeros is greedy everywhere), and the slots that sample
        self.temps, self.topks, self.seeds = self._sampling_registers()
        self._sampling_slots: set = set()
        # per-slot admitted expert footprint, a register like the
        # sampling ones; all-True (the reset value) is bit-identical to
        # no mask
        self.expert_mask = self._expert_mask_register()
        self.greedy = greedy
        maxp = self.state.page_tables.shape[2]
        # sequences can never outgrow the page table (a model without
        # paged layers has none to outgrow)
        self.capacity = (min(max_len, maxp * cfg.page_size)
                         if self.state.kv_pages else max_len)
        self.pages_local = classed_pool.pages_local(self.state.pool, CLS_KV)
        # CLS_STATE blocks of one slot's bounded state (0 in a
        # single-class pool): granted at admission, freed at release
        self._state_blocks = (state_blocks_per_slot(cfg, max_len)
                              if self.state.state_tables is not None else 0)
        # plan-time §4.2 validation: every class must carry 3*ell*L
        # slack over its worst-case live blocks, or lanes can run dry
        # mid-step
        max_live = [b_local * maxp] + [b_local * self._state_blocks] * (
            self.n_classes - 1)
        if self.n_classes > CLS_EXPERT:
            # worst-case live CLS_EXPERT pages == the admission budget
            # (the ledger never loads past it), so the class's §4.2
            # slack is exactly its lane stock
            max_live[CLS_EXPERT] = self.expert_budget
        classed_pool.validate_specs(
            pool_class_specs(cfg, b_local, max_len, lane_tokens,
                             size_classes,
                             self.expert_budget if self.expert_paging
                             else None), max_live)
        self._fed: Dict[int, int] = {}       # host shadow of seq_lens
        self.eos_id = eos_id
        self._eos = -1 if eos_id is None else int(eos_id)
        self.host_transfers = 0
        # the share step's ok flag, read at admission, outside the step
        self.admission_transfers = 0
        # under a DP group: the serve steps' status gathers, the share
        # steps' verdicts, and the clock-only gathers (_sync_clock)
        self.collectives = 0
        self.agreements = 0
        self.clock_syncs = 0
        self._spec_T = self.draft_len + 1
        # prefix sharing from live donors: sound only when the whole
        # decode state is paged (a ring or recurrent layer would need the
        # donor's state at the match point, an encoder-decoder the
        # donor's cross K/V)
        self.prefix_cache = None
        if (prefix_sharing and self.state.kv_pages and not self.state.rings
                and not self.state.rec and self.state.enc_kv is None):
            self.prefix_cache = PrefixCache(cfg.page_size)
        # speculative decoding over shared prefixes, under the same
        # condition (a rejected draft rolls back pages and seq_lens, but
        # ring and recurrent state cannot be un-evolved): drafts come
        # from the continuation history of hot prefixes
        self.spec_store: Optional[SpeculationStore] = None
        if speculate and self.draft_len > 0 and self.prefix_cache is not None:
            self.spec_store = SpeculationStore(cfg.page_size)
        self.speculate = self.spec_store is not None
        # accept-rate-gated drafting: a per-prefix accept-rate EWMA (in
        # the SpeculationStore) against an EWMA of the step's wall time
        # keyed by (lane width, spec); before both are measured, a
        # width-(k+1) verify step costs ~ 1 + slope * k plain steps
        self.spec_gate = bool(spec_gate)
        self.spec_cost_slope = 0.25
        self._step_cost: Dict[Tuple[int, bool], float] = {}
        self._cost_seen: set = set()
        self.scheduler = AdmissionScheduler(
            self.sched_config, n_shards=dp, page_budget=b_local * maxp,
            state_budget=b_local * self._state_blocks)
        # pinned prefixes: a device pin table (rows of cache-owned page
        # ids per shard) and the host LRU ledger; on only when the sched
        # config grants a pin budget and the model can share at all
        self.pins: Optional[PinnedPrefixes] = None
        self.pin_tables: Optional[torch.Tensor] = None
        if self.prefix_cache is not None and self.sched_config.pin_pages > 0:
            self.pins = PinnedPrefixes(dp, self.sched_config.pin_rows,
                                       self.sched_config.pin_pages)
            self.pin_tables = torch.full(
                (self._dp_dev, self.sched_config.pin_rows, maxp), NULL,
                dtype=I32, device=self.device)
        self._pinned_slots: set = set()
        # expert-paged weight plane: the full expert stacks on the host
        # (page-locked on a card), the engine's parameter leaves stubbed
        # to [..., 1, 1], residency through CLS_EXPERT pages and the host
        # ledger; loads, evictions and reference traffic run at
        # admission and release, never inside the serve step
        self.expert_ledger: Optional[ExpertLedger] = None
        self._host_experts = None
        self._slot_experts: Dict[int, tuple] = {}
        self._elayer_slots: List[Tuple[str, int]] = []
        self._fp_masks: Dict[tuple, tuple] = {}
        if self.expert_paging:
            self._host_experts = build_host_experts(
                cfg, params, pin=self.device.type == "cuda")
            self.params = stub_expert_params(params)
            self.expert_ledger = ExpertLedger(dp, self.expert_budget)
            self._elayer_slots = [
                (pos, g) for pos in sorted(self.state.expert_tables)
                for g in range(self.state.expert_tables[pos].shape[0])]
        # the status PAGES row (per-shard pages in use, from the step's
        # one transfer) drives high-water pin eviction; its running sum
        # and peak per shard feed shard_occupancy()
        self.pages_used_shard: List[int] = [0] * dp
        self._pages_shard_sum = np.zeros(dp, np.int64)
        self._pages_shard_peak = np.zeros(dp, np.int64)

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

        # fault tolerance (serving/chaos.py): the journal, the injector,
        # the step watchdog, an injectable clock for deadlines, and the
        # in-place recovery budget of run()
        self._journal = journal
        self._injector = injector
        self.watchdog = watchdog or StepWatchdog()
        self._clock = clock or time.time
        # under a group every host decision reads rank 0's clock: the
        # value of the last gather (:meth:`_sync_clock`), and step costs
        # one step late, from the status gather
        self._local_clock = self._clock
        self._step_dt: Optional[float] = None   # this rank's last step
        self._cost_key: Optional[Tuple[int, bool]] = None
        self._group_verdict: Optional[str] = None
        # under a group: this rank's failure not yet told to the others,
        # as (exception, serve step, FAIL_ kind),
        # and whether its fault schedule is its own (not every rank's)
        self._held: Optional[tuple] = None
        self._faults_alone = False
        if mesh is not None:
            self._sync_clock(construction=True)
            self._clock = lambda: self._shared_now
        self.max_restarts = max_restarts
        self.lost_shards: set = set()
        self.active: Dict[int, Request] = {}     # slot -> request
        self.pending_tokens: Dict[int, List[int]] = {}
        self._latencies: List[float] = []
        self._ft_latencies: List[float] = []
        self.scheduler.telemetry = self.telemetry
        if self.prefix_cache is not None:
            self.prefix_cache.telemetry = self.telemetry
        self.flight.meta.update(
            dp=dp, b_local=b_local, page_size=int(cfg.page_size),
            pages_local=int(self.pages_local),
            lane_ell=classed_pool.lane_ell(self.state.pool, CLS_KV),
            size_classes=self.n_classes, expert_paging=self.expert_paging,
            expert_budget=self.expert_budget, speculate=self.speculate,
            arch=getattr(cfg, "name", "?"))

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

    # --------------------------------------------------- fault tolerance
    def _jrec(self, kind: str, **fields) -> None:
        if self._journal is not None:
            self._journal.record(kind, **fields)

    def _fire(self, phase: str, **ctx) -> None:
        if self._injector is None:
            return
        if not self._faults_alone:
            self._injector.fire(self, phase, **ctx)
            return
        # a schedule of this rank alone: its faults are this rank's
        # failures, held and told to the group at the next gather while
        # the host control goes on in step with the other ranks
        try:
            self._injector.fire(self, phase, alone=True, **ctx)
        except (StepError, HostCrash, PoisonedRequest) as e:
            self._hold(e, FAIL_LATE if phase in ("post_sync", "post_step")
                       else FAIL_IN_STEP)

    def _hold(self, e: BaseException, kind: int,
              step: Optional[int] = None) -> None:
        """Keep this rank's first failure, a FAIL_ ``kind`` after serve
        step ``step`` (this engine's last), until a gather tells it."""
        if self._held is None:
            self._held = (e, self.stats["steps"] if step is None else step,
                          kind)

    @contextlib.contextmanager
    def _holding(self):
        """Around this rank's device work outside the serve step (the
        share, pin, grant, release and expert steps, register writes):
        under a group a failure is held, and the rank's later device
        work skipped (:meth:`_own`), while the host control, and so
        every collective, goes on in step with the other ranks."""
        try:
            yield
        except Exception as e:
            if self.mesh is None:
                raise
            self._hold(e, FAIL_IN_STEP)

    def _sampling_registers(self):
        """Zeroed (temps float32, topks int32, seeds int32) [DP, Bl] on
        the engine's device."""
        shape = (self._dp_dev, self.bl)
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape, dtype=I32, device=self.device),
                torch.zeros(shape, dtype=I32, device=self.device))

    def _expert_mask_register(self):
        """All-True bool [DP, Bl, E] (E = 1 for a model without
        experts) on the engine's device."""
        E = self.cfg.moe.num_experts if self.cfg.moe is not None else 1
        return torch.ones((self._dp_dev, self.bl, E), dtype=torch.bool,
                          device=self.device)

    def _own(self, d: int) -> Optional[int]:
        """Shard ``d``'s row in this process's device state: ``d`` on one
        device; under a group 0 on the rank that owns it, None on the
        others (which skip the device work of the slots of ``d``), and
        None on a rank holding a failure (:meth:`_holding`)."""
        if self.mesh is None:
            return d
        return 0 if d == self.mesh.rank and self._held is None else None

    def _shard_to_device(self, a: np.ndarray) -> torch.Tensor:
        """:meth:`_to_device` of a host buffer with a leading [DP] axis:
        all of it on one device, this rank's row under a group."""
        if self.mesh is not None:
            a = a[self.mesh.rank:self.mesh.rank + 1]
        return self._to_device(np.ascontiguousarray(a))

    def _forget_slot(self, slot: int) -> None:
        """Host bookkeeping of a slot that leaves service without a
        finish: its pending feed, shadows, trie entry, sampling
        registers and host slot."""
        self.pending_tokens.pop(slot, None)
        self._fed.pop(slot, None)
        self._pinned_slots.discard(slot)
        self._clear_sampling(slot)
        if self.prefix_cache is not None:
            self.prefix_cache.remove(slot)
        self._host_free_slot(slot)
        self.scheduler.on_released(slot)

    def _clear_sampling(self, slot: int) -> None:
        if slot in self._sampling_slots:
            self._sampling_slots.discard(slot)
            d, b = divmod(slot, self.bl)
            r = self._own(d)
            if r is not None:
                with self._holding():
                    for reg in (self.temps, self.topks, self.seeds):
                        reg[r, b] = 0

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
        if self.mesh is not None and self.idle():
            # the agreed clock stood still while nothing was owed: bring
            # it to now before stamping the request
            self._sync_clock()
        now = self._clock()
        req.submitted_at = now
        if req.deadline_s > 0 and req.deadline_at == 0.0:
            req.deadline_at = now + req.deadline_s
        # write-ahead: the journal sees every request before the
        # scheduler does, with any resumed token prefix
        self._jrec("submit", rid=req.rid,
                   prompt=[int(t) for t in req.prompt],
                   max_new_tokens=int(req.max_new_tokens),
                   temperature=float(req.temperature),
                   top_k=int(req.top_k), seed=int(req.seed), slo=req.slo,
                   out_tokens=[int(t) for t in req.out_tokens],
                   preemptions=int(req.preemptions),
                   deadline_at=float(req.deadline_at))
        self._tr_begin("request", req.rid, slo=req.slo,
                       prompt_len=len(req.prompt))
        self.tracer.instant("submit", tid=req.rid, slo=req.slo)
        if self.expert_paging:
            # a footprint that cannot fit the expert budget even on an
            # empty shard is unservable: a typed rejection, not a wedge
            need = (EXPERT_PPE * len(self._elayer_slots)
                    * len(self._footprint_of(req)))
            if need > self.expert_budget:
                self.scheduler._count("rejected")
                req.rejected = "too_large"
                self._jrec("reject", rid=req.rid, reason="too_large")
                self._trace_terminal(req, "too_large")
                return Admission(False, "too_large")
        adm = self.scheduler.submit(req, self.est_pages(req))
        if not adm.accepted:
            self._jrec("reject", rid=req.rid, reason=adm.reason)
            self._trace_terminal(req, adm.reason)
        return adm

    def est_pages(self, req: Request) -> int:
        """Worst-case page demand: prompt plus the whole output budget,
        capped at the per-slot capacity."""
        toks = len(req.prompt) + int(req.max_new_tokens)
        toks = min(max(toks, 1), self.capacity)
        return -(-toks // self.cfg.page_size)

    def est_state_blocks(self, req: Request) -> int:
        """CLS_STATE blocks the request holds while admitted: its slot's
        whole bounded state (0 in a single-class pool)."""
        return self._state_blocks

    def free_slot_shards(self) -> set:
        return {s // self.bl for s in self._free_slots}

    def prefix_match(self, req: Request, shard: Optional[int] = None):
        """Trie lookup, restricted to ``shard`` when given (the scheduler
        always restricts: donor pages are shard-local)."""
        if self.prefix_cache is None:
            return None
        toks = (list(req.prompt) + list(req.out_tokens)) or [1]
        return self.prefix_cache.match(toks, shard=shard)

    def pinned_pages_on(self, shard: int) -> int:
        return self.pins.pages_on(shard) if self.pins is not None else 0

    def pinned_pages(self) -> int:
        return self.pins.total_pages() if self.pins is not None else 0

    # ------------------------------------------------------ expert paging
    def _footprint_of(self, req: Request) -> tuple:
        """A request's admitted expert footprint (sorted, deduplicated;
        all experts when unrestricted)."""
        E = self.cfg.moe.num_experts
        if req.experts is None:
            return tuple(range(E))
        return tuple(sorted({int(e) for e in req.experts
                             if 0 <= int(e) < E}))

    def _fp_row(self, fp: tuple) -> np.ndarray:
        row = np.zeros(self.cfg.moe.num_experts, bool)
        row[list(fp)] = True
        return row

    def _fp_entry(self, fp: tuple):
        """(masks, row) of a footprint: the per-table bool [S, E] masks
        the bulk reference step takes, on the device, and the bool [E]
        register row.  Cached: footprints repeat (that is the skew
        admission learns)."""
        ent = self._fp_masks.get(fp)
        if ent is None:
            row = self._fp_row(fp)
            masks = {pos: self._to_device(np.broadcast_to(
                row, (tab.shape[0], row.size)).copy())
                for pos, tab in self.state.expert_tables.items()}
            ent = self._fp_masks[fp] = (masks, row)
        return ent

    def est_expert_pages(self, req: Request, shard: int) -> int:
        """CLS_EXPERT pages a request would load on a shard: 0 for each
        (layer slot, expert) already resident there, EXPERT_PPE for each
        cold one (the scheduler's third admission dimension)."""
        if self.expert_ledger is None:
            return 0
        led = self.expert_ledger
        fp = self._footprint_of(req)
        cold = sum(1 for pos, g in self._elayer_slots for e in fp
                   if not led.resident(shard, pos, g, e))
        return EXPERT_PPE * cold

    def expert_headroom(self, shard: int) -> int:
        """Admissible CLS_EXPERT pages on a shard: the budget less the
        resident pages, plus what LRU eviction of cold experts (no
        active references) can reclaim; hot experts are working set."""
        if self.expert_ledger is None:
            return 1 << 30
        led = self.expert_ledger
        return (self.expert_budget - led.pages_on(shard)
                + led.evictable_pages(shard))

    def expert_pages_resident(self, shard: int) -> int:
        return (0 if self.expert_ledger is None
                else self.expert_ledger.pages_on(shard))

    def _shard_oh(self, d: int) -> torch.Tensor:
        oh = np.zeros(self.dp, bool)
        oh[d] = True
        return self._shard_to_device(oh)

    def _load_expert(self, d: int, pos: str, g: int, e: int) -> None:
        """One expert's pages onto shard d from the host store: an
        asynchronous copy from page-locked memory on a card (on the
        owning rank under a group; every rank's ledger takes it)."""
        if self._own(d) is not None:
            counts = np.zeros((self.dp, self.bl), np.int32)
            counts[d, 0] = EXPERT_PPE
            with self._holding():
                w = self._host_experts[pos][g, e].to(self.device,
                                                     non_blocking=True)
                self.state = expert_load_step(
                    pos, self.state, self._shard_to_device(counts), w,
                    self._shard_oh(d), g, e)
        self.expert_ledger.add(d, pos, g, e)
        self.telemetry.inc("expert_load_pages", EXPERT_PPE)

    def _evict_expert(self, key) -> None:
        d, pos, g, e = key
        self.expert_ledger.remove(key)
        if self._own(d) is not None:
            with self._holding():
                self.state = expert_evict_step(pos, self.state,
                                               self._shard_oh(d), g, e)
        self.telemetry.inc("expert_evictions")
        self.telemetry.inc("expert_evict_pages", EXPERT_PPE)

    def _admit_experts(self, slot: int, req: Request) -> None:
        """Bind the slot's expert footprint: set its router-mask row
        (both engines: token identity holds by construction), and when
        paging make every footprint expert resident (LRU eviction for
        room; the scheduler's placement checked the headroom) and take
        one reference per page for the slot."""
        if self.cfg.moe is None:
            return
        d, b = divmod(slot, self.bl)
        r = self._own(d)
        fp = self._footprint_of(req)
        if self.expert_ledger is None:
            if r is not None:
                with self._holding():
                    self.expert_mask[r, b] = self._to_device(
                        self._fp_row(fp))
            return
        if r is not None:
            with self._holding():
                self.expert_mask[r, b] = self._to_device(self._fp_entry(fp)[1])
        led = self.expert_ledger
        keys = [(d, pos, g, e) for pos, g in self._elayer_slots for e in fp]
        for key in keys:
            if led.resident(*key):
                led.touch(key)
                self.telemetry.inc("expert_admit_hits")
                continue
            self.telemetry.inc("expert_admit_misses")
            while led.pages_on(d) + EXPERT_PPE > self.expert_budget:
                victim = led.lru(d)
                assert victim is not None, (
                    "expert admission over budget with nothing evictable: "
                    "the scheduler's headroom check was violated")
                self._evict_expert(victim)
            self._load_expert(*key)
        # one bulk addref over the whole footprint
        if self._own(d) is not None:
            with self._holding():
                self.state = expert_ref_step(False, self.state,
                                             self._fp_entry(fp)[0],
                                             self._shard_oh(d))
        for key in keys:
            led.addref(key)
        self._slot_experts[slot] = (d, fp)
        peak = max(led.pages_on(s) for s in range(self.dp))
        self.telemetry.set_max("expert_pages_resident_peak", peak)

    def _release_experts(self, slot: int, device: bool = True) -> None:
        """Drop the slot's expert references and reset its router-mask
        row to all-True (both modes).  ``device=False`` when the step
        that held the references died (shard loss, in-place recovery):
        host bookkeeping only, the reconcile reclaims the pages."""
        if self.cfg.moe is None:
            return
        d, b = divmod(slot, self.bl)
        r = self._own(d)
        if r is not None:
            with self._holding():
                self.expert_mask[r, b] = True
        ent = self._slot_experts.pop(slot, None)
        if ent is None or self.expert_ledger is None:
            return
        d, fp = ent
        if device and self._own(d) is not None:
            with self._holding():
                self.state = expert_ref_step(True, self.state,
                                             self._fp_entry(fp)[0],
                                             self._shard_oh(d))
        for pos, g in self._elayer_slots:
            for e in fp:
                self.expert_ledger.deref((d, pos, g, e))

    def flush_experts(self) -> int:
        """Evict every cold resident expert (a drained engine's teardown
        and leak audits; with active references nothing moves).  Returns
        the number of experts evicted."""
        if self.expert_ledger is None:
            return 0
        cold = [k for k, ent in self.expert_ledger.entries.items()
                if ent["batch"] == 0]
        for key in cold:
            self._evict_expert(key)
        return len(cold)

    def admit(self, req: Request, match, shard: int) -> int:
        """Place a request on ``shard`` (the scheduler chose the order
        and the shard and verified budget and slot availability).  A
        preempted request re-enters here carrying its generated tokens:
        they are fed again (often through the prefix cache) and
        generation resumes at ``out_count == len(out_tokens)``, so the
        resumed stream is the one the request would have produced
        unpreempted."""
        toks = (list(req.prompt) + list(req.out_tokens)) or [1]
        slot = self._host_alloc_slot(shard)
        assert slot is not None, "scheduler admitted without a free slot"
        d, b = divmod(slot, self.bl)
        req.slot = slot
        self.active[slot] = req
        shared_n = 0
        if match is not None:
            shared_n = self._try_share(slot, match, len(toks))
        self.pending_tokens[slot] = toks[shared_n:]
        self._fed[slot] = shared_n
        r = self._own(d)
        if r is not None:
            with self._holding():
                if self._state_blocks > 0:
                    # the slot's bounded-state blocks from the fine
                    # class, one bulk shared-pool pull; the class's §4.2
                    # slack and the scheduler's state budget guarantee
                    # the grant
                    counts = np.zeros((self.dp, self.bl), np.int32)
                    counts[d, b] = self._state_blocks
                    self.state = _alloc_state_step(
                        self.state, self._shard_to_device(counts))
                self.budget[r, b] = int(req.max_new_tokens)
                self.out_count[r, b] = len(req.out_tokens)
                if req.temperature > 0:
                    self.temps[r, b] = float(req.temperature)
                    self.topks[r, b] = int(req.top_k)
                    self.seeds[r, b] = int(req.seed)
        if self._state_blocks > 0:
            self.telemetry.inc("state_blocks_granted", self._state_blocks)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(slot, d, toks)
            self.prefix_cache.update_progress(slot, shared_n)
        if self.spec_store is not None:
            req._spec_key = self.spec_store.key_of(req.prompt)
        if req.temperature > 0:
            self._sampling_slots.add(slot)
        self._admit_experts(slot, req)
        self.telemetry.inc("admitted")
        self._tr_begin("active", req.rid, slot=slot, shard=d)
        self.tracer.instant("admit", tid=req.rid, slot=slot, shard=d,
                            shared_tokens=shared_n)
        if req.out_tokens or req.preemptions:
            self.tracer.instant("resume", tid=req.rid,
                                tokens_done=len(req.out_tokens))
        self._jrec("admit", rid=req.rid, slot=slot, shard=d)
        return slot

    def preempt(self, slot: int) -> Request:
        """Evict a running request: pin its whole-page state when the
        budget allows (so readmission feeds it again through the
        cache), release its pages through the refcounted path, free the
        slot, and hand the request back carrying prompt + generated
        tokens."""
        req = self.active.pop(slot)
        self._maybe_pin(slot, list(req.prompt) + list(req.out_tokens))
        self._release_slot_device(slot)
        self._release_experts(slot)
        self._forget_slot(slot)
        req.slot = None
        req.preemptions += 1
        self.telemetry.inc("preemptions")
        self.tracer.instant("preempt", tid=req.rid, slot=slot)
        self._tr_end("active", req.rid)
        self._jrec("preempt", rid=req.rid)
        return req

    def fail_active(self, slot: int, reason: str, retry: bool = False
                    ) -> Request:
        """Terminate (or retry) a running request that hit a fault or an
        expired deadline: release its pages through the refcounted
        path, free the slot, then either park the request for a retry
        after a bounded backoff or reject it with a typed reason
        (sched.FAILURE_REASONS)."""
        req = self.active.pop(slot)
        self._release_slot_device(slot)
        self._release_experts(slot)
        self._forget_slot(slot)
        req.slot = None
        self._tr_end("active", req.rid)
        if retry and req.retries < self.sched_config.retry_limit:
            req.retries += 1
            self.telemetry.inc("retries")
            self.tracer.instant("retry", tid=req.rid, reason=reason,
                                attempt=req.retries)
            self._jrec("preempt", rid=req.rid)
            self.scheduler.park(
                req, self.sched_config.retry_backoff * req.retries)
        else:
            req.rejected = reason
            self.telemetry.inc("failed")
            if reason == "deadline":
                self.telemetry.inc("deadline_expired")
            self._jrec("reject", rid=req.rid, reason=reason)
            self._trace_terminal(req, reason)
        return req

    def _release_slot_device(self, slot: int) -> None:
        """Release one slot's pages and state through the refcounted
        path, outside the step (on the owning rank under a group)."""
        d, b = divmod(slot, self.bl)
        if self._own(d) is None:
            return
        mask = np.zeros((self.dp, self.bl), bool)
        mask[d, b] = True
        with self._holding():
            self.state, _ = _release_slots(self.state,
                                           self._shard_to_device(mask))

    def _requeue(self, slot: int, reason: str) -> None:
        """Evacuate a running request host-side only (no device release:
        its shard is gone, or the device is mid-operation and the pool
        is reconciled after) and put it back at the head of its class."""
        req = self.active.pop(slot)
        self._release_experts(slot, device=False)
        self._forget_slot(slot)
        req.slot = None
        req.preemptions += 1
        self.telemetry.inc("preemptions")
        self.tracer.instant("preempt", tid=req.rid, slot=slot, reason=reason)
        self._tr_end("active", req.rid)
        self._jrec("preempt", rid=req.rid)
        self.scheduler.requeue_front(req)

    def lose_shard(self, shard: int) -> None:
        """Degrade on shard loss: the dead shard's pages, pins and KV are
        unreachable and leave the accounting with the shard.  Its
        running requests are requeued host-side (they prefill again on a
        survivor, token for token, since generation is a function of
        prompt + out_count); its slots leave service and admission
        shrinks to the survivors."""
        if shard in self.lost_shards:
            return
        self.lost_shards.add(shard)
        self.telemetry.inc("shards_lost")
        self.tracer.instant("shard_loss", shard=shard)
        self._jrec("shard_lost", shard=shard)
        self.scheduler.lose_shard(shard)
        for slot in [s for s in self.active if s // self.bl == shard]:
            self._requeue(slot, "shard_loss")
        if self.expert_ledger is not None:
            self.expert_ledger.drop_shard(shard)
        self._free_slots = deque(
            s for s in self._free_slots if s // self.bl != shard)
        if self.pins is not None:
            for pid in [p for p, e in self.pins.entries.items()
                        if e["shard"] == shard]:
                self.pins.remove(pid)
                if self.prefix_cache is not None:
                    self.prefix_cache.pin_remove(pid)
                self._jrec("unpin", pin_id=pid)
        if self.prefix_cache is not None:
            self.prefix_cache.roots.pop(shard, None)

    # ------------------------------------------------------------ pinning
    def _maybe_pin(self, slot: int, tokens: List[int]) -> None:
        """Pin the slot's resident whole pages for ``tokens`` (a prompt
        at prefill completion, prompt + generated at preemption) under
        the scheduler's pin policy.  An exact key already pinned only
        refreshes its LRU place."""
        if self.pins is None:
            return
        d, b = divmod(slot, self.bl)
        psz = self.cfg.page_size
        n_pages = min(len(tokens), self._fed.get(slot, 0)) // psz
        if n_pages < 1:
            return
        key_toks = tokens[:n_pages * psz]
        hit = self.pins.lookup(d, key_toks)
        if hit is not None:
            self.pins.touch(hit)
            return
        if not self.scheduler.may_pin(self, d, n_pages):
            return
        pin_id = self.pins.add(d, key_toks, n_pages)
        row = pin_id % self.pins.npin
        if self._own(d) is not None:
            pin_oh = np.zeros((self.dp, self.pins.npin), bool)
            pin_oh[d, row] = True
            src = np.zeros((self.dp, self.bl), bool)
            src[d, b] = True
            with self._holding():
                pool, self.pin_tables = pin_prefix_step(
                    self.state.pool, self.pin_tables,
                    self.state.page_tables, self._shard_to_device(pin_oh),
                    self._shard_to_device(src), n_pages)
                self.state = self.state._replace(pool=pool)
        self.prefix_cache.pin_insert(pin_id, d, key_toks)
        self.telemetry.inc("pins_created")
        self.tracer.instant("pin", pin_id=pin_id, shard=d,
                            pages=int(n_pages))
        # write-behind: journaled after the device op; a crash between
        # leaves device references the journal never saw, which recovery
        # reclaims
        self._jrec("pin", pin_id=pin_id, shard=d, row=row,
                   tokens=[int(t) for t in key_toks], pages=int(n_pages))

    def evict_pin(self, pin_id: int) -> None:
        """Drop the cache's references on one pinned row (mechanism;
        the scheduler picks which and when)."""
        shard, row = self.pins.remove(pin_id)
        if self._own(shard) is not None:
            oh = np.zeros((self.dp, self.pins.npin), bool)
            oh[shard, row] = True
            with self._holding():
                pool, self.pin_tables = unpin_step(
                    self.state.pool, self.pin_tables,
                    self._shard_to_device(oh))
                self.state = self.state._replace(pool=pool)
        self.prefix_cache.pin_remove(pin_id)
        self.tracer.instant("unpin", pin_id=pin_id, shard=shard)
        self._jrec("unpin", pin_id=pin_id)

    def flush_pins(self) -> int:
        """Evict every pinned prefix; returns how many.  After a full
        drain and a flush, page occupancy must be exactly zero."""
        if self.pins is None:
            return 0
        ids = list(self.pins.entries)
        for pin_id in ids:
            self.evict_pin(pin_id)
        return len(ids)

    def _try_share(self, slot: int, match, prompt_len: int) -> int:
        """Map the matched prefix onto the donor's pages (one device
        step, off the per-token path).  The donor is a live slot or a
        pinned row.  Returns the number of tokens now resident in the
        slot's KV (0 = no sharing)."""
        assert match.shard == slot // self.bl, (
            "cross-shard donor: page ids never alias across shards; the "
            "scheduler must match shard-locally")
        psz = self.cfg.page_size
        n = min(match.n_tokens, prompt_len - 1, self.capacity - 1)
        if n < psz:
            return 0
        dst = np.zeros((self.dp, self.bl), bool)
        dst[slot // self.bl, slot % self.bl] = True
        pin_id = pin_id_of(match.slot) if match.pinned else None
        # under a group only the owning rank runs the step; the others'
        # state would not change, and their verdict is False
        ok = False
        if self._own(match.shard) is not None:
            with self._holding():
                if match.pinned:
                    pin_oh = np.zeros((self.dp, self.pins.npin), bool)
                    pin_oh[match.shard,
                           self.pins.entries[pin_id]["row"]] = True
                    self.state, ok = share_pinned_step(
                        psz, self.state, self.pin_tables,
                        self._shard_to_device(dst),
                        self._shard_to_device(pin_oh), n)
                else:
                    src = np.zeros((self.dp, self.bl), bool)
                    src[match.slot // self.bl, match.slot % self.bl] = True
                    self.state, ok = share_prefix_step(
                        psz, self.state, self._shard_to_device(dst),
                        self._shard_to_device(src), n)
        self.admission_transfers += 1
        if self.mesh is not None:
            self.agreements += 1
            ok = self.mesh.agree(ok)
        if not bool(ok):   # shared pool dry for the COW page: no sharing
            return 0
        rid = self.active[slot].rid
        if match.pinned:
            self.pins.touch(pin_id)
            self.telemetry.inc("pin_hit_reqs")
            self.telemetry.inc("pin_hit_tokens", n)
            self.tracer.instant("pin_hit", tid=rid, tokens=n)
        self.telemetry.inc("prefix_shared_tokens", n)
        self.telemetry.inc("prefix_shared_reqs")
        self.tracer.instant("share", tid=rid, tokens=n, shard=match.shard,
                            pinned=bool(match.pinned))
        if n % psz != 0:
            # the slot got a private copy of the donor's partial tail
            # page, counted here at the share step (COW never happens
            # inside the serve step)
            self.telemetry.inc("cow_copies")
            self.tracer.instant("cow_copy", tid=rid)
        return n

    # -------------------------------------------------------------- step
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host -> device without a sync: a non-blocking copy from pinned
        memory on a card, a plain tensor on the CPU."""
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _status_to_host(self, status: Optional[torch.Tensor],
                        T: int) -> np.ndarray:
        """The step's one device -> host transfer, counted.  Under a DP
        group it is also the step's one collective: this rank's status,
        with its trailing rows, gathered from every rank; rank 0's clock
        becomes every rank's, and its cost of the previous step goes to
        the gate and the watchdog (:meth:`_observe_cost`).  A rank whose
        step failed sends zeros (``status`` None) and its failure flag,
        and every rank raises at this gather (:meth:`_read_trail`)."""
        self.host_transfers += 1
        if self.mesh is None:
            return status.cpu().numpy()
        self.collectives += 1
        if status is None:
            status = self._to_device(np.zeros(
                (T + 3 + self.n_classes * N_CTR, 1, self.bl), np.int32))
        rows = self._to_device(self._trail(self._step_dt))
        got = self.mesh.gather_status(torch.cat([status, rows]))
        trail = got[-TRAIL_ROWS:]
        self._shared_now, dt = _read_clock(trail)
        self._group_verdict = None
        if dt is not None and self._cost_key is not None:
            self._group_verdict = self._observe_cost(self._cost_key, dt)
        self._read_trail(trail, in_step=True)
        return got[:-TRAIL_ROWS]

    def _sync_clock(self, construction: bool = False) -> None:
        """Under a DP group, one gather of the trailing rows alone: rank
        0's wall clock becomes every rank's.  The status gather moves
        the agreed clock on every serve step; an engine with nothing
        owed runs none, so this one runs at construction, at a submit to
        an idle engine, at an idle step that leaves work owed and after
        an in-place recovery (:meth:`run`), where it tells a rank's
        failed recovery to every rank.  Every rank decides it from the
        host state they share, so all call it at the same point; counted
        in ``clock_syncs``.  At construction
        the ranks also compare their fault schedules: a schedule that
        not every rank holds is its rank's alone (:meth:`_fire`)."""
        self.clock_syncs += 1
        got = self.mesh.gather_status(self._to_device(self._trail(None)))
        self._shared_now = _read_clock(got)[0]
        if construction:
            mine = int(got[TRAIL_SCHEDULE, self.mesh.rank, 0])
            self._faults_alone = bool(mine) and any(
                int(x) != mine for x in got[TRAIL_SCHEDULE, :, 0])
        self._read_trail(got, in_step=False)

    def _trail(self, dt: Optional[float]) -> np.ndarray:
        """This rank's trailing rows: its clock, ``dt``, the failure it
        holds (cleared once the gather has told it, :meth:`_read_trail`)
        and its schedule's checksum."""
        fail, fail_step = 0, 0
        if self._held is not None:
            fail_step, fail = self._held[1:]
        return _trail_rows(self._local_clock(), dt, fail, fail_step,
                           0 if self._injector is None
                           else self._injector.digest(), self.bl)

    def _read_trail(self, trail: np.ndarray, in_step: bool) -> None:
        """Raise on every rank if a gather carried a rank's failure
        (:func:`_raise_told`); the failure this rank held is told."""
        held, self._held = self._held, None
        _raise_told(trail, self.mesh.size, in_step,
                    None if held is None else held[0])

    def _observe_cost(self, key: Tuple[int, bool], dt: float
                      ) -> Optional[str]:
        """A serve step's wall time ``dt``: the gate's per-step cost
        model, an EWMA keyed by (lane width, spec) whose first sample of
        a key is discarded, and the watchdog, whose verdict is
        returned."""
        if key in self._cost_seen:
            prev = self._step_cost.get(key)
            self._step_cost[key] = dt if prev is None else (
                0.8 * prev + 0.2 * dt)
        else:
            self._cost_seen.add(key)
        verdict = self.watchdog.observe(self.stats["steps"], dt)
        if verdict == "straggler":
            self.telemetry.inc("stragglers")
        elif verdict == "timeout":
            self.telemetry.inc("step_timeouts")
        if verdict is not None:
            self.tracer.instant("watchdog", verdict=verdict,
                                step=self.stats["steps"])
        return verdict

    def _gate_k(self, key, k_max: int) -> int:
        """Break-even draft length for this prefix.

        Expected tokens per step at accept rate ``a`` with k drafts are
        ``1 + a + ... + a^k``; a width-(k+1) verify step costs
        ``cost(k+1, spec) / cost(1, decode)`` plain steps, from the
        measured per-step EWMA when both widths have run, else the
        linear fallback model.  Returns the largest k <= k_max whose
        expected tokens clear its cost, or 0 to skip drafting.  An
        unmeasured prefix drafts at k_max.
        """
        if not self.spec_gate or k_max <= 0:
            return k_max
        a = self.spec_store.accept_rate(key)
        if a is None:
            return k_max
        c1 = self._step_cost.get((1, False))
        exp_tokens = 1.0
        gain = 1.0
        best = 0
        for k in range(1, k_max + 1):
            gain *= a
            exp_tokens += gain
            ck = self._step_cost.get((k + 1, True))
            ratio = (ck / c1 if c1 and ck
                     else 1.0 + self.spec_cost_slope * k)
            if exp_tokens >= ratio:
                best = k
        return best

    def _build_drafts(self, limit: int) -> Dict[int, List[int]]:
        """Draft proposals for this step's generating slots, from the
        continuation store, once per (prefix, context): never reads
        device state.  Drafts stay within the slot's page-table
        capacity and output budget, and the accept-rate gate shrinks or
        zeroes them."""
        out: Dict[int, List[int]] = {}
        if limit <= 0:
            return out
        memo: Dict[tuple, List[int]] = {}
        for slot, req in self.active.items():
            if self.pending_tokens[slot] or req._spec_key is None:
                continue
            key = req._spec_key
            k = min(limit, self.draft_len,
                    self.capacity - 1 - self._fed[slot],
                    req.max_new_tokens - len(req.out_tokens) - 1)
            if k <= 0:
                continue
            k_gated = self._gate_k(key, k)
            if k_gated <= 0:
                self.telemetry.inc("spec_gate_skips")
                continue
            suffix = tuple(req.prompt[len(key):]) + tuple(req.out_tokens)
            mk = (key, suffix, k_gated)
            if mk not in memo:
                memo[mk] = self.spec_store.draft(key, suffix, k_gated)
            if memo[mk]:
                out[slot] = memo[mk]
        return out

    def step(self) -> bool:
        """One engine step.  Returns True iff device work was dispatched
        (False = idle fast-path: nothing active after admission).

        The ``_fire`` points are the fault-injection phase boundaries
        (serving/chaos.py PHASES): ``feed`` fires before any per-slot
        feed mutation, so a fault there leaves host and device
        consistent; ``post_sync`` fires after the status download but
        before the bookkeeping and the journal, so a crash there loses
        the step's tokens and recovery must draw them again."""
        t0 = time.perf_counter()
        self._fire("pre_tick")
        self.scheduler.tick(self)
        self._fire("post_admission")
        if not self.active:
            self.telemetry.inc("idle_steps")
            if self._held is not None and self._held[2] == FAIL_IN_STEP:
                # no status gather in this step: told as a late failure
                self._held = self._held[:2] + (FAIL_LATE,)
            if self.mesh is not None and self.scheduler.backlog():
                self._sync_clock()     # parked work's deadlines move on
            return False

        # lane widths: the scheduler's prefill bucket, else width 1,
        # widened to draft_len + 1 when an all-decode step has drafts;
        # drafts also ride mixed prompt/decode steps
        any_prompt = any(self.pending_tokens[s] for s in self.active)
        T = self.scheduler.pick_chunk(self, self.chunk) if any_prompt else 1
        drafts: Dict[int, List[int]] = {}
        if self.spec_store is not None:
            if not any_prompt:
                drafts = self._build_drafts(self._spec_T - 1)
                if drafts:
                    T = self._spec_T
            elif T > 1:
                drafts = self._build_drafts(min(self._spec_T, T) - 1)
                if drafts:
                    self.telemetry.inc("spec_mixed_steps")
        self._fire("feed", rids={req.rid: slot
                                 for slot, req in self.active.items()})
        # one host buffer, one upload: [DP, Bl, T + 3] holds the lane
        # tokens, then feed_lens, is_prompt and emit
        feed = np.zeros((self.dp, self.bl, T + 3), np.int32)
        prompt_toks, feed_lens = feed[..., :T], feed[..., T]
        is_prompt, emit = feed[..., T + 1], feed[..., T + 2]
        gen_slots: Dict[int, int] = {}       # slot -> drafts fed
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
                if (emit[d, b] and self.pins is not None
                        and slot not in self._pinned_slots
                        and self._fed[slot]
                        >= len(req.prompt) // self.cfg.page_size
                        * self.cfg.page_size):
                    # the prompt completes this step and its whole pages
                    # are already resident (this chunk covers only the
                    # partial tail): pin before dispatch, since a
                    # request that finishes on this very step releases
                    # inside it and could never pin after
                    self._pinned_slots.add(slot)
                    self._maybe_pin(slot, list(req.prompt))
                self._fed[slot] += n
            else:
                dr = drafts.get(slot, [])
                prompt_toks[d, b, 1:1 + len(dr)] = dr
                feed_lens[d, b] = 1 + len(dr)
                emit[d, b] = 1
                # the KV the lane keeps (== tokens emitted) is known only
                # after verification: _fed advances on the status read
                gen_slots[slot] = len(dr)

        spec = any(gen_slots.values())
        status = None
        if self._held is None:
            try:
                dev = self._shard_to_device(feed)
                (self.state, self.last_tok, self.out_count,
                 status) = _serve_step(
                    self.cfg, self.capacity, self._eos,
                    bool(self._sampling_slots), spec, self._spec_T,
                    self.params, self.state, self.last_tok, self.out_count,
                    self.budget, self.temps, self.topks, self.seeds,
                    dev[..., :T], dev[..., T], dev[..., T + 1].bool(),
                    dev[..., T + 2].bool(), self.expert_mask)
            except Exception as e:
                if self.mesh is None:
                    raise
                # this rank's device step failed: the others learn it at
                # the status gather, which this rank still joins
                self._hold(e, FAIL_IN_STEP)
        self.telemetry.inc("steps")
        self.telemetry.observe_hist("chunk_hist", T)
        self._fire("dispatched")
        status = self._status_to_host(status, T)
        self._fire("post_sync")
        n_emit = status[T + STATUS_EMITTED]
        done_row = status[T + STATUS_DONE]
        pages_row = status[T + STATUS_PAGES]
        ctr_block = status[T + 3:, :, 0]
        self.telemetry.absorb_counter_block(ctr_block)

        self.pages_used_shard = [int(x) for x in pages_row[:, 0]]
        pages_now = int(pages_row[:, 0].sum())
        self.telemetry.set_max("pages_peak", pages_now)
        self.telemetry.inc("pages_sum", pages_now)
        row = pages_row[:, 0].astype(np.int64)
        self._pages_shard_sum += row
        np.maximum(self._pages_shard_peak, row, out=self._pages_shard_peak)

        now = self._clock()
        psz = self.cfg.page_size
        for slot, req in list(self.active.items()):
            d, b = divmod(slot, self.bl)
            ne = int(n_emit[d, b])
            if ne:
                toks = [int(status[j, d, b]) for j in range(ne)]
                req.out_tokens.extend(toks)
                self._jrec("tokens", rid=req.rid, toks=toks)
                self.telemetry.inc("tokens_out", ne)
                if req.first_token_at == 0.0:
                    req.first_token_at = now
                    self._ft_latencies.append(now - req.submitted_at)
                    self.tracer.instant("first_token", tid=req.rid)
            if slot in gen_slots:
                k = gen_slots[slot]
                if k:
                    acc = max(ne - 1, 0)
                    self.telemetry.inc("spec_lanes")
                    self.telemetry.inc("spec_drafted", k)
                    self.telemetry.inc("spec_accepted", acc)
                    self.telemetry.observe_hist("accept_hist", acc)
                    self.tracer.instant("spec_accept", tid=req.rid,
                                        drafted=k, accepted=acc)
                    if req._spec_key is not None:
                        self.spec_store.observe(req._spec_key, k, acc)
                    # whole-page rollback, from the _fed shadow: the
                    # lane fed 1 + k tokens and kept ne
                    fed0 = self._fed[slot]
                    over = (-(-(fed0 + 1 + k) // psz)
                            - (-(-(fed0 + ne) // psz)))
                    self.telemetry.inc("spec_pages_rolled_back", over)
                    if over:
                        self.tracer.instant("spec_rollback",
                                            tid=req.rid, pages=over)
                self._fed[slot] += ne
            if done_row[d, b]:
                # pages were already released inside the step
                req.done = True
                req.finished_at = now
                self._latencies.append(now - req.submitted_at)
                self.active.pop(slot)
                self._release_experts(slot)
                self.pending_tokens.pop(slot, None)
                self._pinned_slots.discard(slot)
                self._clear_sampling(slot)
                if self.prefix_cache is not None:
                    self.prefix_cache.remove(slot)
                if self.spec_store is not None and req._spec_key:
                    # this finished stream drafts for its hot prefix
                    self.spec_store.record(
                        req._spec_key,
                        tuple(req.prompt[len(req._spec_key):])
                        + tuple(req.out_tokens))
                self._host_free_slot(slot)
                self.scheduler.on_released(slot)
                self.tracer.instant("finish", tid=req.rid,
                                    tokens=len(req.out_tokens))
                self._tr_end("active", req.rid)
                self._tr_end("request", req.rid)
                self._jrec("finish", rid=req.rid)
            else:
                if self.prefix_cache is not None:
                    # this step's feed is in device KV now: the slot can
                    # donate that much of its prompt
                    self.prefix_cache.update_progress(slot,
                                                      self._fed[slot])
                if (self.pins is not None
                        and slot not in self._pinned_slots
                        and not self.pending_tokens[slot]):
                    # the prompt is resident (this step's pages too: the
                    # pin runs after the step that allocated them): keep
                    # its whole pages past the request's lifetime
                    self._pinned_slots.add(slot)
                    self._maybe_pin(slot, list(req.prompt))
        self._fire("post_step")
        dt = time.perf_counter() - t0
        if self.mesh is None:
            verdict = self._observe_cost((T, spec), dt)
        else:
            # this rank's wall time goes out with the next status gather;
            # the verdict is of rank 0's previous step, from this one's
            self._step_dt, self._cost_key = dt, (T, spec)
            verdict = self._group_verdict
        self.flight.record(
            step=self.stats["steps"], t=now, T=T, spec=spec,
            status=status.tolist(), ctr=ctr_block.tolist(),
            drafts={int(s): len(d) for s, d in drafts.items()},
            rids={int(s): int(r.rid) for s, r in self.active.items()},
            watchdog=verdict, dt_ms=round(dt * 1e3, 3))
        if verdict == "timeout" and self.flight.dump(
                "watchdog_timeout", {"step": self.stats["steps"]}):
            self.telemetry.inc("flight_dumps")
            self.tracer.instant("flight_dump", reason="watchdog_timeout")
        return True

    def idle(self) -> bool:
        """Nothing running and nothing admissible."""
        return not self.active and self.scheduler.backlog() == 0

    def host_state(self) -> str:
        """The host control every rank of a DP group must hold alike, as
        one string: the slot map, the feeds, the free slots, the queues,
        the pin and expert ledgers, the trie's slots, the gate's step
        costs, the clock and the counters.  Ranks whose strings stay
        equal step after step are in lockstep."""
        pc, led = self.prefix_cache, self.expert_ledger
        return repr((
            sorted((s, r.rid, len(r.out_tokens))
                   for s, r in self.active.items()),
            sorted((s, len(p)) for s, p in self.pending_tokens.items()),
            sorted(self._fed.items()), sorted(self._free_slots),
            [r.rid for r in self.scheduler.pending()],
            self.pins.to_state() if self.pins is not None else None,
            (sorted(pc.completed.items()), sorted(pc.shard_of.items()))
            if pc is not None else None,
            sorted(led.entries.items()) if led is not None else None,
            sorted(self._step_cost.items()), self._clock(),
            dict(self.stats)))

    def run(self, max_steps: int = 10_000,
            max_restarts: Optional[int] = None) -> None:
        """Step until idle or ``max_steps``, surviving faults.

        * :class:`~.chaos.PoisonedRequest` fails exactly the offending
          request (bounded retry, then ``rejected="poisoned"``);
        * :class:`~.chaos.HostCrash` re-raises after a flight dump: the
          host state is gone and only :func:`~.chaos.recover_engine`
          may rebuild it;
        * any other exception recovers in place (active work requeued,
          the pool reconciled), counted in telemetry ``recoveries``, and
          past the restart budget re-raises after recovering, so the
          pool is conserved on that path too.

        Under a DP group only a :class:`~.chaos.StepError` recovers in
        place: one raised alike on every rank (an injected ``error``, or
        a rank's failure told at the step's status gather), so every
        rank's restart count and budget move together.  Anything else
        (:class:`~.chaos.RankFailure` included) re-raises.  After the
        in-place recovery every rank joins one gather of the trailing
        rows (:meth:`_sync_clock`): a rank whose recovery raised holds
        the failure into it, and every rank raises
        :class:`~.chaos.RankFailure` there.
        """
        budget = self.max_restarts if max_restarts is None else max_restarts
        restarts = 0
        for _ in range(max_steps):
            if self.idle():
                break
            try:
                self.step()
            except PoisonedRequest as e:
                if e.slot in self.active:
                    self.fail_active(e.slot, "poisoned", retry=True)
            except HostCrash:
                self.tracer.instant("crash", step=self.stats["steps"])
                if self.flight.dump("host_crash",
                                    {"step": self.stats["steps"]}):
                    self.telemetry.inc("flight_dumps")
                raise
            except Exception as e:
                if self.mesh is not None and not isinstance(e, StepError):
                    raise
                restarts += 1
                if self.flight.dump("step_error",
                                    {"step": self.stats["steps"],
                                     "error": repr(e)}):
                    self.telemetry.inc("flight_dumps")
                    self.tracer.instant("flight_dump", reason="step_error")
                try:
                    self._recover_inplace()
                except Exception as failed:
                    if self.mesh is None:
                        raise
                    # this rank's recovery failed: held for the gather
                    # below, which this rank still joins
                    self._hold(failed, FAIL_RECOVERY)
                if self.mesh is not None:
                    # every rank recovered at this point: a failed
                    # recovery raises RankFailure on every rank here,
                    # before any rank serves on a partly recovered engine
                    self._sync_clock()
                if restarts > budget:
                    raise

    # ----------------------------------------------------- crash recovery
    def adopt_crashed_state(self, dead_state: DecodeState,
                            pin_np: Optional[np.ndarray]) -> dict:
        """Install a crashed engine's surviving device state: keep the
        KV page content (pinned pages' data lives there), rebuild the
        pool against the trusted pin rows
        (:func:`classed_pool.audit_and_reconcile`, back on the engine's
        device), and clear every per-slot mapping and register, since
        all in-flight work re-enters through the preemption-resume
        path.  Under a DP group ``dead_state`` and ``pin_np`` are this
        rank's shard and pin row, and the report is of that shard.
        Returns the reconcile report."""
        assert not self.active, "adopt with active slots"
        C = len(dead_state.pool.classes)
        # pins live only in the KV class
        pins = None if pin_np is None else [pin_np] + [None] * (C - 1)
        pool, report = classed_pool.audit_and_reconcile(
            dead_state.pool, keep_tables=None, pin_tables=pins)
        state = dead_state._replace(
            pool=pool, page_tables=torch.full_like(dead_state.page_tables,
                                                   NULL),
            seq_lens=torch.zeros_like(dead_state.seq_lens),
            rings={p: tuple(torch.zeros_like(t) for t in kv)
                   for p, kv in dead_state.rings.items()},
            rec=tree_map(torch.zeros_like, dead_state.rec))
        if dead_state.state_tables is not None:
            state = state._replace(
                state_tables=torch.full_like(dead_state.state_tables, NULL))
        if dead_state.expert_tables is not None:
            # no keep or pin rows for CLS_EXPERT: the reconcile reclaimed
            # every expert page, so the tables go NULL, the ledger
            # empties and the next admissions load again from the host
            state = state._replace(expert_tables={
                pos: torch.full_like(tab, NULL)
                for pos, tab in dead_state.expert_tables.items()})
            if self.expert_ledger is not None:
                self.expert_ledger.clear()
            self._slot_experts.clear()
        self.state = state
        self.last_tok, self.out_count, self.budget = empty_serve_arrays(
            self._dp_dev, self.bl, self.device)
        self.temps, self.topks, self.seeds = self._sampling_registers()
        self.expert_mask = self._expert_mask_register()
        if self.pin_tables is not None:
            self.pin_tables = (
                torch.as_tensor(pin_np, dtype=I32, device=self.device)
                if pin_np is not None else torch.full_like(self.pin_tables,
                                                           NULL))
        self.pending_tokens.clear()
        self._fed.clear()
        self._pinned_slots.clear()
        self._sampling_slots.clear()
        self.tracer.instant(
            "reconcile", reclaimed=int(report["reclaimed"]),
            resurrected=int(report["resurrected"]),
            clamped=int(report["clamped"]),
            never_dry=bool(report["never_dry"]),
            conserved=bool(report["conserved"]))
        if self.flight.dump("audit_and_reconcile", {"report": report}):
            self.telemetry.inc("flight_dumps")
        return report

    def _trusted_pins(self) -> Optional[np.ndarray]:
        """The device pin table on the host (this rank's row under a
        group) with every row the pin ledger does not hold set to NULL
        (None without pins)."""
        if self.pin_tables is None:
            return None
        pin_np = self.pin_tables.cpu().numpy().copy()
        ok = np.zeros((self.dp, pin_np.shape[1]), bool)
        for e in self.pins.entries.values():
            ok[e["shard"], e["row"]] = True
        if self.mesh is not None:
            ok = ok[self.mesh.rank:self.mesh.rank + 1]
        pin_np[~ok] = NULL
        return pin_np

    def _recover_inplace(self) -> dict:
        """Restore a consistent engine after a failed step without
        losing the process: requeue every active request (host
        bookkeeping only: the device may be mid-operation) and rebuild
        the pool from the pin rows the ledger trusts; a device pin whose
        ledger entry never landed is reclaimed, as after a crash.  Under
        a DP group every rank runs it at the same point, on its own
        shard, with no collective; the step costs waiting to be observed
        are dropped alike on every rank, and a raise here is held by
        :meth:`run` and told at the gather that follows."""
        self.telemetry.inc("recoveries")
        self.tracer.begin("recover", kind="inplace")
        for slot in list(self.active):
            self._requeue(slot, "recovery")
        report = self.adopt_crashed_state(self.state, self._trusted_pins())
        self._step_dt = self._cost_key = self._group_verdict = None
        self.tracer.end("recover")
        return report

    # ------------------------------------------------------- warm restart
    def save_warm(self, ckptr, step: int = 0) -> None:
        """Persist the serving plane's warm state through the
        checkpointer: the DecodeState (pool and pinned KV content), the
        device pin table, and a JSON sidecar with the host ledgers (pin
        entries, speculation streams, queued requests).  Must be called
        drained: queued work requeues exactly, but a running slot's KV
        is not consistent with a host mid-step.

        Under a DP group every rank calls it at the same point with a
        checkpointer of its own shard (``Checkpointer(dir,
        shard_id=rank)``): each rank writes its shard's state and pin
        row, rank 0 alone the sidecar, and after one gather of the
        ranks' done flags rank 0 writes the completion marker, listing
        every shard, only when every file has landed; otherwise every
        rank raises."""
        assert not self.active, "drain the engine before a warm save"
        ckptr.wait()
        payload = {"state": self.state}
        if self.pin_tables is not None:
            payload["pin_tables"] = self.pin_tables
        aux = {
            "pins": (self.pins.to_state() if self.pins is not None else []),
            "spec": (self.spec_store.to_state()
                     if self.spec_store is not None else None),
            "queued": [{
                "rid": int(r.rid),
                "prompt": [int(t) for t in r.prompt],
                "max_new_tokens": int(r.max_new_tokens),
                "temperature": float(r.temperature),
                "top_k": int(r.top_k), "seed": int(r.seed), "slo": r.slo,
                "out_tokens": [int(t) for t in r.out_tokens],
                "preemptions": int(r.preemptions),
                "deadline_at": float(r.deadline_at),
            } for r in self.scheduler.pending()],
        }
        if self.mesh is None:
            ckptr.save(step, payload, aux=aux)
            return
        err = None
        try:
            if ckptr.shard_id != self.mesh.rank:
                raise ValueError(f"rank {self.mesh.rank} saves through a "
                                 f"checkpointer of shard {ckptr.shard_id}")
            ckptr.save(step, payload, aux=aux if self.mesh.rank == 0
                       else None, complete=False)
        except Exception as e:           # told to every rank, then raised
            err = e
        done = self.mesh.gather(torch.tensor([int(err is None)])).cpu()
        if int(done.min()) == 1 and self.mesh.rank == 0:
            ckptr.mark_complete(step, list(range(self.mesh.size)))
        if err is not None:
            raise err
        if int(done.min()) != 1:
            raise RuntimeError(
                f"save_warm: the shard files of ranks "
                f"{[r for r, x in enumerate(done.tolist()) if not x]} did "
                f"not land; step {step} is not marked complete")

    def restore_warm(self, ckptr, step: Optional[int] = None) -> int:
        """Rebuild a freshly built engine from a warm save: adopt the
        device arrays (pool, pinned KV pages, pin table) on this
        engine's device, reload the pin ledger, the trie's pin entries
        and the speculation store, and resubmit the queued requests.
        The first hot-prefix request after the restart shares pinned
        pages and drafts without prefilling again.  Under a DP group
        every rank restores its own shard file and pin row and reads
        rank 0's sidecar."""
        if step is None:
            step = ckptr.latest_step()
        assert step is not None, "no complete warm checkpoint to restore"
        like = {"state": self.state}
        if self.pin_tables is not None:
            like["pin_tables"] = self.pin_tables
        got = ckptr.restore(step, like)
        self.state = got["state"]
        if self.pin_tables is not None and "pin_tables" in got:
            self.pin_tables = got["pin_tables"]
        aux = ckptr.restore_aux(step) or {}
        if self.pins is not None and aux.get("pins"):
            self.pins.load_state(aux["pins"])
            if self.prefix_cache is not None:
                for pid, e in self.pins.entries.items():
                    self.prefix_cache.pin_insert(pid, e["shard"],
                                                 list(e["tokens"]))
        if self.spec_store is not None and aux.get("spec"):
            self.spec_store.load_state(aux["spec"])
        for spec in aux.get("queued", []):
            req = Request(rid=int(spec["rid"]), prompt=list(spec["prompt"]),
                          max_new_tokens=int(spec["max_new_tokens"]),
                          temperature=float(spec["temperature"]),
                          top_k=int(spec["top_k"]), seed=int(spec["seed"]),
                          slo=spec["slo"], out_tokens=list(spec["out_tokens"]))
            req.preemptions = int(spec.get("preemptions", 0))
            req.deadline_at = float(spec.get("deadline_at", 0.0))
            self.submit(req)
        return step

    # ------------------------------------------------------------ metrics
    def blocks_in_use(self, cls: int = CLS_KV) -> int:
        """Blocks of one size class currently referenced across shards
        (shared pages count once).  Under a group a collective: every
        rank calls it at the same point."""
        total = classed_pool.pages_local(self.state.pool, cls) * self.dp
        free = hier_pool.total_free(self.state.pool.classes[cls])
        if self.mesh is not None:
            free = self._gather_read(free).sum()
        return total - int(free)

    def pages_in_use(self) -> int:
        """Physical KV pages currently referenced across shards."""
        return self.blocks_in_use(CLS_KV)

    def page_occupancy(self) -> float:
        return self.pages_in_use() / (self.pages_local * self.dp)

    def shard_occupancy(self) -> Dict[str, list]:
        """Per-shard pages in use over the run, from the status row's
        PAGES entries (no extra transfer; under a group no collective
        either, since every rank holds the gathered status)."""
        steps = max(self.stats["steps"], 1)
        return {
            "pages_mean_shard": [round(float(x) / steps, 1)
                                 for x in self._pages_shard_sum],
            "pages_peak_shard": [int(x) for x in self._pages_shard_peak],
            "mesh_devices": 0 if self.mesh is None else self.mesh.size,
        }

    def leak_free(self) -> bool:
        """Zero live blocks of every class on every surviving shard (the
        post-drain invariant; a lost shard's pages left the accounting
        with the shard).  Under a group a collective: every rank calls
        it at the same point."""
        live = sum(classed_pool.live_per_shard(self.state.pool, c)
                   for c in range(self.n_classes))
        if self.mesh is not None:
            live = self._gather_read(live)
        live = live.cpu()
        return all(int(live[s]) == 0 for s in range(self.dp)
                   if s not in self.lost_shards)

    def _gather_read(self, local: torch.Tensor) -> torch.Tensor:
        """A read outside the step under a group: ``local`` (one value)
        from every rank, in rank order, with this rank's held failure
        beside it, so a failure after a run's last status gather is told
        here at the latest (:meth:`_read_trail`)."""
        fail, step = 0, 0
        if self._held is not None:
            step, fail = self._held[1:]
            fail = FAIL_LATE if fail == FAIL_IN_STEP else fail
        mine = torch.tensor([int(local.reshape(-1)[0]), fail, step],
                            dtype=torch.int64)
        got = self.mesh.gather(mine).reshape(self.mesh.size, 3).cpu()
        trail = np.zeros((TRAIL_ROWS, self.mesh.size, 1), np.int64)
        trail[TRAIL_FAIL, :, 0] = got[:, 1].numpy()
        trail[TRAIL_FAIL_STEP, :, 0] = got[:, 2].numpy()
        self._read_trail(trail, in_step=False)
        return got[:, 0]

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
