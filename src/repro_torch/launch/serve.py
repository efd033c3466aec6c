"""The serving driver: continuous batching over the port's paged-KV
engine.

Counterpart of the JAX package's ``launch/serve.py``, with the same
flags, the same synthetic trace (``np.random.RandomState(0)``) and the
same printed summary, and ``--device`` (``cuda`` unless ``cpu`` is
asked for).  Weights are random, from seed 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --smoke --device cpu --requests 16 --pin-pages 8

Scheduler knobs: ``--pin-pages`` keeps hot prompt prefixes pinned
across request lifetimes, ``--page-budget`` tightens per-shard
admission (deferral and preemption under load), ``--interactive-frac``
puts a fraction of the requests in the higher-priority class.  Lane
knobs: ``--chunk-buckets`` (prefill lane widths the scheduler may
shrink to), ``--speculate``/``--draft-len`` (speculative decoding on
shared prefixes; ``--repeat-frac`` repeats whole prompts).

Fault knobs: ``--inject-fault kind@step:phase[:extra]`` injects host
crashes, shard loss, stragglers, step errors and poisoned requests at
the engine's phase boundaries (serving/chaos.py); ``main`` recovers
each crash by rebuilding the engine and reconciling the pool from the
surviving device state and the journal, then asserts that the run
drained with no page leaked on a surviving shard.  ``--deadline-s``
gives every request a deadline.

Expert knobs (MoE archs): ``--expert-paging`` (or ``--size-classes
3``) pages the expert weights through the pool's third size class,
``--expert-budget N`` caps the resident expert pages per shard (0 =
full residency), ``--expert-frac F`` restricts that fraction of the
requests to a random half of the experts (the routing skew load-aware
admission learns).  In one process expert paging needs ``--dp 1``; on
ranks (below) each shard pages its own experts.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --smoke --device cpu --dp 1 --expert-paging --expert-budget 12 \\
      --expert-frac 0.5

The allocation plane: under ``torchrun`` (``WORLD_SIZE`` > 1) ``--mesh
auto`` runs one rank per DP shard (:mod:`repro_torch.launch.mesh`) over
``--dist-backend``: ``nccl`` with one rank per card, or ``gloo`` for CPU
ranks and for ranks sharing one card.  Every rank serves the same
trace; only rank 0 prints.  ``--inject-fault`` runs on the ranks too:
every rank holds the schedule, so each fault fires on every rank at
the same (step, phase); each crash is recovered on every rank (each
rank adopting its own shard), a step error in place on every rank, and
a lost shard's rank stays in the group owning no slot.  Flight dumps of
rank r > 0 go to ``<path>.rank<r>``.  In one process ``--mesh auto`` is
the single-device plane, DP kept as a leading axis, as the reference
does when fewer than ``dp`` devices exist.

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --dp 2 \\
      --mesh auto --dist-backend nccl \\
      --inject-fault crash@3:post_sync,shard_loss@5:post_admission:1
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from .mesh import BACKENDS, make_dp_group
from ..models.model import init_params
from ..serving import chaos
from ..serving.engine import Request, ServingEngine
from ..serving.sched import SchedConfig
from ..serving.telemetry import FlightRecorder, install_signal_dump
from ..serving.trace import Tracer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--b-local", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--pin-pages", type=int, default=0,
                    help="pinned prefix-cache pages per shard (0 = off)")
    ap.add_argument("--page-budget", type=int, default=0,
                    help="admissible worst-case pages per shard "
                         "(0 = pool capacity)")
    ap.add_argument("--interactive-frac", type=float, default=0.0,
                    help="fraction of requests in the interactive class")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decoding on shared prefixes")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="draft tokens per speculative lane")
    ap.add_argument("--no-spec-gate", action="store_true",
                    help="disable the per-prefix accept-rate break-even "
                         "gate: always draft at full draft-len")
    ap.add_argument("--chunk-buckets", default="",
                    help="comma-separated SLO-aware prefill lane widths "
                         "(e.g. 1,4,8); empty = fixed chunk")
    ap.add_argument("--hot-prefix", type=int, default=0, metavar="N",
                    help="prepend a common N-token prefix to every prompt")
    ap.add_argument("--repeat-frac", type=float, default=0.0,
                    help="fraction of requests repeating a previous full "
                         "prompt (the speculative fast path)")
    ap.add_argument("--size-classes", type=int, default=1,
                    choices=(1, 2, 3),
                    help="allocation-plane size classes: 1 = paged KV, "
                         "2 = add the fine bounded-state class, 3 = add "
                         "the read-only expert-weight class")
    ap.add_argument("--expert-paging", action="store_true",
                    help="page MoE expert weights through the pool's "
                         "expert class (implies --size-classes 3; no-op "
                         "for dense models)")
    ap.add_argument("--expert-budget", type=int, default=0,
                    help="resident expert pages per shard (0 = full "
                         "residency; 3 pages per expert per MoE layer "
                         "slot)")
    ap.add_argument("--expert-frac", type=float, default=0.0,
                    help="fraction of requests restricted to a random "
                         "half of the experts")
    ap.add_argument("--mesh", choices=("auto", "off"), default="auto",
                    help="auto: one rank per DP shard under torchrun "
                         "(WORLD_SIZE > 1), else one process; off: one "
                         "process")
    ap.add_argument("--dist-backend", choices=BACKENDS, default="nccl",
                    help="the ranks' process-group backend: nccl (one "
                         "rank per card) or gloo (CPU ranks, or ranks "
                         "sharing the current card)")
    ap.add_argument("--inject-fault", default="", metavar="SPEC",
                    help="deterministic fault schedule, comma-joined "
                         "kind@step:phase[:extra] (serving/chaos.py)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none)")
    ap.add_argument("--metrics-path", default="", metavar="FILE",
                    help="write a Prometheus text-format telemetry "
                         "snapshot here at the end of the run")
    ap.add_argument("--trace-path", default="", metavar="FILE",
                    help="write the request-lifecycle trace here at the "
                         "end of the run (chrome trace_event JSON; a "
                         ".jsonl suffix writes one event per line)")
    ap.add_argument("--flight-recorder", default="", metavar="FILE",
                    help="flight-recorder dump path: the last steps' "
                         "ring dumps here on SIGTERM")
    ap.add_argument("--flight-sync", type=int, default=0, metavar="N",
                    help="also dump the flight ring every N steps")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device; pass --device cpu to "
                           "serve on the CPU")

    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    group = None
    if ranks > 1:
        if args.mesh == "off":
            raise SystemExit("serve: --mesh off runs one process; launch "
                             "it without torchrun")
        group = make_dp_group(args.dp, args.dist_backend, args.device)
    lead = group is None or group.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_params(cfg, seed=0,
                         device=group.device if group else args.device)
    buckets = tuple(int(b) for b in args.chunk_buckets.split(",") if b)
    faults = bool(args.inject_fault)
    journal = chaos.ServingJournal() if faults else None
    injector = chaos.parse_faults(args.inject_fault) if faults else None
    tracer = Tracer() if args.trace_path else None

    def build():
        # a fresh recorder per build: recover_engine adopts the crashed
        # ring into it, so the forensic window spans the crash
        path = args.flight_recorder or None
        if path and not lead:
            path = f"{path}.rank{group.rank}"
        flight = (FlightRecorder(path=path, sync_every=args.flight_sync)
                  if args.flight_recorder or args.flight_sync else None)
        eng = ServingEngine(
            cfg, params, dp=args.dp, b_local=args.b_local,
            max_len=args.max_len, speculate=args.speculate,
            draft_len=args.draft_len, spec_gate=not args.no_spec_gate,
            size_classes=args.size_classes,
            expert_paging=args.expert_paging,
            expert_budget=(args.expert_budget or None),
            sched=SchedConfig(pin_pages=args.pin_pages,
                              page_budget=args.page_budget,
                              chunk_buckets=buckets),
            journal=journal, injector=injector,
            max_restarts=4, tracer=tracer, flight=flight,
            mesh=group, device=group.device if group else args.device)
        if args.flight_recorder:
            install_signal_dump(eng.flight)
        return eng

    engine = build()
    if group is not None:
        say(f"allocation plane: {group.size} ranks over {group.backend}, "
            f"one DP shard each (rank 0 on {engine.device}), one status "
            f"gather a step")
    else:
        say(f"allocation plane: single device ({engine.device}, dp="
            f"{engine.dp} shards as a leading axis)")

    rng = np.random.RandomState(0)
    hot = list(rng.randint(1, cfg.vocab - 1, args.hot_prefix))
    prompts = []
    for rid in range(args.requests):
        slo = ("interactive" if rng.random_sample() < args.interactive_frac
               else "standard")
        if prompts and rng.random_sample() < args.repeat_frac:
            prompt = list(prompts[rng.randint(len(prompts))])
        else:
            prompt = hot + list(rng.randint(1, cfg.vocab - 1,
                                            rng.randint(4, 12)))
        prompts.append(prompt)
        experts = None
        if (cfg.moe is not None and args.expert_frac > 0
                and rng.random_sample() < args.expert_frac):
            E = cfg.moe.num_experts
            k = max(cfg.moe.top_k, E // 2)
            experts = tuple(
                int(e) for e in rng.choice(E, size=k, replace=False))
        engine.submit(Request(rid, prompt=[int(t) for t in prompt],
                              max_new_tokens=args.max_new, slo=slo,
                              deadline_s=args.deadline_s, experts=experts))
    t0 = time.time()
    crashes = 0
    while True:
        try:
            engine.run()
            break
        except chaos.HostCrash:
            crashes += 1
            engine, report = chaos.recover_engine(build, engine, journal)
            reclaimed = report["reclaimed"]
            if group is not None:       # each rank reconciled its shard
                reclaimed = int(group.gather(torch.tensor([reclaimed])).sum())
            say(f"[chaos] host crash #{crashes} at step "
                f"{injector.step}: reconciled {reclaimed} "
                f"leaked pages, requeued {report['requeued']} "
                f"requests, restored {report['pins_restored']} pins "
                f"(never_dry={report['never_dry']})")
    dt = time.time() - t0
    s = engine.stats
    lat = engine.latency_quantiles()
    say(f"served {s['admitted']} requests, {s['tokens_out']} tokens in "
        f"{s['steps']} engine steps ({dt:.1f}s, "
        f"{s['tokens_out']/max(dt,1e-9):.1f} tok/s)")
    say(f"latency p50={lat['p50_s']*1e3:.0f}ms p99={lat['p99_s']*1e3:.0f}ms "
        f"(first token p50={lat['first_token_p50_s']*1e3:.0f}ms)")
    say(f"host allocator worst-case op steps: {s['alloc_steps_max']} "
        f"(O(1) — paper Result 1)")
    ss = engine.scheduler.stats
    say(f"scheduler: preemptions={s['preemptions']} "
        f"deferred={ss['deferred']} rejected={ss['rejected']} "
        f"pins created={s['pins_created']} "
        f"hits={s['pin_hit_reqs']} evicted={ss['pins_evicted']}")
    say(f"lane widths: {s['chunk_hist']} "
        f"(buckets={engine.scheduler.buckets(engine.chunk)})")
    if engine.speculate:
        rate = s["spec_accepted"] / max(s["spec_drafted"], 1)
        say(f"speculative: drafted={s['spec_drafted']} "
            f"accepted={s['spec_accepted']} (rate={rate:.2f}) "
            f"pages_rolled_back={s['spec_pages_rolled_back']} "
            f"accept_hist={s['accept_hist']} "
            f"gate_skips={s['spec_gate_skips']} "
            f"mixed_steps={s['spec_mixed_steps']}")
    occ = engine.shard_occupancy()
    say(f"shard occupancy: mean={occ['pages_mean_shard']} "
        f"peak={occ['pages_peak_shard']} pages per shard")
    if engine.expert_paging:
        hr = engine.telemetry.expert_hit_rate()
        dropped = int(engine.telemetry.shard["moe_dropped_tokens"].sum())
        say(f"expert paging: budget={engine.expert_budget} pages/shard "
            f"hit_rate={'n/a' if hr is None else f'{hr:.2f}'} "
            f"loads={s['expert_load_pages']} "
            f"evictions={s['expert_evictions']} "
            f"resident_peak={s['expert_pages_resident_peak']} "
            f"dropped_tokens={dropped}")
    engine.flush_pins()
    engine.flush_experts()
    if faults:
        say(f"[chaos] fired={injector.log} crashes={crashes} "
            f"shards_lost={sorted(engine.lost_shards)} "
            f"retries={s['retries']} failed={s['failed']} "
            f"deadline_expired={s['deadline_expired']}")
        assert not injector.pending(), (
            f"faults never reached: {injector.pending()}")
        assert engine.leak_free(), "pages leaked on surviving shards"
        assert not journal.in_flight(), (
            "requests neither finished nor failed")
        say(f"[chaos] drained clean: {len(journal.finished())} "
            f"finished, zero leaked pages on surviving shards")
    else:
        say(f"page occupancy after drain+flush: "
            f"{engine.page_occupancy():.4f}")
    m = engine.telemetry.never_dry_margin_min()
    say(f"never-dry margin (min over shards x steps): {m} "
        f"(>= 0 proves §4.2 held with slack)")
    if args.metrics_path and lead:
        with open(args.metrics_path, "w") as fh:
            fh.write(engine.telemetry.render_prom())
        say(f"telemetry: prometheus snapshot -> {args.metrics_path}")
    if args.trace_path and lead:
        if args.trace_path.endswith(".jsonl"):
            engine.tracer.write_jsonl(args.trace_path)
        else:
            engine.tracer.write_chrome(args.trace_path)
        say(f"telemetry: {len(engine.tracer.events)} trace events -> "
            f"{args.trace_path}")
    return engine


if __name__ == "__main__":
    main()
