"""End-to-end serving driver: batched requests over paged KV cache.

Twin of the JAX package's ``examples/serve_paged.py``, with the same
flags, trace and printed lines, on the port's engine.  The engine
admits requests through the paper's wait-free allocator (sequence
slots = fixed-size blocks) behind a traffic-aware admission scheduler
(priority/SLO classes, per-shard page budgets, preemption, pinned
prefix retention), streams prompts through chunked prefill (``--chunk``
tokens per step, each chunk's pages allocated in one
O(1)-per-request ``alloc_n`` batch), and decodes fully on the device:
per-request temperature/top-k sampling, done-detection and page
release all run inside the step, so the host syncs once per step on a
packed status array.

  PYTHONPATH=src python -m repro_torch.examples.serve_paged \\
      [--arch recurrentgemma-2b] [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_paged \\
      --hot-prefix 24 --pin-pages 12 --bursts 3 --interactive-frac 0.25
  PYTHONPATH=src python -m repro_torch.examples.serve_paged \\
      --hot-prefix 24 --speculate --draft-len 4 --chunk-buckets 1,4,8

Fault-tolerant mode: ``--inject-fault`` takes a comma-joined spec of
deterministic faults (serving/chaos.py), e.g.
``crash@6:post_sync:torn,shard_loss@12:post_admission:1``.  Host
crashes are caught here, the engine is rebuilt, and allocator state is
reconciled from the surviving device tensors + the admission journal
(``chaos.recover_engine``); the driver then proves the run drained
with zero leaked pages.  ``main`` returns the last engine.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, smoke_config
from ..models.model import init_params
from ..serving import chaos
from ..serving.engine import Request, ServingEngine
from ..serving.sched import SchedConfig
from ..serving.telemetry import FlightRecorder, install_signal_dump
from ..serving.trace import Tracer
from . import need_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="fixed prompt length (0 = random 4..24)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="prefill chunk size (tokens per step)")
    ap.add_argument("--chunk-buckets", default="",
                    help="comma-separated SLO-aware prefill widths, e.g. "
                         "1,4,8 (empty = fixed --chunk)")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative decode on shared prefixes "
                         "(draft from hot-prefix continuation history, "
                         "verify+rollback inside the fused step)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="draft tokens per speculative lane")
    ap.add_argument("--no-spec-gate", action="store_true",
                    help="disable the per-prefix accept-rate break-even "
                         "gate: always draft at full draft-len")
    ap.add_argument("--repeat-frac", type=float, default=0.0,
                    help="fraction of requests repeating a previous "
                         "full prompt (the traffic speculation wins on)")
    ap.add_argument("--hot-prefix", type=int, default=0, metavar="N",
                    help="prepend a common N-token prefix to every prompt "
                         "(exercises refcounted prefix sharing)")
    ap.add_argument("--pin-pages", type=int, default=0,
                    help="pinned prefix-cache budget per shard in pages "
                         "(0 = off; keeps the hot prefix alive across "
                         "request lifetimes)")
    ap.add_argument("--bursts", type=int, default=1,
                    help="submit the requests in N bursts, draining the "
                         "engine between bursts (shows pinned prefixes "
                         "surviving idle gaps)")
    ap.add_argument("--interactive-frac", type=float, default=0.0,
                    help="fraction of requests in the interactive SLO "
                         "class (may preempt standard/batch work)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k cutoff when sampling (0 = full vocab)")
    ap.add_argument("--inject-fault", default="", metavar="SPEC",
                    help="deterministic fault spec, comma-joined "
                         "kind@step:phase[:extra] — kinds crash / "
                         "shard_loss / straggler / poison / error "
                         "(serving/chaos.py)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none)")
    ap.add_argument("--metrics-path", default="", metavar="FILE",
                    help="write a Prometheus text-format telemetry "
                         "snapshot at end of run")
    ap.add_argument("--trace-path", default="", metavar="FILE",
                    help="write the request-lifecycle trace at end of "
                         "run (chrome trace_event JSON; .jsonl suffix "
                         "writes one event per line)")
    ap.add_argument("--flight-recorder", default="", metavar="FILE",
                    help="crash flight-recorder dump path (last-N-steps "
                         "ring; dumps on crash / watchdog / reconcile / "
                         "SIGTERM)")
    ap.add_argument("--flight-sync", type=int, default=0, metavar="N",
                    help="also dump the flight ring every N steps "
                         "(covers SIGKILL; 0 = crash paths only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    need_device(args.device, "serve_paged")

    cfg = smoke_config(get_config(args.arch))
    params = init_params(cfg, seed=0, device=args.device)
    buckets = tuple(int(b) for b in args.chunk_buckets.split(",") if b)
    faults = bool(args.inject_fault)
    journal = chaos.ServingJournal() if faults else None
    injector = chaos.parse_faults(args.inject_fault) if faults else None

    tracer = Tracer() if args.trace_path else None

    def build():
        # a fresh recorder per build: chaos.recover_engine adopts the
        # crashed ring into it, so the forensic window spans the crash
        flight = (FlightRecorder(path=args.flight_recorder,
                                 sync_every=args.flight_sync)
                  if args.flight_recorder or args.flight_sync else None)
        eng = ServingEngine(
            cfg, params, dp=2, b_local=4, max_len=96,
            scheduler_lanes=4, chunk_size=args.chunk,
            speculate=args.speculate, draft_len=args.draft_len,
            spec_gate=not args.no_spec_gate,
            sched=SchedConfig(pin_pages=args.pin_pages,
                              chunk_buckets=buckets),
            journal=journal, injector=injector, max_restarts=4,
            tracer=tracer, flight=flight, device=args.device)
        if args.flight_recorder:
            install_signal_dump(eng.flight)
        return eng

    engine = build()

    rng = np.random.RandomState(0)
    hot = list(rng.randint(1, cfg.vocab - 1, args.hot_prefix))
    reqs = []
    prompts = []
    for rid in range(args.requests):
        plen = args.prompt_len or rng.randint(4, 24)
        slo = ("interactive"
               if rng.random_sample() < args.interactive_frac
               else "standard")
        if prompts and rng.random_sample() < args.repeat_frac:
            prompt = list(prompts[rng.randint(len(prompts))])
        else:
            prompt = hot + list(rng.randint(1, cfg.vocab - 1, plen))
        prompts.append(prompt)
        reqs.append(Request(
            rid, prompt=[int(t) for t in prompt],
            max_new_tokens=args.max_new, slo=slo,
            temperature=args.temperature, top_k=args.top_k, seed=rid,
            deadline_s=args.deadline_s))

    t0 = time.time()
    peak_occ = 0.0
    crashes = 0
    per_burst = -(-len(reqs) // max(args.bursts, 1))
    for i in range(0, len(reqs), per_burst):
        for r in reqs[i:i + per_burst]:
            engine.submit(r)
        while not engine.idle():
            try:
                # one protected step: engine.run owns the exception
                # discipline (poison -> bounded retry, step error ->
                # in-place recovery); only a host crash escapes
                engine.run(max_steps=1)
            except chaos.HostCrash:
                # the host process "died": rebuild from scratch and
                # reconcile allocator state against the device tensors
                # + journal — in-flight work requeues token-identically
                crashes += 1
                engine, report = chaos.recover_engine(
                    build, engine, journal)
                print(f"[chaos] host crash #{crashes} at "
                      f"step={injector.step}: reconciled "
                      f"{report['reclaimed']} leaked pages, "
                      f"requeued {report['requeued']} requests, "
                      f"restored {report['pins_restored']} pins "
                      f"(never_dry={report['never_dry']})")
            peak_occ = max(peak_occ, engine.page_occupancy())
    dt = time.time() - t0

    s = engine.stats
    lat = engine.latency_quantiles()
    total = s["tokens_out"] + s["prompt_tokens"]
    print(f"arch={cfg.name} chunk={args.chunk} "
          f"buckets={engine.scheduler.buckets(args.chunk)} "
          f"bursts={args.bursts} lane_hist={s['chunk_hist']}")
    print(f"requests={s['admitted']} gen_tokens={s['tokens_out']} "
          f"prompt_tokens={s['prompt_tokens']} steps={s['steps']} "
          f"wall={dt:.1f}s throughput={total/dt:.1f} tok/s "
          f"({s['tokens_out']/dt:.1f} gen tok/s)")
    print(f"p50 latency={lat['p50_s']*1e3:.0f}ms "
          f"p99={lat['p99_s']*1e3:.0f}ms "
          f"first-token p50={lat['first_token_p50_s']*1e3:.0f}ms")
    print(f"peak page occupancy={peak_occ:.2%}  "
          f"after drain={engine.page_occupancy():.2%} "
          f"({engine.pinned_pages()} pages cache-pinned)")
    if engine.prefix_cache is not None:
        print(f"prefix sharing: {s['prefix_shared_reqs']} requests reused "
              f"{s['prefix_shared_tokens']} prompt tokens from live pages "
              f"(pages-in-use mean={engine.pages_mean():.1f} "
              f"peak={s['pages_peak']})")
    ss = engine.scheduler.stats
    print(f"scheduler: preemptions={s['preemptions']} "
          f"deferred={ss['deferred']} rejected={ss['rejected']} "
          f"pins created={s['pins_created']} hits={s['pin_hit_reqs']} "
          f"({s['pin_hit_tokens']} tokens) evicted={ss['pins_evicted']}")
    if engine.speculate:
        rate = s["spec_accepted"] / max(s["spec_drafted"], 1)
        print(f"speculative: {s['spec_lanes']} draft lanes, "
              f"{s['spec_drafted']} drafted, {s['spec_accepted']} accepted "
              f"(rate={rate:.2f}), {s['spec_pages_rolled_back']} pages "
              f"rolled back, accept_hist={s['accept_hist']}, "
              f"gate_skips={s['spec_gate_skips']}, "
              f"mixed_steps={s['spec_mixed_steps']}")
    print(f"host admission worst-case steps={s['alloc_steps_max']} "
          f"(paper Result 1: O(1))")
    engine.flush_pins()
    if faults:
        print(f"[chaos] fired={injector.log} crashes={crashes} "
              f"shards_lost={sorted(engine.lost_shards)} "
              f"recoveries={s['recoveries']} retries={s['retries']} "
              f"failed={s['failed']} "
              f"deadline_expired={s['deadline_expired']}")
        assert not injector.pending(), (
            f"faults never reached: {injector.pending()}")
        assert engine.leak_free(), "pages leaked on surviving shards"
        assert not journal.in_flight(), "requests neither finished nor failed"
        print(f"[chaos] drained clean: {len(journal.finished())} finished, "
              f"zero leaked pages on surviving shards")
    else:
        assert engine.page_occupancy() == 0.0, \
            "pages leaked after drain+flush"
        assert all(r.done for r in reqs)
    m = engine.telemetry.never_dry_margin_min()
    print(f"never-dry margin (min over shards x steps): {m} "
          f"(>= 0 proves §4.2 held with slack)")
    if args.metrics_path:
        with open(args.metrics_path, "w") as fh:
            fh.write(engine.telemetry.render_prom())
        print(f"telemetry: prometheus snapshot -> {args.metrics_path}")
    if args.trace_path:
        if args.trace_path.endswith(".jsonl"):
            engine.tracer.write_jsonl(args.trace_path)
        else:
            engine.tracer.write_chrome(args.trace_path)
        print(f"telemetry: {len(engine.tracer.events)} trace events -> "
              f"{args.trace_path}")
    return engine


if __name__ == "__main__":
    main()
