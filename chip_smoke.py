"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line (any failure fails the run):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the port's CUDA kernel from the sources in this checkout
   (``src/repro_torch/kernels/paged_attention/csrc``) with nvcc;
3. hold each kernel, through the wrapper the engine calls, against its
   plain PyTorch version on the card, at the serving path's shapes:
   f32 within 1e-4; bf16 within 6e-2 and, since both sides accumulate
   in float32 from the same inputs and round once, within one bf16 ulp
   (2^-7 relative);
4. check the port's engine on the card against the same engine on the
   CPU (where every kernel wrapper runs its plain version) on the
   olmo-1b smoke config: identical tokens and status rows;
5. serve olmo-1b at full width (16 layers x 2048, 16 heads, hd 128,
   vocab 50304, bf16, page size 64) with random weights from ``--seed``
   through ``ServingEngine.run``: every request finishes, the pool
   drains leak-free, the kernel ran 16 times per step, and each step
   made exactly one device-to-host transfer;
6. time the kernel, its plain version, a PyTorch library call for the
   same attention and the bound, at the serving shapes, and print the
   kernels line.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script
exits with a non-zero code and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# one card: the first, unless the caller chose which
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

#: published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
#: bf16: kernel and plain version may differ by one ulp of the output
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -7, 1e-5


def phase(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters: int = 40, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_case(rng, B, T, H, KH, hd, psz, maxp, P, dtype, base=None,
              masked=(), dead=()):
    """Paged-attention inputs on the card: ragged ``base`` lengths, a
    table of distinct random pages covering base + T, optional
    all-masked rows (table all -1) and dead pages (-1 inside the run)."""
    if base is None:
        hi = max((maxp - 1) * psz - T, 1)
        base = rng.randint(0, hi, B)
    base = np.asarray(base, np.int32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    for b in range(B):
        for i in range(min(-(-(int(base[b]) + T) // psz), maxp)):
            table[b, i] = avail.pop()
    for b in masked:
        table[b] = -1
    for b, i in dead:
        table[b, i] = -1
    dev = "cuda"
    q = torch.from_numpy(rng.randn(B, T, H, hd).astype(np.float32))
    kp = torch.from_numpy(rng.randn(P, psz, KH, hd).astype(np.float32))
    vp = torch.from_numpy(rng.randn(P, psz, KH, hd).astype(np.float32))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(base).to(dev))


def check_kernel(ops, plain, rng, cfg_full, cfg_smoke, b_local, maxp, P):
    """Phase 3: K1, through the dispatcher the engine calls, against its
    plain version; returns the worst error over the serving path's
    shapes (bf16)."""
    worst = 0.0
    full = dict(H=cfg_full.n_heads, KH=cfg_full.n_kv_heads, hd=cfg_full.hd,
                psz=cfg_full.page_size, maxp=maxp, P=P)
    smoke = dict(H=cfg_smoke.n_heads, KH=cfg_smoke.n_kv_heads,
                 hd=cfg_smoke.hd, psz=cfg_smoke.page_size, maxp=8, P=72)
    cases = [("full T=1 bf16", full, 1, torch.bfloat16),
             ("full T=64 bf16", full, 64, torch.bfloat16),
             ("full T=1 f32", full, 1, torch.float32),
             ("full T=64 f32", full, 64, torch.float32),
             ("smoke T=8 f32 (G=2)", smoke, 8, torch.float32),
             ("smoke T=1 f32 (G=2)", smoke, 1, torch.float32)]
    for name, shp, T, dt in cases:
        args = attn_case(rng, b_local, T, dtype=dt, masked=(1,),
                         dead=((2, 0),), **shp)
        before = ops.paged_attention_chunk.launches
        out = ops.paged_attention_chunk(*args)
        torch.cuda.synchronize()
        check(ops.paged_attention_chunk.launches == before + 1,
              f"{name}: the dispatcher launched the kernel once")
        ref = plain(*args)
        err = (out.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(out.float()).all()), f"{name}: finite")
        check(bool((out[1] == 0).all()), f"{name}: all-masked row is zero")
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dt],
                                   rtol=TOL[dt],
                                   msg=lambda m, n=name: f"{n}: {m}")
        tol = f"tol {TOL[dt]:g}"
        if dt == torch.bfloat16:
            torch.testing.assert_close(
                out.float(), ref.float(), atol=BF16_ULP_ATOL,
                rtol=BF16_ULP_RTOL,
                msg=lambda m, n=name: f"{n}, one bf16 ulp: {m}")
            tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
        phase(f"[3] K1 {name}: max_abs_err {err:.3e}, max|ref| "
              f"{ref.float().abs().max().item():.3e} ({tol})")
        if dt == torch.bfloat16:
            worst = max(worst, err)
    return worst


def check_engine_vs_cpu(tengine, cfg_smoke, seed):
    """Phase 4: the engine on the card against the engine on the CPU
    (plain versions), olmo-1b smoke config, f32."""
    from repro_torch.models.model import init_params
    from repro_torch.models.layers import tree_map

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    prompts = [list(rng.randint(1, cfg_smoke.vocab, rng.randint(3, 30)))
               for _ in range(9)]
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = tengine.ServingEngine(
            cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=2,
            b_local=2, max_len=64, chunk_size=8, device=dev)
        reqs = [tengine.Request(i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=500)
        check(all(r.done for r in reqs) and eng.leak_free(),
              f"smoke engine on {dev} drained")
        runs[dev] = ([r.out_tokens for r in reqs],
                     [rec["status"] for rec in eng.flight.ring])
    check(runs["cuda"] == runs["cpu"], "engine on the card == on the CPU")
    phase(f"[4] smoke engine on the card == on the CPU: 9 requests, "
          f"{len(runs['cuda'][1])} steps, identical tokens and status rows")


def make_requests(tengine, cfg, seed, n=16):
    """The smoke workload: ``n`` requests of 64-1024 random prompt
    tokens and 32-64 new tokens each, from ``seed``."""
    rng = np.random.RandomState(seed)
    return [tengine.Request(i, prompt=list(rng.randint(1, cfg.vocab,
                                                       rng.randint(64, 1025))),
                            max_new_tokens=int(rng.randint(32, 65)))
            for i in range(n)]


def serve_full_width(tengine, cfg, ops, seed, b_local, max_len, chunk):
    """Phase 5: full-width olmo-1b through ``ServingEngine.run``.
    Returns (engine, K1 launches, generated tok/s)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    phase(f"[5] olmo-1b params: {n_params} ({cfg.dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")
    eng = tengine.ServingEngine(cfg, params, dp=1, b_local=b_local,
                                max_len=max_len, chunk_size=chunk,
                                device="cuda")
    # warm-up: one short request loads the prefill (T = 64) and decode
    # (T = 1) kernels and picks the matmul algorithms; not counted
    eng.submit(tengine.Request(10**6, prompt=[1] * (chunk + 1),
                               max_new_tokens=3))
    eng.run(max_steps=100)
    reqs = make_requests(tengine, cfg, seed)
    phase(f"[5] pool: {eng.pages_local} pages/shard, "
          f"{sum(len(r.prompt) for r in reqs)} prompt tokens, "
          f"{sum(r.max_new_tokens for r in reqs)} new tokens asked")
    # the main path's run: counts zeroed just before, read just after
    ops.paged_attention_chunk.launches = 0
    steps0, transfers0 = eng.stats["steps"], eng.host_transfers
    tokens0, prompt0 = eng.stats["tokens_out"], eng.stats["prompt_tokens"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(3):                      # prefill chunks
        eng.step()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.paged_attention_chunk.launches
    steps = eng.stats["steps"] - steps0
    transfers = eng.host_transfers - transfers0
    tokens = eng.stats["tokens_out"] - tokens0
    prompt = eng.stats["prompt_tokens"] - prompt0
    check(all(r.done for r in reqs), "every request finished")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
          "tokens inside the vocabulary")
    check([len(r.out_tokens) for r in reqs]
          == [r.max_new_tokens for r in reqs], "every budget generated")
    check(eng.page_occupancy() == 0.0 and eng.leak_free(),
          "no page leaked after the drain")
    check(launches == cfg.n_layers * steps > 0,
          f"K1 launched once per layer per step ({launches}, {steps})")
    check(transfers == steps, f"one transfer per step ({transfers}, "
                              f"{steps})")
    phase(f"[5] served 16 requests: {steps} steps, {tokens} tokens out, "
          f"{prompt} prompt tokens, wall {wall:.3f} s")
    phase(f"[5] K1 launches {launches} = {cfg.n_layers} layers x {steps} "
          f"steps; device->host transfers {transfers} (1 per step); "
          f"synchronizing calls in one step under sync-debug mode: "
          f"{len(syncs)} {syncs}")
    phase(f"[5] end-to-end: {tokens / wall:.1f} generated tok/s, "
          f"{(tokens + prompt) / wall:.1f} total tok/s, "
          f"{1e3 * wall / steps:.2f} ms/step")
    return eng, launches, tokens / wall


def profile_serve(tengine, eng, cfg, seed):
    """``--profile``: serve the workload again on the warm engine under
    ``torch.profiler`` and print where a step's time goes."""
    from torch.profiler import ProfilerActivity, profile

    reqs = make_requests(tengine, cfg, seed + 1)
    steps0 = eng.stats["steps"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=10_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.stats["steps"] - steps0
    kernels, ops = [], []           # device kernels; host-side operators
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.key, e.count, e.self_device_time_total))
        else:
            ops.append((e.key, e.count, e.self_cpu_time_total))
    busy_us = sum(k[2] for k in kernels)
    launches = sum(k[1] for k in kernels)
    phase(f"[p] profiled run: {steps} steps, wall {1e3 * wall:.1f} ms "
          f"({1e3 * wall / steps:.2f} ms/step), kernels "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of "
          f"wall), {launches / steps:.0f} kernels/step")
    for key, count, t in sorted(kernels, key=lambda r: -r[2])[:10]:
        phase(f"[p] device {t / 1e3 / steps:8.3f} ms/step {count:7d}x "
              f"{key[:80]}")
    for key, count, t in sorted(ops, key=lambda r: -r[2])[:10]:
        phase(f"[p] host   {t / 1e3 / steps:8.3f} ms/step {count:7d}x "
              f"{key[:80]}")


def time_kernel(ops, plain, rng, cfg, b_local, maxp, P, T, base):
    """Phase 6: K1, its plain version, SDPA over pre-gathered dense K/V
    with the same mask, and the bound, at one serving shape.  Each of
    the model's layers has its own pages, so the timing cycles through
    that many K/V arrays and reads them cold from HBM, as a step does."""
    H, KH, hd, psz = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.page_size
    dt = cfg.tdtype
    layers = [attn_case(rng, b_local, T, H, KH, hd, psz, maxp, P, dt,
                        base=base) for _ in range(cfg.n_layers)]
    it = iter(range(10 ** 9))

    def kern():
        ops.paged_attention_chunk_cuda(*layers[next(it) % len(layers)])

    def ref():
        plain(*layers[next(it) % len(layers)])

    # the library yardstick: SDPA on K/V gathered densely beforehand
    dense = []
    for q, kp, vp, table, bl in layers:
        L = maxp * psz
        safe = table.clamp(min=0).long()
        k = kp[safe].reshape(b_local, L, KH, hd).transpose(1, 2)
        v = vp[safe].reshape(b_local, L, KH, hd).transpose(1, 2)
        qpos = bl[:, None] + torch.arange(T, device="cuda")
        resident = (table >= 0).repeat_interleave(psz, dim=1)
        mask = ((torch.arange(L, device="cuda")[None, None] <= qpos[..., None])
                & resident[:, None])[:, None]
        dense.append((q.transpose(1, 2), k, v, mask))

    def lib():
        q, k, v, mask = dense[next(it) % len(dense)]
        torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=KH != H)

    ms = cuda_ms(kern, iters=4 * cfg.n_layers)
    plain_ms = cuda_ms(ref, iters=cfg.n_layers, warmup=1)
    library_ms = cuda_ms(lib, iters=4 * cfg.n_layers)
    q, kp, vp, table, bl = layers[0]
    nbytes = ops.bound_bytes(q, kp, table, bl)
    pairs = sum(int(b) + t + 1 for b in base for t in range(T))
    flops = 4 * hd * H * pairs
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_OPS[dt]
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return dict(T=T, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also serve the workload again under "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_chunk_ref as plain
    from repro_torch.serving import engine as tengine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # [1] the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    check(torch.cuda.device_count() == 1, "one visible card")
    phase(f"[1] {smi}")
    phase(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}, capability {torch.cuda.get_device_capability(0)}")

    # [2] build the kernel from this checkout's sources
    t0 = time.perf_counter()
    build.load("paged_attention")
    for line in build.logs.get("paged_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            phase(f"[2] paged_attention: {line.strip()}")
    phase(f"[2] built paged_attention in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}")

    cfg = get_config("olmo-1b")
    cfg_smoke = smoke_config(cfg)
    b_local, max_len, chunk = 8, 2048, 64
    maxp = max_len // cfg.page_size
    from repro_torch.models.transformer import pool_class_specs
    P = pool_class_specs(cfg, b_local, max_len, chunk)[0].num_blocks + 1

    # [3] kernel vs plain version
    rng = np.random.RandomState(args.seed)
    err = check_kernel(ops, plain, rng, cfg, cfg_smoke, b_local, maxp, P)

    # [4] the engine on the card vs on the CPU, small input
    check_engine_vs_cpu(tengine, cfg_smoke, args.seed)

    # [5] the main path at full width
    eng, launches, tok_s = serve_full_width(tengine, cfg, ops, args.seed,
                                            b_local, max_len, chunk)
    if args.profile:
        profile_serve(tengine, eng, cfg, args.seed)
    del eng

    # [6] timings at the serving shapes: decode (T=1) at the contexts
    # the run reached, and a prefill chunk (T=64)
    base1 = rng.randint(64 + 32, 1024 + 64, b_local)
    base64 = rng.randint(0, 1024 - 64, b_local) // 64 * 64
    t1 = time_kernel(ops, plain, rng, cfg, b_local, maxp, P, 1, base1)
    t64 = time_kernel(ops, plain, rng, cfg, b_local, maxp, P, 64, base64)
    for t in (t1, t64):
        phase(f"[6] K1 T={t['T']} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16 on {smi}: kernel {t['ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['bytes']} B, {t['flops']} flop), plain "
              f"{t['plain_ms']:.4f} ms, library (SDPA, dense K/V) "
              f"{t['library_ms']:.4f} ms")
    phase(f"[6] end-to-end decode on {smi}: {tok_s:.1f} generated tok/s")
    kernels = [{
        "name": "paged_attention_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:171",
        "launches": launches, "max_abs_err": err,
        "ms": t1["ms"], "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"], "bound_by": t1["bound_by"],
        "library_ms": t1["library_ms"],
        "shape": f"T=1 B={b_local} H={cfg.n_heads} hd={cfg.hd} "
                 f"psz={cfg.page_size} bf16",
        "t64": {k: t64[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
    }]
    phase(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
