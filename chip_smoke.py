"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printed on its own line (any failure fails the run):

1. the card's name and power limit, as nvidia-smi reports them;
2. build the port's CUDA kernels from the sources in this checkout
   (``src/repro_torch/kernels/*/csrc``), one nvcc per source, all
   started together;
3. hold each kernel, through the wrapper the engine calls, against its
   plain PyTorch version on the card, at the serving path's shapes:
   f32 within 1e-4; bf16 within 6e-2 and, since both sides accumulate
   in float32 from the same inputs and round once, within one bf16 ulp
   (2^-7 relative).  K1 (paged attention) at T = 1 and 64; K2 (paged
   decode) at olmo-1b's, llama3.2-1b's and smoke widths, contexts of
   96-1,087 tokens, with ``zero_empty`` off (a row without keys gets
   the uniform mean) and on (zeros), and against K1 at T = 1 over
   base + 1 positions; K3 (verify
   attention) at T = 5 and 64 on tables whose lanes share their prefix
   pages, also against K1 on the same inputs; K4 (SSD scan, f32 and
   bf16) and K5 (RG-LRU, float32 only) at T = 1 and 64 at full width
   and at smoke width, from a carried state, with inert lanes whose
   state must stay bit for bit; K6 (causal flash attention) on strided
   [B, S, H, hd] views, each of its forward kernels: the wgmma/TMA one
   (bf16, hd 64 and 128) at olmo-1b's and llama3.2-1b's widths, with a
   ragged S and bidirectional, the mma.sync one (bf16, hd 16) and the
   float32 one at smoke width, with a ragged S and bidirectional; its
   backward kernels against autograd through the plain version (f32
   within 1e-4, bf16 within 6e-2, S up to 2048, a ragged S), and two
   backward calls on the same inputs bit-equal;
4. check the port's engine on the card against the same engine on the
   CPU (where every kernel wrapper runs its plain version) on smoke
   configs: identical tokens and status rows, for olmo-1b's plain path
   and, with speculation, the hot-prefix workload of
   ``tests/test_speculative.py``, with pinned prefixes and preemption
   (``SchedConfig(pin_pages=8, page_budget=6)``: pool leaves and pin
   tables identical too), and for recurrentgemma-2b and
   mamba2-370m with two size classes; then training: three steps of
   ``launch/train.py::build_step`` on the smoke olmo-1b in f32 from the
   same parameters and ``TokenStream`` batches on both devices (step
   0's loss and gradients within 1e-4, later losses within 1e-3
   relative), and the smoke trainer through ``FaultTolerantLoop`` with
   one injected failure: one restart, the uninterrupted run's losses;
5. the plain path: serve olmo-1b at full width (16 layers x 2048, 16
   heads, hd 128, vocab 50304, bf16, page size 64) with random weights
   from ``--seed`` through ``ServingEngine.run``: every request
   finishes, the pool drains leak-free, K1 ran 16 times on each step
   with a prompt lane and K2 16 times on each decode-only step, no
   other kernel ran, and each step made exactly one device-to-host
   transfer;
6. time K1, its plain version, a PyTorch library call for the same
   attention and the bound, at the serving shapes;
7. the speculative path: the same engine settings with draft length 4
   serve hot-prefix traffic (4 system prompts of 512 tokens, user tails
   of 32-128 tokens, half of the requests repeating an earlier prompt
   exactly, 32 requests of 64 new tokens) with and without
   speculation: K3 ran 16 times per speculative step, K2 16 times per
   decode-only step and K1 16 times per other step, one transfer per
   step, leak-free; in f32 both runs give identical tokens; in bf16 the
   count of identical streams is printed;
8. time K3 at T = 5 on hot-prefix tables and at T = 64, beside its
   bound, its plain version and SDPA;
9. the SSD path: serve mamba2-370m at full width (48 SSD layers, d_model
   1024, 32 heads of 64, state 128, bf16) with two size classes, the
   workload of phase 5, max_len 2048: every request finishes, K4 ran 48
   times per step and no other kernel ran, one transfer per step, no KV
   page and no state block in use after the drain;
10. the RG-LRU path: the same for recurrentgemma-2b (18 RG-LRU layers
   and 8 sliding-window layers of window 2048, d_model 2560, bf16) at
   max_len 4096, 16 prompts of 64-3,000 tokens, 4 of them past the
   window: K5 ran 18 times per step;
11. time K4 and K5 at T = 1 and 64 beside their bounds and plain
   versions, and print both families' end-to-end rates;
12. the training path: olmo-1b at full depth and width (bf16
   parameters, float32 AdamW state), one micro-batch of 4 sequences of
   2048 tokens from ``TokenStream``, a warm-up step and 5 steps of
   ``build_step``: finite losses, K6's forward launched 32 times a step
   (16 global layers, each run forward and again in the backward pass's
   recomputation) and its backward 16 times, and no other kernel, one
   device-to-host transfer a step (the loss); ms a step, tokens a
   second, peak memory, and the model-flops share of the card's bf16
   peak;
13. time K6's forward and backward kernels at the training shape, each
   beside its bound, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (forward, and backward through
   ``torch.autograd.grad``);
14. the serve entry point and preemption at full width (olmo-1b,
   bf16, dp 1, 8 slots, max_len 2048): (a) ``repro_torch.launch.serve
   .main`` with a 512-token hot prefix, 32 requests of 64 new tokens, a
   quarter interactive, 64 pin pages: every request finishes, a pin is
   created, K1 + K2 launches = 16 x steps, one transfer a step, 0 pages
   after the drain and ``flush_pins``, a never-dry margin >= 0; (b) the
   engine driven directly with 128 pin pages, 8 standard requests and
   after 40 steps 4 interactive ones that preempt: a preemption and a
   pin hit, every request finishes, one transfer a step, 0 pages after
   the flush; again in f32 with and without preemption, where every
   stream must be equal or differ first at a near-tie (top-2 logit gap
   within 1e-4 of the logit scale);
15. time K2 and K1 at T = 1 on the same inputs beside K2's bound, its
   plain version and SDPA; serve phase 5's workload with decode-only
   steps through K1 and through K2 in turns (K1, K2, K2, K1); print the
   kernels line (K1-K6, K6's forward and backward on rows of their
   own).

``--profile`` serves the workloads of phases 5, 9 and 10 again, and
runs two more training steps in phase 12, under ``torch.profiler``,
and prints where a step's time goes.  The last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the rest of the
repository beside it, the script exits with a non-zero code and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def cuda_ms(fn, iters: int = 40, warmup: int = 3):
    """(device ms, host ms) of one call of ``fn``.  The device time is
    taken by CUDA events around ``iters`` back-to-back calls that the
    host enqueued while a sleep kernel held the card, so the host's
    cost per call (the Python wrapper, the launches) does not show in
    it; the host time is the wall time per call of the same loop run
    plainly, which is what a caller that waits for it pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most 2 GHz: the sleep outlasts the enqueue at any SM clock
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host_s / iters


def attn_case(rng, B, T, H, KH, hd, psz, maxp, P, dtype, base=None,
              masked=(), dead=(), hot=0):
    """Paged-attention inputs on the card: ragged ``base`` lengths, a
    table of random pages covering base + T, the first ``hot`` of them
    the same pages in every lane (a shared prefix) and the rest
    distinct, optional all-masked rows (table all -1) and dead pages
    (-1 inside the run)."""
    if base is None:
        hi = max((maxp - 1) * psz - T, hot * psz + 1)
        base = rng.randint(hot * psz, hi, B)
    base = np.asarray(base, np.int32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    prefix = [avail.pop() for _ in range(hot)]
    for b in range(B):
        for i in range(min(-(-(int(base[b]) + T) // psz), maxp)):
            table[b, i] = prefix[i] if i < hot else avail.pop()
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


def check_k3(k3, ops, plain, rng, cfg_full, cfg_smoke, b_local, maxp, P):
    """Phase 3: K3, through the dispatcher the engine calls, against its
    plain version and against K1 on the same inputs, on tables whose
    lanes share a 512-token prefix (8 pages); lane 1 is idle.  Returns
    the worst bf16 error against the plain version."""
    worst = 0.0
    full = dict(H=cfg_full.n_heads, KH=cfg_full.n_kv_heads, hd=cfg_full.hd,
                psz=cfg_full.page_size, maxp=maxp, P=P, hot=8)
    smoke = dict(H=cfg_smoke.n_heads, KH=cfg_smoke.n_kv_heads,
                 hd=cfg_smoke.hd, psz=cfg_smoke.page_size, maxp=8, P=72,
                 hot=2)
    cases = [("full T=5 bf16", full, 5, torch.bfloat16),
             ("full T=64 bf16", full, 64, torch.bfloat16),
             ("full T=5 f32", full, 5, torch.float32),
             ("full T=64 f32", full, 64, torch.float32),
             ("smoke T=5 f32 (G=2)", smoke, 5, torch.float32)]
    for name, shp, T, dt in cases:
        args = attn_case(rng, b_local, T, dtype=dt, masked=(1,), **shp)
        before = k3.verify_attention.launches
        out = k3.verify_attention(*args)
        torch.cuda.synchronize()
        check(k3.verify_attention.launches == before + 1,
              f"K3 {name}: the dispatcher launched the kernel once")
        check(bool(torch.isfinite(out.float()).all()), f"K3 {name}: finite")
        check(bool((out[1] == 0).all()), f"K3 {name}: all-masked row is "
                                         f"zero")
        errs = []
        for what, ref in (("plain", plain(*args)),
                          ("K1", ops.paged_attention_chunk(*args))):
            ref = ref.float()
            errs.append((out.float() - ref).abs().max().item())
            torch.testing.assert_close(
                out.float(), ref, atol=TOL[dt], rtol=TOL[dt],
                msg=lambda m, n=name, w=what: f"K3 {n} vs {w}: {m}")
            if dt == torch.bfloat16:
                torch.testing.assert_close(
                    out.float(), ref, atol=BF16_ULP_ATOL,
                    rtol=BF16_ULP_RTOL,
                    msg=lambda m, n=name, w=what: f"K3 {n} vs {w}, one "
                                                  f"bf16 ulp: {m}")
        tol = f"tol {TOL[dt]:g}" + (
            f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
            if dt == torch.bfloat16 else "")
        shared = int((args[3][:, :shp["hot"]] >= 0).sum())
        phase(f"[3] K3 {name}: max_abs_err vs plain {errs[0]:.3e}, vs K1 "
              f"{errs[1]:.3e}, max|ref| {out.float().abs().max().item():.3e}"
              f" ({tol}); {shared} table entries on {shp['hot']} shared "
              f"prefix pages")
        if dt == torch.bfloat16:
            worst = max(worst, errs[0])
    return worst


def check_k2(ops, plain2, rng, cfgs, b_local, maxp, P):
    """Phase 3: K2, through the dispatcher the engine calls, against its
    plain version with ``zero_empty`` off (lane 1 has no valid key and
    must get the uniform mean of what it gathers) and on (zeros), and
    against K1 at T = 1 with ``base + 1`` on the same inputs; contexts
    of 96-1,087 tokens at full width.  Returns the worst bf16 error
    against the plain version."""
    worst = 0.0
    full, llama, smoke = (dict(H=c.n_heads, KH=c.n_kv_heads, hd=c.hd,
                               psz=c.page_size) for c in cfgs)
    full.update(maxp=maxp, P=P)
    llama.update(maxp=maxp, P=P)
    smoke.update(maxp=8, P=72)
    ctx = lambda: rng.randint(64 + 32, 1024 + 64, b_local)  # noqa: E731
    cases = [("full bf16", full, ctx(), torch.bfloat16),
             ("full f32", full, ctx(), torch.float32),
             ("llama3.2-1b widths bf16 (G=4, hd 64)", llama, ctx(),
              torch.bfloat16),
             ("smoke f32 (G=2)", smoke, None, torch.float32)]
    for name, shp, base, dt in cases:
        q, kp, vp, table, base = attn_case(rng, b_local, 1, dtype=dt,
                                           base=base, masked=(1,),
                                           dead=((2, 0),), **shp)
        q2, lens = q[:, 0].contiguous(), base + 1
        errs = []
        for zero_empty in (False, True):
            before = ops.paged_attention.launches
            out = ops.paged_attention(q2, kp, vp, table, lens,
                                      zero_empty=zero_empty)
            torch.cuda.synchronize()
            check(ops.paged_attention.launches == before + 1,
                  f"K2 {name}: the dispatcher launched the kernel once")
            check(bool(torch.isfinite(out.float()).all()),
                  f"K2 {name}: finite")
            refs = [("plain", ops.paged_attention_ref(
                q2, kp, vp, table, lens, zero_empty=zero_empty))]
            if zero_empty:
                check(bool((out[1] == 0).all()),
                      f"K2 {name}: a row without keys is zero")
                refs.append(("K1 T=1", ops.paged_attention_chunk(
                    q, kp, vp, table, base)[:, 0]))
            else:
                check(bool((out[1] != 0).any()),
                      f"K2 {name}: a row without keys is the uniform mean")
            for what, ref in refs:
                ref = ref.float()
                errs.append((out.float() - ref).abs().max().item())
                torch.testing.assert_close(
                    out.float(), ref, atol=TOL[dt], rtol=TOL[dt],
                    msg=lambda m, n=name, w=what: f"K2 {n} vs {w}: {m}")
                if dt == torch.bfloat16:
                    torch.testing.assert_close(
                        out.float(), ref, atol=BF16_ULP_ATOL,
                        rtol=BF16_ULP_RTOL,
                        msg=lambda m, n=name, w=what: f"K2 {n} vs {w}, "
                                                      f"one bf16 ulp: {m}")
        tol = f"tol {TOL[dt]:g}" + (
            f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
            if dt == torch.bfloat16 else "")
        phase(f"[3] K2 {name}: max_abs_err vs plain {errs[0]:.3e} "
              f"(zero_empty off, lane 1 the uniform mean), {errs[1]:.3e} "
              f"(on, lane 1 zeros), vs K1 at T=1 {errs[2]:.3e}; max|ref| "
              f"{out.float().abs().max().item():.3e} ({tol}); contexts "
              f"{int(lens.min())}-{int(lens.max())}")
        if dt == torch.bfloat16:
            worst = max(worst, errs[0], errs[1])
    return worst


def scan_case(rng, kind, dims, dtype):
    """Inputs of K4 (``kind`` "ssd", dims (B, S, H, P, N)) or K5
    ("rglru", dims (B, S, d)) on the card, with the carried state h0 !=
    0; lane 1 is inert (dt = 0, or a = 1 and b = 0) from token 2 on and
    lane 2 throughout, as the serving path's ragged tails and idle slots
    are.  Returns (inputs without the state, h0)."""
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).cuda()
    if kind == "ssd":
        B, S, H, P, N = dims
        dt = torch.from_numpy(rng.rand(B, S, H).astype(np.float32) * 0.5
                              + 0.1).cuda()
        dt[1, 2:] = 0.0
        dt[2] = 0.0
        args = [(f(B, S, H, P) * 0.5).to(dtype), dt, -f(H).abs() * 0.5,
                (f(B, S, N) * 0.3).to(dtype), (f(B, S, N) * 0.3).to(dtype),
                f(H) * 0.1]
        return args, f(B, H, P, N)
    B, S, d = dims
    a = torch.from_numpy(rng.rand(B, S, d).astype(np.float32) * 0.9).cuda()
    b = f(B, S, d) * 0.5
    a[1, 2:], b[1, 2:] = 1.0, 0.0
    a[2], b[2] = 1.0, 0.0
    return [a, b], f(B, d)


def check_scan(name, fn, plain, kind, cases, rng):
    """Phase 3: K4 or K5, through the dispatcher the engine calls, from a
    carried state and with inert lanes, against its plain version on
    the card.  Returns the worst error of the output over the cases."""
    worst = 0.0
    for label, dims, dt in cases:
        args, h0 = scan_case(rng, kind, dims, dt)
        h = h0.clone()
        before = fn.launches
        out, h_out = fn(*args, h)
        torch.cuda.synchronize()
        check(fn.launches == before + 1 and h_out is h,
              f"{name} {label}: the dispatcher launched the kernel once and "
              f"updated the state in place")
        ref, h_ref = plain(*args, h0)
        check(bool(torch.isfinite(out.float()).all())
              and bool(torch.isfinite(h).all()), f"{name} {label}: finite")
        check(torch.equal(h[2], h0[2]),
              f"{name} {label}: an inert lane keeps its state bit for bit")
        torch.testing.assert_close(h, h_ref, atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32],
                                   msg=lambda m, n=label: f"{name} {n} h: {m}")
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dt],
                                   rtol=TOL[dt],
                                   msg=lambda m, n=label: f"{name} {n}: {m}")
        tol = f"tol {TOL[dt]:g}"
        if dt == torch.bfloat16:
            torch.testing.assert_close(
                out.float(), ref.float(), atol=BF16_ULP_ATOL,
                rtol=BF16_ULP_RTOL,
                msg=lambda m, n=label: f"{name} {n}, one bf16 ulp: {m}")
            tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
        err = (out.float() - ref.float()).abs().max().item()
        herr = (h - h_ref).abs().max().item()
        phase(f"[3] {name} {label}: max_abs_err {err:.3e} (state "
              f"{herr:.3e}), max|ref| {ref.float().abs().max().item():.3e} "
              f"({tol}); inert lane bit-equal")
        worst = max(worst, err)
    return worst


def check_engine_vs_cpu(tengine, cfg_smoke, seed, name="smoke engine",
                        **kw):
    """Phase 4: the engine on the card against the engine on the CPU
    (plain versions) on a smoke config, f32; ``kw`` go to both
    engines."""
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
            b_local=2, max_len=64, chunk_size=8, device=dev, **kw)
        reqs = [tengine.Request(i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=500)
        check(all(r.done for r in reqs) and eng.leak_free(),
              f"{name} on {dev} drained")
        runs[dev] = ([r.out_tokens for r in reqs],
                     [rec["status"] for rec in eng.flight.ring])
    check(runs["cuda"] == runs["cpu"], f"{name} on the card == on the CPU")
    phase(f"[4] {name} on the card == on the CPU: 9 requests, "
          f"{len(runs['cuda'][1])} steps, identical tokens and status rows")


def check_spec_engine_vs_cpu(tengine, k3, cfg_smoke, seed):
    """Phase 4: the speculative engine on the card against the same
    engine on the CPU, on the hot-prefix workload of
    tests/test_speculative.py (DP 2, 2 slots a shard, a 16-token prompt
    six times and three cold ones, draft length 4; the wall-clock gate
    off, so both engines draft alike)."""
    from repro_torch.models.model import init_params
    from repro_torch.models.layers import tree_map
    from repro_torch.serving.telemetry import FlightRecorder

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    hot = list(rng.randint(1, cfg_smoke.vocab, 16))
    prompts = [hot] * 6 + [list(rng.randint(1, cfg_smoke.vocab, 10))
                           for _ in range(3)]
    runs, engines = {}, {}
    for dev in ("cpu", "cuda"):
        eng = engines[dev] = tengine.ServingEngine(
            cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=2,
            b_local=2, max_len=64, prefix_sharing=True, speculate=True,
            draft_len=4, spec_gate=False, device=dev,
            flight=FlightRecorder(capacity=4096))
        reqs = [tengine.Request(i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        launches0 = k3.verify_attention.launches
        eng.run(max_steps=500)
        launches = k3.verify_attention.launches - launches0
        check(all(r.done for r in reqs) and eng.leak_free(),
              f"smoke spec engine on {dev} drained")
        runs[dev] = ([r.out_tokens for r in reqs],
                     [(rec["T"], rec["spec"], rec["status"])
                      for rec in eng.flight.ring])
    check(runs["cuda"] == runs["cpu"],
          "speculative engine on the card == on the CPU")
    eng = engines["cuda"]
    spec_steps = sum(rec["spec"] for rec in eng.flight.ring)
    accepted = eng.stats["spec_accepted"]
    check(accepted > 0 and spec_steps > 0, "drafts were accepted")
    check(launches == cfg_smoke.n_layers * spec_steps,
          "K3 launched once per layer per speculative step on the card")
    phase(f"[4] smoke speculative engine on the card == on the CPU: 9 "
          f"requests, {len(runs['cuda'][1])} steps ({spec_steps} "
          f"speculative), {accepted} drafts accepted, identical tokens "
          f"and status rows")


def check_pins_engine_vs_cpu(tengine, cfg_smoke, seed):
    """Phase 4: pinned prefixes and preemption on the card against the
    same engine on the CPU, smoke olmo-1b in f32 with
    ``SchedConfig(pin_pages=8, page_budget=6)``: a standard request on a
    2-page hot prefix, then an interactive one on the same prefix that
    finds no page headroom and preempts it (tests/test_sched.py:154);
    then two sharers of one hot prefix finishing in either order and a
    re-arrival served from the pin (tests/test_sched.py:225, with
    ``SchedConfig(pin_pages=8)`` as there).  Tokens, status rows, stats,
    pool leaves and pin tables must be identical."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params
    from repro_torch.serving.sched import SchedConfig
    from repro_torch.serving.telemetry import FlightRecorder

    params = init_params(cfg_smoke, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    hot = list(rng.randint(1, cfg_smoke.vocab, 16))
    scripts = [
        (dict(pin_pages=8, page_budget=6),
         [(0, hot + [11, 12, 13, 14], 8, "standard"), 3,
          (1, hot + [5, 6], 3, "interactive"), None]),
        (dict(pin_pages=8),
         [(0, hot + [90, 91], 6, "standard"), 2,
          (1, hot + [77, 78, 79], 3, "standard"), None,
          (2, hot + [50, 51], 3, "standard"), None])]
    for n, (sched, script) in enumerate(scripts):
        runs = {}
        for dev in ("cpu", "cuda"):
            eng = tengine.ServingEngine(
                cfg_smoke, tree_map(lambda a: a.to(dev), params), dp=1,
                b_local=2, max_len=64, chunk_size=16, prefix_sharing=True,
                sched=SchedConfig(**sched), device=dev,
                flight=FlightRecorder(capacity=4096))
            reqs = []
            for op in script:
                if isinstance(op, tuple):
                    rid, prompt, max_new, slo = op
                    reqs.append(tengine.Request(rid, prompt=list(prompt),
                                                max_new_tokens=max_new,
                                                slo=slo))
                    eng.submit(reqs[-1])
                elif op is None:
                    eng.run(max_steps=500)
                else:
                    for _ in range(op):
                        eng.step()
            check(all(r.done for r in reqs), f"pins {n} on {dev}: finished")
            stats = {k: v for k, v in eng.stats.items()
                     if k not in ("stragglers", "step_timeouts")}
            pool = [t.cpu() for hp in eng.state.pool.classes
                    for t in (hp.shared.free_ids, hp.shared.top,
                              hp.shared.refcount, hp.private_ids,
                              hp.private_top)]
            runs[dev] = dict(
                tokens=[r.out_tokens for r in reqs],
                status=[rec["status"] for rec in eng.flight.ring],
                stats=stats, sched=dict(eng.scheduler.stats), pool=pool,
                pins=eng.pin_tables.cpu(), flushed=eng.flush_pins(),
                empty=eng.page_occupancy() == 0.0 and eng.leak_free())
        a, b = runs["cpu"], runs["cuda"]
        check(all(a[k] == b[k] for k in ("tokens", "status", "stats",
                                         "sched", "flushed"))
              and all(torch.equal(x, y) for x, y in zip(a["pool"],
                                                        b["pool"]))
              and torch.equal(a["pins"], b["pins"]) and a["empty"]
              and b["empty"], f"pins {n}: the card == the CPU")
        st = b["stats"]
        check(st["pins_created"] > 0 and st["pin_hit_reqs"] > 0
              and (n or st["preemptions"] > 0),
              f"pins {n}: pins created and hit, preemption in the first")
        phase(f"[4] smoke pins and preemption ({n + 1}/2, {sched}) on the "
              f"card == on the CPU: {len(b['status'])} steps, preemptions "
              f"{st['preemptions']}, pins created {st['pins_created']}, "
              f"pin hits {st['pin_hit_reqs']} ({st['pin_hit_tokens']} "
              f"tokens); identical tokens, status rows, stats, pool "
              f"leaves and pin tables; 0 pages after flush_pins")


def make_requests(tengine, cfg, seed, n=16, hi=1024, n_long=0, long_lo=0):
    """The smoke workload: ``n`` requests of 64-``hi`` random prompt
    tokens and 32-64 new tokens each, from ``seed``; every (n //
    n_long)-th prompt (``n_long`` of them) is at least ``long_lo``
    tokens long."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(64, hi + 1, n)
    if n_long:
        lens[::n // n_long] = rng.randint(long_lo, hi + 1, n_long)
    return [tengine.Request(i, prompt=list(rng.randint(1, cfg.vocab, m)),
                            max_new_tokens=int(rng.randint(32, 65)))
            for i, m in enumerate(lens)]


def serve_full_width(tag, tengine, counted, kernel, cfg, seed, b_local,
                     max_len, chunk, reqs, size_classes=1,
                     profile_reqs=None):
    """Phases 5, 9 and 10: one model at full width through
    ``ServingEngine.run``.  ``counted`` maps each kernel's name to its
    dispatcher; ``kernel`` names the one that every layer of its kind
    must launch once a step, and no other kernel may run.  For paged
    attention (``kernel`` K1) a step of width 1 (every lane decoding)
    runs K2 instead, once per layer.
    ``profile_reqs``, when given, are served again under the profiler.
    Returns the run's numbers."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    tag = f"{tag} {cfg.name}"
    phase(f"{tag} params: {n_params} ({cfg.dtype}), init "
          f"{time.perf_counter() - t0:.1f} s")
    eng = tengine.ServingEngine(cfg, params, dp=1, b_local=b_local,
                                max_len=max_len, chunk_size=chunk,
                                size_classes=size_classes, device="cuda")
    bounded = bool(eng.state.rings or eng.state.rec)
    check((eng.prefix_cache is None) == bounded
          and not (bounded and eng.speculate),
          f"{tag}: sharing and speculation off exactly for ring and "
          f"recurrent state")
    # warm-up: one short request loads the prefill (T = 64) and decode
    # (T = 1) kernels and picks the matmul algorithms; not counted
    eng.submit(tengine.Request(10**6, prompt=[1] * (chunk + 1),
                               max_new_tokens=3))
    eng.run(max_steps=100)
    kind = {"K1": "global", "K4": "ssd", "K5": "rglru"}[kernel]
    n_layers = sum(1 for k in cfg.layer_kinds if k == kind)
    phase(f"{tag}: {n_layers} {kind} layers, {size_classes} size "
          f"class(es): {eng.pages_local} KV pages a shard, "
          f"{eng.est_state_blocks(reqs[0])} state blocks a slot; "
          f"{sum(len(r.prompt) for r in reqs)} prompt tokens (longest "
          f"{max(len(r.prompt) for r in reqs)}), "
          f"{sum(r.max_new_tokens for r in reqs)} new tokens asked")
    # the main path's run: counts zeroed just before, read just after
    for fn in counted.values():
        fn.launches = 0
    steps0, transfers0 = eng.stats["steps"], eng.host_transfers
    tokens0, prompt0 = eng.stats["tokens_out"], eng.stats["prompt_tokens"]
    width1_0 = eng.stats["chunk_hist"].get(1, 0)
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
    launches = {k: fn.launches for k, fn in counted.items()}
    steps = eng.stats["steps"] - steps0
    transfers = eng.host_transfers - transfers0
    tokens = eng.stats["tokens_out"] - tokens0
    prompt = eng.stats["prompt_tokens"] - prompt0
    decode_steps = eng.stats["chunk_hist"].get(1, 0) - width1_0
    # the kernels each step must launch, once per layer of its kind
    want = {kernel: n_layers * steps}
    if kernel == "K1":
        want = {"K1": n_layers * (steps - decode_steps),
                "K2": n_layers * decode_steps}
    check(all(r.done for r in reqs), f"{tag}: every request finished")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens),
          f"{tag}: tokens inside the vocabulary")
    check([len(r.out_tokens) for r in reqs]
          == [r.max_new_tokens for r in reqs], f"{tag}: every budget "
                                               f"generated")
    check(all(launches[k] == n > 0 for k, n in want.items())
          and sum(launches.values()) == sum(want.values()),
          f"{tag}: {' and '.join(want)} launched once per {kind} layer per "
          f"step of their width and no other kernel ran ({launches}, "
          f"{steps} steps, {decode_steps} of width 1)")
    check(transfers == steps, f"{tag}: one transfer per step ({transfers}, "
                              f"{steps})")
    in_use = [eng.blocks_in_use(c) for c in range(eng.n_classes)]
    check(not any(in_use) and eng.leak_free(),
          f"{tag}: no KV page and no state block in use after the drain")
    split = "; ".join(f"{k} launches {launches[k]} = {n_layers} x "
                      f"{n // n_layers} steps" for k, n in want.items())
    phase(f"{tag}: served {len(reqs)} requests: {steps} steps ("
          f"{decode_steps} decode-only), {tokens} tokens out, {prompt} "
          f"prompt tokens, wall {wall:.3f} s; {split}, other kernels "
          f"{sum(launches.values()) - sum(want.values())}"
          f"; device->host transfers {transfers} (1 per step), "
          f"synchronizing calls in one step under sync-debug mode: "
          f"{len(syncs)} {syncs}; state blocks granted "
          f"{eng.stats['state_blocks_granted']}; blocks in use after the "
          f"drain, per class (KV first): {in_use}")
    phase(f"{tag}: end-to-end {tokens / wall:.1f} generated tok/s, "
          f"{(tokens + prompt) / wall:.1f} total tok/s, "
          f"{1e3 * wall / steps:.2f} ms/step")
    out = dict(launches=launches[kernel], steps=steps, tok_s=tokens / wall,
               ms_step=1e3 * wall / steps, n_layers=n_layers,
               k2=launches.get("K2", 0), decode_steps=decode_steps)
    if profile_reqs is not None:
        profile_serve(eng, profile_reqs, f"{tag} [p]")
    del eng, params
    torch.cuda.empty_cache()
    return out


def time_scan(kind, fn_cuda, plain, bound_bytes, flops, dims, n_layers, rng,
              dtype):
    """Phase 11: K4 or K5 (``fn_cuda`` launches it on inputs and a state)
    and its plain version at one serving shape, beside the bound.  Each
    layer has its own state, so the timing cycles through ``n_layers``
    inputs and states and reads them cold, as a step does.  No single
    PyTorch call computes either recurrence: no library time."""
    layers = []
    for _ in range(n_layers):
        args, h = scan_case(rng, kind, dims, dtype)
        layers.append((args, h))
    it = iter(range(10 ** 9))

    def kern():
        args, h = layers[next(it) % n_layers]
        fn_cuda(*args, h)

    def ref():
        args, h = layers[next(it) % n_layers]
        plain(*args, h)

    ms, host_ms = cuda_ms(kern, iters=4 * n_layers)
    plain_ms, _ = cuda_ms(ref, iters=n_layers, warmup=1)
    args, h = layers[0]
    nbytes = bound_bytes(args, h)
    nflops = flops(args)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nflops / PEAK_OPS[torch.float32]
    return dict(T=dims[1], ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=nflops)


def hot_prefix_prompts(cfg, seed, n=32):
    """Phase 7's traffic: 4 system prompts of 512 tokens (8 pages), each
    request one of them plus a user tail of 32-128 tokens; every other
    request repeats an earlier prompt exactly."""
    rng = np.random.RandomState(seed + 7)
    systems = [list(rng.randint(1, cfg.vocab, 512)) for _ in range(4)]
    prompts = []
    for i in range(n):
        if i % 2:
            prompts.append(list(prompts[rng.randint(len(prompts))]))
        else:
            prompts.append(systems[(i // 2) % 4] + list(
                rng.randint(1, cfg.vocab, rng.randint(32, 129))))
    return prompts


def serve_trace(tengine, k3, ops, cfg, params, prompts, speculate, b_local,
                max_len, chunk, max_new=64):
    """Serve ``prompts`` on a fresh engine (after a warm-up that runs a
    prefill chunk, plain decode and, with speculation, a verify step),
    with the kernels' launch counts zeroed just before and read just
    after.  Returns the run's numbers."""
    from repro_torch.serving.telemetry import FlightRecorder

    eng = tengine.ServingEngine(
        cfg, params, dp=1, b_local=b_local, max_len=max_len,
        chunk_size=chunk, prefix_sharing=True, speculate=speculate,
        draft_len=4, device="cuda", flight=FlightRecorder(capacity=100_000))
    warm = [1] * (chunk + 1)
    for rid in (10**6, 10**6 + 1):     # the second drafts from the first
        eng.submit(tengine.Request(rid, prompt=list(warm), max_new_tokens=8))
        eng.run(max_steps=100)
    reqs = [tengine.Request(i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    st0 = dict(eng.stats)
    transfers0, adm0 = eng.host_transfers, eng.admission_transfers
    n_rec0 = len(eng.flight.ring)
    # the main path's run: counts zeroed just before, read just after
    ops.paged_attention_chunk.launches = 0
    ops.paged_attention.launches = 0
    k3.verify_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches = ops.paged_attention_chunk.launches
    k2_launches = ops.paged_attention.launches
    k3_launches = k3.verify_attention.launches
    recs = list(eng.flight.ring)[n_rec0:]
    d = {k: eng.stats[k] - st0[k] for k in (
        "steps", "tokens_out", "prompt_tokens", "spec_drafted",
        "spec_accepted", "spec_pages_rolled_back", "spec_mixed_steps",
        "prefix_shared_tokens", "prefix_shared_reqs", "cow_copies")}
    d.update(
        wall=wall, k1=k1_launches, k2=k2_launches, k3=k3_launches,
        spec_steps=sum(rec["spec"] for rec in recs), records=len(recs),
        decode_steps=sum(rec["T"] == 1 and not rec["spec"] for rec in recs),
        transfers=eng.host_transfers - transfers0,
        admission_transfers=eng.admission_transfers - adm0,
        tokens=[r.out_tokens for r in reqs], done=all(r.done for r in reqs),
        pages_after=eng.pages_in_use(), leak_free=eng.leak_free())
    del eng
    torch.cuda.empty_cache()
    return d


def serve_speculative(tengine, k3, ops, cfg, seed, b_local, max_len, chunk):
    """Phase 7: hot-prefix traffic at full width, speculative and plain,
    in bf16 (the model's type; K3's main-path run) and in f32 (where
    the two runs must give identical tokens)."""
    from repro_torch.models.model import init_params

    n_layers = cfg.n_layers
    prompts = hot_prefix_prompts(cfg, seed)
    phase(f"[7] hot-prefix trace: {len(prompts)} requests, "
          f"{sum(len(p) for p in prompts)} prompt tokens, 64 new tokens "
          f"each, draft length 4")
    runs = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = init_params(c, seed=seed, device="cuda")
        for spec in (True, False):
            r = serve_trace(tengine, k3, ops, c, params, prompts, spec,
                            b_local, max_len, chunk)
            runs[dtype, spec] = r
            name = f"{dtype} {'speculative' if spec else 'plain'}"
            check(r["done"], f"{name}: every request finished")
            check(r["records"] == r["steps"], f"{name}: flight records")
            check(all(0 <= t < cfg.vocab for s in r["tokens"] for t in s)
                  and all(len(s) == 64 for s in r["tokens"]),
                  f"{name}: 64 tokens inside the vocabulary per request")
            check(r["pages_after"] == 0 and r["leak_free"],
                  f"{name}: no page in use after the drain")
            check(r["transfers"] == r["steps"],
                  f"{name}: one transfer per step ({r['transfers']}, "
                  f"{r['steps']})")
            other = r["steps"] - r["spec_steps"] - r["decode_steps"]
            check(r["k3"] == n_layers * r["spec_steps"]
                  and r["k2"] == n_layers * r["decode_steps"] > 0
                  and r["k1"] == n_layers * other,
                  f"{name}: K3 {r['k3']} launches = {n_layers} x "
                  f"{r['spec_steps']} speculative steps, K2 {r['k2']} = "
                  f"{n_layers} x {r['decode_steps']} decode-only steps, K1 "
                  f"{r['k1']} = {n_layers} x the other steps")
            check(r["prefix_shared_tokens"] > 0, f"{name}: prefixes shared")
            if spec:
                check(r["spec_accepted"] > 0 and r["spec_steps"] > 0,
                      f"{name}: drafts accepted")
            phase(f"[7] {name}: {r['steps']} steps ({r['spec_steps']} "
                  f"speculative, {r['spec_mixed_steps']} mixed), drafted "
                  f"{r['spec_drafted']}, accepted {r['spec_accepted']}, "
                  f"pages rolled back {r['spec_pages_rolled_back']}, "
                  f"prefix_shared_tokens {r['prefix_shared_tokens']} "
                  f"({r['prefix_shared_reqs']} requests), cow_copies "
                  f"{r['cow_copies']}; K3 launches {r['k3']} = {n_layers} x "
                  f"{r['spec_steps']}, K2 launches {r['k2']} = {n_layers} x "
                  f"{r['decode_steps']}, K1 launches {r['k1']}; "
                  f"host_transfers {r['transfers']} = steps, "
                  f"admission_transfers {r['admission_transfers']}; pages "
                  f"in use after the drain {r['pages_after']}")
            phase(f"[7] {name}: {r['tokens_out'] / r['wall']:.1f} generated "
                  f"tok/s, {1e3 * r['wall'] / r['steps']:.2f} ms/step, wall "
                  f"{r['wall']:.3f} s")
        del params
        torch.cuda.empty_cache()
    check(runs["float32", True]["tokens"] == runs["float32", False]["tokens"],
          "f32: speculative tokens == plain tokens")
    a, b = runs["bfloat16", True]["tokens"], runs["bfloat16", False]["tokens"]
    same16 = sum(x == y for x, y in zip(a, b))
    phase(f"[7] f32: speculative == plain on all {len(prompts)} streams; "
          f"bf16: {same16} of {len(prompts)} streams identical (near-ties "
          f"may flip between kernels and matmul widths)")
    return runs["bfloat16", True]


def serve_entry_point(counted, smi):
    """Phase 14 (a): ``repro_torch.launch.serve.main``, the entry point a
    user starts a server from, at full width (olmo-1b, bf16, dp 1, 8
    slots, max_len 2048, its own seed-0 weights and trace): 32 requests
    on a 512-token hot prefix, 64 new tokens each, a quarter of them
    interactive, 64 pin pages.  The launch counts are zeroed just
    before ``main`` and read just after.  Returns the run's numbers."""
    import contextlib
    import io
    import re

    from repro_torch.launch import serve

    argv = ["--arch", "olmo-1b", "--dp", "1", "--b-local", "8",
            "--max-len", "2048", "--hot-prefix", "512", "--requests", "32",
            "--max-new", "64", "--interactive-frac", "0.25",
            "--pin-pages", "64", "--device", "cuda"]
    phase(f"[14a] python -m repro_torch.launch.serve {' '.join(argv)}")
    for fn in counted.values():
        fn.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eng = serve.main(argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    for line in out.getvalue().splitlines():
        phase(f"[14a] | {line}")
    st = eng.stats
    steps, decode_steps = st["steps"], st["chunk_hist"].get(1, 0)
    n_layers = eng.cfg.n_layers
    tok_s = float(re.search(r"([\d.]+) tok/s\)", out.getvalue()).group(1))
    lat = eng.latency_quantiles()
    margin = eng.telemetry.never_dry_margin_min()
    check(len(eng._latencies) == 32 and not eng.active
          and eng.scheduler.backlog() == 0
          and st["tokens_out"] == 32 * 64, "[14a]: every request finished "
                                           "with 64 tokens")
    check(st["pins_created"] >= 1, "[14a]: at least one pin created")
    check(eng.host_transfers == steps, f"[14a]: one transfer per step "
                                       f"({eng.host_transfers}, {steps})")
    check(launches["K1"] == n_layers * (steps - decode_steps)
          and launches["K2"] == n_layers * decode_steps > 0
          and sum(launches.values()) == n_layers * steps,
          f"[14a]: K1 + K2 launches = {n_layers} x steps ({launches}, "
          f"{steps} steps, {decode_steps} decode-only)")
    check(eng.page_occupancy() == 0.0 and eng.leak_free(),
          "[14a]: no page in use after the drain and flush_pins")
    check(margin is not None and margin >= 0, f"[14a]: never-dry margin "
                                              f"{margin} >= 0")
    phase(f"[14a] entry point on {smi}: {tok_s:.1f} generated tok/s, p50 "
          f"latency {1e3 * lat['p50_s']:.0f} ms, p50 time to first token "
          f"{1e3 * lat['first_token_p50_s']:.0f} ms; {steps} steps "
          f"({decode_steps} decode-only); K1 launches {launches['K1']}, K2 "
          f"launches {launches['K2']} (= {n_layers} x {steps}); transfers "
          f"{eng.host_transfers} = steps, admission_transfers "
          f"{eng.admission_transfers}; pins created {st['pins_created']}, "
          f"pin hits {st['pin_hit_reqs']}, preemptions "
          f"{st['preemptions']}, prefix_shared_reqs "
          f"{st['prefix_shared_reqs']}; never-dry margin {margin}")
    out = dict(k2=launches["K2"], k1=launches["K1"], steps=steps,
               tok_s=tok_s, **lat)
    del eng
    torch.cuda.empty_cache()
    return out


def decode_route_ab(tengine, ops, cfg, seed, b_local, max_len, chunk,
                    smi):
    """Phase 15: phase 5's workload served four times on one warm
    engine, decode-only steps through K1 at T = 1 (the route before K2)
    and through K2, in turns K1, K2, K2, K1 on one card; generated tok/s
    and ms/step of each.  K1 at T = 1 over ``base`` is K2 over ``base +
    1`` with ``zero_empty``, so both routes compute the same function."""
    from repro_torch.models import transformer
    from repro_torch.models.model import init_params

    k2 = transformer.paged_attention

    def via_k1(q, kp, vp, table, seq_lens, zero_empty):
        return ops.paged_attention_chunk(q[:, None].contiguous(), kp, vp,
                                         table, seq_lens - 1)[:, 0]

    params = init_params(cfg, seed=seed, device="cuda")
    eng = tengine.ServingEngine(cfg, params, dp=1, b_local=b_local,
                                max_len=max_len, chunk_size=chunk,
                                device="cuda")
    eng.submit(tengine.Request(10**6, prompt=[1] * (chunk + 1),
                               max_new_tokens=3))
    eng.run(max_steps=100)
    rates, tokens = {"K1": [], "K2": []}, {}
    try:
        for route in ("K1", "K2", "K2", "K1"):
            transformer.paged_attention = k2 if route == "K2" else via_k1
            reqs = make_requests(tengine, cfg, seed)
            steps0, out0 = eng.stats["steps"], eng.stats["tokens_out"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run(max_steps=10_000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = eng.stats["steps"] - steps0
            check(all(r.done for r in reqs), f"[15] {route} route finished")
            rates[route].append(((eng.stats["tokens_out"] - out0) / wall,
                                 1e3 * wall / steps))
            tokens[route] = [r.out_tokens for r in reqs]
    finally:
        transformer.paged_attention = k2
    same = sum(a == b for a, b in zip(tokens["K1"], tokens["K2"]))
    for route, runs in rates.items():
        phase(f"[15] phase 5's workload, decode-only steps through "
              f"{route}, on {smi}: "
              + ", ".join(f"{r:.1f} generated tok/s ({ms:.2f} ms/step)"
                          for r, ms in runs))
    phase(f"[15] {same} of {len(tokens['K1'])} streams identical between "
          f"the routes (bf16: near-ties may flip)")
    del eng, params
    torch.cuda.empty_cache()
    return rates


def top2_gap(cfg, params, context):
    """(top-1 minus top-2 logit, largest |logit|) of the next token
    after ``context``, from one full forward pass on the card."""
    from repro_torch.models.layers import logits_apply
    from repro_torch.models.transformer import forward_train

    with torch.no_grad():
        x = forward_train(cfg, params, torch.tensor([context], device="cuda"),
                          remat=False)
        logits = logits_apply(cfg, params["embed"], x[:, -1])[0].float()
    top = logits.topk(2).values
    return (top[0] - top[1]).item(), logits.abs().max().item()


def serve_preempting(tengine, counted, cfg, seed, preemption=True):
    """Phase 14 (b): the engine driven directly at full width with
    ``SchedConfig(pin_pages=128, pin_rows=16)`` (with the default 4 rows
    the 4 interactive prompts' own pins evict the victims' pins before
    readmission): 8 standard requests of 512-1,024
    prompt tokens and 128 new tokens fill the 8 slots; after 40 steps 4
    interactive requests of 64-256 prompt tokens and 32 new tokens
    arrive and preempt standard victims, whose whole pages ``preempt``
    pins and readmission shares back.  Returns the run's numbers; the
    engine's parameters stay in ``out["params"]`` for the caller."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.sched import SchedConfig

    params = init_params(cfg, seed=seed, device="cuda")
    eng = tengine.ServingEngine(
        cfg, params, dp=1, b_local=8, max_len=2048, chunk_size=64,
        sched=SchedConfig(pin_pages=128, pin_rows=16,
                          preemption=preemption),
        device="cuda")
    rng = np.random.RandomState(seed + 14)
    std = [tengine.Request(i, prompt=list(rng.randint(
        1, cfg.vocab, rng.randint(512, 1025))), max_new_tokens=128)
        for i in range(8)]
    inter = [tengine.Request(8 + i, prompt=list(rng.randint(
        1, cfg.vocab, rng.randint(64, 257))), max_new_tokens=32,
        slo="interactive") for i in range(4)]
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in std:
        eng.submit(r)
    for _ in range(40):
        eng.step()
    for r in inter:
        eng.submit(r)
    eng.run(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    reqs = std + inter
    st = dict(eng.stats)
    out = dict(tokens=[r.out_tokens for r in reqs], done=all(
        r.done for r in reqs), steps=st["steps"], wall=wall,
        tokens_out=st["tokens_out"], preemptions=st["preemptions"],
        pins=st["pins_created"], pin_hits=st["pin_hit_reqs"],
        pin_hit_tokens=st["pin_hit_tokens"],
        victims=sum(r.preemptions > 0 for r in reqs),
        transfers=eng.host_transfers, launches=launches,
        flushed=eng.flush_pins(), prompts=[r.prompt for r in reqs],
        params=params, n_layers=cfg.n_layers)
    out["empty"] = eng.page_occupancy() == 0.0 and eng.leak_free()
    del eng
    torch.cuda.empty_cache()
    return out


def check_preempting(tengine, counted, cfg, seed, smi):
    """Phase 14 (b) in bf16 (the model's type), then in f32 with and
    without preemption: every f32 stream must be the same, or differ
    first where the top-2 logit gap is within 1e-4 of the logit scale
    (a near-tie that batch-dependent matmul widths may flip)."""
    runs = {}
    for name, dtype, pre in (("bf16", "bfloat16", True),
                             ("f32", "float32", True),
                             ("f32 no preemption", "float32", False)):
        c = dataclasses.replace(cfg, dtype=dtype)
        r = runs[name] = serve_preempting(tengine, counted, c, seed, pre)
        n = r["n_layers"]
        check(r["done"] and r["empty"], f"[14b] {name}: every request "
              f"finished; 0 pages after the drain and flush_pins")
        check(r["transfers"] == r["steps"], f"[14b] {name}: one transfer "
                                            f"per step")
        check(r["launches"]["K1"] + r["launches"]["K2"] == n * r["steps"]
              and sum(r["launches"].values()) == n * r["steps"],
              f"[14b] {name}: K1 + K2 = {n} x steps ({r['launches']})")
        if pre:
            check(r["preemptions"] >= 1 and r["pin_hits"] >= 1,
                  f"[14b] {name}: a preemption and a pin hit")
        else:
            check(r["preemptions"] == 0, f"[14b] {name}: no preemption")
        phase(f"[14b] {name} on {smi}: {r['steps']} steps, "
              f"{r['tokens_out'] / r['wall']:.1f} generated tok/s, "
              f"{1e3 * r['wall'] / r['steps']:.2f} ms/step; preemptions "
              f"{r['preemptions']} ({r['victims']} victims), pins created "
              f"{r['pins']}, pin hits {r['pin_hits']} "
              f"({r['pin_hit_tokens']} tokens), pins flushed "
              f"{r['flushed']}; K1 {r['launches']['K1']} + K2 "
              f"{r['launches']['K2']} launches = {n} x {r['steps']}; "
              f"transfers {r['transfers']} = steps")
        if name != "f32":
            del r["params"]
            torch.cuda.empty_cache()
    a, b = runs["f32"], runs["f32 no preemption"]
    c32 = dataclasses.replace(cfg, dtype="float32")
    same = 0
    for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"])):
        if x == y:
            same += 1
            continue
        p = next(j for j, (u, v) in enumerate(zip(x, y)) if u != v)
        gap, scale = top2_gap(c32, a["params"], a["prompts"][i] + x[:p])
        phase(f"[14b] f32 stream {i} differs first at token {p}: top-2 "
              f"logit gap {gap:.3e}, logit scale {scale:.3e}")
        check(gap <= 1e-4 * scale, f"[14b] f32 stream {i}: a divergence "
                                   f"where the top-2 gap is not a near-tie")
    phase(f"[14b] f32: {same} of {len(a['tokens'])} streams of the "
          f"preempting run equal the run without preemption")
    del a["params"]
    torch.cuda.empty_cache()
    return runs["bf16"]


def profiled(run, tag="[p]"):
    """``--profile``: call ``run()``, which returns its step count,
    under ``torch.profiler`` and print where a step's time goes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ops = [], []           # device kernels; host-side operators
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.key, e.count, e.self_device_time_total))
        else:
            ops.append((e.key, e.count, e.self_cpu_time_total))
    busy_us = sum(k[2] for k in kernels)
    launches = sum(k[1] for k in kernels)
    phase(f"{tag} profiled run: {steps} steps, wall {1e3 * wall:.1f} ms "
          f"({1e3 * wall / steps:.2f} ms/step), kernels "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f}% of "
          f"wall), {launches / steps:.0f} kernels/step")
    for key, count, t in sorted(kernels, key=lambda r: -r[2])[:10]:
        phase(f"{tag} device {t / 1e3 / steps:8.3f} ms/step {count:7d}x "
              f"{key[:80]}")
    for key, count, t in sorted(ops, key=lambda r: -r[2])[:10]:
        phase(f"{tag} host   {t / 1e3 / steps:8.3f} ms/step {count:7d}x "
              f"{key[:80]}")


def profile_serve(eng, reqs, tag="[p]"):
    """``--profile``: serve ``reqs`` again on the warm engine under the
    profiler."""
    def run():
        steps0 = eng.stats["steps"]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=10_000)
        return eng.stats["steps"] - steps0

    profiled(run, tag)


def time_kernel(kernel, bound_bytes, plain, rng, cfg, b_local, maxp, P, T,
                base, hot=0):
    """Phases 6 and 8: a kernel, its plain version, SDPA over
    pre-gathered dense K/V with the same mask, and the bound, at one
    serving shape.  ``kernel(*inputs)`` returns a callable that
    launches the kernel once on those inputs (set-up the engine does
    once per step happens there, outside the timing).  Each of the
    model's layers has its own pages, so the timing cycles through that
    many K/V arrays and reads them cold from HBM, as a step does."""
    H, KH, hd, psz = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.page_size
    dt = cfg.tdtype
    layers = [attn_case(rng, b_local, T, H, KH, hd, psz, maxp, P, dt,
                        base=base, hot=hot) for _ in range(cfg.n_layers)]
    calls = [kernel(*layer) for layer in layers]
    it = iter(range(10 ** 9))

    def kern():
        calls[next(it) % len(calls)]()

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

    ms, host_ms = cuda_ms(kern, iters=4 * cfg.n_layers)
    plain_ms, _ = cuda_ms(ref, iters=cfg.n_layers, warmup=1)
    library_ms, _ = cuda_ms(lib, iters=4 * cfg.n_layers)
    q, kp, vp, table, bl = layers[0]
    nbytes = bound_bytes(q, kp, table, bl)
    pairs = sum(int(b) + t + 1 for b in base for t in range(T))
    flops = 4 * hd * H * pairs
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_OPS[dt]
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return dict(T=T, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def k6_inputs(rng, B, H, KH, S, hd, dtype, grad=False):
    """K6's inputs on the card as the training step hands them over: q
    and k transposed views of [B, S, H, hd] tensors, v contiguous."""
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
    q, k = f(B, S, H, hd).transpose(1, 2), f(B, S, KH, hd).transpose(1, 2)
    return [t.requires_grad_(grad) for t in (q, k, f(B, KH, S, hd))]


def check_k6(k6, rng):
    """Phase 3: K6, through the autograd Function the model calls,
    against its plain version, on each of its forward kernels (the
    route ``ops.forward_route`` picks by dtype and hd); then its
    backward kernels against autograd through the plain version, and
    twice on the same inputs.  Returns the worst bf16 forward and
    backward errors."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    bf, f32 = torch.bfloat16, torch.float32
    worst, worst_bwd = 0.0, 0.0
    routes = dict(k6.flash_attention.routes)
    for name, dt, B, H, KH, S, hd, causal in (
            ("olmo-1b bf16", bf, 1, 16, 16, 2048, 128, True),
            ("llama3.2-1b bf16 (G=4)", bf, 1, 32, 8, 1024, 64, True),
            ("S=77 bf16 (ragged tile, G=2)", bf, 2, 4, 2, 77, 128, True),
            ("S=200 bf16 bidirectional", bf, 2, 4, 1, 200, 64, False),
            ("hd=16 bf16 bidirectional", bf, 2, 4, 1, 77, 16, False),
            ("smoke f32 (G=2)", f32, 2, 4, 2, 64, 16, True),
            ("S=200 f32 (ragged tile)", f32, 2, 4, 2, 200, 64, True),
            ("bidirectional f32", f32, 1, 4, 4, 300, 128, False)):
        q, k, v = k6_inputs(rng, B, H, KH, S, hd, dt)
        route = k6.forward_route(dt, hd)
        before = k6.flash_attention.launches
        out = k6.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        check(k6.flash_attention.launches == before + 1,
              f"K6 {name}: the dispatcher launched the kernel once")
        check(bool(torch.isfinite(out.float()).all()), f"K6 {name}: finite")
        ref = flash_attention_ref(q, k, v, causal).float()
        torch.testing.assert_close(out.float(), ref, atol=TOL[dt],
                                   rtol=TOL[dt],
                                   msg=lambda m, n=name: f"K6 {n}: {m}")
        tol = f"tol {TOL[dt]:g}"
        if dt == bf:
            torch.testing.assert_close(
                out.float(), ref, atol=BF16_ULP_ATOL, rtol=BF16_ULP_RTOL,
                msg=lambda m, n=name: f"K6 {n}, one bf16 ulp: {m}")
            tol += f" and one ulp: rtol 2^-7, atol {BF16_ULP_ATOL:g}"
        err = (out.float() - ref).abs().max().item()
        phase(f"[3] K6 {name} B={B} H={H} KH={KH} S={S} hd={hd} "
              f"{'causal' if causal else 'bidirectional'}, {route} kernel: "
              f"max_abs_err {err:.3e}, max|ref| {ref.abs().max().item():.3e} "
              f"({tol})")
        if dt == bf:
            worst = max(worst, err)
    ran = {r: n - routes[r] for r, n in k6.flash_attention.routes.items()}
    check(all(n > 0 for n in ran.values()),
          f"K6: every forward kernel launched ({ran})")
    # the backward kernels against the gradient of the plain version;
    # bf16 at 6e-2: the kernels round P and dS to bf16 as the A operand
    # of their products, and both read o rounded to bf16 in rowsum(dO *
    # O)
    for name, dt, B, H, KH, S, hd, causal in (
            ("smoke f32", f32, 2, 4, 2, 64, 16, True),
            ("S=200 f32 bidirectional", f32, 2, 4, 2, 200, 64, False),
            ("S=1024 bf16", bf, 1, 16, 16, 1024, 128, True),
            ("S=2048 bf16", bf, 1, 16, 16, 2048, 128, True),
            ("S=77 bf16 (ragged tile, G=2)", bf, 2, 4, 2, 77, 128, True),
            ("hd=16 bf16 bidirectional", bf, 2, 4, 1, 77, 16, False)):
        q, k, v = k6_inputs(rng, B, H, KH, S, hd, dt, grad=True)
        do = torch.from_numpy(rng.randn(B, H, S, hd).astype(np.float32)).to(
            "cuda", dt)
        before = (k6.flash_attention.launches,
                  k6.flash_attention_bwd.launches)
        got = torch.autograd.grad(k6.flash_attention(q, k, v, causal),
                                  (q, k, v), do)
        torch.cuda.synchronize()
        check((k6.flash_attention.launches, k6.flash_attention_bwd.launches)
              == (before[0] + 1, before[1] + 1),
              f"K6 gradient {name}: one forward and one backward launch")
        want = torch.autograd.grad(flash_attention_ref(q, k, v, causal),
                                   (q, k, v), do)
        errs = []
        for what, a, b in zip(("dq", "dk", "dv"), got, want):
            check(a.dtype == dt, f"K6 gradient {name} {what}: dtype")
            torch.testing.assert_close(
                a.float(), b.float(), atol=TOL[dt], rtol=TOL[dt],
                msg=lambda m, n=name, w=what: f"K6 gradient {n} {w}: {m}")
            errs.append((a.float() - b.float()).abs().max().item())
        again = torch.autograd.grad(k6.flash_attention(q, k, v, causal),
                                    (q, k, v), do)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K6 gradient {name}: two backward calls bit-equal")
        phase(f"[3] K6 gradient {name} B={B} H={H} KH={KH} S={S} hd={hd} "
              f"{'causal' if causal else 'bidirectional'}, backward "
              f"kernels: max_abs_err dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
              f"{errs[2]:.3e} (tol {TOL[dt]:g}); a second call bit-equal")
        if dt == bf:
            worst_bwd = max(worst_bwd, *errs)
    return worst, worst_bwd


def smoke_batches(cfg_smoke, seed):
    """The smoke trainer's ``TokenStream``: 4 sequences of 64 tokens."""
    from repro_torch.data.pipeline import DataConfig, TokenStream

    return TokenStream(DataConfig(vocab=cfg_smoke.vocab, seq_len=64,
                                  global_batch=4, seed=seed))


def smoke_params(cfg_smoke, seed, device):
    """The smoke parameters, drawn on the CPU from ``seed``."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params

    return tree_map(lambda a: a.to(device),
                    init_params(cfg_smoke, seed=seed, device="cpu"))


def step0_grads(cfg_smoke, params, seed):
    """The gradients of the loss of the smoke trainer's first batch."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import loss_fn

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    device = leaves[0].device
    batch = {k: torch.from_numpy(a).to(device)
             for k, a in smoke_batches(cfg_smoke, seed).batch_at(0).items()}
    return torch.autograd.grad(loss_fn(cfg_smoke, params, batch), leaves)


def smoke_trainer(cfg_smoke, seed, device, n_steps, failure_at=None,
                  ckpt_dir=None):
    """The smoke trainer of ``launch/train.py`` on ``device`` from the
    same parameters and ``TokenStream`` batches: ``n_steps`` of
    ``build_step``, through ``FaultTolerantLoop`` when ``ckpt_dir`` is
    given.  Returns (losses by step, loop stats or None)."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.launch.train import build_step
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FailureInjector, FaultTolerantLoop

    params = smoke_params(cfg_smoke, seed, device)
    stream = smoke_batches(cfg_smoke, seed)
    step_fn = build_step(cfg_smoke, adamw.AdamWConfig(warmup_steps=10,
                                                      decay_steps=n_steps))
    losses = {}

    def step(state, batch):
        i = int(state[1].step)
        state, metrics = step_fn(state, {
            k: torch.from_numpy(a).to(device) for k, a in batch.items()})
        losses[i] = float(metrics["loss"])
        return state

    state = (params, adamw.init(params), None)
    if ckpt_dir is None:
        for i in range(n_steps):
            state = step(state, stream.batch_at(i))
        return losses, None
    injector = (FailureInjector(fail_at={failure_at: RuntimeError(
        "injected")}) if failure_at is not None else None)
    loop = FaultTolerantLoop(step, stream.batch_at, Checkpointer(ckpt_dir),
                             save_every=2, injector=injector)
    loop.run(state, n_steps)
    return losses, loop.stats


def check_train_vs_cpu(cfg_smoke, seed):
    """Phase 4: training on the card against the CPU (every kernel
    wrapper there runs its plain version), f32.  Step 0's gradients:
    each leaf within 1e-4 of its scale, or within twice what a one-ulp
    change of every weight moves that leaf on the CPU itself, where
    float32's own noise on this batch is larger than 1e-4 (the
    embedding gradient sums many positions of the same frequent
    token)."""
    from repro_torch.models.layers import tree_map

    cpu_params = smoke_params(cfg_smoke, seed, "cpu")
    g_cpu = step0_grads(cfg_smoke, cpu_params, seed)
    g_card = step0_grads(cfg_smoke, smoke_params(cfg_smoke, seed, "cuda"),
                         seed)
    rng = np.random.RandomState(seed)
    nudged = tree_map(lambda a: torch.nextafter(a.detach(), torch.from_numpy(
        np.where(rng.rand(*a.shape) < 0.5, -np.inf, np.inf).astype(
            np.float32))), cpu_params)
    g_nudged = step0_grads(cfg_smoke, nudged, seed)
    worst, floor_max, loose = 0.0, 0.0, 0
    for a, b, c in zip(g_card, g_cpu, g_nudged):
        a, scale = a.cpu(), b.abs().max().item()
        floor = ((c - b).abs().max() / scale).item()
        tol = max(1e-4, 2 * floor)
        loose += tol > 1e-4
        torch.testing.assert_close(a, b, rtol=1e-4, atol=tol * scale,
                                   msg=lambda m: f"step 0 gradients: {m}")
        worst = max(worst, ((a - b).abs().max() / scale).item())
        floor_max = max(floor_max, floor)
    cpu, card = smoke_trainer(cfg_smoke, seed, "cpu", 3), smoke_trainer(
        cfg_smoke, seed, "cuda", 3)
    l_card, l_cpu = [card[0][i] for i in range(3)], [cpu[0][i]
                                                     for i in range(3)]
    check(all(np.isfinite(l_card)), "finite losses on the card")
    check(abs(l_card[0] - l_cpu[0]) <= 1e-4 * abs(l_cpu[0]),
          f"step 0 loss on the card == on the CPU ({l_card[0]}, "
          f"{l_cpu[0]})")
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-3,
                               err_msg="losses on the card vs the CPU")
    phase(f"[4] smoke olmo-1b training on the card == on the CPU: losses "
          f"{l_card} vs {l_cpu} (step 0 within 1e-4, later 1e-3 relative);"
          f" step 0 gradients within {worst:.2e} of each leaf's scale "
          f"(tol 1e-4; {loose} of {len(g_cpu)} leaves at twice their CPU "
          f"one-ulp noise floor, which reaches {floor_max:.2e})")


def check_train_loop(cfg_smoke, seed):
    """Phase 4: the smoke trainer through ``FaultTolerantLoop`` on the
    card, with a failure injected before step 3, against an
    uninterrupted run; the loop counts every exception as a restart, so
    the count is checked."""
    import shutil

    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        clean = smoke_trainer(cfg_smoke, seed, "cuda", 5,
                              ckpt_dir=str(root / "clean"))
        failed = smoke_trainer(cfg_smoke, seed, "cuda", 5, failure_at=3,
                               ckpt_dir=str(root / "failed"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(clean[1].restarts == 0, f"uninterrupted run: no restart "
                                  f"({clean[1].restarts})")
    check(failed[1].restarts == 1 and failed[1].completed_steps == 5,
          f"one restart, five steps ({failed[1]})")
    check(sorted(failed[0]) == list(range(5)), "a loss for every step")
    diff = max(abs(failed[0][i] - clean[0][i]) for i in range(5))
    check(diff == 0.0, f"losses after the restart == the uninterrupted "
                       f"run's ({failed[0]} vs {clean[0]})")
    phase(f"[4] smoke trainer through FaultTolerantLoop on the card, "
          f"failure injected before step 3: {failed[1].restarts} restart, "
          f"restored from step 2, {failed[1].completed_steps} steps; losses "
          f"{[failed[0][i] for i in range(5)]} == the uninterrupted run's")


def train_full_width(cfg, seed, counted, smi, batch=4, seq=2048, steps=5,
                     profile=False):
    """Phase 12: olmo-1b at full width through ``build_step``: a warm-up
    step, then ``steps`` steps with the kernels' launch counts zeroed
    just before and read just after; with ``profile``, two more steps
    under the profiler.  Returns the run's numbers."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch.train import build_step
    from repro_torch.models.model import count_params, init_params
    from repro_torch.optim import adamw

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    state = (params, adamw.init(params), None)
    torch.cuda.synchronize()
    n_params = count_params(cfg)
    tag = f"[12] {cfg.name}"
    phase(f"{tag} params: {n_params} ({cfg.dtype}; AdamW mu, nu and master "
          f"float32), init {time.perf_counter() - t0:.1f} s; batch {batch} "
          f"x {seq} tokens (one micro-batch), {cfg.n_layers} layers")
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=0))
    # data loading is set-up: every batch on the card before the steps
    batches = [{k: torch.from_numpy(a).cuda() for k, a in
                stream.batch_at(i).items()} for i in range(steps + 1)]
    step_fn = build_step(cfg, adamw.AdamWConfig(warmup_steps=10,
                                                decay_steps=steps + 1))
    state, m = step_fn(state, batches[0])           # warm-up, not counted
    losses = [float(m["loss"])]
    n_global = sum(1 for k in cfg.layer_kinds if k == "global")
    expected = 2 * n_global
    phase(f"{tag}: K6 launches expected {expected} a step = {n_global} "
          f"global layers x 2 (the forward, and its recomputation in the "
          f"backward pass: remat=True puts each one-layer pattern group "
          f"under torch.utils.checkpoint), and {n_global} K6 backward "
          f"launches")
    # the main path's run: counts zeroed just before, read just after
    for fn in counted.values():
        fn.launches = 0
    syncs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, m = step_fn(state, batches[i])
                losses.append(float(m["loss"]))     # the one read a step
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append([str(w.message).splitlines()[0] for w in caught
                      if "called a synchronizing" in str(w.message)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{tag}: finite losses {losses}")
    k6_bwd = launches["K6 backward"]
    check(launches["K6"] == expected * steps and k6_bwd == n_global * steps
          and sum(launches.values()) == launches["K6"] + k6_bwd,
          f"{tag}: K6 launched {expected} times a step, its backward "
          f"{n_global} times, and no other kernel ran ({launches}, {steps} "
          f"steps)")
    check(all(len(s) == 1 for s in syncs),
          f"{tag}: one device-to-host transfer a step (the loss): {syncs}")
    ms = 1e3 * wall / steps
    tokens = batch * seq
    H, hd, L = cfg.n_heads, cfg.hd, n_global
    # 6 N per token for the matmul parameters (the input embedding is a
    # lookup), and the causal attention products forward and backward
    n_mm = n_params - cfg.vocab * cfg.d_model
    flops = 6 * n_mm * tokens + 6 * batch * H * hd * seq * (seq + 1) * L
    mfu = flops / (ms / 1e3) / PEAK_OPS[torch.bfloat16]
    phase(f"{tag}: losses {losses} (the first the warm-up step's); K6 "
          f"launches {launches['K6']} = {expected} x {steps} steps, K6 "
          f"backward {k6_bwd} = {n_global} x {steps}, other kernels "
          f"{sum(launches.values()) - launches['K6'] - k6_bwd}; "
          f"synchronizing calls a step under sync-debug mode: "
          f"{[len(s) for s in syncs]} {syncs[0]}")
    phase(f"{tag} on {smi}: {ms:.1f} ms a step, {tokens / (ms / 1e3):.0f} "
          f"tokens/s, peak memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated), model flops {flops:.4e} a step "
          f"(6 N_matmul tokens + attention), {100 * mfu:.1f}% of the card's "
          f"989 TFLOP/s bf16 peak")
    if profile:
        def run():
            nonlocal state
            for i in (1, 2):
                state, m = step_fn(state, batches[i])
                float(m["loss"])
            return 2

        profiled(run, f"{tag} [p]")
    del state, params, batches
    torch.cuda.empty_cache()
    return dict(launches=launches["K6"], bwd_launches=k6_bwd, steps=steps,
                ms=ms, mfu=mfu,
                tok_s=tokens / (ms / 1e3), peak=peak, losses=losses)


def time_k6(k6, rng, cfg, B=4, S=2048):
    """Phase 13: K6's forward and backward kernels at the training shape
    (bf16, causal, q and k strided views as the training step passes
    them), each beside its bound, its plain version and the library
    call (SDPA with ``is_causal``; its backward through
    ``torch.autograd.grad``).  Four sets of inputs (134 MB each) cycle,
    so each call reads its inputs from HBM as a layer of the step
    does."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)

    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(int(rng.randint(2**31)))
    f = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda").to(torch.bfloat16)
    sets = [(f(B, S, H, hd).transpose(1, 2), f(B, S, KH, hd).transpose(1, 2),
             f(B, KH, S, hd)) for _ in range(4)]
    it = iter(range(10 ** 9))

    def kern():
        k6.flash_attention_cuda(*sets[next(it) % 4])

    def ref():
        flash_attention_fwd_ref(*sets[next(it) % 4])

    def lib():
        torch.nn.functional.scaled_dot_product_attention(
            *sets[next(it) % 4], is_causal=True)

    saved = []
    for q, k, v in sets:
        o, lse = k6.flash_attention_cuda(q, k, v)
        saved.append((q, k, v, o, lse, torch.randn_like(o)))

    def bwd():
        k6.flash_attention_bwd_cuda(*saved[next(it) % 4])

    def bwd_ref():
        flash_attention_bwd_ref(*saved[next(it) % 4])

    # SDPA's backward alone: its graph kept, the gradient asked again
    graphs = []
    for q, k, v in sets[:2]:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                             is_causal=True)
        graphs.append((o, (q, k, v), torch.randn_like(o)))

    def bwd_lib():
        torch.autograd.grad(*graphs[next(it) % 2], retain_graph=True)

    ms, host_ms = cuda_ms(kern, iters=32)
    plain_ms, _ = cuda_ms(ref, iters=4, warmup=1)
    library_ms, _ = cuda_ms(lib, iters=32)
    b_ms, b_host_ms = cuda_ms(bwd, iters=16)
    b_plain_ms, _ = cuda_ms(bwd_ref, iters=4, warmup=1)
    b_library_ms, _ = cuda_ms(bwd_lib, iters=16)
    q, k, _ = sets[0]
    out = {}
    for name, t, nbytes, nflops in (
            ("fwd", (ms, host_ms, plain_ms, library_ms),
             k6.bound_bytes(q, k), k6.flops(q)),
            ("bwd", (b_ms, b_host_ms, b_plain_ms, b_library_ms),
             k6.bound_bytes_bwd(q, k), k6.flops_bwd(q))):
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * nflops / PEAK_OPS[torch.bfloat16]
        out[name] = dict(zip(("ms", "host_ms", "plain_ms", "library_ms"), t),
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms
                         else "operations", bytes=nbytes, flops=nflops)
    del sets, saved, graphs
    torch.cuda.empty_cache()
    return dict(B=B, S=S, **out)


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
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_chunk_ref as plain
    from repro_torch.kernels.paged_attention.ref import \
        paged_attention_ref as plain2
    from repro_torch.kernels.rg_lru import ops as k5
    from repro_torch.kernels.rg_lru.ref import rg_lru_ref
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.verify_attention import ops as k3
    from repro_torch.kernels.verify_attention.schedule import \
        build_verify_schedule
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

    # [2] build the kernels from this checkout's sources, in parallel
    t0 = time.perf_counter()
    stems = ("paged_attention", "paged_decode", "verify_attention",
             "ssd_scan", "rg_lru", "flash_attention", "flash_attention_bwd")
    build.load_all(stems)
    for stem in stems:
        for line in build.logs.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                phase(f"[2] {stem}: {line.strip()}")
    phase(f"[2] built {', '.join(stems)} in {time.perf_counter() - t0:.1f} "
          f"s into {build.BUILD_DIR}")

    cfg = get_config("olmo-1b")
    cfg_smoke = smoke_config(cfg)
    b_local, max_len, chunk = 8, 2048, 64
    maxp = max_len // cfg.page_size
    from repro_torch.models.transformer import pool_class_specs
    P = pool_class_specs(cfg, b_local, max_len, chunk)[0].num_blocks + 1

    # [3] kernels vs plain versions
    rng = np.random.RandomState(args.seed)
    err = check_kernel(ops, plain, rng, cfg, cfg_smoke, b_local, maxp, P)
    err2 = check_k2(ops, plain2, rng, (cfg, get_config("llama3.2-1b"),
                                       cfg_smoke), b_local, maxp, P)
    err3 = check_k3(k3, ops, plain, rng, cfg, cfg_smoke, b_local, maxp, P)
    mamba, mamba_smoke = (get_config("mamba2-370m"),
                          smoke_config(get_config("mamba2-370m")))
    rgemma, rgemma_smoke = (get_config("recurrentgemma-2b"),
                            smoke_config(get_config("recurrentgemma-2b")))

    def ssd_dims(c, T):
        di = c.ssd_expand * c.d_model
        return (b_local, T, di // c.ssd_head_dim, c.ssd_head_dim,
                c.ssd_state)

    bf, f32 = torch.bfloat16, torch.float32
    err4 = check_scan("K4", k4.ssd_scan, ssd_scan_ref, "ssd", [
        ("full T=1 bf16", ssd_dims(mamba, 1), bf),
        ("full T=64 bf16", ssd_dims(mamba, 64), bf),
        ("full T=1 f32", ssd_dims(mamba, 1), f32),
        ("full T=64 f32", ssd_dims(mamba, 64), f32),
        ("smoke T=8 f32", ssd_dims(mamba_smoke, 8), f32),
        ("smoke T=1 f32", ssd_dims(mamba_smoke, 1), f32)], rng)
    # K5's a and b are float32 in a bf16 model too
    err5 = check_scan("K5", k5.rg_lru, rg_lru_ref, "rglru", [
        ("full T=1 f32", (b_local, 1, rgemma.d_model), f32),
        ("full T=64 f32", (b_local, 64, rgemma.d_model), f32),
        ("smoke T=8 f32", (b_local, 8, rgemma_smoke.d_model), f32),
        ("S=200 d=192 f32", (b_local, 200, 192), f32)], rng)
    err6, err6b = check_k6(k6, rng)

    # [4] the engine on the card vs on the CPU, small input
    check_engine_vs_cpu(tengine, cfg_smoke, args.seed)
    check_spec_engine_vs_cpu(tengine, k3, cfg_smoke, args.seed)
    check_pins_engine_vs_cpu(tengine, cfg_smoke, args.seed)
    for c in (rgemma_smoke, mamba_smoke):
        check_engine_vs_cpu(tengine, c, args.seed, name=f"{c.name} engine "
                            f"(two size classes)", size_classes=2)
    check_train_vs_cpu(cfg_smoke, args.seed)
    check_train_loop(cfg_smoke, args.seed)

    # [5] the plain path at full width
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    run1 = serve_full_width(
        "[5]", tengine, counted, "K1", cfg, args.seed, b_local, max_len,
        chunk, make_requests(tengine, cfg, args.seed),
        profile_reqs=make_requests(tengine, cfg, args.seed + 1)
        if args.profile else None)

    # [6] K1 timings at the serving shapes: decode (T=1) at the contexts
    # the run reached, and a prefill chunk (T=64)
    def k1_call(*inputs):
        return lambda: ops.paged_attention_chunk_cuda(*inputs)

    base1 = rng.randint(64 + 32, 1024 + 64, b_local)
    base64 = rng.randint(0, 1024 - 64, b_local) // 64 * 64
    t1 = time_kernel(k1_call, ops.bound_bytes, plain, rng, cfg, b_local,
                     maxp, P, 1, base1)
    t64 = time_kernel(k1_call, ops.bound_bytes, plain, rng, cfg, b_local,
                      maxp, P, 64, base64)
    for t in (t1, t64):
        phase(f"[6] K1 T={t['T']} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16 on {smi}: kernel {t['ms']:.4f} ms "
              f"(host {t['host_ms']:.4f} ms a call), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['bytes']} B, {t['flops']} flop), plain "
              f"{t['plain_ms']:.4f} ms, library (SDPA, dense K/V) "
              f"{t['library_ms']:.4f} ms")
    phase(f"[6] end-to-end decode on {smi}: {run1['tok_s']:.1f} generated "
          f"tok/s")

    # [7] the speculative path at full width
    spec = serve_speculative(tengine, k3, ops, cfg, args.seed, b_local,
                             max_len, chunk)

    # [8] K3 timings: a verify step (T=5) of lanes past a shared
    # 512-token prompt, and a 64-token chunk after it
    work = torch.empty(k3.workspace_numel(b_local, 64, cfg.n_heads, cfg.hd,
                                          maxp), device="cuda")

    def k3_call(q, kp, vp, table, base):
        sched = build_verify_schedule(table, base, q.shape[1], kp.shape[1])
        return lambda: k3.verify_attention_cuda(q, kp, vp, table, base,
                                                sched, work)

    v5 = time_kernel(k3_call, k3.bound_bytes, plain, rng, cfg, b_local,
                     maxp, P, 5, rng.randint(512 + 32, 512 + 192, b_local),
                     hot=8)
    v64 = time_kernel(k3_call, k3.bound_bytes, plain, rng, cfg, b_local,
                      maxp, P, 64, rng.randint(512, 576, b_local), hot=8)
    for t in (v5, v64):
        phase(f"[8] K3 T={t['T']} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16, 8 shared prefix pages, on {smi}: "
              f"kernel {t['ms']:.4f} ms (host {t['host_ms']:.4f} ms a call), "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} "
              f"B, distinct pages; "
              f"{t['flops']} flop), plain {t['plain_ms']:.4f} ms, library "
              f"(SDPA, dense K/V) {t['library_ms']:.4f} ms")

    # [9], [10] the recurrent paths at full width: mamba2-370m (K4) and
    # recurrentgemma-2b (K5, and ring attention in plain torch ops)
    def rgemma_requests(seed):
        return make_requests(tengine, rgemma, seed, hi=3000, n_long=4,
                             long_lo=rgemma.window + 1)

    run4 = serve_full_width(
        "[9]", tengine, counted, "K4", mamba, args.seed, b_local, 2048,
        chunk, make_requests(tengine, mamba, args.seed), size_classes=2,
        profile_reqs=make_requests(tengine, mamba, args.seed + 1)
        if args.profile else None)
    run5 = serve_full_width(
        "[10]", tengine, counted, "K5", rgemma, args.seed, b_local, 4096,
        chunk, rgemma_requests(args.seed), size_classes=2,
        profile_reqs=rgemma_requests(args.seed + 1) if args.profile
        else None)

    # [11] K4 and K5 timings at the serving shapes: decode (T=1) and a
    # prefill chunk (T=64); bf16 activations as the model serves them
    def k4_bytes(a, h):
        return k4.bound_bytes(a[0], a[1], a[3], h)

    k4_times = [time_scan("ssd", k4.ssd_scan_cuda, ssd_scan_ref, k4_bytes,
                          lambda a: k4.flops(a[0], a[3]), ssd_dims(mamba, T),
                          mamba.n_layers, rng, bf) for T in (1, 64)]
    k5_times = [time_scan("rglru", k5.rg_lru_cuda, rg_lru_ref,
                          lambda a, h: k5.bound_bytes(a[0], h),
                          lambda a: k5.flops(a[0]),
                          (b_local, T, rgemma.d_model), run5["n_layers"], rng,
                          f32) for T in (1, 64)]
    for name, shape, ts in (
            ("K4", f"B={b_local} H={ssd_dims(mamba, 1)[2]} "
                   f"P={mamba.ssd_head_dim} N={mamba.ssd_state} bf16 x",
             k4_times),
            ("K5", f"B={b_local} d={rgemma.d_model} f32", k5_times)):
        for t in ts:
            phase(f"[11] {name} T={t['T']} {shape} on {smi}: kernel "
                  f"{t['ms']:.4f} ms (host {t['host_ms']:.4f} ms a call), "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                  f"{t['bytes']} B, {t['flops']} flop), plain "
                  f"{t['plain_ms']:.4f} ms, library: no single PyTorch call")
    for name, r in (("mamba2-370m", run4), ("recurrentgemma-2b", run5)):
        phase(f"[11] end-to-end {name} on {smi}: {r['tok_s']:.1f} generated "
              f"tok/s, {r['ms_step']:.2f} ms/step")

    # [12] the training path at full width, [13] K6 at its shape
    train = train_full_width(cfg, args.seed, counted, smi,
                             profile=args.profile)
    t6 = time_k6(k6, rng, cfg)
    for name, t, lib in (("forward (wgmma/TMA)", t6["fwd"], "SDPA, is_causal"),
                         ("backward", t6["bwd"], "SDPA's backward through "
                                                 "torch.autograd.grad")):
        phase(f"[13] K6 {name} B={t6['B']} H={cfg.n_heads} S={t6['S']} "
              f"hd={cfg.hd} causal bf16 on {smi}: kernel {t['ms']:.4f} ms "
              f"(host {t['host_ms']:.4f} ms a call), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']} flop, "
              f"{t['bytes']} B), plain {t['plain_ms']:.4f} ms, library "
              f"({lib}) {t['library_ms']:.4f} ms")

    # [14] the serve entry point at full width, then preemption
    entry = serve_entry_point(counted, smi)
    preempting = check_preempting(tengine, counted, cfg, args.seed, smi)

    # [15] K2 and K1 at T = 1 on the same inputs (decode at contexts of
    # 96-1,087 tokens), beside K2's bound, plain version and SDPA
    def k2_call(q, kp, vp, table, base):
        q2, lens = q[:, 0].contiguous(), base + 1
        return lambda: ops.paged_attention_cuda(q2, kp, vp, table, lens,
                                                True)

    def k2_plain(q, kp, vp, table, base):
        return plain2(q[:, 0], kp, vp, table, base + 1, zero_empty=True)

    def k2_bytes(q, kp, table, base):
        return ops.decode_bound_bytes(q[:, 0], kp, table, base + 1)

    base15 = np.random.RandomState(args.seed + 15).randint(96, 1088, b_local)
    t2, t2k1 = (time_kernel(call, nbytes, ref, np.random.RandomState(
        args.seed + 15), cfg, b_local, maxp, P, 1, base15)
        for call, nbytes, ref in ((k2_call, k2_bytes, k2_plain),
                                  (k1_call, ops.bound_bytes, plain)))
    for name, t in (("K2", t2), ("K1 at T=1, same inputs", t2k1)):
        phase(f"[15] {name} B={b_local} H={cfg.n_heads} hd={cfg.hd} "
              f"psz={cfg.page_size} bf16 on {smi}: kernel {t['ms']:.4f} ms "
              f"(host {t['host_ms']:.4f} ms a call), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
              f"{t['flops']} flop), plain {t['plain_ms']:.4f} ms, library "
              f"(SDPA, dense K/V) {t['library_ms']:.4f} ms")
    decode_route_ab(tengine, ops, cfg, args.seed, b_local, max_len, chunk,
                    smi)
    phase(f"[15] end-to-end on {smi}: entry point {entry['tok_s']:.1f} "
          f"generated tok/s; preempting run (bf16) "
          f"{preempting['tokens_out'] / preempting['wall']:.1f} tok/s")

    def row(name, src, replaces, n, e, t, t_other, shape):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": n, "max_abs_err": e,
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
                "shape": shape,
                f"t{t_other['T']}": {k: t_other[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}

    shape = (f"B={b_local} H={cfg.n_heads} hd={cfg.hd} psz={cfg.page_size} "
             f"bf16")
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:227",
         "launches": entry["k2"], "max_abs_err": err2,
         **{k: t2[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "host_ms")},
         "shape": f"T=1 {shape}, contexts 97-1088",
         "k1_same_inputs": {k: t2k1[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "library_ms")}},
        row("paged_attention_chunk",
            "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:171",
            run1["launches"], err,
            t1, t64, f"T=1 {shape}"),
        row("verify_attention",
            "src/repro_torch/kernels/verify_attention/csrc/"
            "verify_attention.cu",
            "src/repro/kernels/verify_attention/kernel.py:173", spec["k3"],
            err3, v5, v64, f"T=5 {shape}, 8 shared prefix pages"),
        row("ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan/kernel.py:93", run4["launches"],
            err4, *k4_times, f"T=1 B={b_local} H={ssd_dims(mamba, 1)[2]} "
                             f"P={mamba.ssd_head_dim} N={mamba.ssd_state} "
                             f"bf16"),
        row("rg_lru", "src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu",
            "src/repro/kernels/rg_lru/kernel.py:67", run5["launches"], err5,
            *k5_times, f"T=1 B={b_local} d={rgemma.d_model} f32"),
        *({"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/flash_attention/csrc/{src}",
           "replaces": replaces, "launches": n, "max_abs_err": e,
           **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "host_ms")},
           "shape": f"B={t6['B']} H={cfg.n_heads} S={t6['S']} hd={cfg.hd} "
                    f"causal bf16"}
          for name, src, replaces, n, e, t in (
              ("flash_attention", "flash_attention.cu",
               "src/repro/kernels/flash_attention/kernel.py:80",
               train["launches"], err6, t6["fwd"]),
              ("flash_attention_bwd", "flash_attention_bwd.cu",
               "src/repro/models/attention.py:53",
               train["bwd_launches"], err6b, t6["bwd"]))),
    ]
    phase(f"[15] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
