"""Where a mixtral-8x7b serving step's device time goes, on one H100.

    python3 tools/moe_step_profile.py [--layers 8] [--seed 0]

Builds ``chip_smoke.py`` phase 17's model (mixtral-8x7b at full width,
bf16, capacity factor 64, cut to ``--layers`` layers; random weights
from ``--seed``) and engines (dp 1, 8 slots, max_len 2048, chunk 64),
first resident (two size classes), then expert-paged at half of full
residency.  Each engine admits 8 requests restricted to experts (0, 1),
prompts of 128 and 1,000 tokens in turns, takes three steps, and then
runs two prefill steps (T = 64) and the first decode-only step (T = 1)
under ``torch.profiler``.  For each profiled step it prints the wall
time (slowed by the profiler), the device time and count of all
kernels, and the twelve largest kernels and the twelve operators whose
kernels take the most device time.  Needs one card; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def profile_step(eng, name):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    ka = prof.key_averages()
    kern = sorted((e for e in ka if e.device_type == cuda),
                  key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in ka if e.device_type != cuda),
                 key=lambda e: -e.self_device_time_total)
    print(f"{name}: wall {1e3 * wall:.1f} ms (profiled), kernels "
          f"{sum(e.self_device_time_total for e in kern) / 1e3:.2f} ms, "
          f"{sum(e.count for e in kern)} launches", flush=True)
    for tag, rows in (("kernel", kern), ("op", ops)):
        for e in rows[:12]:
            print(f"   {tag:6s} {e.self_device_time_total / 1e3:8.3f} ms "
                  f"{e.count:5d}x {e.key[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_step_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import engine as tengine

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = cs.moe_cfg(get_config("mixtral-8x7b"), n_layers=args.layers)
    params = init_params(cfg, seed=args.seed, device="cuda")
    full = args.layers * cfg.moe.num_experts * 3
    for paging in (False, True):
        eng = tengine.ServingEngine(
            cfg, params, dp=1, b_local=8, max_len=2048, chunk_size=64,
            size_classes=3 if paging else 2, expert_paging=paging,
            expert_budget=full // 2 if paging else None, device="cuda")
        rng = np.random.RandomState(3)
        reqs = [tengine.Request(i, prompt=list(rng.randint(
            1, cfg.vocab, 1000 if i % 2 else 128)), max_new_tokens=8,
            experts=(0, 1)) for i in range(8)]
        for r in reqs:
            eng.submit(r)
        for _ in range(3):
            eng.step()
        tag = "paged" if paging else "resident"
        profile_step(eng, f"{tag} T=64")
        profile_step(eng, f"{tag} T=64")
        while any(eng.pending_tokens[s] for s in eng.active):
            eng.step()
        profile_step(eng, f"{tag} T=1")
        eng.run(max_steps=1000)
        if not all(r.done for r in reqs):
            raise RuntimeError(f"{tag}: a request did not finish")
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
