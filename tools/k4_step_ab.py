"""mamba2-370m serving with K4's T = 1 launches on its step route and on
the fma kernel, in turns on one H100.

    python3 tools/k4_step_ab.py [--seed 0] [--pairs 6] [--profile]

Serves ``chip_smoke.py`` phase 5's workload on mamba2-370m at full width
(bf16, two size classes, 8 slots, max_len 2048, chunk 64, random weights
from ``--seed``) on one warm engine through ``chip_smoke.route_ab``, as
phase 11 does: both sides run K4's wgmma route from SCAN_WGMMA_MIN_S
tokens on, and differ only in the T = 1 launches (the decode steps).
``--pairs`` pairs, in the order A B B A A B ..., then each side's
median ms/step, the distance between its quartiles, and the pairs the
step route won.  ``--profile`` then serves the workload twice more on
each side, A B A B on a new warm engine, under ``torch.profiler``
(``chip_smoke.profile_serve``; the first session of a process has been
seen to miss kernels): a step's device time by kernel and host time by
operator.  Needs one
card; prints the card's name and power limit first, and a line per turn
as ``chip_smoke.py`` does.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--profile", action="store_true",
                    help="then each side twice under the profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_step_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.models.model import init_params
    from repro_torch.serving import engine as tengine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.phase(f"[1] {smi}")
    build.load_all(("ssd_scan", "ssd_scan_wgmma", "ssd_step"))
    cs.phase(f"[2] built in {time.perf_counter() - t0:.1f} s")
    scan_route, wgmma_from = k4.scan_route, k4.SCAN_WGMMA_MIN_S
    fma, step = "T=1 on fma", "T=1 on step"
    order = sum(((fma, step) if i % 2 == 0 else (step, fma)
                 for i in range(args.pairs)), ())
    cfg = get_config("mamba2-370m")
    turns = {fma: cs.k4_turn(k4, scan_route, wgmma_from, False),
             step: cs.k4_turn(k4, scan_route, wgmma_from, True),
             None: cs.k4_turn(k4, scan_route, wgmma_from, True)}
    rates = cs.route_ab("[ab]", tengine, cfg, args.seed, 8, 2048, 64, smi,
                        turns, order, size_classes=2)
    ms = {name: np.array([m for _, m in runs]) for name, runs in rates.items()}
    for name, m in ms.items():
        q1, q3 = np.percentile(m, [25, 75])
        cs.phase(f"[ab] {name} on {smi}: median {np.median(m):.2f} ms/step, "
                 f"quartiles {q1:.2f}-{q3:.2f} ({q3 - q1:.2f} apart), "
                 f"{len(m)} turns")
    wins = int((ms[step] < ms[fma]).sum())
    cs.phase(f"[ab] the step route won {wins} of {args.pairs} pairs in "
             f"{time.perf_counter() - t0:.1f} s")
    if args.profile:
        eng = tengine.ServingEngine(
            cfg, init_params(cfg, seed=args.seed, device="cuda"), dp=1,
            b_local=8, max_len=2048, chunk_size=64, size_classes=2,
            device="cuda")
        eng.submit(tengine.Request(10**6, prompt=[1] * 65, max_new_tokens=3))
        eng.run(max_steps=100)
        try:
            for name in (fma, step, fma, step):
                turns[name]()
                cs.profile_serve(eng, cs.make_requests(tengine, cfg,
                                                       args.seed),
                                 f"[p {name}]")
        finally:
            turns[None]()
    cs.phase(f"[ab] total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
