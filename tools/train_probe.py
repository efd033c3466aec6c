"""Training at full width alone, on one H100.

    python3 tools/train_probe.py [--seed 0] [--profile] [--phase 22|24]

Builds K6's kernels, then runs one of ``chip_smoke.py``'s training
phases through the same function.  Phase 22 (the default,
``train_vlm_encdec``): (e) K6's backward at hd 96 and at whisper-tiny's
encoder shape against its plain version and its walk, (a)
phi-3-vision-4.2b at full width through ``build_step``, (b)
``launch.train.main`` for it, (c) whisper-tiny at full width, (d)
phi-3-vision in float32 at two layers, card against CPU, (f) K6's
backward times; ``--profile`` runs two more steps of (a) and (c)
under ``torch.profiler`` and prints where a step's time goes.  Phase
24 (``train_three_archs``): K6 at G 4 and G 3 against its plain
version, llama3.2-1b, phi4-mini-3.8b and mixtral-8x7b at full width
at their reckoned depths, the float32 checks at two layers, K6's
times.  Prints the card's name and
power limit first, and a line per check as ``chip_smoke.py`` does
(phase 22 (b) prints the free disk and host memory its depth comes
from).  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="two more steps of (a) and (c) under the profiler")
    ap.add_argument("--phase", type=int, choices=(22, 24), default=22)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.rg_lru import ops as k5
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.kernels.verify_attention import ops as k3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.phase(f"[1] {smi}")
    stems = ("flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_wgmma")
    build.load_all(stems)
    for stem in stems:
        for line in build.logs.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                cs.phase(f"[2] {stem}: {line.strip()}")
    cs.phase(f"[2] built in {time.perf_counter() - t0:.1f} s")
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    if args.phase == 22:
        cs.train_vlm_encdec(k6, counted, args.seed, smi,
                            profile=args.profile)
    else:
        cs.train_three_archs(k6, counted, args.seed, smi)
    cs.phase(f"[{args.phase}] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
