"""Phase 25 of ``chip_smoke.py`` alone, on one H100.

    python3 tools/phase25_probe.py [--seed 0] [--parts abcd]

Builds the kernels the phase runs (K1, K2, K3 and K6), then runs its
parts through the same functions: (a) llama4-maverick expert-paged at
its published widths cut to 2 layers, skewed and uniform mixes, against
the resident engine on the same batches; (b) olmo-1b at phase 12's
shape without, then with ``--compress-grads`` (phase 12's own run is
not part of this probe: both runs here take 3 counted steps), and
``compress_tree`` on the card against the CPU; (c) the example twins
of ``repro_torch.examples`` on the card; (d) compressed training under
an injected failure.  Prints the card's name and power limit first,
and a line per check as ``chip_smoke.py`` does.  Exits non-zero if a
check fails.
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
    ap.add_argument("--parts", default="abcd",
                    help="the parts of phase 25 to run, of a, b, c, d")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase25_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.rg_lru import ops as k5
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.kernels.verify_attention import ops as k3
    from repro_torch.serving import engine as tengine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.phase(f"[1] {smi}")
    stems = ("paged_attention", "paged_attention_wgmma", "paged_decode",
             "paged_decode_tma", "verify_attention", "verify_attention_wgmma",
             "flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_wgmma")
    build.load_all(stems)
    cs.phase(f"[2] built {', '.join(stems)} in "
             f"{time.perf_counter() - t0:.1f} s")
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    lap = [time.perf_counter()]

    def done(part):
        now = time.perf_counter()
        cs.phase(f"[25{part}] in {now - lap[0]:.1f} s")
        lap[0] = now

    if "a" in args.parts:
        cs.serve_llama4_paged(tengine, counted, args.seed, smi)
        done("a")
    if "b" in args.parts:
        plain = cs.train_full_width(get_config("olmo-1b"), args.seed,
                                    counted, smi, steps=3, tag="[12]",
                                    turns=False)
        cs.train_compressed(counted, args.seed, smi, plain)
        done("b")
    if "c" in args.parts:
        cs.run_examples(smi)
        done("c")
    if "d" in args.parts:
        cs.compressed_recovery(smi)
        done("d")
    cs.phase(f"[25] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
