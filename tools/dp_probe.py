"""The DP allocation plane alone: phase 20 of ``chip_smoke.py``.

    python3 tools/dp_probe.py [--seed 0]

Builds the paged-attention kernels olmo-1b serves through, then runs
``chip_smoke.py``'s phase 20 through the same function: (a) phase 4's
f32 olmo-1b smoke workload at dp 2 on two gloo ranks sharing the card
against the CPU single-process engine, (b) olmo-1b at full width on
phase 5's requests at dp 2 on the same ranks against the single-process
dp 2 engine, (c) (b) over nccl where the run was given two cards,
(d) olmo-1b in f32 at full width and two layers on the ranks of (a),
token for token against the single-process dp 2 engine, (e) phase 16
(c)'s ``launch.serve`` with every fault kind on the ranks, (f) (d)'s
model under a crash, a torn crash and a step error against one process
under the same faults.

Needs one card; prints the card's name and power limit first, and a
line per phase as ``chip_smoke.py`` does.  Exits non-zero if a check
fails.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config, smoke_config
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
    build.load_all(("paged_attention", "paged_attention_wgmma",
                    "paged_decode", "paged_decode_tma"))
    cs.phase(f"[2] built in {time.perf_counter() - t0:.1f} s")
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    cfg = get_config("olmo-1b")
    cs.serve_dp_ranks(tengine, counted, cfg, smoke_config(cfg), args.seed,
                      8, 2048, 64, smi)
    cs.phase(f"[20] total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
