"""Serving ms/step of two checkouts in turns on one H100.

    python3 tools/serve_ab.py --src /path/to/other/src --src src \\
        --order 0,1,1,0

Each turn is one process that imports the package under its ``--src``
(so two checkouts never share a module), builds the paged-attention
kernels into that checkout's build directory, and serves olmo-1b at
full width (bf16, dp 1, 8 slots, max_len 2048, chunk 64, random weights
from seed 0) on ``chip_smoke.py`` phase 5's workload: one warm-up
request, then the 16 requests twice, greedy, or with ``--sampled`` three
in four sampled as phase 16 does (temperature 0.8, top-k 50, seeds 1000
+ rid).  A turn prints its checkout, ms/step and generated tok/s of each
serve; the parent prints the card's name and power limit first and every
turn's line after.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def workload(tengine, cfg, seed, sampled):
    """chip_smoke.py's phase 5 requests (``make_requests``), sampled as
    phase 16 samples them when asked."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = rng.randint(64, 1025, 16)
    reqs = [tengine.Request(i, prompt=list(rng.randint(1, cfg.vocab, m)),
                            max_new_tokens=int(rng.randint(32, 65)))
            for i, m in enumerate(lens)]
    if sampled:
        for r in reqs:
            if r.rid % 4:
                r.temperature, r.top_k, r.seed = 0.8, 50, 1000 + r.rid
    return reqs


def turn(sampled: bool) -> None:
    """One checkout's serves (this process's ``sys.path`` has its src)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving import engine as tengine

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_all(("paged_attention", "paged_attention_wgmma",
                    "paged_decode", "paged_decode_tma"))
    cfg = get_config("olmo-1b")
    params = init_params(cfg, seed=0, device="cuda")
    eng = tengine.ServingEngine(cfg, params, dp=1, b_local=8, max_len=2048,
                                chunk_size=64, device="cuda")
    eng.submit(tengine.Request(10**6, prompt=[1] * 65, max_new_tokens=3))
    eng.run(max_steps=100)
    out = []
    for _ in range(2):
        reqs = workload(tengine, cfg, 0, sampled)
        steps0, tok0 = eng.stats["steps"], eng.stats["tokens_out"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=10_000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.stats["steps"] - steps0
        if not all(r.done for r in reqs):
            raise RuntimeError("a request did not finish")
        out.append({"ms_step": 1e3 * wall / steps, "steps": steps,
                    "tok_s": (eng.stats["tokens_out"] - tok0) / wall})
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src directory (give two)")
    ap.add_argument("--order", default="0,1,1,0",
                    help="the turns, as indices into the --src list")
    ap.add_argument("--sampled", action="store_true")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.sampled)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for i in (int(x) for x in args.order.split(",")):
        src = str(Path(args.src[i]).resolve())
        env = dict(os.environ, PYTHONPATH=src)
        cmd = [sys.executable, str(Path(__file__).resolve()), "--turn",
               "--src", src] + (["--sampled"] if args.sampled else [])
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=900)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{args.src[i]}: " + ", ".join(
            f"{r['ms_step']:.2f} ms/step ({r['steps']} steps), "
            f"{r['tok_s']:.1f} tok/s" for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
