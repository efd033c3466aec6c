"""Do two checkouts' builds of K6's kernels, K5's ``seq`` kernel and
K2's ``tma`` route give the same bits?  Run on an H100, once with each
checkout's ``src``:

    python3 tools/kernel_bits.py --src /path/to/other/src --save bits.pt
    python3 tools/kernel_bits.py --compare bits.pt

Each run builds the kernels of the package under ``--src`` (by default
this checkout's) into that checkout's build directory and runs them on
the same inputs, drawn from a seed with numpy: K6's forward on each of
its kernels (bf16 at hd 128 and 64, hd 16, float32), its backward on
the ``mma.sync`` and float32 kernels of ``flash_attention_bwd.cu`` (bf16
at hd 16, 64 and 128; float32 at hd 16, 64 and 128) and, in bf16 at hd
64 and 128, on the wgmma/TMA kernels of
``flash_attention_bwd_wgmma.cu``, K5 at T = 1, and
K2's ``tma`` route at hd 64 and 128 with G 1, 2, 4 and 8 (contexts of
1-1,023 tokens, an idle lane and a dead page; ``zero_empty`` off and
on).
``--save`` writes the outputs; ``--compare`` holds them bit for bit
against a saved file, prints one line a case, and exits 1 if any
differs.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

#: K2's tma cases: (H, KH, hd)
K2_CASES = [(16, 16, 128), (32, 8, 64), (32, 16, 128), (64, 8, 128)]
#: K6's cases: (dtype, B, H, KH, S, hd, causal)
K6_CASES = [("bfloat16", 2, 8, 4, 300, 128, True),
            ("bfloat16", 2, 4, 1, 200, 64, False),
            ("bfloat16", 2, 4, 2, 77, 16, True),
            ("float32", 2, 4, 2, 200, 64, True),
            ("float32", 1, 4, 4, 130, 128, False),
            ("float32", 2, 4, 2, 64, 16, True)]


def outputs(seed: int) -> dict:
    """Every case's outputs, on the CPU, by name."""
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops as k2
    from repro_torch.kernels.rg_lru import ops as k5

    rng = np.random.RandomState(seed)

    def f(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            "cuda", dtype)

    out = {}
    for name, B, H, KH, S, hd, causal in K6_CASES:
        dt = getattr(torch, name)
        q, k, v = (f(B, S, h, hd, dtype=dt).transpose(1, 2)
                   for h in (H, KH, KH))
        do = f(B, H, S, hd, dtype=dt)
        tag = f"K6 {name} hd={hd} S={S} {'causal' if causal else 'bidir'}"
        o, lse = k6.flash_attention_cuda(q, k, v, causal)
        out[f"{tag} forward o"], out[f"{tag} forward lse"] = o, lse
        # the mma.sync kernels at every bf16 hd: a route of their own
        # where the package has routes, the only kernel where it has not
        route = ({"route": "f32" if dt == torch.float32 else "mma"}
                 if hasattr(k6, "backward_route") else {})
        grads = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                            **route)
        for what, g in zip(("dq", "dk", "dv"), grads):
            out[f"{tag} backward {what}"] = g
        if dt == torch.bfloat16 and hd in (64, 128):
            grads = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                                route="wgmma")
            for what, g in zip(("dq", "dk", "dv"), grads):
                out[f"{tag} backward wgmma {what}"] = g
    a = torch.sigmoid(f(8, 1, 2560))
    b = f(8, 1, 2560)
    h = f(8, 2560)
    route = {"route": "seq"} if hasattr(k5, "lru_route") else {}
    hs = k5.rg_lru_cuda(a, b, h, **route)          # h updated in place
    out["K5 T=1 B=8 d=2560 hs"], out["K5 T=1 B=8 d=2560 h"] = hs, h
    B, maxp, P = 8, 16, 160
    for H, KH, hd in K2_CASES:
        lens = rng.randint(1, maxp * 64, B).astype(np.int32)
        table = np.full((B, maxp), -1, np.int32)
        avail = list(rng.permutation(P))
        for b in range(B):
            for i in range(-(-int(lens[b]) // 64)):
                table[b, i] = avail.pop()
        table[1] = -1                  # idle: no valid key
        table[2, 0] = -1               # a dead page in a live run
        q = f(B, H, hd, dtype=torch.bfloat16)
        kp, vp = (f(P, 64, KH, hd, dtype=torch.bfloat16) for _ in range(2))
        tbl = torch.from_numpy(table).cuda()
        sl = torch.from_numpy(lens).cuda()
        for zero_empty in (False, True):
            out[f"K2 tma H={H} KH={KH} hd={hd} zero_empty={zero_empty}"] = (
                k2.paged_attention_cuda(q, kp, vp, tbl, sl, zero_empty,
                                        "tma"))
    torch.cuda.synchronize()
    return {n: t.cpu() for n, t in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the checkout to build")
    ap.add_argument("--seed", type=int, default=0)
    act = ap.add_mutually_exclusive_group(required=True)
    act.add_argument("--save", help="write the outputs to this file")
    act.add_argument("--compare", help="hold the outputs against this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bits: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sys.path.insert(0, args.src)
    got = outputs(args.seed)
    if args.save:
        torch.save(got, args.save)
        print(f"kernel_bits: {len(got)} outputs of {args.src} saved to "
              f"{args.save}")
        return 0
    saved = torch.load(args.compare)
    check(sorted(saved) == sorted(got), "the same cases on both sides")
    differ = 0
    for name, t in got.items():
        same = t.dtype == saved[name].dtype and torch.equal(t, saved[name])
        differ += not same
        err = "" if same else (
            f": max |diff| "
            f"{(t.float() - saved[name].float()).abs().max().item():.3e}")
        print(f"kernel_bits: {name} {'bit-equal' if same else 'DIFFERS'}"
              f"{err}")
    print(f"kernel_bits: {len(got) - differ} of {len(got)} outputs "
          f"bit-equal to {args.compare}")
    return 1 if differ else 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"kernel_bits: FAILED: {what}")


if __name__ == "__main__":
    sys.exit(main())
