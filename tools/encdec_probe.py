"""Encoder-decoder and VLM serving alone, on one H100.

    python3 tools/encdec_probe.py [--seed 0]

Builds the kernels phase 19 runs, then runs ``chip_smoke.py``'s checks
of them through the same functions: phase 3's hd 96 and encoder-shape
kernel checks (K6 at hd 96 in bf16 and float32, bidirectional K6 at S
= 1,500, K1 and K2 at phi-3-vision's width), phase 4's whisper-tiny
and phi-3-vision smoke engines on the card against the CPU at one and
two size classes, and phase 19 ((a) whisper-tiny and (b) phi-3-vision
prefill and decode in bf16, (c) both in float32 against the one-shot
forward, (d) their engines at full width and phi-3-vision's text-only
prefill path against its engine, (e) the hd 96 kernels' times).

``--floors`` first runs phase 19 (c) for whisper-tiny at the
reference's weight scale and at each layer's own fan-in, printing the
error against the one-shot forward and the one-ulp floor without
holding them, and phi-3-vision's one-ulp floors of the one-shot
logits at both scales (text-only prompts of 512 tokens, and 64 tokens
after the image); ``--no-checks`` skips phases 3 and 4.

Needs one card; prints the card's name and power limit first, and a
line per phase as ``chip_smoke.py`` does.  Exits non-zero if a check
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def logit_floor(cs, cfg, seed, stacks, extra_rows=0, n=4, S=512):
    """One-ulp floor of the full-width f32 one-shot logits of ``n``
    prompts of ``S`` tokens (after ``extra_rows`` image positions or
    with the frames of an encoder-decoder), the stacked trees
    ``stacks`` at each layer's own fan-in."""
    from repro_torch.models.layers import logits_apply, tree_map
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import forward_train

    params = cs.own_fan_in(cfg, init_params(cfg, seed=seed, device="cuda"),
                           stacks)
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab, (n, S)).astype(
        np.int32)).cuda()
    extra = {}
    if cfg.arch_kind == "encdec":
        extra["enc_embeds"] = torch.randn(n, cfg.enc_len, cfg.d_model,
                                          device="cuda")
    elif extra_rows:
        extra["img_embeds"] = torch.randn(n, extra_rows, cfg.d_model,
                                          device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    with torch.no_grad():
        for p in (params, tree_map(lambda p: torch.nextafter(p, torch.where(
                torch.rand(p.shape, generator=g, device="cuda") < 0.5,
                torch.inf, -torch.inf)), params)):
            x = forward_train(cfg, p, toks, extra, remat=False)
            out.append(logits_apply(cfg, p["embed"], x[:, -17:]))
    del params, x
    torch.cuda.empty_cache()
    return ((out[1] - out[0]).abs().max() / out[0].abs().max()).item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--floors", action="store_true",
                    help="first, phase 19 (c) for whisper-tiny at the "
                         "reference's weight scale, its error and one-ulp "
                         "floor printed and not held")
    ap.add_argument("--no-checks", action="store_true",
                    help="skip phase 3's and phase 4's checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("encdec_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as k6
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_chunk_ref, paged_attention_ref)
    from repro_torch.kernels.rg_lru import ops as k5
    from repro_torch.kernels.ssd_scan import ops as k4
    from repro_torch.kernels.verify_attention import ops as k3
    from repro_torch.models.transformer import pool_class_specs
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
                    "paged_decode", "paged_decode_tma", "flash_attention"))
    for line in build.logs.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            cs.phase(f"[2] flash_attention: {line.strip()}")
    cs.phase(f"[2] built in {time.perf_counter() - t0:.1f} s")
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    olmo = get_config("olmo-1b")
    b_local, max_len, chunk = 8, 2048, 64
    maxp = max_len // olmo.page_size
    P = pool_class_specs(olmo, b_local, max_len, chunk)[0].num_blocks + 1
    if args.floors:
        c = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
        for stacks in ((), ("groups", "encoder")):
            cs.extra_full_width("[floor]", tengine, counted, c, args.seed, 8,
                                32, 16, smi, one_shot=True, stacks=stacks,
                                tol=float("inf"))
        phi = dataclasses.replace(get_config("phi-3-vision-4.2b"),
                                  dtype="float32")
        for rows, S in ((0, 512), (phi.img_tokens, 64)):
            for stacks in ((), ("groups",)):
                scale = ("each layer's own fan-in" if stacks
                         else "the reference's scale")
                cs.phase(f"[floor] phi-3-vision-4.2b, 4 prompts of {S} "
                         f"tokens after {rows} image positions, at {scale} "
                         f"on {smi}: a one-ulp change of every weight moves "
                         f"the f32 one-shot logits by "
                         f"{logit_floor(cs, phi, args.seed, stacks, rows, S=S):.3e}"
                         f" of their scale")
    if not args.no_checks:
        cs.check_encdec_kernels(k6, ops, k3, paged_attention_chunk_ref,
                                paged_attention_ref,
                                np.random.RandomState(args.seed + 24),
                                b_local, maxp, P)
        for arch in ("whisper-tiny", "phi-3-vision-4.2b"):
            for sc in (1, 2):
                cs.check_engine_vs_cpu(
                    tengine, smoke_config(get_config(arch)), args.seed,
                    name=f"{arch} smoke engine ({sc} size classes)",
                    size_classes=sc)
    t19 = time.perf_counter()
    cs.serve_encdec_vlm(tengine, k6, ops, paged_attention_chunk_ref, counted,
                        args.seed, smi, b_local, maxp, P, chunk)
    cs.phase(f"[19] encoder-decoder and VLM serving in "
             f"{time.perf_counter() - t19:.1f} s")
    cs.phase(f"[probe] total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
