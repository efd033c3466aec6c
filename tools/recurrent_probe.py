"""Training and prefill of the recurrent decoders alone, on one H100.

    python3 tools/recurrent_probe.py [--seed 0] [--profile]

Runs ``chip_smoke.py``'s phase 4 training checks on the mamba2-370m and
recurrentgemma-2b smoke configs and its phase 18 ((a) and (b) training
at full width, (c) their profile with ``--profile``, (d) the prefill
path in float32), through the same functions, after building the
kernels.  Then it measures what ``chip_smoke.rglru_fan_in`` is for:
each model's float32 noise floor at the reference's weight scale
(``init_params`` as it draws them) and at each layer's own fan-in.

- full width, f32: the largest change of the one-shot logits (4 prompts
  of 512 tokens) when every weight moves by one ulp, relative to their
  largest magnitude;
- smoke, f32: step 0's gradients on the card against the CPU, leaf by
  leaf, beside the CPU's one-ulp floor of the same leaf (phase 4's
  rule holds a leaf within the larger of 1e-4 and twice that floor).

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


def nudged(params, seed, device):
    """Every leaf moved one ulp up or down, at random from ``seed``."""
    from repro_torch.models.layers import tree_map

    g = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda p: torch.nextafter(p, torch.where(
        torch.rand(p.shape, generator=g, device=device) < 0.5, torch.inf,
        -torch.inf)), params)


def logit_floor(cs, arch, seed, fan_in):
    """One-ulp floor of the full-width f32 one-shot logits."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import logits_apply
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import forward_train

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    params = init_params(cfg, seed=seed, device="cuda")
    if fan_in:
        params = cs.rglru_fan_in(cfg, params)
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        1, cfg.vocab, (4, 512)).astype(np.int32)).cuda()
    out = []
    with torch.no_grad():
        for p in (params, nudged(params, seed, "cuda")):
            x = forward_train(cfg, p, toks, remat=False)
            out.append(logits_apply(cfg, p["embed"], x[:, -64:]))
    del params, x
    torch.cuda.empty_cache()
    return ((out[1] - out[0]).abs().max() / out[0].abs().max()).item()


def gradient_floors(cs, arch, seed, fan_in):
    """Largest card-vs-CPU gradient difference and largest CPU one-ulp
    floor over the smoke config's leaves, each relative to the leaf's
    scale, and the largest ratio of the first to the second."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_params

    cfg = smoke_config(get_config(arch))
    params = init_params(cfg, seed=seed, device="cpu")
    if fan_in:
        params = cs.rglru_fan_in(cfg, params)
    g_cpu = cs.step0_grads(cfg, params, seed)
    g_card = cs.step0_grads(cfg, tree_map(lambda a: a.detach().cuda(),
                                          params), seed)
    g_nudged = cs.step0_grads(cfg, nudged(tree_map(
        lambda a: a.detach(), params), seed, "cpu"), seed)
    diff = floor = ratio = 0.0
    for a, b, c in zip(g_card, g_cpu, g_nudged):
        scale = b.abs().max().item()
        d = (a.cpu() - b).abs().max().item() / scale
        f = (c - b).abs().max().item() / scale
        diff, floor = max(diff, d), max(floor, f)
        ratio = max(ratio, d / max(1e-4, 2 * f))
    return diff, floor, ratio


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="phase 18 (c): two training steps a model under "
                         "torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("recurrent_probe: no CUDA device", file=sys.stderr)
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
    print(smi, flush=True)
    build.load_all(("paged_attention", "paged_attention_wgmma",
                    "paged_decode", "paged_decode_tma", "verify_attention",
                    "verify_attention_wgmma", "ssd_scan", "ssd_scan_wgmma",
                    "ssd_step", "rg_lru", "rg_lru_tma", "flash_attention",
                    "flash_attention_bwd", "flash_attention_bwd_wgmma"))
    counted = {"K1": ops.paged_attention_chunk, "K2": ops.paged_attention,
               "K3": k3.verify_attention, "K4": k4.ssd_scan,
               "K5": k5.rg_lru, "K6": k6.flash_attention,
               "K6 backward": k6.flash_attention_bwd}
    mamba, rgemma = get_config("mamba2-370m"), get_config("recurrentgemma-2b")
    for c in (smoke_config(mamba), smoke_config(rgemma)):
        cs.check_train_vs_cpu(c, args.seed)
        cs.check_train_loop(c, args.seed)
    for x, c in (("a", mamba), ("b", rgemma)):
        cs.train_recurrent_full_width(f"[18{x}]", c, args.seed, counted, smi,
                                      profile=args.profile)
    for c, n, plen in ((mamba, 8, 512), (rgemma, 4, 2304)):
        cs.prefill_full_width("[18d]", tengine, counted, c, args.seed, n,
                              plen, smi)
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        for fan_in in (False, True):
            if fan_in and arch == "mamba2-370m":
                continue                # rglru_fan_in leaves it as it is
            scale = ("each layer's own fan-in" if fan_in
                     else "the reference's scale")
            lf = logit_floor(cs, arch, args.seed, fan_in)
            diff, floor, ratio = gradient_floors(cs, arch, args.seed, fan_in)
            cs.phase(f"[floor] {arch} at {scale} on {smi}: a one-ulp change "
                     f"of every weight moves the full-width f32 logits by "
                     f"{lf:.3e} of their scale; smoke step 0 gradients, card "
                     f"against CPU, up to {diff:.3e} of a leaf's scale, the "
                     f"CPU's one-ulp floor up to {floor:.3e}, the worst leaf "
                     f"at {ratio:.3g} x phase 4's limit")
    cs.phase(f"[probe] total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
