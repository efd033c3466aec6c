"""Does K6's wgmma forward need the hi/lo split of P?  Run on an H100:

    python3 tools/k6_split_probe.py

Builds a copy of ``flash_attention.cu`` with the second PV product (the
lo half of P) taken out into ``build/k6_split_probe/``, holds both
versions to one bf16 ulp (rtol 2^-7, atol 1e-5) of the plain version on
``chip_smoke.py`` phase 3's bf16 wgmma cases and olmo-1b's training
shape, and times both there in turns (split, no split, no split,
split).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k6  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_fwd_ref  # noqa: E402

LO_PRODUCT = "        wgmma_pv<HD>(acc, pl_[kk], dv);\n"


def build_unsplit():
    """The wgmma entry point of a copy of the source without the lo
    product."""
    src = build.PKG / "kernels" / "flash_attention" / "csrc"
    out = ROOT / "build" / "k6_split_probe"
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "flash_common.cuh", out)
    text = (src / "flash_attention.cu").read_text()
    if LO_PRODUCT not in text:
        raise RuntimeError("the lo product of PV is not where expected")
    (out / "unsplit.cu").write_text(text.replace(LO_PRODUCT, ""))
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                    str(out / "libunsplit.so"), str(out / "unsplit.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "libunsplit.so")).flash_attention_fwd_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])

    def unsplit(q, k, v, causal=True):
        B, H, S, hd = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda")
        st = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                     for s in t.stride()[:3]))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), ctypes.addressof(st), B, H, k.shape[1], S,
                 hd, int(causal), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return o, lse

    return unsplit


def ms(fn, sets, iters=30):
    it = iter(range(10 ** 9))
    for _ in range(3):
        fn(*sets[next(it) % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*sets[next(it) % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    routes = {"split": k6.flash_attention_cuda, "no split": build_unsplit()}
    rng = np.random.RandomState(0)

    def qkv(B, H, KH, S, hd):
        f = lambda *s: torch.from_numpy(  # noqa: E731
            rng.randn(*s).astype(np.float32)).to("cuda", torch.bfloat16)
        return (f(B, S, H, hd).transpose(1, 2),
                f(B, S, KH, hd).transpose(1, 2), f(B, KH, S, hd))

    for name, B, H, KH, S, hd, causal in (
            ("olmo-1b", 1, 16, 16, 2048, 128, True),
            ("llama3.2-1b (G=4)", 1, 32, 8, 1024, 64, True),
            ("S=77 (ragged, G=2)", 2, 4, 2, 77, 128, True),
            ("S=200 bidirectional", 2, 4, 1, 200, 64, False),
            ("olmo-1b B=4", 4, 16, 16, 2048, 128, True)):
        q, k, v = qkv(B, H, KH, S, hd)
        ref = flash_attention_fwd_ref(q, k, v, causal)[0].float()
        for tag, fn in routes.items():
            out = fn(q, k, v, causal)[0].float()
            bad = ~torch.isclose(out, ref, rtol=2.0 ** -7, atol=1e-5)
            print(f"{name} {tag}: max_abs_err "
                  f"{(out - ref).abs().max().item():.3e}, outside one bf16 "
                  f"ulp: {int(bad.sum())} of {bad.numel()}")
    sets = [qkv(4, 16, 16, 2048, 128) for _ in range(4)]
    for tag in ("split", "no split", "no split", "split"):
        print(f"B=4 H=16 S=2048 hd=128 causal, {tag}: "
              f"{ms(routes[tag], sets):.4f} ms")


if __name__ == "__main__":
    main()
