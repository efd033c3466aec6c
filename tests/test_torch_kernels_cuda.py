"""The port's CUDA kernels against their plain PyTorch versions.

Runs only on an NVIDIA Hopper card (``pytest -m cuda``); elsewhere each
test skips.  Imports neither jax nor the reference package, so it runs
on a machine that has only the port's dependencies.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import numpy as np
import torch

from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_chunk_ref as plain


@pytest.fixture
def card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs an NVIDIA Hopper GPU (sm_90)")


def _case(rng, B, T, H, KH, hd, psz, maxp, P, dtype):
    base = rng.randint(0, (maxp - 1) * psz - T, B).astype(np.int32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    for b in range(B):
        for i in range(-(-(int(base[b]) + T) // psz)):
            table[b, i] = avail.pop()
    table[1] = -1                      # an idle slot: all rows masked
    table[2, 0] = -1                   # a dead page inside a live run
    q, kp, vp = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((B, T, H, hd), (P, psz, KH, hd),
                           (P, psz, KH, hd)))
    return [q.to("cuda", dtype), kp.to("cuda", dtype), vp.to("cuda", dtype),
            torch.from_numpy(table).cuda(), torch.from_numpy(base).cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,H,KH,hd,psz", [
    (torch.float32, 3, 4, 2, 16, 8),          # smoke widths, G = 2
    (torch.float32, 1, 16, 16, 128, 64),      # olmo-1b widths, decode
    (torch.float32, 64, 16, 16, 128, 64),     # olmo-1b widths, prefill
    (torch.bfloat16, 1, 16, 16, 128, 64),
    (torch.bfloat16, 64, 32, 8, 64, 64),      # llama3.2-1b widths, G = 4
    (torch.bfloat16, 100, 8, 4, 128, 16),     # rows beyond one tile
])
def test_paged_attention_chunk_kernel_vs_plain(card, dtype, T, H, KH, hd,
                                               psz):
    rng = np.random.RandomState(T + H)
    args = _case(rng, 8, T, H, KH, hd, psz, 8, 96, dtype)
    before = ops.paged_attention_chunk.launches
    out = ops.paged_attention_chunk(*args)
    torch.cuda.synchronize()
    assert ops.paged_attention_chunk.launches == before + 1
    assert (out[1] == 0).all()
    ref = plain(*args).float()
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # both sides accumulate in float32 from the same inputs and round
        # once to bf16, so they may differ by one ulp (2^-7 relative)
        torch.testing.assert_close(out.float(), ref, atol=1e-5,
                                   rtol=2.0 ** -7)
