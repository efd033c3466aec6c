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
from repro_torch.kernels.verify_attention import ops as k3


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


def _hot_case(rng, B, T, H, KH, hd, psz, maxp, P, dtype, hot=4):
    """Verify-step inputs: every lane maps the same ``hot`` prefix
    pages, then pages of its own, and one page past its causal window
    (which no query may see); lane 1 is idle (all rows masked)."""
    base = rng.randint(hot * psz, (maxp - 1) * psz - T, B).astype(np.int32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    prefix = [avail.pop() for _ in range(hot)]
    for b in range(B):
        for i in range(min(-(-(int(base[b]) + T) // psz) + 1, maxp)):
            table[b, i] = prefix[i] if i < hot else avail.pop()
    table[1] = -1
    base[1] = 0
    q, kp, vp = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((B, T, H, hd), (P, psz, KH, hd),
                           (P, psz, KH, hd)))
    return [q.to("cuda", dtype), kp.to("cuda", dtype), vp.to("cuda", dtype),
            torch.from_numpy(table).cuda(), torch.from_numpy(base).cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,H,KH,hd,psz", [
    (torch.float32, 5, 4, 2, 16, 8),          # smoke widths, G = 2
    (torch.float32, 5, 16, 16, 128, 64),      # olmo-1b widths, draft 4
    (torch.float32, 64, 16, 16, 128, 64),     # a draft riding a chunk
    (torch.bfloat16, 5, 16, 16, 128, 64),
    (torch.bfloat16, 64, 16, 16, 128, 64),
    (torch.bfloat16, 5, 32, 8, 64, 64),       # llama3.2-1b widths, G = 4
])
def test_verify_attention_kernel_vs_plain_and_k1(card, dtype, T, H, KH, hd,
                                                 psz):
    """K3 against its plain version and against K1 on the same inputs,
    with lanes sharing their prefix pages."""
    rng = np.random.RandomState(T + H + 1)
    args = _hot_case(rng, 8, T, H, KH, hd, psz, 16, 160, dtype)
    before = k3.verify_attention.launches
    out = k3.verify_attention(*args)
    torch.cuda.synchronize()
    assert k3.verify_attention.launches == before + 1
    assert (out[1] == 0).all()
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for ref in (plain(*args), ops.paged_attention_chunk(*args)):
        ref = ref.float()
        torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(out.float(), ref, atol=1e-5,
                                       rtol=2.0 ** -7)
