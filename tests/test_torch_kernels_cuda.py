"""The port's CUDA kernels against their plain PyTorch versions.

Runs only on an NVIDIA Hopper card (``pytest -m cuda``); elsewhere each
test skips.  Imports neither jax nor the reference package, so it runs
on a machine that has only the port's dependencies.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as k6
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_chunk_ref as plain
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref as plain2
from repro_torch.kernels.rg_lru import ops as k5
from repro_torch.kernels.rg_lru.ref import rg_lru_ref
from repro_torch.kernels.ssd_scan import ops as k4
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,KH,hd,psz", [
    (torch.float32, 4, 2, 16, 8),             # smoke widths, G = 2
    (torch.float32, 16, 16, 128, 64),         # olmo-1b widths
    (torch.bfloat16, 16, 16, 128, 64),
    (torch.bfloat16, 32, 8, 64, 64),          # llama3.2-1b widths, G = 4
    (torch.bfloat16, 24, 8, 128, 16),         # G = 3, a head group of 4
    (torch.float32, 32, 2, 256, 16),          # G = 16: two head groups
    (torch.float32, 4, 2, 18, 8),             # rows off 16-byte loads
])
def test_paged_decode_kernel_vs_plain_and_k1(card, dtype, H, KH, hd, psz):
    """K2 against its plain version with ``zero_empty`` off (lane 1 has
    no valid key: the uniform mean) and on (zeros), and against K1 at
    T = 1 over ``base + 1`` positions, with a dead page in lane 2."""
    rng = np.random.RandomState(H + hd + psz)
    q, kp, vp, table, base = _case(rng, 8, 1, H, KH, hd, psz, 8, 96, dtype)
    q2, lens = q[:, 0].contiguous(), base + 1
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for zero_empty in (False, True):
        before = ops.paged_attention.launches
        out = ops.paged_attention(q2, kp, vp, table, lens,
                                  zero_empty=zero_empty)
        torch.cuda.synchronize()
        assert ops.paged_attention.launches == before + 1
        refs = [plain2(q2, kp, vp, table, lens, zero_empty=zero_empty)]
        if zero_empty:
            assert (out[1] == 0).all()
            refs.append(ops.paged_attention_chunk(q, kp, vp, table,
                                                  base)[:, 0])
        for ref in refs:
            ref = ref.float()
            torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
            if dtype == torch.bfloat16:
                torch.testing.assert_close(out.float(), ref, atol=1e-5,
                                           rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,H,P,N", [
    (torch.float32, 3, 5, 4, 16, 16),         # smoke widths
    (torch.float32, 8, 1, 32, 64, 128),       # mamba2-370m, decode
    (torch.float32, 8, 64, 32, 64, 128),      # mamba2-370m, prefill chunk
    (torch.bfloat16, 8, 1, 32, 64, 128),
    (torch.bfloat16, 8, 64, 32, 64, 128),
    (torch.float32, 3, 7, 3, 48, 100),        # P, N off the warp tiling
])
def test_ssd_scan_kernel_vs_plain(card, dtype, B, S, H, P, N):
    """K4 from a carried state h0 != 0, lane 1 with dt = 0 from token 2
    on and lane 2 with dt = 0 throughout (the serving path's inert
    tails): y and the state against the plain version, lane 2's state
    unchanged bit for bit."""
    rng = np.random.RandomState(S + P)
    dt = rng.rand(B, S, H).astype(np.float32) * 0.5 + 0.1
    dt[1, 2:] = 0.0
    dt[2] = 0.0
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
    x, Bm, Cm = f(B, S, H, P) * 0.5, f(B, S, N) * 0.3, f(B, S, N) * 0.3
    args = [x.to("cuda", dtype), torch.from_numpy(dt).cuda(),
            (-f(H).abs() * 0.5).cuda(), Bm.to("cuda", dtype),
            Cm.to("cuda", dtype), (f(H) * 0.1).cuda()]
    h0 = f(B, H, P, N).cuda()
    h = h0.clone()
    before = k4.ssd_scan.launches
    y, h_out = k4.ssd_scan(*args, h)
    torch.cuda.synchronize()
    assert k4.ssd_scan.launches == before + 1 and h_out is h
    y_ref, h_ref = ssd_scan_ref(*args, h0)
    assert y.dtype == dtype and torch.equal(h[2], h0[2])
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), y_ref.float(), atol=1e-5,
                                   rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,d", [
    (2, 5, 64), (8, 1, 2560), (8, 64, 2560),  # smoke; recurrentgemma-2b
    (3, 200, 192), (2, 13, 100)])             # S % 128 != 0; odd width
def test_rg_lru_kernel_vs_plain(card, B, S, d):
    """K5 from h0 != 0 with lane 1 inert (a = 1, b = 0) from token 3
    on: bit-equal to the plain version (the kernel rounds the product
    and the sum separately, as the two tensor ops do)."""
    rng = np.random.RandomState(S + d)
    a = rng.rand(B, S, d).astype(np.float32) * 0.9
    b = rng.randn(B, S, d).astype(np.float32) * 0.5
    a[1, 3:], b[1, 3:] = 1.0, 0.0
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    h0 = torch.from_numpy(rng.randn(B, d).astype(np.float32)).cuda()
    h = h0.clone()
    before = k5.rg_lru.launches
    hs, h_out = k5.rg_lru(a, b, h)
    torch.cuda.synchronize()
    assert k5.rg_lru.launches == before + 1 and h_out is h
    hs_ref, h_ref = rg_lru_ref(a, b, h0)
    assert torch.equal(hs, hs_ref) and torch.equal(h, h_ref)
    assert torch.equal(h[1], hs[1, min(2, S - 1)])


def _qkv(rng, B, H, KH, S, hd, dtype, grad=False):
    """q [B, H, S, hd] and k, v [B, KH, S, hd] on the card, q and k as
    the training step hands them over: transposed views of [B, S, H,
    hd] tensors."""
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32)).to("cuda", dtype)
    q, k = f(B, S, H, hd).transpose(1, 2), f(B, S, KH, hd).transpose(1, 2)
    v = f(B, KH, S, hd)
    return [t.requires_grad_(grad) for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,KH,S,hd,causal", [
    (torch.bfloat16, 1, 16, 16, 2048, 128, True),  # olmo-1b
    (torch.bfloat16, 1, 32, 8, 1024, 64, True),    # llama3.2-1b, G = 4
    (torch.float32, 2, 4, 2, 64, 16, True),        # the smoke configs
    (torch.float32, 2, 4, 2, 200, 64, True),       # a ragged last tile
    (torch.float32, 1, 4, 4, 300, 128, False),     # bidirectional
    (torch.bfloat16, 2, 4, 1, 77, 16, False),
    (torch.bfloat16, 2, 4, 2, 77, 128, True),      # ragged, wgmma
    (torch.bfloat16, 2, 4, 1, 200, 64, False),
])
def test_flash_attention_kernel_vs_plain(card, dtype, B, H, KH, S, hd,
                                         causal):
    """K6 on strided inputs against its plain version, through the
    forward kernel its dtype and hd pick; bf16 within one ulp of it
    (both compute in float32 from the same inputs and round once)."""
    rng = np.random.RandomState(S + H)
    q, k, v = _qkv(rng, B, H, KH, S, hd, dtype)
    before = k6.flash_attention.launches
    route = k6.forward_route(dtype, hd)
    on_route = k6.flash_attention.routes[route]
    out = k6.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert k6.flash_attention.launches == before + 1
    assert k6.flash_attention.routes[route] == on_route + 1
    assert out.dtype == dtype and out.stride() == q.stride()
    ref = flash_attention_ref(q, k, v, causal).float()
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref, atol=1e-5,
                                   rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,KH,S,hd,causal", [
    (torch.float32, 2, 4, 2, 64, 16, True),        # the smoke configs
    (torch.bfloat16, 1, 16, 16, 1024, 128, True),
    (torch.bfloat16, 1, 16, 16, 2048, 128, True),  # olmo-1b's S
    (torch.bfloat16, 2, 4, 2, 77, 128, True),      # ragged, G = 2
    (torch.bfloat16, 1, 32, 8, 512, 64, True),     # llama3.2-1b, G = 4
    (torch.bfloat16, 2, 4, 1, 77, 16, False),
    (torch.float32, 2, 4, 2, 200, 64, False),
])
def test_flash_attention_gradient(card, dtype, B, H, KH, S, hd, causal):
    """dq, dk, dv through K6's Function (its backward kernels, one
    counted launch) against autograd through the plain version.  bf16
    at 6e-2: the kernels round P and dS to bf16 as the A operand of
    their products, and both read the forward's output rounded to bf16
    in rowsum(dO * O)."""
    rng = np.random.RandomState(S)
    q, k, v = _qkv(rng, B, H, KH, S, hd, dtype, grad=True)
    do = torch.from_numpy(rng.randn(B, H, S, hd).astype(np.float32)).to(
        "cuda", dtype)
    before = k6.flash_attention_bwd.launches
    got = torch.autograd.grad(k6.flash_attention(q, k, v, causal), (q, k, v),
                              do)
    assert k6.flash_attention_bwd.launches == before + 1
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal),
                               (q, k, v), do)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_is_deterministic(card, dtype):
    """The backward kernels use no atomics: two calls on the same inputs
    give the same bits (the trainer's restart promise rests on it)."""
    rng = np.random.RandomState(1)
    q, k, v = _qkv(rng, 2, 8, 4, 300, 128, dtype)
    o, lse = k6.flash_attention_cuda(q, k, v)
    do = torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(
        "cuda", dtype)
    first = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    second = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_raises_on_what_it_does_not_take(card):
    rng = np.random.RandomState(0)
    q, k, v = _qkv(rng, 1, 4, 2, 64, 32, torch.float32)
    with pytest.raises(ValueError):
        k6.flash_attention(q, k, v)              # hd 32
    q, k, v = _qkv(rng, 1, 4, 2, 64, 16, torch.float16)
    with pytest.raises(TypeError):
        k6.flash_attention(q, k, v)
    # the wgmma kernel's tensor maps: rows on 16-byte boundaries
    q, k, v = _qkv(rng, 1, 4, 2, 64, 128, torch.bfloat16)
    qs = torch.empty(1, 4, 64, 129, dtype=torch.bfloat16,
                     device="cuda")[..., 1:]
    qs.copy_(q)
    with pytest.raises(ValueError):
        k6.flash_attention(qs, k, v)
    o, lse = k6.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError):                   # lse of another shape
        k6.flash_attention_bwd_cuda(q, k, v, o, lse[:, :, 1:], o)
