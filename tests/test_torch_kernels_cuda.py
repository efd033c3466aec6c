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
from repro_torch.kernels.flash_attention.ref import (
    BWD_ROW_TOL, flash_attention_bwd_tiled_ref, flash_attention_fwd_ref,
    flash_attention_ref, row_scaled_err)
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
    (torch.bfloat16, 1, 32, 32, 96, 64),      # phi-3-vision widths, wgmma
    (torch.bfloat16, 64, 32, 32, 96, 64),
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


def _route_case(rng, T, H, KH, hd, B=10, psz=64, maxp=24, P=224, hot=4):
    """bf16 inputs of the wgmma routes: the lanes map the same ``hot``
    prefix pages (8 lanes map the first: at T = 64 it holds 8 x 64 rows,
    8 row tiles of K3), then pages of their own; bases off the page
    grid; lane 1 idle (all rows masked); lane 2 without the second hot
    page and lane 3 without its first own page (dead pages inside a
    run); lane 6 at base 3 with its first page dead (rows that see no
    key)."""
    base = rng.randint(hot * psz + 1, (maxp - 2) * psz - T, B)
    base[base % psz == 0] += 1
    base[1], base[6] = 0, 3
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    prefix = [avail.pop() for _ in range(hot)]
    for b in range(B):
        for i in range(-(-(int(base[b]) + T) // psz)):
            table[b, i] = prefix[i] if i < hot and b != 6 else avail.pop()
    table[1] = -1
    table[2, 1] = -1
    table[3, hot] = -1
    table[6, 0] = -1
    q, kp, vp = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                 for s in ((B, T, H, hd), (P, psz, KH, hd),
                           (P, psz, KH, hd)))
    return [q.to("cuda", torch.bfloat16), kp.to("cuda", torch.bfloat16),
            vp.to("cuda", torch.bfloat16), torch.from_numpy(table).cuda(),
            torch.from_numpy(base.astype(np.int32)).cuda()]


def _one_ulp(out, ref):
    """bf16: within one ulp of the other side (both accumulate in
    float32 from the same inputs and round once)."""
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-5,
                               rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 8, 16, 64, 100])
@pytest.mark.parametrize("H,KH,hd", [(16, 16, 128),   # olmo-1b, G = 1
                                     (32, 8, 64),     # llama3.2-1b, G = 4
                                     (24, 8, 128),    # phi4-mini, G = 3
                                     (32, 16, 128),   # gemma3-27b, G = 2
                                     (40, 8, 128)])   # llama4, G = 5
def test_wgmma_routes_vs_plain(card, T, H, KH, hd):
    """K1's and K3's wgmma/TMA kernels through the dispatchers: each
    within one bf16 ulp of the plain version, K3 within one ulp of K1,
    rows without a key zero, and two calls on the same inputs
    bit-equal."""
    rng = np.random.RandomState(1000 + T + hd)
    args = _route_case(rng, T, H, KH, hd)
    assert int((args[3][:, 0] == args[3][0, 0]).sum()) == 8
    assert ops.chunk_route(torch.bfloat16, hd, 64, T, H // KH) == "wgmma"
    assert k3.verify_route(torch.bfloat16, hd, 64, T, H // KH) == "wgmma"
    r1, r3 = ops.paged_attention_chunk.routes["wgmma"], \
        k3.verify_attention.routes["wgmma"]
    o1 = ops.paged_attention_chunk(*args)
    o3 = k3.verify_attention(*args)
    torch.cuda.synchronize()
    assert ops.paged_attention_chunk.routes["wgmma"] == r1 + 1
    assert k3.verify_attention.routes["wgmma"] == r3 + 1
    ref = plain(*args)
    for out in (o1, o3):
        assert out.dtype == torch.bfloat16 and (out[1] == 0).all()
        assert torch.isfinite(out.float()).all()
        _one_ulp(out, ref)
    # lane 6's rows that see only its dead first page
    assert (o1[6, :61] == 0).all() and (o3[6, :61] == 0).all()
    _one_ulp(o3, o1)
    assert torch.equal(o1, ops.paged_attention_chunk(*args))
    assert torch.equal(o3, k3.verify_attention(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 64, 100])
def test_k1_wgmma_route_at_hd96(card, T):
    """K1 at phi-3-vision's width (hd 96, G 1, pages of 64) on its wgmma
    route, over tiles padded to two 64-column atoms: within one bf16 ulp
    of the plain version, rows without a key zero, two calls bit-equal;
    the fma kernel it replaced, by its explicit route, within one ulp
    too; K2 at the same width takes its tma route, and K3 stays on fma
    and refuses its wgmma route before any launch."""
    rng = np.random.RandomState(960 + T)
    args = _route_case(rng, T, 32, 32, 96)
    assert ops.chunk_route(torch.bfloat16, 96, 64, T, 1) == "wgmma"
    assert k3.verify_route(torch.bfloat16, 96, 64, T, 1) == "fma"
    assert ops.decode_route(torch.bfloat16, 96, 64, 1) == "tma"
    r1 = dict(ops.paged_attention_chunk.routes)
    out = ops.paged_attention_chunk(*args)
    torch.cuda.synchronize()
    assert ops.paged_attention_chunk.routes == {
        **r1, "wgmma": r1["wgmma"] + 1}
    ref = plain(*args)
    assert out.dtype == torch.bfloat16 and (out[1] == 0).all()
    assert (out[6, :61] == 0).all()
    _one_ulp(out, ref)
    assert torch.equal(out, ops.paged_attention_chunk(*args))
    _one_ulp(ops.paged_attention_chunk_cuda(*args, route="fma"), ref)
    r3 = dict(k3.verify_attention.routes)
    with pytest.raises(ValueError, match="takes hd in"):
        k3.verify_attention_cuda(*args, route="wgmma")
    assert k3.verify_attention.routes == r3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,H,KH,hd,psz", [
    (torch.float32, 5, 4, 2, 16, 8),          # the smoke configs
    (torch.float32, 64, 16, 16, 128, 64),     # f32 at olmo-1b widths
    (torch.bfloat16, 5, 4, 2, 16, 8),         # hd 16, pages of 8
])
def test_present_kernels_keep_their_shapes(card, dtype, T, H, KH, hd, psz):
    """float32, hd 16 and pages of 8 still take the present kernels of
    K1 and K3, and the wgmma wrappers refuse them."""
    rng = np.random.RandomState(T + hd)
    args = _hot_case(rng, 8, T, H, KH, hd, psz, 16, 160, dtype)
    f1, f3 = ops.paged_attention_chunk.routes["fma"], \
        k3.verify_attention.routes["fma"]
    o1 = ops.paged_attention_chunk(*args)
    o3 = k3.verify_attention(*args)
    torch.cuda.synchronize()
    assert ops.paged_attention_chunk.routes["fma"] == f1 + 1
    assert k3.verify_attention.routes["fma"] == f3 + 1
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for out in (o1, o3):
        torch.testing.assert_close(out.float(), plain(*args).float(),
                                   atol=tol, rtol=tol)
    with pytest.raises((TypeError, ValueError)):
        ops.paged_attention_chunk_cuda(*args, route="wgmma")
    with pytest.raises((TypeError, ValueError)):
        k3.verify_attention_cuda(*args, route="wgmma")


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
    route = ops.decode_route(dtype, hd, psz, H // KH)
    for zero_empty in (False, True):
        before = ops.paged_attention.launches
        on_route = ops.paged_attention.routes[route]
        out = ops.paged_attention(q2, kp, vp, table, lens,
                                  zero_empty=zero_empty)
        torch.cuda.synchronize()
        assert ops.paged_attention.launches == before + 1
        assert ops.paged_attention.routes[route] == on_route + 1
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
@pytest.mark.parametrize("H,KH,hd", [(16, 16, 128),   # olmo-1b, G = 1
                                     (32, 8, 64),     # llama3.2-1b, G = 4
                                     (32, 16, 128),   # gemma3-27b, G = 2
                                     (64, 8, 128),    # G = 8
                                     (32, 32, 96),    # phi-3-vision, G = 1
                                     (32, 8, 96),     # hd 96, G = 4
                                     (24, 8, 128),    # phi4-mini, G = 3
                                     (40, 8, 128)])   # llama4, G = 5
@pytest.mark.parametrize("hi", [64, 1088, 2048])
def test_paged_decode_tma_route_vs_plain_and_k1(card, H, KH, hd, hi):
    """K2's TMA route at contexts of 1 to ``hi`` tokens (lane 0 has one
    token, lane 4 ``hi``), maxp 32 pages of 64, lane 1 idle, a dead
    page in lane 2: within one bf16 ulp of the plain version with
    ``zero_empty`` off and on, and of K1 at T = 1 over base + 1 (its
    wgmma route), two calls bit-equal.  At hd 96 the tiles are padded
    to two 64-column atoms; the fma kernel, by its explicit route,
    within one ulp of the plain version on the same inputs."""
    rng = np.random.RandomState(hi + hd)
    B, maxp, P = 8, 32, 300
    base = rng.randint(0, hi, B).astype(np.int32)
    base[0], base[4] = 0, hi - 1
    table = np.full((B, maxp), -1, np.int32)
    avail = list(rng.permutation(P))
    for b in range(B):
        for i in range(-(-(int(base[b]) + 1) // 64)):
            table[b, i] = avail.pop()
    table[1] = -1
    table[2, 0] = -1
    q, kp, vp = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        "cuda", torch.bfloat16) for s in ((B, 1, H, hd), (P, 64, KH, hd),
                                          (P, 64, KH, hd)))
    table, base = torch.from_numpy(table).cuda(), torch.from_numpy(base).cuda()
    q2, lens = q[:, 0].contiguous(), base + 1
    assert ops.decode_route(torch.bfloat16, hd, 64, H // KH) == "tma"
    for zero_empty in (False, True):
        before = ops.paged_attention.routes["tma"]
        out = ops.paged_attention(q2, kp, vp, table, lens,
                                  zero_empty=zero_empty)
        torch.cuda.synchronize()
        assert ops.paged_attention.routes["tma"] == before + 1
        assert torch.isfinite(out.float()).all()
        refs = [plain2(q2, kp, vp, table, lens, zero_empty=zero_empty)]
        if zero_empty:
            assert (out[1] == 0).all()
            refs.append(ops.paged_attention_chunk(q, kp, vp, table,
                                                  base)[:, 0])
        for ref in refs:
            _one_ulp(out, ref)
        assert torch.equal(out, ops.paged_attention_cuda(
            q2, kp, vp, table, lens, zero_empty, route="tma"))
        if hd == 96:
            _one_ulp(ops.paged_attention_cuda(q2, kp, vp, table, lens,
                                              zero_empty, route="fma"),
                     refs[0])


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
    route = k4.scan_route(dtype, S, P, N)
    on_route = k4.ssd_scan.routes[route]
    y, h_out = k4.ssd_scan(*args, h)
    torch.cuda.synchronize()
    assert k4.ssd_scan.launches == before + 1 and h_out is h
    assert k4.ssd_scan.routes[route] == on_route + 1
    y_ref, h_ref = ssd_scan_ref(*args, h0)
    assert y.dtype == dtype and torch.equal(h[2], h0[2])
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), y_ref.float(), atol=1e-5,
                                   rtol=2.0 ** -7)


def _ssd_args(rng, B, S, H, P, N, dtype):
    """K4's inputs on the card from a carried state h0 != 0: lane 1 with
    dt = 0 from token 2 on, lane 2 with dt = 0 throughout."""
    dt = rng.rand(B, S, H).astype(np.float32) * 0.5 + 0.1
    dt[1, 2:] = 0.0
    dt[2] = 0.0
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
    x, Bm, Cm = f(B, S, H, P) * 0.5, f(B, S, N) * 0.3, f(B, S, N) * 0.3
    args = [x.to("cuda", dtype), torch.from_numpy(dt).cuda(),
            (-f(H).abs() * 0.5).cuda(), Bm.to("cuda", dtype),
            Cm.to("cuda", dtype), (f(H) * 0.1).cuda()]
    return args, f(B, H, P, N).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("S,N", [(3, 128), (16, 128), (64, 128),
                                 (100, 128), (200, 128), (64, 64)])
def test_ssd_scan_wgmma_route_vs_plain(card, S, N):
    """K4's wgmma route (the chunked dual form) at mamba2-370m's widths,
    one chunk, a masked last chunk and several: y within one bf16 ulp
    of the sequential plain version, the state within 1e-4, the inert
    lane's state bit for bit, two calls bit-equal."""
    rng = np.random.RandomState(S + N + 1)
    args, h0 = _ssd_args(rng, 8, S, 32, 64, N, torch.bfloat16)
    assert k4.scan_route(torch.bfloat16, S, 64, N) == "wgmma"
    h = h0.clone()
    before = k4.ssd_scan.routes["wgmma"]
    y, _ = k4.ssd_scan(*args, h)
    torch.cuda.synchronize()
    assert k4.ssd_scan.routes["wgmma"] == before + 1
    y_ref, h_ref = ssd_scan_ref(*args, h0)
    assert torch.isfinite(h).all() and torch.equal(h[2], h0[2])
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=1e-5,
                               rtol=2.0 ** -7)
    h2 = h0.clone()
    y2 = k4.ssd_scan_cuda(*args, h2, route="wgmma")
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 128])
def test_ssd_scan_step_route_vs_plain_and_fma(card, N):
    """K4's step route (one token) at mamba2-370m's widths: y within one
    bf16 ulp of the plain version and of the fma kernel on the same
    inputs, the state within 1e-4 of both, the inert lane's state bit
    for bit, two calls bit-equal."""
    rng = np.random.RandomState(N)
    args, h0 = _ssd_args(rng, 8, 1, 32, 64, N, torch.bfloat16)
    assert k4.scan_route(torch.bfloat16, 1, 64, N) == "step"
    h = h0.clone()
    before = k4.ssd_scan.routes["step"]
    y, _ = k4.ssd_scan(*args, h)
    assert k4.ssd_scan.routes["step"] == before + 1
    torch.cuda.synchronize()
    h_fma = h0.clone()
    y_fma = k4.ssd_scan_cuda(*args, h_fma, route="fma")
    y_ref, h_ref = ssd_scan_ref(*args, h0)
    assert torch.isfinite(h).all() and torch.equal(h[2], h0[2])
    for y_other, h_other in ((y_ref, h_ref), (y_fma, h_fma)):
        torch.testing.assert_close(h, h_other, atol=1e-4, rtol=1e-4)
        _one_ulp(y, y_other)
    h2 = h0.clone()
    y2 = k4.ssd_scan_cuda(*args, h2, route="step")
    assert torch.equal(y, y2) and torch.equal(h, h2)


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


def _lru_args(rng, B, S, d):
    """a, b [B, S, d] and h0 [B, d] on the card; lane 1 inert (a = 1, b
    = 0) from token 3 on, lane 2 throughout."""
    a = rng.rand(B, S, d).astype(np.float32) * 0.9
    b = rng.randn(B, S, d).astype(np.float32) * 0.5
    a[1, 3:], b[1, 3:] = 1.0, 0.0
    a[2], b[2] = 1.0, 0.0
    return [torch.from_numpy(x).cuda() for x in
            (a, b, rng.randn(B, d).astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [3, 16, 64, 100, 200])
@pytest.mark.parametrize("d", [2560, 192])    # recurrentgemma-2b; tiles of 64
def test_rg_lru_tma_route_vs_plain(card, S, d):
    """K5's tma route (S past ``LRU_TMA_MIN_S``, 8-token stages, a ring
    over S > 64): bit-equal to the plain version, inert lanes keep their
    state bit for bit, two calls bit-equal."""
    a, b, h0 = _lru_args(np.random.RandomState(S + d), 4, S, d)
    route = "tma" if S >= k5.LRU_TMA_MIN_S else "seq"
    assert k5.lru_route(S, d) == route
    on_route = k5.rg_lru.routes[route]
    h = h0.clone()
    hs, _ = k5.rg_lru(a, b, h)
    torch.cuda.synchronize()
    assert k5.rg_lru.routes[route] == on_route + 1
    hs_ref, h_ref = rg_lru_ref(a, b, h0)
    assert torch.equal(hs, hs_ref) and torch.equal(h, h_ref)
    assert torch.equal(h[2], h0[2])
    h2 = h0.clone()
    assert torch.equal(k5.rg_lru_cuda(a, b, h2, "tma"), hs_ref)
    assert torch.equal(h2, h_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("S,d", [(1, 2560), (64, 2560), (13, 100), (9, 6)])
def test_rg_lru_present_kernel_keeps_its_shapes(card, S, d):
    """The seq route (T = 1 on the serving path; d not a multiple of 4)
    still bit-equal to the plain version, and the tma route refuses what
    its tensor map cannot stride."""
    a, b, h0 = _lru_args(np.random.RandomState(S), 3, S, d)
    h = h0.clone()
    hs = k5.rg_lru_cuda(a, b, h, "seq")
    hs_ref, h_ref = rg_lru_ref(a, b, h0)
    assert torch.equal(hs, hs_ref) and torch.equal(h, h_ref)
    if d % 4:
        assert k5.lru_route(S, d) == "seq"
        with pytest.raises(ValueError):
            k5.rg_lru_cuda(a, b, h0.clone(), "tma")
    with pytest.raises(ValueError):
        k5.rg_lru_cuda(a, b, h0.clone(), "wgmma")


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
    (torch.bfloat16, 1, 32, 32, 640, 96, True),    # phi-3-vision, wgmma
    (torch.bfloat16, 2, 4, 2, 77, 96, False),      # ragged, hd 96
    (torch.bfloat16, 2, 4, 1, 200, 96, False),     # hd 96, G = 4
    (torch.float32, 2, 4, 2, 77, 96, True),
    (torch.bfloat16, 1, 6, 6, 1500, 64, False),    # whisper's encoder
    (torch.bfloat16, 1, 24, 8, 2048, 128, True),   # phi4-mini-3.8b, G = 3
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
    (torch.bfloat16, 1, 32, 32, 704, 96, True),    # phi-3-vision, 576 + 128
    (torch.float32, 1, 32, 32, 704, 96, True),
    (torch.float32, 2, 4, 2, 77, 96, False),       # ragged, G = 2
    (torch.bfloat16, 1, 24, 8, 2048, 128, True),   # phi4-mini-3.8b, G = 3
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
@pytest.mark.parametrize("B,H,KH,S,hd,causal", [
    (1, 16, 16, 2048, 128, True),   # olmo-1b
    (4, 16, 16, 2048, 128, True),   # olmo-1b's training shape
    (1, 32, 8, 1024, 64, True),     # llama3.2-1b, G = 4
    (2, 4, 2, 77, 128, True),       # a ragged last tile, G = 2
    (2, 4, 1, 200, 64, False),      # bidirectional, G = 4
    (1, 2, 2, 130, 128, True),      # a key tile of one key past 128
    (4, 32, 32, 640, 96, True),     # phi-3-vision, padded to two atoms
    (1, 32, 16, 700, 96, False),    # hd 96, G = 2, a ragged last tile
    (2, 4, 2, 77, 96, True),        # hd 96, ragged, G = 2
    (8, 6, 6, 1500, 64, False),     # whisper-tiny's encoder
    (1, 24, 8, 2048, 128, True),    # phi4-mini-3.8b, G = 3
    (4, 32, 8, 2048, 64, True),     # llama3.2-1b's training shape, G = 4
])
def test_flash_attention_backward_wgmma_route(card, B, H, KH, S, hd, causal):
    """The wgmma/TMA backward (bf16, hd 64, 96 and 128) against autograd
    through the plain version at 6e-2 (P and dS enter their products
    rounded to bf16), and against its walk with P and dS so rounded,
    each row within ``BWD_ROW_TOL`` of its own scale (the limit a
    dropped late tile lies beyond: test_torch_flash_attention.py's
    control test); counted on its route; two calls bit-equal."""
    rng = np.random.RandomState(S + hd)
    q, k, v = _qkv(rng, B, H, KH, S, hd, torch.bfloat16, grad=True)
    do = torch.from_numpy(rng.randn(B, H, S, hd).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    assert k6.backward_route(torch.bfloat16, hd) == "wgmma"
    before = k6.flash_attention_bwd.routes["wgmma"]
    got = torch.autograd.grad(k6.flash_attention(q, k, v, causal), (q, k, v),
                              do)
    assert k6.flash_attention_bwd.routes["wgmma"] == before + 1
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), b.float(), atol=6e-2,
                                   rtol=6e-2)
    q, k, v = (t.detach() for t in (q, k, v))
    o, lse = k6.flash_attention_cuda(q, k, v, causal)
    twin = flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, causal)
    for a, b in zip(got, twin):
        assert row_scaled_err(a, b) < BWD_ROW_TOL
    first = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    second = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_wgmma_routes_on_a_fresh_thread(card):
    """A host thread that has made no CUDA call has no current context,
    and the TMA maps of K6's wgmma kernels cannot be encoded without one:
    the autograd engine's worker thread, whose first launch may be the
    backward (or the forward, rematerialised under remat).  Each of
    forward and backward, launched first thing on new threads, gives
    the main thread's bits."""
    import threading

    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, 1, 32, 8, 1024, 64, torch.bfloat16)
    do = torch.from_numpy(rng.randn(1, 32, 1024, 64).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    o, lse = k6.flash_attention_cuda(q, k, v)
    want = (o, *k6.flash_attention_bwd_cuda(q, k, v, o, lse, do))
    got = {}

    def run(name, fn):
        try:
            got[name] = fn()
            torch.cuda.synchronize()
        except Exception as e:      # re-raised on the main thread
            got[name] = e

    for name, fn in (
            ("forward", lambda: k6.flash_attention_cuda(q, k, v)[0]),
            ("backward", lambda: k6.flash_attention_bwd_cuda(
                q, k, v, o, lse, do))):
        t = threading.Thread(target=run, args=(name, fn))
        t.start()
        t.join()
        if isinstance(got[name], Exception):
            raise got[name]
    for a, b in zip((got["forward"], *got["backward"]), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 16, "mma"), (torch.float32, 64, "f32"),
    (torch.float32, 128, "f32"), (torch.float32, 96, "f32")])
def test_flash_attention_backward_present_routes(card, dtype, hd, route):
    """hd 16 and float32 (hd 96 too) keep the kernels of
    flash_attention_bwd.cu, counted on their routes; the wgmma route
    refuses them."""
    rng = np.random.RandomState(hd)
    q, k, v = _qkv(rng, 2, 4, 2, 77, hd, dtype, grad=True)
    do = torch.from_numpy(rng.randn(2, 4, 77, hd).astype(np.float32)).to(
        "cuda", dtype)
    assert k6.backward_route(dtype, hd) == route
    before = k6.flash_attention_bwd.routes[route]
    got = torch.autograd.grad(k6.flash_attention(q, k, v), (q, k, v), do)
    assert k6.flash_attention_bwd.routes[route] == before + 1
    want = torch.autograd.grad(flash_attention_ref(q, k, v), (q, k, v), do)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)
    o, lse = k6.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError):
        k6.flash_attention_bwd_cuda(q, k, v, o, lse, do, route="wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,S,causal", [
    (4, 32, 32, 640, True),                        # phi-3-vision's prefill
    (2, 4, 2, 77, True),                           # ragged, G = 2
    (2, 4, 1, 200, False),                         # bidirectional, G = 4
])
def test_flash_attention_hd96_wgmma_and_mma(card, B, H, KH, S, causal):
    """bf16 hd 96 on the wgmma route (tiles padded to two atoms) and on
    the mma.sync instance it replaced, by explicit route, on the same
    inputs: each within one ulp of the plain version, lse within 1e-4,
    two calls bit-equal."""
    rng = np.random.RandomState(96 + S)
    q, k, v = _qkv(rng, B, H, KH, S, 96, torch.bfloat16)
    assert k6.forward_route(torch.bfloat16, 96) == "wgmma"
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal)
    for route in ("wgmma", "mma"):
        o, lse = k6.flash_attention_cuda(q, k, v, causal, route=route)
        torch.cuda.synchronize()
        _one_ulp(o, o_ref)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
        assert torch.equal(o, k6.flash_attention_cuda(q, k, v, causal,
                                                      route=route)[0])


@pytest.mark.cuda
def test_flash_attention_backward_hd96_has_no_mma_instance(card):
    """bf16 hd 96's backward is the wgmma route's alone: the mma.sync
    route and the float32 route refuse it before a launch, and the
    wgmma route's padded columns never reach the gradients (dq, dk, dv
    keep hd 96 and the inputs' strides, and are finite)."""
    rng = np.random.RandomState(97)
    q, k, v = _qkv(rng, 1, 4, 2, 130, 96, torch.bfloat16)
    o, lse = k6.flash_attention_cuda(q, k, v)
    do = torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    for route in ("mma", "f32"):
        with pytest.raises(ValueError, match="hd 96"):
            k6.flash_attention_bwd_cuda(q, k, v, o, lse, do, route=route)
    got = k6.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and g.stride() == t.stride()
        assert bool(torch.isfinite(g).all())


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
    # a route without an instance at this (dtype, hd): no launch
    with pytest.raises(ValueError):
        k6.flash_attention_cuda(q, k, v, route="mma")     # mma at hd 128
    with pytest.raises(ValueError):
        k6.flash_attention_cuda(q, k, v, route="f32")     # f32 on bf16
    q, k, v = _qkv(rng, 1, 4, 2, 64, 16, torch.bfloat16)
    with pytest.raises(ValueError):
        k6.flash_attention_cuda(q, k, v, route="wgmma")   # wgmma at hd 16


@pytest.mark.cuda
def test_sampler_on_the_card_matches_the_cpu(card):
    """The sampler (torch ops, no kernel of its own) on the card: its
    threefry bits and uniforms bit-equal to the CPU's at olmo-1b's
    vocabulary, the Gumbel noise within 1e-6 of max(1, |g|) (the two
    ``log``s may differ in the last place), and the sampled tokens equal
    but where the CPU's top-2 gap of ``logits / T + g`` is within 1e-5
    of its scale."""
    from repro_torch.serving import sampling

    V, shape = 50304, (2, 8)
    rng = np.random.RandomState(21)
    seeds = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, shape)
                             .astype(np.int32))
    counts = torch.from_numpy(rng.randint(0, 2048, shape).astype(np.int32))
    logits = torch.from_numpy((rng.randn(*shape, V) * 3).astype(np.float32))
    temp = torch.from_numpy(rng.uniform(0.2, 1.5, shape).astype(np.float32))
    top_k = torch.from_numpy(rng.choice([0, 1, 50, V], shape)
                             .astype(np.int32))
    args = (logits, temp, top_k, seeds, counts)
    k_cpu = sampling.request_key(seeds, counts)
    k_gpu = sampling.request_key(seeds.cuda(), counts.cuda())
    assert torch.equal(sampling.random_bits(*k_gpu, V).cpu(),
                       sampling.random_bits(*k_cpu, V))
    assert torch.equal(sampling.uniform(*k_gpu, V).cpu(),
                       sampling.uniform(*k_cpu, V))
    g_cpu = sampling.gumbel(seeds, counts, V)
    g_gpu = sampling.gumbel(seeds.cuda(), counts.cuda(), V).cpu()
    assert ((g_gpu - g_cpu).abs() / g_cpu.abs().clamp(min=1.0)).max() <= 1e-6
    got = sampling.sample_tokens(*(a.cuda() for a in args)).cpu()
    want = sampling.sample_tokens(*args)
    scores = sampling.perturbed_scores(*args)
    for idx in zip(*np.nonzero((got != want).numpy())):
        top = scores[idx].topk(2).values
        assert top[0] - top[1] <= 1e-5 * scores[idx][
            scores[idx].isfinite()].abs().max(), idx


@pytest.mark.cuda
def test_compress_tree_on_the_card_matches_the_cpu(card):
    """``parallel/compress.py::compress_tree`` (torch ops, no kernel of
    its own) on the card: int8 payloads, scales and error-feedback
    residuals bit-equal to the CPU's over two rounds, each device
    carrying its own residual, on leaves of float32 gradients at three
    scales, the first round's largest leaf with a row of halves to round
    (half to even).  Every operation
    is exact or correctly rounded on both; a Python-number divisor would
    be a CPU scalar, which the card's division multiplies by its
    reciprocal."""
    from repro_torch.parallel import compress

    rng = np.random.RandomState(33)
    shapes = ((4096, 1024), (50304,), (7, 333))
    rounds = []
    for r in range(2):
        leaves = {f"w{i}": torch.from_numpy(
            (rng.randn(*s) * 10.0 ** (i - 3)).astype(np.float32))
            for i, s in enumerate(shapes)}
        if r == 0:      # scale 1: every payload of the row a .5 to round
            leaves["w0"][0, :255] = torch.cat([
                torch.arange(-127, 127) + 0.5, torch.tensor([127.0])])
        rounds.append(leaves)
    ef = {d: compress.init_error_feedback(
        {k: v.to(d) for k, v in rounds[0].items()}) for d in ("cpu", "cuda")}
    for grads in rounds:
        out = {}
        for d in ("cpu", "cuda"):
            q, s, ef[d] = compress.compress_tree(
                {k: v.to(d) for k, v in grads.items()}, ef[d])
            out[d] = (q, s, ef[d].residual)
        for a, b in zip(out["cpu"], out["cuda"]):
            for k in a:
                assert a[k].dtype == b[k].dtype and torch.equal(
                    a[k], b[k].cpu()), k
    assert all(bool(v.any()) for v in ef["cuda"].residual.values())
