"""K3, page-grouped verify attention: the port's plain version against
the reference's jnp oracle and its Pallas kernel run in interpret mode,
on the sweep of ``tests/test_spec_perf.py`` (no / prefix / all page
overlap, GQA 1-4); the port's device schedule item for item against the
reference's, and the wgmma route's unit list against one built in numpy
from the reference's schedule; the route function and the wrapper's
refusals; the dispatcher's CPU path and byte bound; the chunked
vocabulary argmax.  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.kernels.verify_attention import (build_verify_schedule,
                                            verify_attention_ref)
from repro.kernels.verify_attention.kernel import verify_attention \
    as pallas_verify
from repro.models.layers import logits_apply as j_logits
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_chunk_ref
from repro_torch.kernels.verify_attention import ops
from repro_torch.kernels.verify_attention.ref import \
    verify_attention_ref as plain
from repro_torch.kernels.verify_attention.schedule import \
    build_verify_schedule as t_schedule
from repro_torch.kernels.verify_attention.schedule import (
    build_verify_units, units_capacity)
from repro_torch.models.layers import logits_apply, logits_argmax_chunked

#: tests/test_spec_perf.py::TestVerifyAttentionKernel::test_vs_ref_sweep
SWEEP = [
    (4, 5, 4, 2, 32, 8, 6, 64, "prefix"),     # draft_len 4
    (8, 3, 4, 2, 32, 8, 6, 64, "all"),        # draft_len 2, hot pages
    (2, 2, 4, 4, 16, 4, 8, 32, "none"),       # draft_len 1, no GQA
    (6, 5, 8, 2, 16, 16, 4, 48, "prefix"),    # big pages, GQA 4
    (3, 4, 4, 1, 32, 8, 6, 32, "all"),        # single kv head
]


def _spec_tables(rng, B, T, psz, maxp, P, overlap):
    """Verify-step tables as the reference suite builds them: B lanes
    mid-generation sharing no / the first two / all prefix pages."""
    base = rng.randint(psz, (maxp - 1) * psz - T, size=B).astype(np.int32)
    tbl = np.full((B, maxp), -1, np.int32)
    shared = rng.choice(P, size=maxp, replace=False)
    for b in range(B):
        for i in range(int(np.ceil((int(base[b]) + T) / psz))):
            if overlap == "all" or (overlap == "prefix" and i < 2):
                tbl[b, i] = shared[i]
            else:
                tbl[b, i] = int(rng.randint(0, P))
    return tbl, base


def _case(seed, B, T, H, KH, hd, psz, maxp, P, overlap):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, hd).astype(np.float32)
    kp = rng.randn(P, psz, KH, hd).astype(np.float32)
    vp = rng.randn(P, psz, KH, hd).astype(np.float32)
    tbl, base = _spec_tables(rng, B, T, psz, maxp, P, overlap)
    return q, kp, vp, tbl, base


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,T,H,KH,hd,psz,maxp,P,overlap", SWEEP)
def test_plain_vs_ref_and_pallas(B, T, H, KH, hd, psz, maxp, P, overlap):
    case = _case(B * 100 + T * 10 + psz, B, T, H, KH, hd, psz, maxp, P,
                 overlap)
    out = plain(*_torch(*case))
    assert out.shape == (B, T, H, hd) and out.dtype == torch.float32
    for ref in (verify_attention_ref(*_jax(*case)),
                pallas_verify(*_jax(*case), interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("B,T,H,KH,hd,psz,maxp,P,overlap", SWEEP)
def test_schedule_equals_reference(B, T, H, KH, hd, psz, maxp, P, overlap):
    """The device schedule, item for item: pages sorted stably with the
    dead items at the tail (page -1), lanes and slots in the same
    order."""
    _, _, _, tbl, base = _case(B + T + psz, B, T, H, KH, hd, psz, maxp, P,
                               overlap)
    want = build_verify_schedule(jnp.asarray(tbl), jnp.asarray(base), T, psz)
    got = t_schedule(*_torch(tbl, base), T, psz)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_schedule_parks_items_past_the_window():
    """Fully mapped tables (pages past each lane's causal window, as a
    lane holds after a chunk was granted), with windows that end
    exactly on a page boundary, one page short of it and one past it:
    the same schedule, and the pages past base + T - 1 are dead."""
    T, psz, maxp = 5, 8, 6
    tbl = np.random.RandomState(4).permutation(40)[:4 * maxp].reshape(
        4, maxp).astype(np.int32)
    base = np.array([3, 11, 12, 0], np.int32)    # base + T: 8, 16, 17, 5
    want = build_verify_schedule(jnp.asarray(tbl), jnp.asarray(base), T, psz)
    got = t_schedule(*_torch(tbl, base), T, psz)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pages, lanes, slots = (g.numpy() for g in got)
    live = pages >= 0
    assert sorted(zip(lanes[live], slots[live])) == \
        [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (3, 0)]


def test_all_masked_rows_are_zero_and_match_k1():
    """An idle lane (table all -1) and rows past every key output exact
    zeros; on the same inputs K3's function is K1's."""
    q, kp, vp, tbl, base = _case(7, 4, 5, 4, 2, 32, 8, 6, 64, "prefix")
    tbl[1] = -1
    base[1] = 0
    t = _torch(q, kp, vp, tbl, base)
    out = plain(*t)
    assert (out[1] == 0).all()
    assert torch.equal(out, paged_attention_chunk_ref(*t))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(pallas_verify(*_jax(q, kp, vp, tbl, base),
                                              interpret=True)),
        atol=1e-4, rtol=1e-4)


def test_dispatcher_takes_plain_version_on_cpu():
    case = _torch(*_case(3, 4, 5, 4, 2, 32, 8, 6, 64, "all"))
    before = ops.verify_attention.launches
    out = ops.verify_attention(*case)
    assert ops.verify_attention.launches == before
    assert torch.equal(out, plain(*case))


def test_bound_counts_each_distinct_page_once():
    """Lanes that share every page cost the bytes of one lane's pages."""
    q, kp, vp, tbl, base = _case(5, 8, 3, 4, 2, 32, 8, 6, 64, "all")
    t = _torch(q, kp, vp, tbl, base)
    distinct = len({int(p) for b in range(8) for i, p in enumerate(tbl[b])
                    if p >= 0 and i * 8 <= base[b] + 2})
    page_bytes = 8 * 2 * 32 * 4
    assert ops.bound_bytes(t[0], t[1], t[3], t[4]) == \
        2 * q.nbytes + 2 * distinct * page_bytes
    assert distinct < int((tbl >= 0).sum())


def _units_numpy(pages, TG):
    """The unit list built by hand from a schedule's pages: runs of
    equal live pages in order, each cut into ceil(n * TG / 64) tiles."""
    units, i = [], 0
    while i < len(pages) and pages[i] >= 0:
        n = 1
        while i + n < len(pages) and pages[i + n] == pages[i]:
            n += 1
        units += [(i, n, tile) for tile in range(-(-n * TG // 64))]
        i += n
    return units


#: the sweep, then verify steps whose hot runs need several 64-row tiles
UNIT_CASES = SWEEP + [
    (8, 64, 16, 16, 128, 64, 6, 64, "all"),   # olmo-1b widths, chunk
    (8, 64, 32, 8, 64, 64, 5, 48, "prefix"),  # llama3.2-1b widths, G 4
    (8, 5, 32, 16, 128, 64, 6, 64, "all"),    # gemma3-27b widths, G 2
]


@pytest.mark.parametrize("B,T,H,KH,hd,psz,maxp,P,overlap", UNIT_CASES)
def test_units_equal_numpy_construction(B, T, H, KH, hd, psz, maxp, P,
                                        overlap):
    """The device unit list of the wgmma route: the same runs, tiles and
    rows as a numpy construction from the reference's schedule, a dead
    tail of -1 after them, never more units than the capacity, and
    every query row of every live item in exactly one unit."""
    _, _, _, tbl, base = _case(B * 7 + T + psz, B, T, H, KH, hd, psz, maxp,
                               P, overlap)
    G = H // KH
    pages = np.asarray(build_verify_schedule(jnp.asarray(tbl),
                                             jnp.asarray(base), T, psz)[0])
    want = _units_numpy(pages, T * G)
    got = build_verify_units(t_schedule(*_torch(tbl, base), T, psz)[0], T,
                             G)
    cap = units_capacity(B * maxp, T, G)
    assert got.dtype == torch.int32 and got.shape == (cap, 3)
    assert len(want) <= cap
    np.testing.assert_array_equal(got[:len(want)].numpy(),
                                  np.asarray(want, np.int32).reshape(-1, 3))
    assert (got[len(want):] == -1).all()
    rows = [(first + rho // (T * G), rho % (T * G))
            for first, n, tile in got[:len(want)].tolist()
            for rho in range(64 * tile, min(64 * tile + 64, n * T * G))]
    live = int((pages >= 0).sum())
    assert sorted(rows) == [(i, r) for i in range(live)
                            for r in range(T * G)]
    if overlap == "all" and T == 64:
        assert max(n for _, n, _ in want) == B    # a run of every lane
        assert max(t for _, _, t in want) == B - 1  # ... over B tiles


def test_units_fill_the_capacity_at_worst():
    """Every item its own run, T * G one row past a tile: two units an
    item, exactly the capacity, and no dead tail."""
    pages = torch.arange(12, dtype=torch.int32)
    got = build_verify_units(pages, 65, 1)
    assert got.shape == (units_capacity(12, 65, 1), 3) == (24, 3)
    assert got.tolist() == [[i, 1, t] for i in range(12) for t in (0, 1)]
    empty = build_verify_units(torch.full((6,), -1, dtype=torch.int32), 5, 2)
    assert (empty == -1).all()


@pytest.mark.parametrize("dtype,hd,psz,T,G,route", [
    (torch.bfloat16, 128, 64, 5, 1, "wgmma"),     # olmo-1b, verify step
    (torch.bfloat16, 128, 64, 64, 1, "wgmma"),    # drafts on a chunk
    (torch.bfloat16, 64, 64, 5, 4, "wgmma"),      # llama3.2-1b
    (torch.float32, 128, 64, 5, 1, "fma"),
    (torch.float32, 16, 8, 5, 2, "fma"),          # the smoke configs
    (torch.bfloat16, 16, 8, 5, 2, "fma"),
    (torch.bfloat16, 128, 32, 5, 1, "fma"),
    (torch.bfloat16, 96, 64, 5, 1, "fma"),        # phi-3-vision's width
    (torch.bfloat16, 96, 64, 64, 1, "fma"),
])
def test_verify_route(dtype, hd, psz, T, G, route):
    """K3's route function picks the documented kernel: K1's rule at hd
    64 and 128, and the fma kernel at hd 96, where K1 takes its wgmma
    route and K3 has no wgmma instance."""
    assert ops.verify_route(dtype, hd, psz, T, G) == route


@pytest.mark.parametrize("dtype,hd,psz,exc", [
    (torch.float32, 128, 64, TypeError),
    (torch.bfloat16, 16, 64, ValueError),
    (torch.bfloat16, 128, 8, ValueError),
    (torch.bfloat16, 128, 64, ValueError),   # right shapes, CPU tensors
    (torch.bfloat16, 96, 64, ValueError),    # hd 96: K1's route, not K3's
])
def test_wgmma_wrapper_raises_on_what_it_does_not_take(dtype, hd, psz, exc):
    """Asked for the wgmma route, the wrapper raises before anything
    launches on what that kernel does not take; no fallback.  At hd 96
    it raises for the head dim itself."""
    q = torch.zeros(2, 5, 4, hd, dtype=dtype)
    kp = torch.zeros(4, psz, 2, hd, dtype=dtype)
    table = torch.zeros(2, 3, dtype=torch.int32)
    base = torch.zeros(2, dtype=torch.int32)
    before = (ops.verify_attention.launches, dict(ops.verify_attention.routes))
    with pytest.raises(exc, match="takes hd in" if hd == 96 else None):
        ops.verify_attention_cuda(q, kp, kp.clone(), table, base,
                                  route="wgmma")
    assert (ops.verify_attention.launches,
            ops.verify_attention.routes) == before


@pytest.fixture(scope="module")
def smoke():
    cfg = smoke_config(get_config("olmo-1b"))
    params = jmodels.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


@pytest.mark.parametrize("chunk", [16, 100, 256, 1024])
def test_chunked_argmax_matches_full_projection(smoke, chunk):
    """Split, odd, exact and single-chunk vocabularies (vocab 256), on
    the bridged weights of the smoke config, against the port's full
    projection and the reference's."""
    cfg, params = smoke
    embed = params_from_numpy(jax.tree.map(np.asarray, params["embed"]),
                              "cpu")
    x = np.random.RandomState(2).randn(2, 3, 5, cfg.d_model).astype(
        np.float32)
    full = torch.argmax(logits_apply(cfg, embed, torch.from_numpy(x)), -1)
    got = logits_argmax_chunked(cfg, embed, torch.from_numpy(x), chunk=chunk)
    assert got.dtype == torch.int32
    assert torch.equal(got, full.to(torch.int32))
    ref = jnp.argmax(j_logits(cfg, params["embed"], jnp.asarray(x)), -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_chunked_argmax_tie_break_is_first_max(smoke):
    """Duplicated lm_head columns give exact ties, across chunks and
    inside one: the first maximum wins, as in a full argmax."""
    cfg, _ = smoke
    w = torch.zeros((cfg.d_model, 8))
    w[:, 2] = 1.0
    w[:, 5] = 1.0
    w[:, 3] = 1.0
    x = torch.ones((3, cfg.d_model))
    for chunk in (2, 3, 8):
        got = logits_argmax_chunked(cfg, {"lm_head": w}, x, chunk=chunk)
        assert (got == 2).all(), chunk
