"""K2, single-token paged decode attention: the port's plain version
against the reference's jnp oracle and its Pallas kernel run in
interpret mode (the four cases of ``tests/test_kernels.py`` and a
seeded sweep of random tables), rows without a valid key under both
conventions, the serving convention against K1's plain version at
T = 1, the dispatcher's CPU path, and the engine's routing of
decode-only steps; the TMA route's choice (``decode_route``), its
schedule (``decode_splits``) and its split-then-merge arithmetic
(``paged_attention_split_ref``) against the same oracle.  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from _torch_helpers import engine_setup, serve
from repro.kernels.paged_attention.kernel import paged_attention as pallas
from repro.kernels.paged_attention.ref import paged_attention_ref as jref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    decode_splits, paged_attention_chunk_ref as k1_plain,
    paged_attention_ref as plain, paged_attention_split_ref as split_plain)
from repro_torch.kernels.verify_attention import ops as k3
from repro_torch.models import transformer

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _tol(dt):
    return 1e-4 if dt == jnp.float32 else 6e-2


def _case(rng, B, H, KH, hd, psz, maxp, P, lens=None):
    """Random decode inputs as numpy: q, pages, a table of distinct
    random pages covering each sequence's length, the lengths."""
    if lens is None:
        lens = rng.randint(1, maxp * psz, B)
    lens = np.asarray(lens, np.int32)
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randn(P, psz, KH, hd).astype(np.float32)
    vp = rng.randn(P, psz, KH, hd).astype(np.float32)
    table = np.full((B, maxp), -1, np.int32)
    avail = list(range(P))
    rng.shuffle(avail)
    for b in range(B):
        for i in range(min(-(-int(lens[b]) // psz), maxp)):
            table[b, i] = avail.pop()
    return q, kp, vp, table, lens


def _both(q, kp, vp, table, lens, dt=jnp.float32):
    j = (jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
         jnp.asarray(table), jnp.asarray(lens))
    tdt = TORCH_DT[dt]
    t = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
         torch.from_numpy(vp).to(tdt), torch.from_numpy(table),
         torch.from_numpy(lens))
    return j, t


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,H,KH,hd,psz,maxp,P,dt", [
    (4, 8, 2, 128, 16, 6, 64, jnp.float32),
    (2, 4, 4, 64, 8, 4, 32, jnp.float32),
    (3, 8, 1, 128, 32, 3, 16, jnp.bfloat16),
    (1, 16, 8, 64, 16, 5, 48, jnp.float32),
    (3, 4, 4, 96, 64, 4, 16, jnp.bfloat16),    # phi-3-vision: hd 96, G 1
])
def test_plain_vs_ref_and_pallas(B, H, KH, hd, psz, maxp, P, dt):
    """The reference suite's cases (tests/test_kernels.py:27-32) and a
    phi-3-vision case (H 4, KH 4, hd 96, pages of 64), which the Pallas
    kernel also runs in interpret mode."""
    rng = np.random.RandomState(hash((B, H, KH)) % 2**31)
    j, t = _both(*_case(rng, B, H, KH, hd, psz, maxp, P), dt)
    out = plain(*t)
    assert out.dtype == TORCH_DT[dt] and out.shape == (B, H, hd)
    _close(out, jref(*j), _tol(dt))
    _close(out, pallas(*j, interpret=True), _tol(dt))


@pytest.mark.parametrize("seed", range(6))
def test_random_tables_sweep(seed):
    """Random shapes and tables: dead pages inside live runs, lengths
    past the table, zero lengths and idle rows; f32 against the oracle
    (and Pallas in interpret mode on the first seeds), bf16 against the
    oracle."""
    rng = np.random.RandomState(100 + seed)
    G = [1, 2, 4][seed % 3]
    KH = [1, 2][seed % 2]
    psz, maxp = [8, 16][seed % 2], int(rng.randint(2, 6))
    B = int(rng.randint(2, 6))
    lens = rng.randint(0, maxp * psz + 10, B)
    q, kp, vp, table, lens = _case(rng, B, G * KH, KH, 64, psz, maxp, 48,
                                   lens)
    table[rng.randint(B), 0] = -1            # a dead page in a live run
    table[rng.randint(B)] = -1               # an idle row
    for dt in (jnp.float32, jnp.bfloat16):
        j, t = _both(q, kp, vp, table, lens, dt)
        out = plain(*t)
        _close(out, jref(*j), _tol(dt))
        if dt == jnp.float32 and seed < 3:
            _close(out, pallas(*j, interpret=True), _tol(dt))


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_rows_without_a_key_mean_or_zero(dt):
    """A row with no valid key (zero length, an all-dead table, or only
    dead pages below its length) returns the uniform mean of the V rows
    it gathers (dead entries gather page 0), as the oracle and the
    Pallas kernel do; with ``zero_empty`` it returns exact zeros, and
    the other rows are unchanged."""
    rng = np.random.RandomState(21)
    B, H, KH, hd, psz, maxp, P = 4, 4, 2, 64, 8, 3, 16
    q, kp, vp, table, lens = _case(rng, B, H, KH, hd, psz, maxp, P,
                                   [9, 0, 5, 17])
    table[1] = -1                              # idle: no table, no length
    table[2, 0] = -1                           # its only page is dead
    j, t = _both(q, kp, vp, table, lens, dt)
    out = plain(*t)
    _close(out, jref(*j), _tol(dt))
    _close(out, pallas(*j, interpret=True), _tol(dt))
    vt = t[2].float()
    for b in (1, 2):
        gathered = vt[t[3][b].clamp(min=0).long()]      # [maxp, psz, KH, hd]
        mean = gathered.reshape(-1, KH, hd).mean(0)      # [KH, hd]
        _close(out[b], mean.repeat_interleave(H // KH, 0), _tol(dt))
    z = plain(*t, zero_empty=True)
    assert (z[1] == 0).all() and (z[2] == 0).all()
    assert torch.equal(z[[0, 3]], out[[0, 3]])


@pytest.mark.parametrize("G", [1, 2])
def test_zero_empty_equals_k1_at_t1(G):
    """The serving convention: ``zero_empty`` and seq_lens = base + 1
    give K1's plain version at T = 1, on live lanes, an idle lane (no
    table, base 0) and denied lanes (base > 0 but no page granted for
    position base: the page is dead, or a page boundary was reached)."""
    rng = np.random.RandomState(30 + G)
    B, KH, hd, psz, maxp, P = 5, 2, 64, 8, 5, 40
    base = np.array([13, 0, 16, 22, 31], np.int32)
    q, kp, vp, table, _ = _case(rng, B, G * KH, KH, hd, psz, maxp, P,
                                base + 1)
    table[1] = -1
    table[2, 2] = -1                   # position 16's page not granted
    table[3, 2] = -1                   # base 22: its page denied mid-page
    _, t = _both(q, kp, vp, table, base + 1)
    base_t = torch.from_numpy(base)
    k1 = k1_plain(t[0][:, None], *t[1:4], base_t)[:, 0]
    k2 = plain(*t, zero_empty=True)
    assert (k1[1] == 0).all() and (k2[1] == 0).all()
    _close(k2, k1.numpy(), 1e-5)


def test_dispatcher_takes_plain_version_on_cpu():
    rng = np.random.RandomState(14)
    t = _both(*_case(rng, 3, 4, 2, 16, 8, 4, 16))[1]
    before = ops.paged_attention.launches
    for zero_empty in (False, True):
        out = ops.paged_attention(*t, zero_empty=zero_empty)
        assert torch.equal(out, plain(*t, zero_empty=zero_empty))
    assert ops.paged_attention.launches == before
    n = ops.decode_bound_bytes(t[0], t[1], t[3], t[4])
    live = int((t[3] >= 0).sum())
    assert n == 2 * t[0].numel() * 4 + 2 * live * 8 * 2 * 16 * 4


def test_engine_routes_decode_only_steps_to_k2(monkeypatch):
    """Every width-1, non-verify step calls K2 once per paged layer, and
    every other step K1: counted through the model's references to the
    two dispatchers while the engine serves on the CPU."""
    calls = {"K1": 0, "K2": 0}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(transformer, "paged_attention",
                        counting("K2", transformer.paged_attention))
    monkeypatch.setattr(transformer, "paged_attention_chunk",
                        counting("K1", transformer.paged_attention_chunk))
    setup = engine_setup("olmo-1b")
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 20)))
               for _ in range(5)]
    eng, reqs = serve(setup, True, prompts, 5, dp=2, b_local=2, max_len=64,
                      chunk_size=8, prefix_sharing=False)
    assert all(r.done for r in reqs)
    widths = [rec["T"] for rec in eng.flight.ring]
    n_layers = setup[2].n_layers
    assert calls["K2"] == n_layers * widths.count(1) > 0
    assert calls["K1"] == n_layers * (len(widths) - widths.count(1)) > 0


# ------------------------------------------------------ K2's TMA route

@pytest.mark.parametrize("dtype,hd,psz,G,route", [
    (torch.bfloat16, 128, 64, 1, "tma"),       # olmo-1b
    (torch.bfloat16, 64, 64, 4, "tma"),        # llama3.2-1b
    (torch.bfloat16, 128, 64, 2, "tma"),       # gemma3-27b
    (torch.bfloat16, 128, 64, 8, "tma"),
    (torch.bfloat16, 128, 64, 6, "fma"),       # a G the route lacks
    (torch.bfloat16, 128, 64, 16, "fma"),
    (torch.float32, 128, 64, 1, "fma"),
    (torch.float32, 16, 8, 2, "fma"),          # the smoke configs
    (torch.bfloat16, 16, 8, 2, "fma"),
    (torch.bfloat16, 128, 16, 1, "fma"),
    (torch.bfloat16, 96, 64, 1, "tma"),        # phi-3-vision
    (torch.bfloat16, 96, 64, 4, "tma"),
    (torch.float32, 96, 64, 1, "fma"),
    (torch.bfloat16, 96, 16, 1, "fma"),
    (torch.bfloat16, 128, 64, 3, "tma"),       # phi4-mini-3.8b
    (torch.bfloat16, 128, 64, 5, "tma"),       # llama4-maverick
])
def test_decode_route(dtype, hd, psz, G, route):
    assert ops.decode_route(dtype, hd, psz, G) == route


def test_decode_splits_schedule():
    """The TMA route's schedule on a table with a live lane, a lane past
    its table, an idle lane, a lane whose only live page is dead and a
    zero length: pages walked, splits and the lanes without a key, under
    both conventions for those."""
    psz, maxp = 8, 7
    table = torch.tensor([[3, 4, 5, -1, -1, -1, -1],
                          [1, 2, 6, 7, 8, 9, 10],
                          [-1] * 7,
                          [-1, 11, -1, -1, -1, -1, -1],
                          [12, -1, -1, -1, -1, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([17, 200, 0, 5, 0], dtype=torch.int32)
    for zero_empty, idle in ((False, 7), (True, 0)):
        n, splits, empty = decode_splits(table, lens, psz, zero_empty, 2)
        assert empty.tolist() == [False, False, True, True, True]
        assert n.tolist() == [3, 7, idle, idle, idle]
        assert splits.tolist() == [2, 4] + [-(-idle // 2)] * 3
    n, splits, _ = decode_splits(table, lens, psz, False, 1)
    assert splits.tolist() == n.tolist()


@pytest.mark.parametrize("hd", [64, 96])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
def test_split_form_vs_ref(seed, pages_per_split, hd):
    """The TMA route's arithmetic (splits, each a partial softmax state
    in log2 units, merged in split order) over random tables with dead
    pages, an idle lane and a lane whose pages are all dead, at hd 64
    and at phi-3-vision's 96, at G 1, 2, 4 and 8 and at phi4-mini's 3
    and llama4-maverick's 5: against the JAX oracle with
    ``zero_empty`` off, and with it on, zeros on the lanes without a key
    and the oracle elsewhere."""
    rng = np.random.RandomState(200 + seed + hd - 64)
    G, KH = [1, 4, 2, 8, 3, 5][seed], [2, 1][seed % 2]
    psz, maxp = 8, int(rng.randint(3, 7))
    B = 6
    lens = rng.randint(1, maxp * psz + 10, B)
    q, kp, vp, table, lens = _case(rng, B, G * KH, KH, hd, psz, maxp, 64,
                                   lens)
    table[1] = -1                              # idle
    table[2, :] = -1                           # every live page dead
    table[3, 0] = -1                           # a dead page in a live run
    lens[1] = 0
    # the lanes with a valid key (lane 3 may have none: its first page
    # is dead and its length may end inside it)
    pos = np.arange(maxp * psz)
    keyed = ((pos[None] < lens[:, None])
             & (table[:, pos // psz] >= 0)).any(1)
    assert not keyed[1] and not keyed[2] and keyed[[0, 4, 5]].all()
    for dt in (jnp.float32, jnp.bfloat16):
        j, t = _both(q, kp, vp, table, lens, dt)
        ref = np.asarray(jref(*j), np.float32)
        out = split_plain(*t, False, pages_per_split)
        _close(out, ref, _tol(dt))
        z = split_plain(*t, True, pages_per_split)
        assert (z[~keyed] == 0).all()
        _close(z[keyed], ref[keyed], _tol(dt))


@pytest.mark.parametrize("dtype,H,KH,hd,psz,route,err", [
    (torch.float32, 16, 16, 128, 64, "tma", TypeError),     # float32
    (torch.bfloat16, 4, 2, 16, 8, "tma", ValueError),       # hd 16, psz 8
    (torch.bfloat16, 96, 16, 128, 64, "tma", ValueError),   # G = 6
    (torch.bfloat16, 16, 16, 128, 64, "wgmma", ValueError),  # no such route
    (torch.bfloat16, 32, 32, 80, 64, "tma", ValueError),    # hd 80
])
def test_wrapper_raises_on_what_the_route_does_not_take(dtype, H, KH, hd,
                                                        psz, route, err):
    """K2's kernel wrapper refuses the tma route for inputs it does not
    take, before it looks for a card (nothing falls back to the fma
    kernel); at hd 80, which no Hopper route takes, for the head dim
    itself; no launch is counted."""
    q = torch.zeros(2, H, hd, dtype=dtype)
    pages = torch.zeros(8, psz, KH, hd, dtype=dtype)
    table = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    before = (ops.paged_attention.launches, dict(ops.paged_attention.routes))
    with pytest.raises(err, match="takes hd in" if hd == 80 else None):
        ops.paged_attention_cuda(q, pages, pages.clone(), table, lens,
                                 route=route)
    assert (ops.paged_attention.launches,
            ops.paged_attention.routes) == before


def test_k3_wgmma_refuses_hd96():
    """K3's wgmma route keeps hd 64 and 128 only: at phi-3-vision's hd
    96, which K1's and K2's Hopper routes take, the verify dispatcher
    picks ``"fma"`` and the wrapper refuses ``"wgmma"`` for the head dim
    before it looks for a card; no launch is counted."""
    assert k3.verify_route(torch.bfloat16, 96, 64, 5, 1) == "fma"
    q = torch.zeros(2, 5, 4, 96, dtype=torch.bfloat16)
    pages = torch.zeros(8, 64, 4, 96, dtype=torch.bfloat16)
    table = torch.zeros(2, 4, dtype=torch.int32)
    base = torch.ones(2, dtype=torch.int32)
    before = (k3.verify_attention.launches, dict(k3.verify_attention.routes))
    with pytest.raises(ValueError, match="takes hd in"):
        k3.verify_attention_cuda(q, pages, pages.clone(), table, base,
                                 route="wgmma")
    assert (k3.verify_attention.launches,
            k3.verify_attention.routes) == before
