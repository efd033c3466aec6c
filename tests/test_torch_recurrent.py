"""The port's ring and recurrent serving path against the reference's.

Model level: ``decode_step_chunk`` on the mamba2-370m (SSD),
recurrentgemma-2b (RG-LRU + ring attention) and gemma3-27b (ring +
paged attention) smoke configs, DP = 2, B_local = 2, with one and two
size classes: ragged chunks of 4 + 4 + 3 tokens, then chunks of random
valid lengths past the 32-token window, one lane at lens = 0
throughout.  Logits at valid positions, recurrent state, conv state
and rings allclose; page tables, ``seq_lens``, ``state_tables`` and
every pool leaf exactly equal, step after step.

Engine level: the JAX engine against the port's on the recurrentgemma
and mamba2 smoke configs (9 requests on 4 slots): identical tokens,
per-step status rows (the class-1 counter block included) and stats,
one transfer per step, no page and no CLS_STATE block live after the
drain.

Float tolerance, float32: rtol ``TOL[arch]`` with an absolute term of
``TOL[arch]`` times the reference leaf's largest magnitude (state
leaves reach 10^3, where a float32 ulp is 1e-4).  mamba2 and gemma3
hold 1e-4.  recurrentgemma's smoke config carries a residual stream of
order 10^3 (random weights) through the RG-LRU's saturating gates: a
one-ulp change of its weights alone moves its logits by the order of
1e-4 of their scale (``test_float32_noise_floor``), and the port, which
rounds differently at every operation, sits a few such steps from the
reference.  It is held to 1e-3, which covers that noise with a margin
of at least two.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import assert_pools_equal, assert_same, engine_setup
from repro import models as jmodels
from repro.models.decode_init import empty_decode_state as j_empty
from repro_torch.core.classed_pool import CLS_KV, CLS_STATE
from repro_torch.models import model as tmodel
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.layers import tree_map
from repro_torch.serving.telemetry import N_CTR

ARCHS = ["mamba2-370m", "recurrentgemma-2b", "gemma3-27b"]
TOL = {"mamba2-370m": 1e-4, "recurrentgemma-2b": 1e-3, "gemma3-27b": 1e-4}
DP, BL, MAX_LEN = 2, 2, 64

#: the reference's chunk step, jitted (eager op-by-op dispatch of the
#: whole model costs more than its compile)
j_step_chunk = jax.jit(jmodels.decode_step_chunk, static_argnums=0)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return request.param, engine_setup(request.param)


def _close(port, ref, arch, what):
    ref = np.asarray(ref, np.float32)
    tol = TOL[arch]
    np.testing.assert_allclose(
        np.asarray(port, np.float32), ref, rtol=tol,
        atol=tol * max(float(np.abs(ref).max(initial=0.0)), 1.0),
        err_msg=what)


def _workload(T_steps=(4, 4, 4, 8, 8, 8, 8, 8, 8, 1, 1), seed=3):
    """(tokens, lens) per step: 11 tokens as 4 + 4 + 3, then chunks of
    random valid lengths (a fifth of them 0, the rest at least half the
    chunk); lane (1, 1) feeds nothing."""
    rng = np.random.RandomState(seed)
    out = []
    for s, T in enumerate(T_steps):
        toks = rng.randint(1, 255, (DP, BL, T)).astype(np.int32)
        if s < 3:
            lens = np.full((DP, BL), 3 if s == 2 else 4, np.int32)
        else:
            lens = np.where(rng.rand(DP, BL) < 0.2, 0,
                            rng.randint(-(-T // 2), T + 1, (DP, BL))
                            ).astype(np.int32)
        lens[1, 1] = 0
        out.append((toks, lens))
    return out


def _state_leaves(state):
    """{name: float leaf} of rings (the port's sink slot sliced off) and
    recurrent state."""
    out = {}
    for pos, (k, v) in state.rings.items():
        if isinstance(k, torch.Tensor):
            k, v = k[:, :, :, :-1], v[:, :, :, :-1]
        out[f"ring {pos} k"], out[f"ring {pos} v"] = k, v
    for pos, leaves in state.rec.items():
        for name, a in leaves.items():
            out[f"rec {pos} {name}"] = a
    return out


@pytest.mark.parametrize("size_classes", [1, 2])
def test_forward_decode_chunk_matches_reference(setup, size_classes):
    arch, (cfg, params, tcfg, tparams) = setup
    js = j_empty(cfg, DP, BL, MAX_LEN, size_classes=size_classes)
    ts = t_empty(tcfg, DP, BL, MAX_LEN, size_classes=size_classes,
                 device="cpu")
    idle0 = {n: a[:, 1, 1].clone() for n, a in _state_leaves(ts).items()}
    for step, (toks, lens) in enumerate(_workload()):
        T = toks.shape[2]
        jl, js, jok = j_step_chunk(cfg, params, jnp.asarray(toks), js,
                                   jnp.asarray(lens))
        tl, ts, tok = tmodel.decode_step_chunk(
            tcfg, tparams, torch.from_numpy(toks), ts,
            torch.from_numpy(lens))
        what = f"{arch} C={size_classes} step {step}"
        valid = np.arange(T) < lens[..., None]
        _close(tl.numpy()[valid], np.asarray(jl)[valid], arch, what)
        assert np.array_equal(tok.numpy(), np.asarray(jok)), what
        for name in ("page_tables", "seq_lens", "state_tables"):
            j, t = getattr(js, name), getattr(ts, name)
            assert (j is None) == (t is None) == (size_classes == 1
                                                  and name == "state_tables")
            if t is not None:
                assert np.array_equal(t.numpy(), np.asarray(j)), (what, name)
        assert_pools_equal(js.pool, ts.pool, what)
        jleaves = _state_leaves(js)
        tleaves = _state_leaves(ts)
        assert sorted(jleaves) == sorted(tleaves) and tleaves, what
        for name, j in jleaves.items():
            _close(tleaves[name].numpy(), j, arch, f"{what} {name}")
        # the lane that never fed a token kept its state bit for bit
        for name, a in tleaves.items():
            assert torch.equal(a[:, 1, 1], idle0[name]), (what, name)
    assert int(ts.seq_lens.max()) > 32, "the rings wrapped"


def test_chunks_match_single_tokens(setup):
    """The reference's model contract (tests/test_serving.py, ring and
    recurrent cases) on the port: ragged 4 + 4 + 3 chunks give the
    token-by-token logits and state."""
    arch, (_, _, tcfg, tparams) = setup
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(1, 255, (1, 2, 11)).astype(np.int32))
    s1 = t_empty(tcfg, 1, 2, MAX_LEN, device="cpu")
    outs1 = []
    for t in range(11):
        lg, s1 = tmodel.decode_step(tcfg, tparams, toks[:, :, t], s1)
        outs1.append(lg)
    s2 = t_empty(tcfg, 1, 2, MAX_LEN, device="cpu")
    outs2 = []
    for c0 in range(0, 11, 4):
        n = min(4, 11 - c0)
        chunk = torch.zeros((1, 2, 4), dtype=torch.int32)
        chunk[:, :, :n] = toks[:, :, c0:c0 + n]
        lg, s2, ok = tmodel.decode_step_chunk(
            tcfg, tparams, chunk, s2, torch.full((1, 2), n,
                                                 dtype=torch.int32))
        assert ok.all()
        outs2.append(lg[:, :, :n])
    _close(torch.cat(outs2, dim=2).numpy(), torch.stack(outs1, 2).numpy(),
           arch, arch)
    assert torch.equal(s1.seq_lens, s2.seq_lens)
    for name, a in _state_leaves(s1).items():
        _close(_state_leaves(s2)[name].numpy(), a.numpy(), arch, name)


def test_float32_noise_floor():
    """Why recurrentgemma is held to 1e-3: the port against itself with
    every weight moved by about one float32 ulp (relative 2^-23,
    seeded), on the parity test's workload.  That alone moves the
    logits by more than half of 1e-4 of their scale, so an
    implementation that rounds differently at every operation cannot
    be held to 1e-4; and by less than half of 1e-3 of it, the
    tolerance the parity tests use."""
    arch = "recurrentgemma-2b"
    _, _, tcfg, tparams = engine_setup(arch)
    g = torch.Generator().manual_seed(0)
    nudged = tree_map(lambda a: a * (1 + 2.0 ** -23 * torch.randn(
        a.shape, generator=g)), tparams)
    runs = []
    for p in (tparams, nudged):
        st = t_empty(tcfg, DP, BL, MAX_LEN, device="cpu")
        outs = []
        for toks, lens in _workload():
            lg, st, _ = tmodel.decode_step_chunk(
                tcfg, p, torch.from_numpy(toks), st, torch.from_numpy(lens))
            outs.append(lg.numpy()[np.arange(toks.shape[2]) < lens[..., None]])
        runs.append(np.concatenate(outs))
    scale = np.abs(runs[0]).max()
    noise = np.abs(runs[0] - runs[1]).max() / scale
    assert 5e-5 < noise < TOL[arch] / 2, noise


# ------------------------------------------------------------- engine


@pytest.mark.parametrize("arch,size_classes", [
    ("recurrentgemma-2b", 2), ("mamba2-370m", 2), ("recurrentgemma-2b", 1)])
def test_engine_matches_reference(arch, size_classes):
    """dp 2, b_local 2, 9 requests of 3-40 prompt tokens on 4 slots (the
    longest past the 32-token window).  Both engines are asked for
    prefix sharing and speculation, which the reference's rule turns
    off for ring and recurrent state: the port's does the same."""
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 41)))
               for _ in range(9)]
    tr, te, je = assert_same(engine_setup(arch), prompts, 5, dp=2,
                             b_local=2, max_len=MAX_LEN,
                             size_classes=size_classes, prefix_sharing=True,
                             speculate=True, spec_gate=False)
    assert te.prefix_cache is None and not te.speculate
    assert je.prefix_cache is None and not je.speculate
    assert all(len(r.out_tokens) == 5 for r in tr)
    assert te.n_classes == size_classes == len(te.state.pool.classes)
    for rec in te.flight.ring:
        assert len(rec["status"]) == rec["T"] + 3 + size_classes * N_CTR
    assert te.blocks_in_use(CLS_KV) == 0 and te.leak_free()
    if size_classes == 2:
        assert te.stats["state_blocks_granted"] == 9 * te._state_blocks > 0
        assert te.blocks_in_use(CLS_STATE) == 0
        assert bool((te.state.state_tables == -1).all())
    # released slots' rings (but for their write sinks) and recurrent
    # state are zero again
    assert not any(bool(a.any()) for a in _state_leaves(te.state).values())
