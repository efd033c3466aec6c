"""The port's prefill path against the reference's, on bridged weights.

For each of the ten configurations (smoke sizes, float32; the two MoE
ones at no-drop capacity, as the reference's
``test_prefill_decode_consistency`` sets them): a 37-token prompt on 4
sequences (past the 32-token smoke window, so rings wrap, and not a
whole number of 8-token pages) through ``prefill``, with seeded image
patch embeddings before it (phi-3-vision) or frame embeddings through
the encoder (whisper-tiny), then ``load_prefill`` into an empty decode
state of DP 2 x B_local 2, then 3 decode steps.

- ``forward_prefill``'s hidden states and every cache within ``TOL``
  of the reference's;
- ``load_prefill``'s page tables, ``seq_lens`` and every pool leaf
  exactly the reference's; KV pages, rings, recurrent state and
  ``enc_kv`` within ``TOL``, the port's sink page and sink ring slot
  left zero;
- prefill and decode logits within 2e-3 of the port's own one-shot
  ``forward_train`` (the reference test's bound) and within ``TOL`` of
  the reference's decode logits.

``TOL`` is 1e-4 of a tensor's scale, whisper-tiny's 1e-3: a one-ulp
change of every weight moves the reference's own whisper hidden states
by more than 1e-4 of their scale
(``test_torch_encdec.py::test_encdec_float32_noise_floor``).
recurrentgemma-2b's weights are the reference's draw rescaled to each
layer's own fan-in (``_torch_helpers.rglru_fan_in``, which says why).
``count_active_params`` against the reference's at full width for the
same ten.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import assert_pools_equal, extra_inputs, rglru_fan_in
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.models.decode_init import empty_decode_state as j_empty
from repro.models.decode_init import load_prefill as j_load
from repro.models.transformer import forward_prefill as j_forward_prefill
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import model as tmodel
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.decode_init import load_prefill as t_load
from repro_torch.models.layers import logits_apply
from repro_torch.models.transformer import forward_prefill, forward_train

ARCHS = ["olmo-1b", "llama3.2-1b", "phi4-mini-3.8b", "gemma3-27b",
         "llama4-maverick-400b-a17b", "mixtral-8x7b", "mamba2-370m",
         "recurrentgemma-2b", "whisper-tiny", "phi-3-vision-4.2b"]
TOL = 1e-4
#: above the float32 noise floor (see the module's docstring)
ARCH_TOL = {"whisper-tiny": 1e-3}
B, T0, T1, DP, BL, MAX_LEN = 4, 37, 4, 2, 2, 64

j_decode = jax.jit(jmodels.decode_step, static_argnums=0)


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=tol,
        atol=tol * max(float(np.abs(want).max(initial=0.0)), 1.0),
        err_msg=what)


def _setup(arch):
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    if cfg.moe:      # no-drop capacity, so decode == the one-shot forward
        cfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.num_experts)))
            for c in (cfg, tcfg))
    params = rglru_fan_in(cfg, jmodels.init_params(cfg, jax.random.PRNGKey(1)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tcfg, tparams


def _caches_close(got, want, tol, what):
    """Caches of either kind: (k, v) tuples or {"h", "conv"} dicts."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _caches_close(got[k], want[k], tol, f"{what}.{k}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _caches_close(g, w, tol, f"{what}[{i}]")
    else:
        _close(got, want, tol, what)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_load_and_decode_match_reference(arch):
    cfg, params, tcfg, tparams = _setup(arch)
    tol = ARCH_TOL.get(arch, TOL)
    rng = np.random.RandomState(1)
    toks = rng.randint(1, cfg.vocab, (B, T0 + T1)).astype(np.int32)
    ttoks = torch.from_numpy(toks)
    extra = extra_inputs(cfg, rng, B)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    img = cfg.img_tokens if "img_embeds" in extra else 0
    plen = T0 + img

    # forward_prefill: hidden states and caches
    x, caches = jax.jit(lambda p, t, e: j_forward_prefill(cfg, p, t, e))(
        params, jnp.asarray(toks[:, :T0]), jextra)
    tx, tcaches = forward_prefill(tcfg, tparams, ttoks[:, :T0], textra)
    _close(tx, x, tol, f"{arch} hidden")
    assert set(tcaches) == set(caches), (set(tcaches), set(caches))
    for pos in caches:
        _caches_close(tcaches[pos], caches[pos], tol, f"{arch} {pos}")

    # load_prefill: integer state exact, payloads close, sinks zero
    jlogits, jcaches = jax.jit(lambda p, t, e: jmodels.prefill(
        cfg, p, {"tokens": t, **e}))(params, jnp.asarray(toks[:, :T0]),
                                     jextra)
    tlogits, tcaches = tmodel.prefill(tcfg, tparams,
                                      {"tokens": ttoks[:, :T0], **textra})
    jstate = j_load(cfg, j_empty(cfg, DP, BL, MAX_LEN), jcaches, plen)
    tstate = t_load(tcfg, t_empty(tcfg, DP, BL, MAX_LEN, device="cpu"),
                    tcaches, plen)
    assert np.array_equal(tstate.page_tables.numpy(),
                          np.asarray(jstate.page_tables))
    assert np.array_equal(tstate.seq_lens.numpy(),
                          np.asarray(jstate.seq_lens))
    assert_pools_equal(jstate.pool, tstate.pool, f"{arch} after load")
    for pos, kv in jstate.kv_pages.items():
        for got, want in zip(tstate.kv_pages[pos], kv):
            P = want.shape[2]
            _close(got[:, :, :P], want, tol, f"{arch} pages {pos}")
            assert not got[:, :, P].any(), f"{arch} sink page {pos}"
    for pos, kv in jstate.rings.items():
        for got, want in zip(tstate.rings[pos], kv):
            W = want.shape[3]
            _close(got[:, :, :, :W], want, tol, f"{arch} ring {pos}")
            assert not got[:, :, :, W].any(), f"{arch} sink slot {pos}"
    for pos, st in jstate.rec.items():
        for name in st:
            _close(tstate.rec[pos][name], st[name], tol,
                   f"{arch} rec {pos}.{name}")
    assert (tstate.enc_kv is None) == (jstate.enc_kv is None)
    if jstate.enc_kv is not None:
        assert not any(bool(t.any()) for t in t_empty(
            tcfg, DP, BL, MAX_LEN, device="cpu").enc_kv)
        for i, (got, want) in enumerate(zip(tstate.enc_kv, jstate.enc_kv)):
            _close(got, want, tol, f"{arch} enc_kv[{i}]")
    assert tstate.state_tables is None and tstate.expert_tables is None

    # decode: against the one-shot forward and the reference's logits
    with torch.no_grad():
        full = logits_apply(tcfg, tparams["embed"], forward_train(
            tcfg, tparams, ttoks, textra, remat=False)[:, img:])
    errs = [float((tlogits - full[:, T0 - 1]).abs().max())]
    _close(tlogits, jlogits, tol, f"{arch} prefill logits")
    for t in range(T1 - 1):
        tok = toks[:, T0 + t].reshape(DP, BL)
        jl, jstate = j_decode(cfg, params, jnp.asarray(tok), jstate)
        tl, tstate = tmodel.decode_step(tcfg, tparams, torch.from_numpy(tok),
                                        tstate)
        errs.append(float((tl - full[:, T0 + t].reshape(DP, BL, -1))
                          .abs().max()))
        _close(tl, jl, tol, f"{arch} decode logits, step {t}")
        assert np.array_equal(tstate.page_tables.numpy(),
                              np.asarray(jstate.page_tables))
    assert max(errs) < 2e-3, f"{arch}: decode diverges {max(errs):.2e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_count_active_params_matches_reference(arch):
    """At full width, from the parameter definitions alone."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    n = tmodel.count_active_params(tcfg)
    assert n == jmodels.count_active_params(cfg)
    assert 0 < n <= tmodel.count_params(tcfg)
    assert (n < tmodel.count_params(tcfg)) == (cfg.moe is not None)


def test_load_prefill_raises_when_the_pool_is_short():
    """A grant that comes up short raises rather than loading garbage
    page ids: a 37-token prompt needs 5 pages a slot, and a pool of
    MAX_LEN 64 with 8-token pages holds 8 a slot plus lane slack;
    filling it first leaves too few."""
    _, _, tcfg, tparams = _setup("olmo-1b")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        1, tcfg.vocab, (B, T0)).astype(np.int32))
    _, caches = tmodel.prefill(tcfg, tparams, {"tokens": toks})
    state = t_load(tcfg, t_empty(tcfg, DP, BL, MAX_LEN, device="cpu"),
                   caches, T0)
    state = t_load(tcfg, state, caches, T0)
    with pytest.raises(RuntimeError, match="cannot grant"):
        t_load(tcfg, state, caches, T0)
