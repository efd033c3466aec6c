"""The port's encoder-decoder (whisper-tiny) and VLM (phi-3-vision-4.2b)
against the reference's, on bridged weights, at smoke sizes in float32.

- the parameter trees (``encoder``, ``enc_final_norm``, ``norm_x`` and
  ``xattn`` leaves included) are in ``test_torch_model.py``;
- ``_encoder_apply``, ``cross_attention`` and ``_xattn_decode_chunk``
  on the same seeded inputs within 1e-5 of the reference's scale;
- ``forward_train`` with the extra inputs, ``loss_fn`` (a VLM's loss
  leaves out the image positions) and its gradients through autograd
  against ``jax.grad``;
- the decode state: ``enc_kv`` zero at [n_layers, DP, B_local,
  enc_len, KH, hd], and the CLS_STATE sizing with the encoder term
  (whisper-tiny: 4 layers x ceil(1500 / 16) = 376 blocks a slot)
  equal to the reference's ``pool_class_specs``; a ragged chunk over
  loaded cross K/V against the reference's, and frames of another
  length refused by ``load_prefill``;
- both engines at one and two size classes: tokens, status rows, stats
  and pool leaves identical, prefix sharing (and so speculation) off
  for the encoder-decoder as the reference turns it off;
- ``launch.serve.main`` against the reference's on whisper argvs.

Prefill, ``load_prefill`` (``enc_kv``) and decode are in
``test_torch_prefill.py``.  whisper-tiny's smoke forward is badly
conditioned in float32: its encoder's activations reach a few hundred,
and a one-ulp change of every weight moves the reference's own hidden
states by more than 1e-4 of their scale and its gradients by more
than 1e-3 (``test_encdec_float32_noise_floor``).  Its hidden states are
held at 1e-3 and its gradients at 1e-2, phi-3-vision's gradients at
1e-3: each the smallest power of ten above twice its floor.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import (TIMING, assert_same, engine_setup, extra_inputs,
                            run_main)
from repro import models as jmodels
from repro.configs import get_config, smoke_config
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.models.decode_init import empty_decode_state as j_empty
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.core.classed_pool import CLS_KV, CLS_STATE
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tt
from repro_torch.models.decode_init import empty_decode_state as t_empty
from repro_torch.models.layers import tree_leaves, tree_map

ARCHS = ["whisper-tiny", "phi-3-vision-4.2b"]
#: hidden-state and gradient tolerances, relative to a tensor's scale
HIDDEN_TOL = {"whisper-tiny": 1e-3, "phi-3-vision-4.2b": 1e-4}
GRAD_TOL = {"whisper-tiny": 1e-2, "phi-3-vision-4.2b": 1e-3}


def _setup(arch, seed=0):
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    params = jmodels.init_params(cfg, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, tcfg, tparams


def _batch(cfg, seed, B=2, S=40):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(1, 256, (B, S)).astype(np.int32),
             "labels": rng.randint(1, 256, (B, S)).astype(np.int32)}
    return {**batch, **extra_inputs(cfg, rng, B)}


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _layer(params, i=0):
    """Decoder layer i of the stacked groups."""
    return jax.tree.map(lambda a: a[i], params["groups"]["pos0"])


def test_encoder_apply_matches_reference():
    cfg, params, tcfg, tparams = _setup("whisper-tiny")
    frames = np.random.RandomState(3).randn(
        2, cfg.enc_len, cfg.d_model).astype(np.float32)
    want = jax.jit(lambda p, e: jt._encoder_apply(cfg, p, e))(
        params, jnp.asarray(frames))
    for remat in (False, True):
        with torch.no_grad():
            got = tt._encoder_apply(tcfg, tparams, torch.from_numpy(frames),
                                    remat=remat)
        _close(got, want, 1e-5, f"encoder, remat {remat}")


def test_cross_attention_matches_reference():
    cfg, params, tcfg, tparams = _setup("whisper-tiny")
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    k, v = (rng.randn(2, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
            .astype(np.float32) for _ in range(2))
    lp = _layer(params)["xattn"]
    want = jattn.cross_attention(cfg, lp, jnp.asarray(x),
                                 (jnp.asarray(k), jnp.asarray(v)))
    got = tattn.cross_attention(
        tcfg, tree_map(lambda a: a[0], tparams["groups"]["pos0"]["xattn"]),
        torch.from_numpy(x), (torch.from_numpy(k), torch.from_numpy(v)))
    _close(got, want, 1e-5, "cross_attention")


def test_xattn_decode_chunk_matches_reference():
    """A chunk of T = 3 tokens on DP 2 x B_local 2 over one layer's
    encoder K/V."""
    cfg, params, tcfg, tparams = _setup("whisper-tiny")
    rng = np.random.RandomState(5)
    x = rng.randn(2, 2, 3, cfg.d_model).astype(np.float32)
    k, v = (rng.randn(2, 2, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
            .astype(np.float32) for _ in range(2))
    want = jt._xattn_decode_chunk(cfg, _layer(params, 1), jnp.asarray(x),
                                  (jnp.asarray(k), jnp.asarray(v)))
    got = tt._xattn_decode_chunk(
        tcfg, tree_map(lambda a: a[1], tparams["groups"]["pos0"]),
        torch.from_numpy(x), (torch.from_numpy(k), torch.from_numpy(v)))
    _close(got, want, 1e-5, "_xattn_decode_chunk")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    cfg, params, tcfg, tparams = _setup(arch)
    batch = _batch(cfg, 1)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    hidden = jax.jit(lambda p, b: jt.forward_train(cfg, p, b["tokens"],
                                                   extra=b))(params, jb)
    with torch.no_grad():
        t_hidden = tt.forward_train(tcfg, tparams, tb["tokens"], tb)
    S = batch["tokens"].shape[1] + (cfg.img_tokens if "img_embeds" in batch
                                    else 0)
    assert t_hidden.shape == (2, S, cfg.d_model)
    _close(t_hidden, hidden, HIDDEN_TOL[arch], f"{arch} hidden")

    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(cfg, p, jb)))(params)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    t_loss = tmodel.loss_fn(tcfg, tparams, tb)
    t_grads = torch.autograd.grad(t_loss, leaves)
    _close(t_loss, loss, 1e-5, f"{arch} loss")
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    assert len(paths) == len(t_grads)
    for path, g, tg in zip(paths, jax.tree.leaves(grads), t_grads):
        _close(tg, g, GRAD_TOL[arch], f"{arch} grad {path}")


def test_phi3_vision_at_hd96_loss_and_gradients_match_reference():
    """phi-3-vision's smoke config widened to its own head dim, hd 96
    (d 384, 4 heads of 96, its G 1, 2 layers, 8 image positions): the
    port's ``loss_fn`` and its gradients through autograd (K6's plain
    backward at hd 96 on the CPU) against ``jax.value_and_grad`` of the
    reference's, loss within 1e-5 and every gradient leaf within
    phi-3-vision's 1e-3 of its scale."""
    import dataclasses

    arch = "phi-3-vision-4.2b"
    wide = dict(d_model=384, n_heads=4, n_kv_heads=4, head_dim=96)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **wide)
    tcfg = dataclasses.replace(t_smoke_config(t_get_config(arch)), **wide)
    assert cfg.hd == tcfg.hd == 96 and tcfg.img_tokens == 8
    assert tcfg.n_layers == 2
    params = jmodels.init_params(cfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    batch = _batch(cfg, 4)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(cfg, p, jb)))(params)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    t_loss = tmodel.loss_fn(tcfg, tparams, tb)
    t_grads = torch.autograd.grad(t_loss, leaves)
    _close(t_loss, loss, 1e-5, f"{arch} hd 96 loss")
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(grads)[0]]
    assert len(paths) == len(t_grads)
    for path, g, tg in zip(paths, jax.tree.leaves(grads), t_grads):
        _close(tg, g, GRAD_TOL[arch], f"{arch} hd 96 grad {path}")


def test_vlm_loss_leaves_out_the_image_positions():
    """The loss is the mean cross-entropy of the text positions alone:
    changing the image embeddings moves it, and it equals the chunked
    cross-entropy of the text slice of the hidden states."""
    from repro_torch.models.layers import chunked_softmax_xent

    _, _, tcfg, tparams = _setup("phi-3-vision-4.2b")
    tb = {k: torch.from_numpy(a)
          for k, a in _batch(t_smoke_config(t_get_config(
              "phi-3-vision-4.2b")), 2).items()}
    with torch.no_grad():
        loss = tmodel.loss_fn(tcfg, tparams, tb)
        x = tt.forward_train(tcfg, tparams, tb["tokens"], tb)
        want = chunked_softmax_xent(tcfg, tparams["embed"],
                                    x[:, tcfg.img_tokens:], tb["labels"])
        moved = tmodel.loss_fn(tcfg, tparams,
                               {**tb, "img_embeds": tb["img_embeds"] + 1})
    assert float(loss) == float(want)
    assert float(moved) != float(loss)


def test_encdec_float32_noise_floor():
    """A one-ulp change of every weight of the reference (up or down at
    random) moves its own whisper-tiny hidden states by more than 1e-4
    of their scale and its gradients by more than 1e-3, so no
    implementation that rounds differently can be held to the
    decoders' 1e-4 there; phi-3-vision's gradients move by more than
    1e-4.  Each tolerance of this module is the smallest power of ten
    above twice its floor."""
    for arch, want_h, want_g in (("whisper-tiny", 1e-3, 1e-2),
                                 ("phi-3-vision-4.2b", 1e-4, 1e-3)):
        cfg, params, _, _ = _setup(arch)
        jb = jax.tree.map(jnp.asarray, _batch(cfg, 1))
        g = np.random.RandomState(5)

        def nudge(a):
            a = np.asarray(a)
            up = g.rand(*a.shape) < 0.5
            return np.nextafter(a, np.where(up, np.float32(np.inf),
                                            np.float32(-np.inf))
                                .astype(a.dtype))

        fwd = jax.jit(lambda p: (
            jt.forward_train(cfg, p, jb["tokens"], extra=jb),
            jax.grad(lambda q: jmodels.loss_fn(cfg, q, jb))(p)))
        h0, g0 = fwd(params)
        h1, g1 = fwd(jax.tree.map(nudge, params))
        floor_h = _rel(h1, h0)
        floor_g = max(_rel(b, a) for a, b in zip(jax.tree.leaves(g0),
                                                 jax.tree.leaves(g1)))
        assert 2 * floor_g <= want_g < 20 * floor_g, (arch, floor_g)
        assert 2 * floor_h <= want_h, (arch, floor_h)
        if arch == "whisper-tiny":
            assert floor_h > 1e-4, floor_h
        assert HIDDEN_TOL[arch] == want_h and GRAD_TOL[arch] == want_g


def test_decode_state_and_class_sizing_match_reference():
    """``enc_kv`` zero at the reference's shape; CLS_STATE carries the
    encoder term, at full width and smoke width."""
    for arch in ARCHS:
        for get in (lambda a: (get_config(a), t_get_config(a)),
                    lambda a: (smoke_config(get_config(a)),
                               t_smoke_config(t_get_config(a)))):
            cfg, tcfg = get(arch)
            for C in (1, 2):
                assert (tt.pool_class_specs(tcfg, 8, 2048, 64, C)
                        == tuple(jt.pool_class_specs(cfg, 8, 2048, 64, C)))
            assert (tt.state_blocks_per_slot(tcfg, 2048)
                    == jt.state_blocks_per_slot(cfg, 2048))
    whisper = t_get_config("whisper-tiny")
    assert tt.state_blocks_per_slot(whisper, 2048) == 4 * 94 == 376
    assert tt.state_blocks_per_slot(t_get_config("phi-3-vision-4.2b"),
                                    2048) == 0
    cfg = smoke_config(get_config("whisper-tiny"))
    tcfg = t_smoke_config(t_get_config("whisper-tiny"))
    js = j_empty(cfg, 2, 2, 64, size_classes=2)
    ts = t_empty(tcfg, 2, 2, 64, size_classes=2, device="cpu")
    for got, want in zip(ts.enc_kv, js.enc_kv):
        assert tuple(got.shape) == want.shape == (2, 2, 2, 24, 2, 16)
        assert got.dtype == torch.float32 and not got.any()
    assert ts.state_tables.shape == js.state_tables.shape == (2, 2, 2 * 12)
    assert t_empty(t_smoke_config(t_get_config("phi-3-vision-4.2b")), 2, 2,
                   64, device="cpu").enc_kv is None


def test_chunk_over_loaded_enc_kv_matches_reference():
    """After ``load_prefill`` (a 13-token prompt with its frames), a
    4-token ``decode_step_chunk`` with ragged lengths attends over the
    loaded cross K/V: logits within the module's whisper tolerance of
    the reference's, page tables, lengths and pool leaves exact."""
    from _torch_helpers import assert_pools_equal
    from repro.models.decode_init import load_prefill as j_load
    from repro_torch.models.decode_init import load_prefill as t_load

    cfg, params, tcfg, tparams = _setup("whisper-tiny", seed=1)
    rng = np.random.RandomState(6)
    toks = rng.randint(1, 256, (4, 17)).astype(np.int32)
    frames = extra_inputs(cfg, rng, 4)
    _, jc = jmodels.prefill(cfg, params, {
        "tokens": jnp.asarray(toks[:, :13]),
        **{k: jnp.asarray(v) for k, v in frames.items()}})
    _, tc = tmodel.prefill(tcfg, tparams, {
        "tokens": torch.from_numpy(toks[:, :13]),
        **{k: torch.from_numpy(v) for k, v in frames.items()}})
    js = j_load(cfg, j_empty(cfg, 2, 2, 64, size_classes=2), jc, 13)
    ts = t_load(tcfg, t_empty(tcfg, 2, 2, 64, size_classes=2,
                              device="cpu"), tc, 13)
    chunk = toks[:, 13:].reshape(2, 2, 4)
    lens = np.array([[4, 1], [3, 0]], np.int32)
    jl, js, jok = jmodels.decode_step_chunk(cfg, params, jnp.asarray(chunk),
                                            js, jnp.asarray(lens))
    tl, ts, tok = tmodel.decode_step_chunk(tcfg, tparams,
                                           torch.from_numpy(chunk), ts,
                                           torch.from_numpy(lens))
    valid = np.arange(4)[None, None] < lens[..., None]
    _close(tl.detach().numpy()[valid], np.asarray(jl)[valid],
           HIDDEN_TOL["whisper-tiny"], "chunk logits")
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert np.array_equal(ts.seq_lens.numpy(), np.asarray(js.seq_lens))
    assert np.array_equal(ts.page_tables.numpy(), np.asarray(js.page_tables))
    assert_pools_equal(js.pool, ts.pool, "after the chunk")


def test_load_prefill_rejects_frames_of_another_length():
    """The reference's ``load_prefill`` keeps cross K/V of any length and
    its decode then reshapes them with ``enc_len``; the port's raises."""
    from repro_torch.models.decode_init import load_prefill as t_load

    _, _, tcfg, tparams = _setup("whisper-tiny")
    frames = torch.randn(4, tcfg.enc_len + 8, tcfg.d_model)
    _, caches = tmodel.prefill(tcfg, tparams, {
        "tokens": torch.ones((4, 5), dtype=torch.int32),
        "enc_embeds": frames})
    with pytest.raises(ValueError, match="enc_len"):
        t_load(tcfg, t_empty(tcfg, 2, 2, 64, device="cpu"), caches, 5)


@pytest.mark.parametrize("arch,size_classes", [
    ("whisper-tiny", 1), ("whisper-tiny", 2), ("phi-3-vision-4.2b", 1),
    ("phi-3-vision-4.2b", 2)])
def test_engine_matches_reference(arch, size_classes):
    """dp 2, b_local 2, 9 requests of 3-40 prompt tokens on 4 slots, both
    engines asked for prefix sharing and speculation: on for the VLM
    (fully paged), off for the encoder-decoder, whose slots decode over
    zero cross K/V (neither engine takes encoder input)."""
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, 255, rng.randint(3, 41)))
               for _ in range(9)]
    tr, te, je = assert_same(engine_setup(arch), prompts, 5, dp=2,
                             b_local=2, max_len=64,
                             size_classes=size_classes, prefix_sharing=True,
                             speculate=True, spec_gate=False)
    encdec = arch == "whisper-tiny"
    assert (te.prefix_cache is None) == (je.prefix_cache is None) == encdec
    assert te.speculate == je.speculate == (not encdec)
    assert all(len(r.out_tokens) == 5 for r in tr)
    assert te.n_classes == size_classes
    assert te.blocks_in_use(CLS_KV) == 0 and te.leak_free()
    assert (te.state.enc_kv is not None) == encdec
    if encdec:
        assert not any(bool(t.any()) for t in te.state.enc_kv)
    if size_classes == 2:
        assert te.blocks_in_use(CLS_STATE) == 0
        granted = te.stats["state_blocks_granted"]
        assert granted == (9 * 2 * 12 if encdec else 0)


@pytest.mark.parametrize("extra", [
    ["--size-classes", "2"],
    ["--dp", "1", "--b-local", "3", "--max-new", "6"],
])
def test_serve_main_matches_reference_main(monkeypatch, extra):
    argv = ["--arch", "whisper-tiny", "--smoke", "--requests", "8"] + extra
    jparams = jax.tree.map(np.asarray, engine_setup("whisper-tiny")[1])
    je, jreqs = run_main(jserve, argv, monkeypatch)
    te, treqs = run_main(tserve, argv + ["--device", "cpu"], monkeypatch,
                         jparams)
    assert all(r.done for r in treqs) and len(treqs) == len(jreqs) == 8
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert ({k: v for k, v in te.stats.items() if k not in TIMING}
            == {k: v for k, v in je.stats.items() if k not in TIMING})
    assert te.scheduler.stats == je.scheduler.stats
    keys = ("T", "spec", "status", "ctr", "rids")
    assert [[r[k] for k in keys] for r in te.flight.ring] == \
        [[r[k] for k in keys] for r in je.flight.ring]
    assert te.host_transfers == te.stats["steps"]
    assert te.page_occupancy() == je.page_occupancy() == 0.0
    assert te.leak_free() and te.prefix_cache is None
    assert te.telemetry.never_dry_margin_min() == \
        je.telemetry.never_dry_margin_min() >= 0
