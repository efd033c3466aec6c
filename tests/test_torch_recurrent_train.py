"""The port's full-sequence recurrent forms against the reference's.

``ssd_chunked`` (float32, S 64 in chunks of 16 so the inter-chunk loop
runs, with and without a carried state): y and the final state within
1e-5 of their scale, the VJP of a random cotangent with respect to
every input within 1e-4 of ``jax.vjp``'s; one bf16 case at the
reference's own 6e-2.  The associative-scan mirror bit-equal to eager
``jax.lax.associative_scan`` in float32 at an even and an odd length;
``rglru_scan`` with a carried state and its VJP.  Both full-sequence
blocks against the reference's ``*_block_apply(decode=False)`` from a
given (h0, conv0), outputs within 1e-5 and one layer's gradients
within 1e-4; their final (h, conv) equal within 1e-5 to the port's own
serving chunk form run over the same tokens through K4's and K5's
plain versions, which ties the train and serve forms.  Smoke widths
(mamba2-370m's and recurrentgemma-2b's smoke configs), inputs from
numpy seeds.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro.configs import get_config, smoke_config
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.layers import init_tree
from repro.models.transformer import layer_defs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import tree_leaves


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(rng, B=2, S=64, H=4, P=8, N=16, h0=True):
    return dict(
        x=rng.randn(B, S, H, P).astype(np.float32),
        dt=np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32) * 0.5,
        A=-np.exp(rng.randn(H) * 0.5).astype(np.float32),
        Bm=rng.randn(B, S, N).astype(np.float32),
        Cm=rng.randn(B, S, N).astype(np.float32),
        D=rng.randn(H).astype(np.float32),
        h0=rng.randn(B, H, P, N).astype(np.float32) if h0 else None)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    rng = np.random.RandomState(1)
    inp = _ssd_inputs(rng, h0=with_h0)
    names = [k for k, v in inp.items() if v is not None]

    def jfn(*args):
        kw = dict(zip(names, args))
        return jssm.ssd_chunked(kw["x"], kw["dt"], kw["A"], kw["Bm"],
                                kw["Cm"], kw["D"], chunk=16,
                                h0=kw.get("h0"))

    (y, hf), vjp = jax.vjp(jax.jit(jfn),
                           *(jnp.asarray(inp[k]) for k in names))
    targs = [_t(inp[k]).requires_grad_(True) for k in names]
    kw = dict(zip(names, targs))
    ty, thf = tssm.ssd_chunked(kw["x"], kw["dt"], kw["A"], kw["Bm"],
                               kw["Cm"], kw["D"], chunk=16, h0=kw.get("h0"))
    _close(ty, y, 1e-5, "y")
    _close(thf, hf, 1e-5, "h_final")
    cy = rng.randn(*y.shape).astype(np.float32)
    ch = rng.randn(*hf.shape).astype(np.float32)
    jg = vjp((jnp.asarray(cy), jnp.asarray(ch)))
    tg = torch.autograd.grad((ty, thf), targs, (_t(cy), _t(ch)))
    for name, a, b in zip(names, tg, jg):
        _close(a, b, 1e-4, f"d{name}")


def test_ssd_chunked_pads_a_ragged_last_chunk():
    """S = 40 in chunks of 16: the reference requires a whole number of
    chunks, so it runs the same inputs as one 40-token chunk; the
    port's padded tail (dt = 0) leaves y and the final state as they
    are, within 1e-5."""
    rng = np.random.RandomState(4)
    inp = _ssd_inputs(rng, S=40)
    y, hf = jssm.ssd_chunked(*(jnp.asarray(inp[k]) for k in
                               ("x", "dt", "A", "Bm", "Cm", "D")),
                             chunk=40, h0=jnp.asarray(inp["h0"]))
    t = {k: _t(v) for k, v in inp.items()}
    ty, thf = tssm.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                               t["D"], chunk=16, h0=t["h0"])
    _close(ty, y, 1e-5, "y")
    _close(thf, hf, 1e-5, "h_final")


def test_ssd_chunked_bf16_matches_reference():
    """x, B and C in bf16 as a bf16 model feeds them (dt, A, D and the
    carried state float32): the reference's casts, at its 6e-2."""
    import ml_dtypes
    rng = np.random.RandomState(2)
    inp = _ssd_inputs(rng)
    for k in ("x", "Bm", "Cm"):
        inp[k] = inp[k].astype(ml_dtypes.bfloat16)
    y, hf = jssm.ssd_chunked(*(jnp.asarray(inp[k]) for k in
                               ("x", "dt", "A", "Bm", "Cm", "D")),
                             chunk=16, h0=jnp.asarray(inp["h0"]))
    t = params_from_numpy(inp, "cpu")
    ty, thf = tssm.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                               t["D"], chunk=16, h0=t["h0"])
    assert ty.dtype == torch.float32 and thf.dtype == torch.float32
    _close(ty.float(), np.asarray(y, np.float32), 6e-2, "y bf16")
    _close(thf, hf, 6e-2, "h_final bf16")


@pytest.mark.parametrize("S", [32, 37])
def test_associative_scan_is_bit_equal_to_jax(S):
    """Float32, eager: the same operands combined in the same order give
    the same bits, the decays' running product and the state alike
    (decays in (0.5, 1): no denormals, which XLA flushes)."""
    rng = np.random.RandomState(S)
    a = rng.uniform(0.5, 1.0, (3, S, 7)).astype(np.float32)
    b = rng.randn(3, S, 7).astype(np.float32)

    def comb(left, right):
        al, bl = left
        ar, br = right
        return al * ar, ar * bl + br

    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    ta, tb = trglru.associative_scan(trglru._combine, (_t(a), _t(b)), dim=1)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


def _layer(arch, kind, seed):
    """One layer's recurrent block parameters of ``arch``'s smoke config,
    drawn by the reference from ``seed``, and the bridged copy."""
    cfg = smoke_config(get_config(arch))
    tcfg = t_smoke_config(t_get_config(arch))
    p = init_tree(jax.random.PRNGKey(seed), layer_defs(cfg, kind))[kind]
    p = jax.tree.map(np.asarray, p)
    return cfg, tcfg, p, params_from_numpy(p, "cpu")


def test_rglru_scan_matches_reference():
    cfg, tcfg, p, tp = _layer("recurrentgemma-2b", "rglru", 3)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 45, cfg.d_model).astype(np.float32)
    h0 = rng.randn(2, cfg.d_model).astype(np.float32)
    (y, hf), vjp = jax.vjp(jax.jit(jrglru.rglru_scan),
                           jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(h0))
    leaves = [tp[k].requires_grad_(True) for k in sorted(tp)]
    tx, th = _t(x).requires_grad_(True), _t(h0).requires_grad_(True)
    ty, thf = trglru.rglru_scan(tp, tx, th)
    _close(ty, y, 1e-5, "y")
    _close(thf, hf, 1e-5, "h_final")
    cy = rng.randn(*y.shape).astype(np.float32)
    ch = rng.randn(*hf.shape).astype(np.float32)
    jp, jx, jh = vjp((jnp.asarray(cy), jnp.asarray(ch)))
    tg = torch.autograd.grad((ty, thf), leaves + [tx, th], (_t(cy), _t(ch)),
                             allow_unused=True)
    for k, g in zip(sorted(tp), tg):
        if g is None:                       # conv_w, w_gate, ... unused
            assert not np.any(np.asarray(jp[k])), k
        else:
            _close(g, jp[k], 1e-4, f"d{k}")
    _close(tg[-2], jx, 1e-4, "dx")
    _close(tg[-1], jh, 1e-4, "dh0")


BLOCKS = {"ssd": ("mamba2-370m", jssm.ssd_block_apply, tssm.ssd_block_full),
          "rglru": ("recurrentgemma-2b", jrglru.rglru_block_apply,
                    trglru.rglru_block_full)}


def _block_case(kind, S, seed=5):
    arch, jblock, tblock = BLOCKS[kind]
    cfg, tcfg, p, tp = _layer(arch, kind, seed)
    rng = np.random.RandomState(seed)
    d = cfg.d_model
    x = rng.randn(2, S, d).astype(np.float32)
    if kind == "ssd":
        di = cfg.ssd_expand * d
        H = di // cfg.ssd_head_dim
        h0 = rng.randn(2, H, cfg.ssd_head_dim, cfg.ssd_state)
        conv0 = rng.randn(2, 3, di + 2 * cfg.ssd_state)
    else:
        h0 = rng.randn(2, d)
        conv0 = rng.randn(2, cfg.rglru_conv - 1, d)
    return (cfg, tcfg, p, tp, jblock, tblock, x, h0.astype(np.float32),
            conv0.astype(np.float32))


@pytest.mark.parametrize("kind,S", [("ssd", 256), ("rglru", 45)])
def test_block_full_matches_reference(kind, S):
    """From a given (h0, conv0); the SSD block's 256 tokens are two of
    its 128-token chunks.  Outputs and final state within 1e-5, the
    gradients of one layer (every parameter, x, h0, conv0) within
    1e-4."""
    cfg, tcfg, p, tp, jblock, tblock, x, h0, conv0 = _block_case(kind, S)
    rng = np.random.RandomState(6)

    def jfn(p, x, h, c):
        return jblock(cfg, p, x, h, c, decode=False)

    (y, (hf, cf)), vjp = jax.vjp(
        jax.jit(jfn), jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(h0), jnp.asarray(conv0))
    names = sorted(tp)
    leaves = [tp[k].requires_grad_(True) for k in names]
    tin = [_t(a).requires_grad_(True) for a in (x, h0, conv0)]
    ty, (thf, tcf) = tblock(tcfg, tp, *tin)
    _close(ty, y, 1e-5, "y")
    _close(thf, hf, 1e-5, "h_final")
    _close(tcf, cf, 1e-5, "conv state")
    cts = [rng.randn(*a.shape).astype(np.float32) for a in (y, hf)]
    jp, *jin = vjp((jnp.asarray(cts[0]), (jnp.asarray(cts[1]),
                                          jnp.zeros(cf.shape))))
    tg = torch.autograd.grad((ty, thf), leaves + tin,
                             [_t(c) for c in cts])
    for k, g in zip(names, tg):
        _close(g, jp[k], 1e-4, f"{kind} d{k}")
    for name, g, j in zip(("x", "h0", "conv0"), tg[len(names):], jin):
        _close(g, j, 1e-4, f"{kind} d{name}")


@pytest.mark.parametrize("kind,S", [("ssd", 256), ("rglru", 45)])
def test_block_full_state_equals_serving_chunk_form(kind, S):
    """The train form's final (h, conv) is the state the serving chunk
    form (K4's and K5's plain versions on the CPU) carries after the
    same tokens from the same state: one chunk of all S tokens, and
    chunks of 7 tokens with a ragged last one."""
    _, tcfg, _, tp, _, tblock, x, h0, conv0 = _block_case(kind, S)
    serve = (tssm.ssd_block_apply if kind == "ssd"
             else trglru.rglru_block_apply)
    with torch.no_grad():
        y, (hf, cf) = tblock(tcfg, tp, _t(x), _t(h0), _t(conv0))
        for T in (S, 7):
            h, conv = _t(h0), _t(conv0)
            for t0 in range(0, S, T):
                xs = _t(x[:, t0:t0 + T])
                n = xs.shape[1]
                xs = torch.cat([xs, xs.new_zeros(2, T - n, xs.shape[2])], 1)
                lens = torch.full((2,), n, dtype=torch.int32)
                yc = serve(tcfg, tp, xs, h, conv, lens,
                           torch.arange(T)[None] < lens[:, None])
                _close(yc[:, :n], y[:, t0:t0 + n], 1e-5, f"{kind} y T={T}")
            _close(h, hf, 1e-5, f"{kind} h T={T}")
            _close(conv, cf, 1e-5, f"{kind} conv T={T}")


def test_block_full_defaults_to_zero_state():
    """No (h0, conv0): the zero state, as the reference starts training
    and prefill."""
    for kind in BLOCKS:
        cfg, tcfg, p, tp, jblock, tblock, x, h0, conv0 = _block_case(
            kind, 32)
        y, (hf, cf) = jax.jit(lambda p, x: jblock(cfg, p, x))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        with torch.no_grad():
            ty, (thf, tcf) = tblock(tcfg, tp, _t(x))
        zh, zc = np.zeros_like(h0), np.zeros_like(conv0)
        with torch.no_grad():
            ty0, _ = tblock(tcfg, tp, _t(x), _t(zh), _t(zc))
        assert torch.equal(ty, ty0), kind
        _close(ty, y, 1e-5, f"{kind} y")
        _close(thf, hf, 1e-5, f"{kind} h_final")
        _close(tcf, cf, 1e-5, f"{kind} conv")
        assert len(tree_leaves(tp)) == len(jax.tree.leaves(p))
