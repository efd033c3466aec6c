"""K6 (causal flash attention) of the port against the JAX package.

The port's plain version and the CPU path of ``ops.flash_attention``
against the reference's jnp oracle, its Pallas kernel in interpret mode
and its ``blockwise_attention`` (causal and not, grouped kv heads, a
ragged S); the port's gradient (the plain backward in ``ref.py``, from
the saved log-sum-exp, which the dispatcher runs on the CPU) and its
delta = rowsum(dO * O) against ``jax.grad`` of ``blockwise_attention``
and the reference's oracle; the forward's choice of kernel by dtype and
hd, and the bounds; and the port's plain
``blockwise_attention``/``local_attention`` and their gradients against
the reference's.  Float32 at 1e-4, as ``tests/test_kernels.py::_tol``.
"""

import pytest

pytest.importorskip("torch")   # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_helpers  # noqa: F401  (caps torch's CPU threads)
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as j_flash_ref
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (
    BWD_ROW_TOL, TILE, attention_delta_ref, flash_attention_bwd_ref,
    flash_attention_bwd_tiled_ref, flash_attention_fwd_ref,
    flash_attention_ref, row_scaled_err)
from repro_torch.models import attention as tattn

TOL = 1e-4


def _inputs(seed, B, H, KH, S, hd):
    """q [B, H, S, hd], k, v [B, KH, S, hd] as numpy float32."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, S, hd).astype(np.float32),
            rng.randn(B, KH, S, hd).astype(np.float32),
            rng.randn(B, KH, S, hd).astype(np.float32))


def _expand(a, H):
    """[B, KH, S, hd] numpy -> [B, H, S, hd] (kv head h // G)."""
    return np.repeat(a, H // a.shape[1], axis=1)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,H,KH,S,hd,causal", [
    (2, 4, 2, 64, 16, True),            # the smoke configs
    (1, 4, 1, 77, 64, True),            # ragged S, G = 4
    (1, 8, 2, 33, 128, False),
    (1, 4, 4, 70, 96, True),            # phi-3-vision's hd
    (2, 6, 6, 40, 64, False),           # an encoder's layer
    (1, 6, 2, 53, 16, True),            # G = 3, ragged S
    (1, 6, 2, 53, 128, True),           # G = 3 at phi4-mini's hd
])
def test_plain_and_cpu_path_vs_reference_oracle(B, H, KH, S, hd, causal):
    q, k, v = _inputs(S + H, B, H, KH, S, hd)
    want = j_flash_ref(jnp.asarray(q), jnp.asarray(_expand(k, H)),
                       jnp.asarray(_expand(v, H)), causal=causal)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    launches = ops.flash_attention.launches
    for got in (flash_attention_ref(tq, tk, tv, causal),
                ops.flash_attention(tq, tk, tv, causal)):
        _close(got, want)
    assert ops.flash_attention.launches == launches    # no kernel on the CPU
    # the log-sum-exp the backward reads
    s = np.einsum("bhqd,bhkd->bhqk", q, _expand(k, H)) / hd ** 0.5
    if causal:
        s = np.where(np.tril(np.ones((S, S), bool)), s, -1e30)
    _close(flash_attention_fwd_ref(tq, tk, tv, causal)[1],
           jax.nn.logsumexp(jnp.asarray(s), axis=-1))


def test_bf16_plain_vs_reference_oracle():
    q, k, v = _inputs(5, 2, 4, 4, 64, 64)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*t)
    assert got.dtype == torch.bfloat16
    _close(got.float(), j_flash_ref(*j), tol=6e-2)


@pytest.mark.parametrize("S,hd,bq,bk,causal", [
    (128, 64, 64, 128, True),
    (128, 16, 64, 64, True),
    (128, 64, 64, 64, False),
])
def test_vs_pallas_interpret(S, hd, bq, bk, causal):
    """The TPU kernel in interpret mode, as tests/test_kernels.py runs
    it, on expanded kv heads."""
    q, k, v = _inputs(S + hd, 1, 4, 2, S, hd)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(_expand(k, 4)),
                        jnp.asarray(_expand(v, 4)), causal=causal,
                        block_q=bq, block_k=bk, interpret=True)
    _close(ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal),
           want)


def _bshd(a):
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("B,H,KH,S,hd,causal", [
    (1, 4, 1, 300, 16, True),           # ragged against 256-row blocks
    (2, 8, 2, 45, 64, False),
])
def test_vs_blockwise_attention_and_its_gradient(B, H, KH, S, hd, causal):
    """Forward and (dq, dk, dv) against the reference's jnp
    ``blockwise_attention`` and ``jax.grad`` of it; the query and key
    views are strided, as the training step hands them over."""
    q, k, v = _inputs(S + KH, B, H, KH, S, hd)
    do = np.random.RandomState(S).randn(B, H, S, hd).astype(np.float32)

    def j_loss(q, k, v):
        o = jattn.blockwise_attention(
            q, jattn._expand_kv(k, H), jattn._expand_kv(v, H), causal=causal,
            block_q=64, block_k=32)
        return jnp.sum(o * jnp.asarray(_bshd(do))), o

    (_, j_o), j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(_bshd(a)) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(_bshd(a)).transpose(1, 2).requires_grad_()
                  for a in (q, k, v))
    t_o = ops.flash_attention(tq, tk, tv, causal)
    t_g = torch.autograd.grad(t_o, (tq, tk, tv), torch.from_numpy(do))
    _close(t_o.detach().transpose(1, 2), j_o)
    for got, want in zip(t_g, j_g):
        _close(got.transpose(1, 2), want)


@pytest.mark.parametrize("S,window,block_q,causal,q_offset", [
    (37, 8, 16, True, 0),               # ragged, windowed
    (48, 16, 16, True, 0),              # local_attention's sliced path
    (30, None, 512, False, 5),          # bidirectional, offset queries
])
def test_plain_window_attention_vs_reference(S, window, block_q, causal,
                                             q_offset):
    """The port's plain ``blockwise_attention`` (and, with a window,
    ``local_attention``), the forms of the ``local`` layers, against the
    reference's: outputs and the gradients of q, k, v."""
    q, k, v = (_bshd(a) for a in _inputs(S, 2, 4, 4, S, 16))
    do = np.random.RandomState(1).randn(*q.shape).astype(np.float32)
    fns = [(jattn.blockwise_attention, tattn.blockwise_attention,
            (causal, window, block_q, 16, q_offset))]
    if window is not None:
        fns.append((jattn.local_attention, tattn.local_attention,
                    (window, block_q, q_offset)))
    for jfn, tfn, args in fns:
        (_, j_o), j_g = jax.value_and_grad(
            lambda *a: (jnp.sum(jfn(*a, *args) * do), jfn(*a, *args)),
            argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
        t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        t_o = tfn(*t, *args)
        t_g = torch.autograd.grad(t_o, t, torch.from_numpy(do))
        _close(t_o.detach(), j_o)
        for got, want in zip(t_g, j_g):
            _close(got, want)


def test_bound_at_the_training_shape():
    """The note in the kernel's source: 68.75 Gflop and 134 MB at
    olmo-1b, B 4, S 2048, bf16: bounded by its operations."""
    q = torch.empty(4, 16, 2048, 128, dtype=torch.bfloat16, device="meta")
    assert ops.flops(q) == 4 * 4 * 16 * 128 * 2048 * 2049 // 2
    assert round(ops.flops(q) / 1e9, 2) == 68.75
    assert round(ops.bound_bytes(q, q) / 1e6) == 135   # 134.2 MB + the lse
    assert ops.bound_bytes(q, q) / 3.35e12 < ops.flops(q) / 989e12


@pytest.mark.parametrize("B,H,KH,S,hd,causal", [
    (1, 4, 1, 300, 16, True),           # ragged against 256-row blocks
    (2, 4, 2, 64, 16, True),            # the smoke configs
    (2, 8, 2, 45, 64, False),
    (1, 6, 2, 53, 16, True),            # G = 3, ragged S
    (1, 6, 2, 53, 128, True),           # G = 3 at phi4-mini's hd
])
def test_plain_backward_vs_jax_grad(B, H, KH, S, hd, causal):
    """The plain backward, called directly on the plain forward's o and
    lse (strided views, as the training step hands them over), against
    ``jax.grad`` of the reference's ``blockwise_attention``."""
    q, k, v = _inputs(S + 2 * KH, B, H, KH, S, hd)
    do = np.random.RandomState(S + 1).randn(B, H, S, hd).astype(np.float32)

    def j_loss(q, k, v):
        o = jattn.blockwise_attention(
            q, jattn._expand_kv(k, H), jattn._expand_kv(v, H), causal=causal,
            block_q=64, block_k=32)
        return jnp.sum(o * jnp.asarray(_bshd(do)))

    j_g = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(_bshd(a)) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(_bshd(a)).transpose(1, 2)
                  for a in (q, k, v))
    o, lse = flash_attention_fwd_ref(tq, tk, tv, causal)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  causal)
    for g, want in zip(got, j_g):
        assert g.shape == tq.shape or g.shape == tk.shape
        _close(g.transpose(1, 2), want)


def test_backward_dispatcher_takes_the_plain_route_on_the_cpu():
    """``ops.flash_attention_bwd`` and the autograd Function's backward
    run the plain version on CPU tensors and count no launch."""
    q, k, v = map(torch.from_numpy, _inputs(3, 2, 4, 2, 70, 64))
    do = torch.from_numpy(
        np.random.RandomState(4).randn(2, 4, 70, 64).astype(np.float32))
    o, lse = flash_attention_fwd_ref(q, k, v)
    launches = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    via_fn = torch.autograd.grad(ops.flash_attention(tq, tk, tv), (tq, tk, tv),
                                 do)
    for a, b in zip(via_fn, want):
        assert torch.equal(a, b)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == launches


@pytest.mark.parametrize("causal", [True, False])
def test_delta_vs_reference_oracle(causal):
    """delta = rowsum(dO * O), the backward's first pass, against the
    same reduction over the reference oracle's output, and against its
    definition rowsum(P * dP) from the oracle's probabilities."""
    B, H, S, hd = 2, 4, 50, 16
    q, k, v = _inputs(7, B, H, H, S, hd)
    do = np.random.RandomState(8).randn(B, H, S, hd).astype(np.float32)
    j_o = j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal)
    o = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal)
    got = attention_delta_ref(o, torch.from_numpy(do))
    assert got.shape == (B, H, S) and got.dtype == torch.float32
    _close(got, jnp.sum(jnp.asarray(do) * j_o, axis=-1))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / hd ** 0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    dp = jnp.einsum("bhqd,bhkd->bhqk", do, v)
    _close(got, jnp.sum(p * dp, axis=-1))


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 96, "wgmma"),      # phi-3-vision, padded to 128
    (torch.float32, 128, "f32"),
    (torch.float32, 16, "f32"),
    (torch.float32, 96, "f32"),
])
def test_forward_route_by_dtype_and_hd(dtype, hd, route):
    """The forward's kernel by dtype and hd: bf16 hd 96 takes the wgmma
    route over tiles padded to two 64-column atoms; its mma.sync
    instance stays reachable by an explicit route only, and the
    backward has no mma.sync instance there."""
    assert ops.forward_route(dtype, hd) == route
    assert hd in ops.HEAD_DIMS
    if route == "wgmma" and hd == 96:
        assert 96 in ops.MMA_HEAD_DIMS
        assert 96 not in ops.BWD_MMA_HEAD_DIMS


@pytest.mark.parametrize("H,KH,S,causal", [
    (4, 4, 80, True),                   # phi-3-vision's G 1, a ragged tile
    (4, 2, 77, False),                  # bidirectional, G 2
])
def test_hd96_padded_to_two_atoms(H, KH, S, causal):
    """The wgmma route's argument at hd 96: q, k and v zero-padded to 128
    columns give, at the true hd's scale 1 / sqrt(96), the JAX oracle's
    attention in the first 96 columns (float32, within 1e-4) and zeros
    in the padding.  The control: the port's plain version on the padded
    tensors takes 1 / sqrt(128) from their width and misses."""
    q, k, v = _inputs(31 + S, 2, H, KH, S, 96)
    k, v = _expand(k, H), _expand(v, H)
    want = j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal)
    qp, kp, vp = (torch.nn.functional.pad(torch.from_numpy(a), (0, 32))
                  for a in (q, k, v))
    s = qp @ kp.transpose(-1, -2) * 96 ** -0.5
    if causal:
        s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, -1e30)
    got = torch.softmax(s, -1) @ vp
    assert got.shape == (2, H, S, 128) and (got[..., 96:] == 0).all()
    _close(got[..., :96], want)
    ctrl = flash_attention_ref(qp, kp, vp, causal)[..., :96]
    assert not np.allclose(ctrl.numpy(), np.asarray(want), atol=TOL,
                           rtol=TOL)


def test_backward_bound_at_the_training_shape():
    """The note in the backward kernel's source: five products, 171.9
    Gflop, 2.5 times the forward, and 269 MB at olmo-1b, B 4, S 2048,
    bf16: bounded by its operations (0.174 ms at 989 TFLOP/s)."""
    q = torch.empty(4, 16, 2048, 128, dtype=torch.bfloat16, device="meta")
    assert ops.flops_bwd(q) == 10 * 4 * 16 * 128 * 2048 * 2049 // 2
    assert round(ops.flops_bwd(q) / 1e9, 1) == 171.9
    assert ops.flops_bwd(q) * 2 == 5 * ops.flops(q)
    assert round(ops.flops_bwd(q) / 989e12 * 1e3, 3) == 0.174
    assert round(ops.bound_bytes_bwd(q, q) / 1e6) == 269  # 268.4 MB + lse
    assert ops.bound_bytes_bwd(q, q) / 3.35e12 < ops.flops_bwd(q) / 989e12
    assert ops.flops_bwd(q, causal=False) == 10 * 4 * 16 * 128 * 2048 ** 2


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "mma"),
    (torch.float32, 128, "f32"),
    (torch.float32, 16, "f32"),
])
def test_backward_route_by_dtype_and_hd(dtype, hd, route):
    assert ops.backward_route(dtype, hd) == route


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "f32")])
def test_backward_route_at_hd_96(dtype, route):
    """hd 96 (phi-3-vision) has a backward kernel of each kind its
    forward has: bf16 on the wgmma route (tiles padded to two 64-column
    atoms), float32 on the FMA kernels; no bf16 mma.sync instance, and
    the route is the forward's."""
    assert ops.backward_route(dtype, 96) == route
    assert ops.backward_route(dtype, 96) == ops.forward_route(dtype, 96)
    assert 96 not in ops.BWD_MMA_HEAD_DIMS


@pytest.mark.parametrize("B,H,KH,S,hd,causal", [
    (2, 4, 2, 77, 64, True),            # a ragged last tile, G = 2
    (1, 8, 2, 130, 64, True),           # G = 4, a key tile past 128
    (2, 4, 1, 100, 128, False),         # bidirectional
])
def test_tiled_backward_walk(B, H, KH, S, hd, causal):
    """The wgmma backward's walk (64-key and 64-query tiles, the G heads
    of a kv head in order, tiles above the diagonal skipped, P rebuilt
    in base 2) against autograd through the plain version and
    ``jax.grad`` of the reference's ``blockwise_attention``: at 1e-4 in
    float32; with P and dS rounded to bf16 where the kernels round them,
    at 2e-2 (absolute and relative): each rounding moves a term by up
    to 2^-9 of itself, and a gradient sums up to S such terms with
    random signs (these cases' largest error is 1.4e-2, on a dv entry
    near 9)."""
    q, k, v = _inputs(S + H, B, H, KH, S, hd)
    do = np.random.RandomState(S + 3).randn(B, H, S, hd).astype(np.float32)

    def j_loss(q, k, v):
        o = jattn.blockwise_attention(
            q, jattn._expand_kv(k, H), jattn._expand_kv(v, H), causal=causal,
            block_q=64, block_k=32)
        return jnp.sum(o * jnp.asarray(_bshd(do)))

    j_g = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(_bshd(a)) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tdo = torch.from_numpy(do)
    t_g = torch.autograd.grad(flash_attention_ref(tq, tk, tv, causal),
                              (tq, tk, tv), tdo)
    o, lse = flash_attention_fwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                     causal)
    args = (tq.detach(), tk.detach(), tv.detach(), o, lse, tdo, causal)
    exact = flash_attention_bwd_tiled_ref(*args, bf16_operands=False)
    rounded = flash_attention_bwd_tiled_ref(*args)
    for got, want, jwant in zip(exact, t_g, j_g):
        _close(got, want)
        _close(got.transpose(1, 2), jwant)
    for got, want, jwant in zip(rounded, t_g, j_g):
        _close(got, want, tol=2e-2)
        _close(got.transpose(1, 2), jwant, tol=2e-2)
        assert not torch.equal(got, want)    # the rounding is there


@pytest.mark.parametrize("B,H,KH,S,hd,causal", [
    (2, 4, 2, 77, 64, True),            # a ragged last tile, G = 2
    (1, 8, 2, 130, 64, True),           # G = 4, a key tile past 128
    (2, 4, 1, 200, 128, False),         # bidirectional
])
def test_tiled_backward_controls_lie_beyond_the_row_limit(B, H, KH, S, hd,
                                                          causal):
    """The measure the card holds the wgmma backward to against its walk
    (``row_scaled_err`` within ``BWD_ROW_TOL``) sees a fault confined to
    one late tile: the walk with the last query tile's pair with the key
    tile before it dropped, and with delta left out, lie beyond the
    limit; the walk's gradients written in bf16, as the kernels write
    them, lie within a bf16 rounding (2^-8) of it."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(S + hd, B, H, KH, S,
                                                    hd))
    do = torch.from_numpy(
        np.random.RandomState(S + 5).randn(B, H, S, hd).astype(np.float32))
    o, lse = flash_attention_fwd_ref(q, k, v, causal)
    twin = flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, causal)
    n = -(-S // TILE)
    dropped = flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, causal,
                                            drop=(n - 1, n - 2))
    no_delta = flash_attention_bwd_tiled_ref(q, k, v, torch.zeros_like(o),
                                             lse, do, causal)
    for control in (dropped, no_delta):
        assert max(row_scaled_err(a, b)
                   for a, b in zip(control, twin)) > 4 * BWD_ROW_TOL
    for a in twin:
        assert row_scaled_err(a, a) == 0.0
        assert row_scaled_err(a.to(torch.bfloat16), a) <= 2.0 ** -8


@pytest.mark.parametrize("S", [70, 200])
@pytest.mark.parametrize("KH", [4, 2])          # G 1 (phi-3-vision) and 2
@pytest.mark.parametrize("causal", [True, False])
def test_backward_at_hd96_vs_jax_grad(causal, KH, S):
    """At phi-3-vision's hd 96: the plain backward (the CPU path) and the
    wgmma kernels' walk against ``jax.grad`` of the reference's
    ``blockwise_attention``, in float32 within 1e-4; with P and dS
    rounded to bf16 the walk stays within its 2e-2
    (``test_tiled_backward_walk``)."""
    B, H, hd = 2, 4, 96
    q, k, v = _inputs(S + KH + int(causal), B, H, KH, S, hd)
    do = np.random.RandomState(S + 96).randn(B, H, S, hd).astype(np.float32)

    def j_loss(q, k, v):
        o = jattn.blockwise_attention(
            q, jattn._expand_kv(k, H), jattn._expand_kv(v, H), causal=causal,
            block_q=64, block_k=32)
        return jnp.sum(o * jnp.asarray(_bshd(do)))

    j_g = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(_bshd(a)) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(_bshd(a)).transpose(1, 2)
                  for a in (q, k, v))
    tdo = torch.from_numpy(do)
    o, lse = flash_attention_fwd_ref(tq, tk, tv, causal)
    args = (tq, tk, tv, o, lse, tdo, causal)
    exact = flash_attention_bwd_tiled_ref(*args, bf16_operands=False)
    rounded = flash_attention_bwd_tiled_ref(*args)
    for plain, walk, bf, want in zip(flash_attention_bwd_ref(*args), exact,
                                     rounded, j_g):
        for got in (plain, walk):
            _close(got.transpose(1, 2), want)
        _close(bf.transpose(1, 2), want, tol=2e-2)
