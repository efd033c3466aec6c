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
from repro_torch.kernels.flash_attention.ref import (attention_delta_ref,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref,
                                                     flash_attention_ref)
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
    (torch.float32, 128, "f32"),
    (torch.float32, 16, "f32"),
])
def test_forward_route_by_dtype_and_hd(dtype, hd, route):
    assert ops.forward_route(dtype, hd) == route
    assert hd in ops.HEAD_DIMS


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
