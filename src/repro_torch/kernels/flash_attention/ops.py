"""Causal flash attention (K6): dispatcher between the CUDA kernels and
their plain PyTorch versions, with a gradient.

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention/kernel.py::flash_attention`` (its
``pallas_call`` at ``kernel.py:80``).  The CUDA C++ kernels for Hopper
are built for ``sm_90a`` at first use and called through ctypes.

The forward (``csrc/flash_attention.cu``) has three kernels, chosen by
dtype and hd (:func:`forward_route`):

- ``"wgmma"``, bf16 at hd 64 and 128 (the training path): 128 query
  rows a block in two consumer warpgroups and a producer warp that
  keeps a ring of K/V stages full with TMA; QK^T and PV on ``wgmma``;
- ``"mma"``, bf16 at hd 16: 64 rows a block on ``mma.sync``;
- ``"f32"``, float32 at any of :data:`HEAD_DIMS`: plain float32 FMAs.

Each walks the K/V tiles up to the diagonal with an online softmax and
writes the output and the float32 log-sum-exp.  The backward
(``csrc/flash_attention_bwd.cu``) is three kernels a call: delta =
rowsum(dO * O), then dK/dV per key tile and dQ per query tile
(FlashAttention-2's split, no atomics, so two calls agree bit for bit),
on ``mma.sync`` in bf16 and float32 FMAs in float32.  The JAX package
has no backward kernel (it differentiates the jnp
``blockwise_attention``); the backward computes that gradient.

Bounds on an H100 at the training shape (B 4, H 16, S 2048, hd 128,
causal, bf16): operations, 68.75 Gflop forward (about 0.0695 ms at 989
TFLOP/s) and 171.9 Gflop backward (0.174 ms) (:func:`flops`,
:func:`bound_bytes`, :func:`flops_bwd`, :func:`bound_bytes_bwd`).

:func:`flash_attention` is a ``torch.autograd.Function``.  On a CUDA
tensor its forward and backward launch their kernels or raise; on a
CPU tensor they run the plain versions in :mod:`.ref`.
``flash_attention.launches`` counts forward launches (the recomputation
of a checkpointed forward included) and ``flash_attention.routes`` the
same by kernel; ``flash_attention_bwd.launches`` counts backward calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)
#: head dims of the wgmma/TMA forward (bf16)
WGMMA_HEAD_DIMS = (64, 128)


def forward_route(dtype, hd: int) -> str:
    """The forward's kernel for (dtype, hd): ``"wgmma"`` for bf16 at hd
    64 or 128, ``"mma"`` for bf16 at hd 16, ``"f32"`` for float32."""
    if dtype == torch.bfloat16:
        return "wgmma" if hd in WGMMA_HEAD_DIMS else "mma"
    return "f32"


@functools.cache
def _lib():
    from ..build import load
    lib = load("flash_attention")
    for fn, n_ints in ((lib.flash_attention_fwd, 7),
                       (lib.flash_attention_fwd_wgmma, 6)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
    return lib


@functools.cache
def _bwd_fn():
    from ..build import load
    fn = load("flash_attention_bwd").flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


def _rows_aligned(t) -> bool:
    """Rows that 16-byte copies (TMA, cp.async) can read: the base and
    the (b, h, s) strides on 16-byte boundaries."""
    n = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % n == 0 for s in t.stride()[:3])


def _check(name, q, k, v):
    """The checks every K6 kernel makes of q [B, H, S, hd] and k, v [B,
    KH, S, hd]."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if (k.shape != (B, KH, S, hd) or v.shape != k.shape or KH == 0
            or H % KH or hd not in HEAD_DIMS or 0 in q.shape
            or B * H > 65535):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} (hd in "
                         f"{HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the last dim of q, k, v must be "
                         f"contiguous")


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch the forward kernel of :func:`forward_route` on PyTorch's
    current stream (no sync).  q: [B, H, S, hd], k, v: [B, KH, S, hd],
    any strides with the last dim contiguous (for ``"wgmma"``, rows on
    16-byte boundaries).  Returns (o like q, lse float32 [B, H, S])."""
    _check("flash_attention", q, k, v)
    B, H, S, hd = q.shape
    KH = k.shape[1]
    route = forward_route(q.dtype, hd)
    if route == "wgmma" and not all(map(_rows_aligned, (q, k, v))):
        raise ValueError("flash_attention: the wgmma kernel's tensor maps "
                         "need q, k, v rows on 16-byte boundaries")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), ctypes.addressof(strides))
    tail = (B, H, KH, S, hd, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if route == "wgmma":
        err = _lib().flash_attention_fwd_wgmma(*args, *tail)
    else:
        err = _lib().flash_attention_fwd(*args, _DTYPES[q.dtype], *tail)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({route}) launch "
                           f"failed: cudaError {err} (hd={hd}, S={S})")
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True):
    """Launch the backward kernels on PyTorch's current stream (no
    sync): (dq, dk, dv) like (q, k, v), from the forward's o and lse
    and the output's gradient do."""
    _check("flash_attention_bwd", q, k, v)
    B, H, S, hd = q.shape
    KH = k.shape[1]
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or lse.shape != (B, H, S)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: o, do like q; lse float32 "
                         "[B, H, S], contiguous")
    if not all(t.is_cuda and t.device == q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: every input on q's device")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and not all(map(_rows_aligned, (q, k, v, o))):
        raise ValueError("flash_attention_bwd: bf16 rows must lie on "
                         "16-byte boundaries")
    if do.stride(-1) != 1 or (bf16 and not _rows_aligned(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                                      for s in t.stride()[:3]))
    err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    ctypes.addressof(strides), _DTYPES[q.dtype], B, H, KH,
                    S, hd, int(causal),
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err} (hd={hd}, S={S})")
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = True):
    """(o, lse): the kernel on a CUDA tensor (counted), the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal)
    out = flash_attention_cuda(q, k, v, causal)
    flash_attention.launches += 1
    flash_attention.routes[forward_route(q.dtype, q.shape[-1])] += 1
    return out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv): the backward kernels on a CUDA tensor (counted
    once a call), the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    out = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    flash_attention_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention(q, k, v, causal: bool = True):
    """q: [B, H, S, hd]; k, v: [B, KH, S, hd] (H a multiple of KH) ->
    o [B, H, S, hd] in q's dtype (see :mod:`.ref`), differentiable."""
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention.routes = {"wgmma": 0, "mma": 0, "f32": 0}


def _pairs(S: int, causal: bool) -> int:
    """(query, key) pairs the mask lets through."""
    return S * (S + 1) // 2 if causal else S * S


def flops(q, causal: bool = True) -> int:
    """Operations of QK^T and PV: 4 B H hd times the visible pairs."""
    B, H, S, hd = q.shape
    return 4 * B * H * hd * _pairs(S, causal)


def bound_bytes(q, k) -> int:
    """Bytes the forward must move: q, k, v read and o written once,
    and the float32 log-sum-exp written."""
    B, H, S, _ = q.shape
    return (2 * q.numel() * q.element_size()
            + 2 * k.numel() * k.element_size() + 4 * B * H * S)


def flops_bwd(q, causal: bool = True) -> int:
    """Operations of the backward's five products (QK^T, dO V^T, P^T dO,
    dS^T Q, dS K): 10 B H hd times the visible pairs, 2.5 times the
    forward; the recomputation of P in the dQ pass is not counted."""
    B, H, S, hd = q.shape
    return 10 * B * H * hd * _pairs(S, causal)


def bound_bytes_bwd(q, k) -> int:
    """Bytes the backward must move: q, o, do read and dq written; k, v
    read and dk, dv written; the float32 log-sum-exp read."""
    B, H, S, _ = q.shape
    return (4 * q.numel() * q.element_size()
            + 4 * k.numel() * k.element_size() + 4 * B * H * S)
