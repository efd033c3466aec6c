"""Causal flash attention (K6): dispatcher between the CUDA kernel and
its plain PyTorch version, with a gradient.

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention/kernel.py::flash_attention`` (its
``pallas_call`` at ``kernel.py:80``).  The CUDA C++ kernel for Hopper
(``csrc/flash_attention.cu``, built for ``sm_90a`` at first use and
called through ctypes) runs one block per (batch, head, 64-row query
tile), walks the K/V tiles up to the diagonal with an online softmax,
runs QK^T and PV on ``mma.sync`` in bf16 (plain float32 FMAs in
float32), and writes the output and the float32 log-sum-exp.

Bound on an H100 at the training shape (B 4, H 16, S 2048, hd 128,
causal, bf16): operations, 68.75 Gflop, about 0.0695 ms at 989 TFLOP/s
(:func:`flops`, :func:`bound_bytes`).

:func:`flash_attention` is a ``torch.autograd.Function``.  Its forward
is the kernel on a CUDA tensor and the plain version on a CPU tensor;
on a CUDA tensor it launches the kernel or raises.  The JAX package has
no backward kernel (it differentiates the jnp ``blockwise_attention``),
and neither has the port yet: the backward is :func:`flash_attention_bwd`
in torch ops, the same code on the CPU and on the card.
``flash_attention.launches`` counts kernel launches, the recomputation
of a checkpointed forward included.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import flash_attention_fwd_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)
#: query rows a step of the backward (its float32 score block is
#: B x H x 256 x S)
BWD_BLOCK = 256


@functools.cache
def _fn():
    from ..build import load
    fn = load("flash_attention").flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


def flash_attention_cuda(q, k, v, causal: bool = True):
    """Launch the CUDA kernel on PyTorch's current stream (no sync).
    q: [B, H, S, hd], k, v: [B, KH, S, hd], any strides with the last
    dim contiguous.  Returns (o like q, lse float32 [B, H, S])."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if (k.shape != (B, KH, S, hd) or v.shape != k.shape or KH == 0
            or H % KH or hd not in HEAD_DIMS or 0 in q.shape
            or B * H > 65535):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} (hd in "
                         f"{HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim of q, k, v must be "
                         "contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), ctypes.addressof(strides), _DTYPES[q.dtype],
                B, H, KH, S, hd, int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err} (hd={hd}, S={S})")
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = True):
    """(o, lse): the kernel on a CUDA tensor (counted), the plain
    version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal)
    out = flash_attention_cuda(q, k, v, causal)
    flash_attention.launches += 1
    return out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """Gradients (dq, dk, dv) of :func:`flash_attention` in torch ops,
    float32 inside, one ``BWD_BLOCK``-row query block at a time, from the
    forward's output and log-sum-exp; never holds a [B, H, S, S]
    tensor.  dk and dv sum over the G query heads of each kv head."""
    B, H, S, hd = q.shape
    KH = k.shape[1]
    grp = (KH, H // KH)
    scale = 1.0 / hd ** 0.5
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    delta = (do.float() * o.float()).sum(-1).unflatten(1, grp)
    lse = lse.unflatten(1, grp)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i0 in range(0, S, BWD_BLOCK):
        i1 = min(S, i0 + BWD_BLOCK)
        n = i1 if causal else S                      # keys any row can see
        qb = q[:, :, i0:i1].float().unflatten(1, grp)     # [B, KH, G, bq, hd]
        dob = do[:, :, i0:i1].float().unflatten(1, grp)
        kb, vb = kf[..., :n, :], vf[..., :n, :]
        s = qb @ kb.transpose(-1, -2) * scale
        if causal:
            qpos = torch.arange(i0, i1, device=q.device)[:, None]
            seen = torch.arange(n, device=q.device)[None] <= qpos
            s = torch.where(seen, s, -torch.inf)
        p = torch.exp(s - lse[..., i0:i1, None])
        dv[:, :, :n] += (p.transpose(-1, -2) @ dob).sum(2)
        ds = p * (dob @ vb.transpose(-1, -2) - delta[..., i0:i1, None])
        dq[:, :, i0:i1] = (ds @ kb).flatten(1, 2) * scale
        dk[:, :, :n] += (ds.transpose(-1, -2) @ qb).sum(2) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def flops(q, causal: bool = True) -> int:
    """Operations of QK^T and PV: 4 B H hd times the (query, key) pairs
    the mask lets through."""
    B, H, S, hd = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * hd * pairs


def bound_bytes(q, k) -> int:
    """Bytes the function must move: q, k, v read and o written once,
    and the float32 log-sum-exp written."""
    B, H, S, _ = q.shape
    return (2 * q.numel() * q.element_size()
            + 2 * k.numel() * k.element_size() + 4 * B * H * S)
