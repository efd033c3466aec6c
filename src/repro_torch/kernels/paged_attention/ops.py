"""Paged chunk attention (K1): dispatcher between the CUDA kernel and
its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/paged_attention/kernel.py::paged_attention_chunk`` (its
``pallas_call`` at ``kernel.py:171``).  The CUDA C++ kernel for Hopper
(``csrc/paged_attention.cu``, built for ``sm_90a`` at first use and
called through ctypes) runs one thread block per (kv head, sequence),
walks only the sequence's live pages, stages each K/V page in shared
memory and keeps the online-softmax state in float registers.

Bound on an H100: bytes.  The least time is the bytes of the live K/V
pages plus q and out over 3.35 TB/s (:func:`bound_bytes`).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  ``paged_attention_chunk.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import paged_attention_chunk_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    from ..build import load
    fn = load("paged_attention").paged_attention_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def paged_attention_chunk_cuda(q, k_pages, v_pages, page_table, base_lens):
    """Launch the CUDA kernel on PyTorch's current stream (no sync)."""
    B, T, H, hd = q.shape
    P, psz, KH, hd_k = k_pages.shape
    maxp = page_table.shape[1]
    tensors = (q, k_pages, v_pages, page_table, base_lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_chunk: all inputs on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention_chunk: q/k/v must share float32 "
                        f"or bfloat16, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or base_lens.dtype != torch.int32:
        raise TypeError("paged_attention_chunk: page_table and base_lens "
                        "must be int32")
    if (v_pages.shape != k_pages.shape or hd_k != hd or H % KH
            or page_table.shape != (B, maxp) or base_lens.shape != (B,)
            or hd > 256 or B == 0 or T == 0):
        raise ValueError(f"paged_attention_chunk: bad shapes q {q.shape} "
                         f"pages {k_pages.shape} table {page_table.shape} "
                         f"base {base_lens.shape}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_chunk: inputs must be contiguous")
    out = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), base_lens.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, T, H, KH, hd, psz, maxp,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_chunk kernel launch failed: "
                           f"cudaError {err} (hd={hd}, psz={psz})")
    return out


def paged_attention_chunk(q, k_pages, v_pages, page_table, base_lens):
    """q: [B, T, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (< 0 = dead); base_lens: int32 [B] lengths before the
    chunk -> [B, T, H, hd] (see :func:`.ref.paged_attention_chunk_ref`).
    """
    if q.device.type == "cpu":
        return paged_attention_chunk_ref(q, k_pages, v_pages, page_table,
                                         base_lens)
    out = paged_attention_chunk_cuda(q, k_pages, v_pages, page_table,
                                     base_lens)
    paged_attention_chunk.launches += 1
    return out


paged_attention_chunk.launches = 0


def bound_bytes(q, k_pages, page_table, base_lens) -> int:
    """Bytes the function must move for these inputs: q read and out
    written once, and the K and V of every live page each read once
    (the pages a query of the chunk can see, resident ones only).
    Reads the table on the host: for measurement, not the serving path.
    """
    B, T, H, hd = q.shape
    P, psz, KH, _ = k_pages.shape
    maxp = page_table.shape[1]
    table = page_table.cpu()
    n_live = ((base_lens.cpu().long() + T + psz - 1) // psz).clamp(max=maxp)
    live = (torch.arange(maxp)[None] < n_live[:, None]) & (table >= 0)
    page_bytes = psz * KH * hd * k_pages.element_size()
    return (2 * q.numel() * q.element_size()
            + 2 * int(live.sum()) * page_bytes)
