"""Paged attention: dispatchers between the CUDA kernels and their
plain PyTorch versions.

* K1, :func:`paged_attention_chunk`, replaces the JAX package's Pallas
  TPU kernel ``kernels/paged_attention/kernel.py::paged_attention_chunk``
  (its ``pallas_call`` at ``kernel.py:171``).  Two CUDA C++ kernels for
  Hopper, chosen by :func:`chunk_route`:

  - ``"wgmma"`` (``csrc/paged_attention_wgmma.cu``), bf16 at hd 64, 96
    and 128 (:data:`CHUNK_WGMMA_HEAD_DIMS`) with pages of 64 tokens, the
    serving path of olmo-1b, llama3.2-1b, gemma3-27b and phi-3-vision: a
    producer warp keeps a ring of K/V page stages full by TMA, two
    consumer warpgroups run QK^T and PV on ``wgmma`` over 64-row query
    tiles and, when one tile holds all of a lane's rows, split its pages
    between them; hd 96 over tiles padded to two 64-column swizzle
    atoms, the padding zeros from TMA;
  - ``"fma"`` (``csrc/paged_attention.cu``), every other shape (float32,
    hd 16, pages of 8: the smoke configs; hd 96 by an explicit route
    only): one block per (kv head, sequence), each K/V page staged in
    shared memory as float, scalar float FMAs.
* K2, :func:`paged_attention`, single-token decode, replaces
  ``kernel.py::paged_attention`` (its ``pallas_call`` at
  ``kernel.py:227``).  Two CUDA C++ kernels, chosen by
  :func:`decode_route`:

  - ``"tma"`` (``csrc/paged_decode_tma.cu``), bf16 at hd 64, 96 and
    128 (:data:`DECODE_TMA_HEAD_DIMS`) with pages of 64 tokens and G of
    1, 2, 3, 4, 5 or 8, the decode-only steps of olmo-1b, llama3.2-1b,
    gemma3-27b, phi-3-vision, phi4-mini-3.8b (G 3) and llama4-maverick
    (G 5): each lane's pages
    cut into splits of :data:`PAGES_PER_SPLIT` (:func:`.ref.decode_splits`),
    a block per (kv head, lane, split) fed by TMA from a producer warp,
    then a merge of each lane's splits in split order; hd 96 over tiles
    padded to two 64-column atoms, the padding zeros from TMA;
  - ``"fma"`` (``csrc/paged_decode.cu``), every other shape (float32,
    hd 16, pages of 8, a G outside :data:`TMA_GROUPS`; hd 96 in bf16 by
    an explicit route only): one block per (kv head, sequence) whose
    warps take the live pages' keys in units of 32, each warp its own
    online softmax, merged at the end.

All kernels are built for ``sm_90a`` at first use and called through
ctypes.  Bound on an H100: bytes.  The least time is the bytes of the
live K/V pages plus q and out over 3.35 TB/s (:func:`bound_bytes`,
:func:`decode_bound_bytes`).  The TMA routes encode their tensor maps
on every call (their host time a call: PERF.md §6).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel of its route or raises (nothing falls back from one
route to the other).  ``paged_attention_chunk.launches`` and
``paged_attention.launches`` count kernel launches (K2's split kernel
and merge together as one), ``paged_attention_chunk.routes`` and
``paged_attention.routes`` the same by route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import paged_attention_chunk_ref, paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of K3's wgmma route, and the page size of every Hopper
#: route of K1, K2 and K3 (bf16)
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_PAGE = 64
#: head dims of K1's wgmma/TMA route: hd 96 runs over tiles padded to 128
CHUNK_WGMMA_HEAD_DIMS = (64, 96, 128)
#: head dims of K2's tma route: hd 96 runs over tiles padded to 128
DECODE_TMA_HEAD_DIMS = (64, 96, 128)


def chunk_route(dtype, hd: int, psz: int, T: int, G: int) -> str:
    """K1's kernel for q of ``dtype`` with head dim ``hd``, pages of
    ``psz`` tokens, ``T`` tokens a lane and ``G`` query heads a kv head:
    ``"wgmma"`` for bf16 at hd 64, 96 or 128 with pages of 64, at every
    T and G, else ``"fma"``.  No width goes to ``"fma"``: on an H100 the
    wgmma kernel is the faster one at T = 1 too, where one query row
    fills a 64-row tile (``chip_smoke.py`` phase 6, PERF.md)."""
    del T, G
    if (dtype == torch.bfloat16 and hd in CHUNK_WGMMA_HEAD_DIMS
            and psz == WGMMA_PAGE):
        return "wgmma"
    return "fma"


def check_wgmma(name, q, k_pages, v_pages, head_dims=WGMMA_HEAD_DIMS):
    """Raise on what the wgmma/TMA kernels of K1, K2 and K3 do not take:
    they read bf16 pages of 64 tokens at ``head_dims`` (K1 takes
    :data:`CHUNK_WGMMA_HEAD_DIMS`, K2 :data:`DECODE_TMA_HEAD_DIMS`)
    through TMA tensor maps, and q rows with 16-byte copies."""
    if not all(t.dtype == torch.bfloat16 for t in (q, k_pages, v_pages)):
        raise TypeError(f"{name}: the wgmma route takes bfloat16 only, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if (q.shape[-1] not in head_dims or k_pages.dim() != 4
            or k_pages.shape[1] != WGMMA_PAGE):
        raise ValueError(f"{name}: the wgmma route takes hd in "
                         f"{head_dims} and pages of {WGMMA_PAGE} "
                         f"tokens, got q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError(f"{name}: the wgmma route needs q and the pools "
                         f"on 16-byte boundaries")


@functools.cache
def _fn():
    from ..build import load
    fn = load("paged_attention").paged_attention_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _wgmma_fn():
    from ..build import load
    fn = load("paged_attention_wgmma").paged_attention_chunk_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def paged_attention_chunk_cuda(q, k_pages, v_pages, page_table, base_lens,
                               route=None):
    """Launch the kernel of ``route`` (by default :func:`chunk_route` of
    these inputs) on PyTorch's current stream (no sync)."""
    B, T, H, hd = q.shape
    P, psz, KH, hd_k = k_pages.shape
    maxp = page_table.shape[1]
    if route is None:
        route = chunk_route(q.dtype, hd, psz, T, H // max(KH, 1))
    if route == "wgmma":
        check_wgmma("paged_attention_chunk", q, k_pages, v_pages,
                    CHUNK_WGMMA_HEAD_DIMS)
    elif route != "fma":
        raise ValueError(f"paged_attention_chunk: no route {route!r}")
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
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), base_lens.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        err = _wgmma_fn()(*ptrs, B, T, H, KH, hd, psz, maxp, P, stream)
    else:
        err = _fn()(*ptrs, _DTYPES[q.dtype], B, T, H, KH, hd, psz, maxp,
                    stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_chunk kernel ({route}) launch "
                           f"failed: cudaError {err} (hd={hd}, psz={psz})")
    return out


def paged_attention_chunk(q, k_pages, v_pages, page_table, base_lens):
    """q: [B, T, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (< 0 = dead); base_lens: int32 [B] lengths before the
    chunk -> [B, T, H, hd] (see :func:`.ref.paged_attention_chunk_ref`).
    """
    if q.device.type == "cpu":
        return paged_attention_chunk_ref(q, k_pages, v_pages, page_table,
                                         base_lens)
    route = chunk_route(q.dtype, q.shape[-1], k_pages.shape[1], q.shape[1],
                        q.shape[2] // max(k_pages.shape[2], 1))
    out = paged_attention_chunk_cuda(q, k_pages, v_pages, page_table,
                                     base_lens, route)
    paged_attention_chunk.launches += 1
    paged_attention_chunk.routes[route] += 1
    return out


paged_attention_chunk.launches = 0
paged_attention_chunk.routes = {"wgmma": 0, "fma": 0}


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


# ---------------------------------------------------------------- K2

#: pages of a lane that one block of K2's TMA route reads: at phase 15's
#: contexts (96-1,087 tokens, 2-17 pages) olmo-1b's 16 kv heads x 8
#: lanes then give about three blocks with bytes an SM, and the route
#: its least time of splits of 1, 2, 4 and 8 pages (chip_smoke.py phase
#: 15; PERF.md)
PAGES_PER_SPLIT = 4
#: G = H / KH that K2's TMA route takes
TMA_GROUPS = (1, 2, 3, 4, 5, 8)


def decode_route(dtype, hd: int, psz: int, G: int) -> str:
    """K2's kernel for q of ``dtype`` with head dim ``hd``, pages of
    ``psz`` tokens and ``G`` query heads a kv head: ``"tma"`` for bf16
    at hd 64, 96 or 128 with pages of 64 and G in :data:`TMA_GROUPS`,
    else ``"fma"``."""
    if (dtype == torch.bfloat16 and hd in DECODE_TMA_HEAD_DIMS
            and psz == WGMMA_PAGE and G in TMA_GROUPS):
        return "tma"
    return "fma"


def decode_workspace_numel(B: int, H: int, hd: int, maxp: int,
                           pages_per_split: int = PAGES_PER_SPLIT) -> int:
    """Floats of the TMA route's workspace: every (lane, head, split)'s
    partial acc [hd], m and l."""
    return B * H * -(-maxp // pages_per_split) * (hd + 2)


@functools.cache
def _decode_tma_fn():
    from ..build import load
    fn = load("paged_decode_tma").paged_decode_tma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _decode_fn():
    from ..build import load
    fn = load("paged_decode").paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def paged_attention_cuda(q, k_pages, v_pages, page_table, seq_lens,
                         zero_empty: bool = False, route=None,
                         pages_per_split: int = PAGES_PER_SPLIT):
    """Launch K2's kernel of ``route`` (by default :func:`decode_route`
    of these inputs) on PyTorch's current stream (no sync)."""
    B, H, hd = q.shape
    P, psz, KH, hd_k = k_pages.shape
    maxp = page_table.shape[1]
    if route is None:
        route = decode_route(q.dtype, hd, psz, H // max(KH, 1))
    if route == "tma":
        check_wgmma("paged_attention", q, k_pages, v_pages,
                    DECODE_TMA_HEAD_DIMS)
        if H % KH or H // KH not in TMA_GROUPS:
            raise ValueError(f"paged_attention: the tma route takes G in "
                             f"{TMA_GROUPS}, got H {H} KH {KH}")
    elif route != "fma":
        raise ValueError(f"paged_attention: no route {route!r}")
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention: all inputs on one CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and seq_lens must be "
                        "int32")
    if (v_pages.shape != k_pages.shape or hd_k != hd or H % KH
            or page_table.shape != (B, maxp) or seq_lens.shape != (B,)
            or hd > 256 or B == 0 or maxp == 0):
        raise ValueError(f"paged_attention: bad shapes q {q.shape} pages "
                         f"{k_pages.shape} table {page_table.shape} "
                         f"seq_lens {seq_lens.shape}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tma":
        work = torch.empty(decode_workspace_numel(B, H, hd, maxp,
                                                  pages_per_split),
                           dtype=torch.float32, device=q.device)
        err = _decode_tma_fn()(*ptrs, work.data_ptr(), B, H, KH, hd, psz,
                               maxp, P, pages_per_split,
                               int(bool(zero_empty)), stream)
    else:
        err = _decode_fn()(*ptrs, _DTYPES[q.dtype], B, H, KH, hd, psz, maxp,
                           int(bool(zero_empty)), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel ({route}) launch "
                           f"failed: cudaError {err} (hd={hd}, H={H}, "
                           f"KH={KH})")
    return out


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    zero_empty: bool = False):
    """q: [B, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (< 0 = dead); seq_lens: int32 [B] -> [B, H, hd] (see
    :func:`.ref.paged_attention_ref`; ``zero_empty`` gives rows without
    a valid key zeros instead of the uniform mean)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table,
                                   seq_lens, zero_empty=zero_empty)
    route = decode_route(q.dtype, q.shape[-1], k_pages.shape[1],
                         q.shape[1] // max(k_pages.shape[2], 1))
    out = paged_attention_cuda(q, k_pages, v_pages, page_table, seq_lens,
                               zero_empty, route)
    paged_attention.launches += 1
    paged_attention.routes[route] += 1
    return out


paged_attention.launches = 0
paged_attention.routes = {"tma": 0, "fma": 0}


def decode_bound_bytes(q, k_pages, page_table, seq_lens) -> int:
    """K2's bytes for these inputs: those of K1 at T = 1 over
    ``seq_lens - 1`` (q read and out written once, the K and V of every
    page that holds a valid key read once)."""
    return bound_bytes(q[:, None], k_pages, page_table, seq_lens - 1)
