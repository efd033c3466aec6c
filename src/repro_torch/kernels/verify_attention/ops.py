"""Page-grouped verify attention (K3): dispatcher between the CUDA
kernel and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/verify_attention/kernel.py::verify_attention`` (its
``pallas_call`` at ``kernel.py:173``).  The work items (page, lane,
slot) are sorted by physical page id on the device
(:func:`.schedule.build_verify_schedule`), so lanes that share a hot
prefix page are neighbours.  Two CUDA C++ routes for Hopper (built for
``sm_90a`` at first use and called through ctypes), chosen by
:func:`verify_route`, each a partials kernel that reads each distinct
live page once per kv head and writes every item's partial softmax
state to a float32 workspace, then a merge of each lane's partials in
slot order:

- ``"wgmma"`` (``csrc/verify_attention_wgmma.cu``), bf16 at hd 64 and
  128 with pages of 64 tokens: the runs of equal pages are cut into
  64-row units on the device (:func:`.schedule.build_verify_units`),
  each a warpgroup's ``wgmma`` products over a page loaded by TMA, so a
  hot page's rows spread over many warpgroups, and the merge keeps every
  row's partials in flight at once;
- ``"fma"`` (``csrc/verify_attention.cu``), every other shape: one
  block per run, scalar float FMAs.

Bound on an H100: bytes.  The least time is q and out plus the K and V
of each DISTINCT live page over 3.35 TB/s (:func:`bound_bytes`), fewer
bytes than K1's bound whenever lanes share pages.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernels of its route or raises (nothing falls back from
one route to the other).  ``verify_attention.launches`` counts launches
(one per call: the partials and the merge together),
``verify_attention.routes`` the same by route and
``verify_attention.widths`` by lane width T.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..paged_attention.ops import WGMMA_HEAD_DIMS, check_wgmma, chunk_route
from .ref import verify_attention_ref
from .schedule import build_verify_schedule, build_verify_units, \
    units_capacity

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def verify_route(dtype, hd: int, psz: int, T: int, G: int) -> str:
    """K3's route for these inputs: K1's rule (:func:`..paged_attention.
    ops.chunk_route`), ``"wgmma"`` for bf16 at hd 64 or 128 with pages
    of 64, at every T and G, else ``"fma"``; hd 96, which K1's wgmma
    route takes, is outside K3's :data:`..paged_attention.ops.
    WGMMA_HEAD_DIMS` and takes ``"fma"``."""
    if hd not in WGMMA_HEAD_DIMS:
        return "fma"
    return chunk_route(dtype, hd, psz, T, G)


@functools.cache
def _fn():
    from ..build import load
    fn = load("verify_attention").verify_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _wgmma_fn():
    from ..build import load
    fn = load("verify_attention_wgmma").verify_attention_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return fn


def workspace_numel(B: int, T: int, H: int, hd: int, maxp: int) -> int:
    """float32 elements of the partials workspace: (acc[hd], m, l) per
    (lane, slot, query head, token)."""
    return B * maxp * H * T * (hd + 2)


def verify_attention_cuda(q, k_pages, v_pages, page_table, base_lens,
                          schedule=None, workspace=None, units=None,
                          route=None):
    """Launch the kernels of ``route`` (by default :func:`verify_route`
    of these inputs) on PyTorch's current stream (no sync).
    ``schedule`` is :func:`.schedule.build_verify_schedule` of these
    table, base lengths, T and page size; ``workspace`` a float32
    tensor of at least :func:`workspace_numel` elements; ``units`` (the
    wgmma route's) :func:`.schedule.build_verify_units` of that
    schedule, T and G.  Each is made here when not given."""
    B, T, H, hd = q.shape
    P, psz, KH, hd_k = k_pages.shape
    maxp = page_table.shape[1]
    G = H // max(KH, 1)
    if route is None:
        route = verify_route(q.dtype, hd, psz, T, G)
    if route == "wgmma":
        check_wgmma("verify_attention", q, k_pages, v_pages)
    elif route != "fma":
        raise ValueError(f"verify_attention: no route {route!r}")
    if schedule is None:
        schedule = build_verify_schedule(page_table, base_lens, T, psz)
    if workspace is None:
        workspace = torch.empty(workspace_numel(B, T, H, hd, maxp),
                                dtype=torch.float32, device=q.device)
    extra = ()
    if route == "wgmma":
        if units is None:
            units = build_verify_units(schedule[0], T, G)
        if (units.dtype != torch.int32 or units.shape
                != (units_capacity(B * maxp, T, G), 3)):
            raise ValueError(f"verify_attention: units must be int32 "
                             f"[{units_capacity(B * maxp, T, G)}, 3], got "
                             f"{units.dtype} {tuple(units.shape)}")
        if workspace.data_ptr() % 16:
            raise ValueError("verify_attention: the wgmma route's merge "
                             "reads the workspace in 16-byte loads")
        extra = (units,)
    tensors = (q, k_pages, v_pages, page_table, base_lens, *schedule,
               workspace, *extra)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("verify_attention: all inputs on one CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"verify_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (page_table, base_lens,
                                            *schedule)):
        raise TypeError("verify_attention: table, base lengths and "
                        "schedule must be int32")
    if workspace.dtype != torch.float32 \
            or workspace.numel() < workspace_numel(B, T, H, hd, maxp):
        raise ValueError("verify_attention: workspace too small or not "
                         "float32")
    if (v_pages.shape != k_pages.shape or hd_k != hd or H % KH
            or page_table.shape != (B, maxp) or base_lens.shape != (B,)
            or any(s.shape != (B * maxp,) for s in schedule)
            or hd > 256 or B == 0 or T == 0):
        raise ValueError(f"verify_attention: bad shapes q {q.shape} pages "
                         f"{k_pages.shape} table {page_table.shape} base "
                         f"{base_lens.shape}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("verify_attention: inputs must be contiguous")
    pages, lanes, slots = schedule
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), base_lens.data_ptr(), pages.data_ptr(),
            lanes.data_ptr(), slots.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "wgmma":
        err = _wgmma_fn()(*ptrs, units.data_ptr(), workspace.data_ptr(),
                          out.data_ptr(), units.shape[0], B, T, H, KH, hd,
                          psz, maxp, P, stream)
    else:
        err = _fn()(*ptrs, workspace.data_ptr(), out.data_ptr(),
                    _DTYPES[q.dtype], B, T, H, KH, hd, psz, maxp, stream)
    if err != 0:
        raise RuntimeError(f"verify_attention kernel ({route}) launch "
                           f"failed: cudaError {err} (hd={hd}, psz={psz})")
    return out


def verify_attention(q, k_pages, v_pages, page_table, base_lens,
                     schedule=None, workspace=None, units=None):
    """q: [B, T, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (< 0 = dead); base_lens: int32 [B] lengths before the
    verify window -> [B, T, H, hd] (see :mod:`.ref`).  ``schedule``,
    ``workspace`` and ``units`` let a caller that attends several
    layers over one table build them once (see
    :func:`verify_attention_cuda`); the plain version needs none."""
    if q.device.type == "cpu":
        return verify_attention_ref(q, k_pages, v_pages, page_table,
                                    base_lens)
    B, T, H, hd = q.shape
    route = verify_route(q.dtype, hd, k_pages.shape[1], T,
                         H // max(k_pages.shape[2], 1))
    out = verify_attention_cuda(q, k_pages, v_pages, page_table, base_lens,
                                schedule, workspace, units, route)
    verify_attention.launches += 1
    verify_attention.routes[route] += 1
    verify_attention.widths[T] += 1
    return out


verify_attention.launches = 0
verify_attention.routes = {"wgmma": 0, "fma": 0}
verify_attention.widths = collections.Counter()


def bound_bytes(q, k_pages, page_table, base_lens) -> int:
    """Bytes the function must move for these inputs: q read and out
    written once, and the K and V of every DISTINCT live page each read
    once (live: resident and inside some lane's causal window), however
    many lanes map it.  Reads the table on the host: for measurement,
    not the serving path."""
    B, T, H, hd = q.shape
    P, psz, KH, _ = k_pages.shape
    pages, _, _ = build_verify_schedule(page_table.cpu(), base_lens.cpu(),
                                        T, psz)
    distinct = int(torch.unique(pages[pages >= 0]).numel())
    page_bytes = psz * KH * hd * k_pages.element_size()
    return 2 * q.numel() * q.element_size() + 2 * distinct * page_bytes
