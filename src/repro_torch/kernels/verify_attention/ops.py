"""Page-grouped verify attention (K3): dispatcher between the CUDA
kernel and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/verify_attention/kernel.py::verify_attention`` (its
``pallas_call`` at ``kernel.py:173``).  The work items (page, lane,
slot) are sorted by physical page id on the device
(:func:`.schedule.build_verify_schedule`), so lanes that share a hot
prefix page are neighbours; the CUDA C++ kernel for Hopper
(``csrc/verify_attention.cu``, built for ``sm_90a`` at first use and
called through ctypes) stages each distinct live page once per kv head
and writes every item's partial softmax state to a float32 workspace,
and a second kernel merges each lane's partials in slot order.

Bound on an H100: bytes.  The least time is q and out plus the K and V
of each DISTINCT live page over 3.35 TB/s (:func:`bound_bytes`), fewer
bytes than K1's bound whenever lanes share pages.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  ``verify_attention.launches`` counts
launches (one per call: kernel A and kernel B together).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import verify_attention_ref
from .schedule import build_verify_schedule

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    from ..build import load
    fn = load("verify_attention").verify_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def workspace_numel(B: int, T: int, H: int, hd: int, maxp: int) -> int:
    """float32 elements of the partials workspace: (acc[hd], m, l) per
    (lane, slot, query head, token)."""
    return B * maxp * H * T * (hd + 2)


def verify_attention_cuda(q, k_pages, v_pages, page_table, base_lens,
                          schedule=None, workspace=None):
    """Launch the CUDA kernels on PyTorch's current stream (no sync).
    ``schedule`` is :func:`.schedule.build_verify_schedule` of these
    table, base lengths, T and page size; ``workspace`` a float32
    tensor of at least :func:`workspace_numel` elements.  Either is
    made here when not given."""
    B, T, H, hd = q.shape
    P, psz, KH, hd_k = k_pages.shape
    maxp = page_table.shape[1]
    if schedule is None:
        schedule = build_verify_schedule(page_table, base_lens, T, psz)
    if workspace is None:
        workspace = torch.empty(workspace_numel(B, T, H, hd, maxp),
                                dtype=torch.float32, device=q.device)
    tensors = (q, k_pages, v_pages, page_table, base_lens, *schedule,
               workspace)
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
    err = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), base_lens.data_ptr(),
                pages.data_ptr(), lanes.data_ptr(), slots.data_ptr(),
                workspace.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], B, T,
                H, KH, hd, psz, maxp,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verify_attention kernel launch failed: "
                           f"cudaError {err} (hd={hd}, psz={psz})")
    return out


def verify_attention(q, k_pages, v_pages, page_table, base_lens,
                     schedule=None, workspace=None):
    """q: [B, T, H, hd]; k/v_pages: [P, psz, KH, hd]; page_table: int32
    [B, maxp] (< 0 = dead); base_lens: int32 [B] lengths before the
    verify window -> [B, T, H, hd] (see :mod:`.ref`).  ``schedule`` and
    ``workspace`` let a caller that attends several layers over one
    table build them once (see :func:`verify_attention_cuda`); the
    plain version needs neither."""
    if q.device.type == "cpu":
        return verify_attention_ref(q, k_pages, v_pages, page_table,
                                    base_lens)
    out = verify_attention_cuda(q, k_pages, v_pages, page_table, base_lens,
                                schedule, workspace)
    verify_attention.launches += 1
    return out


verify_attention.launches = 0


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
