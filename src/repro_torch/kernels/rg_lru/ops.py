"""RG-LRU linear recurrence (K5): dispatcher between the CUDA kernel
and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/rg_lru/kernel.py::rg_lru`` (its ``pallas_call`` at
``kernel.py:67``).  Two CUDA C++ kernels for Hopper, built for
``sm_90a`` at first use and called through ctypes, chosen by
:func:`lru_route`; both run each channel's recurrence in token order
with the product and the sum rounded apart, so both are bit-equal to
the plain version:

- ``"tma"`` (``csrc/rg_lru_tma.cu``), d a multiple of 4 at S >=
  :data:`LRU_TMA_MIN_S` tokens (recurrentgemma-2b's prefill chunks): one
  block per (sequence, 64 channels), the [8 tokens, 64 channels] boxes
  of a and b brought into a ring of eight stages by TMA, so a chunk of
  64 tokens is in flight at once;
- ``"seq"`` (``csrc/rg_lru.cu``), the rest (a decode step, T = 1): one
  thread per (sequence, channel) with a loop over the tokens, coalesced
  along the channels, any S and d.

Bound on an H100: bytes (:func:`bound_bytes` over 3.35 TB/s).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel of its route or raises (nothing falls back from one
route to the other).  ``rg_lru.launches`` counts kernel launches,
``rg_lru.routes`` the same by route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import rg_lru_ref

#: the fewest tokens a call takes to the tma route: below 8 tokens the
#: two kernels' device times on an H100 lie within 0.0002 ms of each
#: other, and the seq kernel's wrapper spends less host time (no tensor
#: maps to encode) on a path that the host bounds (chip_smoke.py phase
#: 11 times both routes at T = 1-64; PERF.md)
LRU_TMA_MIN_S = 8


def lru_route(S: int, d: int) -> str:
    """K5's kernel for ``S`` tokens of ``d`` channels: ``"tma"`` for d a
    multiple of 4 (rows the tensor map can stride) at S >=
    :data:`LRU_TMA_MIN_S`, else ``"seq"``."""
    return "tma" if d % 4 == 0 and S >= LRU_TMA_MIN_S else "seq"


@functools.cache
def _fn(stem):
    from ..build import load
    fn = getattr(load(stem), stem)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fn


def rg_lru_cuda(a, b, h, route=None):
    """Launch the kernel of ``route`` (by default :func:`lru_route` of
    these inputs) on PyTorch's current stream (no sync): returns h for
    every token and updates ``h`` in place."""
    B, S, d = a.shape
    if route is None:
        route = lru_route(S, d)
    if route == "tma":
        if d % 4 or any(t.data_ptr() % 16 for t in (a, b)):
            raise ValueError(f"rg_lru: the tma route takes d a multiple of "
                             f"4 and a, b on 16-byte boundaries, got d {d}")
    elif route != "seq":
        raise ValueError(f"rg_lru: no route {route!r}")
    tensors = (a, b, h)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError("rg_lru: all inputs on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rg_lru: a, b and h must be float32")
    if b.shape != a.shape or h.shape != (B, d) or 0 in a.shape:
        raise ValueError(f"rg_lru: bad shapes a {a.shape} b {b.shape} h "
                         f"{h.shape}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rg_lru: inputs must be contiguous")
    hs = torch.empty_like(a)
    stem = "rg_lru_tma" if route == "tma" else "rg_lru"
    err = _fn(stem)(a.data_ptr(), b.data_ptr(), h.data_ptr(), hs.data_ptr(),
                    B, S, d, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel ({route}) launch failed: "
                           f"cudaError {err} (S={S}, d={d})")
    return hs


def rg_lru(a, b, h=None):
    """a, b: float32 [B, S, d]; h: float32 [B, d], the carried state, or
    None for a zero state.  Returns (hs float32 [B, S, d], h), with
    ``h`` updated in place to the last token's state (see :mod:`.ref`).
    """
    if h is None:
        h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                        device=a.device)
    if a.device.type == "cpu":
        hs, h_new = rg_lru_ref(a, b, h)
        h.copy_(h_new)
        return hs, h
    route = lru_route(a.shape[1], a.shape[2])
    hs = rg_lru_cuda(a, b, h, route)
    rg_lru.launches += 1
    rg_lru.routes[route] += 1
    return hs, h


rg_lru.launches = 0
rg_lru.routes = {"tma": 0, "seq": 0}


def bound_bytes(a, h) -> int:
    """Bytes the function must move: a and b read and hs written once,
    and the state read and written once."""
    return 3 * a.numel() * a.element_size() + 2 * h.numel() * h.element_size()


def flops(a) -> int:
    """Float32 operations: a multiply and an add per element."""
    return 2 * a.numel()
