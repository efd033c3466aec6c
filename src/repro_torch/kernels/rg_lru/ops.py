"""RG-LRU linear recurrence (K5): dispatcher between the CUDA kernel
and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/rg_lru/kernel.py::rg_lru`` (its ``pallas_call`` at
``kernel.py:67``).  The CUDA C++ kernel for Hopper (``csrc/rg_lru.cu``,
built for ``sm_90a`` at first use and called through ctypes) runs one
thread per (sequence, channel) with a sequential loop over the tokens,
coalesced along the channels, and takes any S and d.

Bound on an H100: bytes (:func:`bound_bytes` over 3.35 TB/s).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  ``rg_lru.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import rg_lru_ref


@functools.cache
def _fn():
    from ..build import load
    fn = load("rg_lru").rg_lru
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fn


def rg_lru_cuda(a, b, h):
    """Launch the CUDA kernel on PyTorch's current stream (no sync):
    returns h for every token and updates ``h`` in place."""
    B, S, d = a.shape
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
    err = _fn()(a.data_ptr(), b.data_ptr(), h.data_ptr(), hs.data_ptr(), B,
                S, d, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rg_lru kernel launch failed: cudaError {err}")
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
    hs = rg_lru_cuda(a, b, h)
    rg_lru.launches += 1
    return hs, h


rg_lru.launches = 0


def bound_bytes(a, h) -> int:
    """Bytes the function must move: a and b read and hs written once,
    and the state read and written once."""
    return 3 * a.numel() * a.element_size() + 2 * h.numel() * h.element_size()


def flops(a) -> int:
    """Float32 operations: a multiply and an add per element."""
    return 2 * a.numel()
