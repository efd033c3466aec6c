"""Mamba-2 SSD scan (K4): dispatcher between the CUDA kernel and its
plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/ssd_scan/kernel.py::ssd_scan`` (its ``pallas_call`` at
``kernel.py:93``).  The CUDA C++ kernel for Hopper
(``csrc/ssd_scan.cu``, built for ``sm_90a`` at first use and called
through ctypes) runs one thread block per (sequence, head) with the
float32 state [P, N] in registers across the tokens, reading and
writing the decode state's own [B, H, P, N] layout in place.

Bound on an H100: bytes.  The least time is the state read and written
once plus x, y, B, C and dt over 3.35 TB/s (:func:`bound_bytes`).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel or raises.  ``ssd_scan.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import ssd_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    from ..build import load
    fn = load("ssd_scan").ssd_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, h):
    """Launch the CUDA kernel on PyTorch's current stream (no sync):
    returns y and updates ``h`` in place."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    tensors = (x, dt, A, Bm, Cm, D, h)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan: all inputs on one CUDA device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B and C must share float32 or "
                        f"bfloat16, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D, h)):
        raise TypeError("ssd_scan: dt, A, D and h must be float32")
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or D.shape != (H,)
            or Bm.shape != (Bsz, S, N) or Cm.shape != (Bsz, S, N)
            or h.shape != (Bsz, H, P, N) or P > 64 or N > 128
            or 0 in x.shape):
        raise ValueError(f"ssd_scan: bad shapes x {x.shape} dt {dt.shape} "
                         f"B {Bm.shape} h {h.shape} (P <= 64, N <= 128)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: inputs must be contiguous")
    y = torch.empty_like(x)
    err = _fn()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), h.data_ptr(), y.data_ptr(),
                _DTYPES[x.dtype], Bsz, S, H, P, N,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err} "
                           f"(P={P}, N={N})")
    return y


def ssd_scan(x, dt, A, Bm, Cm, D, h=None):
    """x: [B, S, H, P]; dt: float32 [B, S, H]; A, D: float32 [H]; Bm,
    Cm: [B, S, N] in x's dtype; h: float32 [B, H, P, N], the carried
    state, or None for a zero state (the TPU kernel's function).

    Returns (y [B, S, H, P] in x's dtype, h), with ``h`` updated in
    place to the state after the S tokens (see :mod:`.ref`).
    """
    if h is None:
        Bsz, _, H, P = x.shape
        h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    if x.device.type == "cpu":
        y, h_new = ssd_scan_ref(x, dt, A, Bm, Cm, D, h)
        h.copy_(h_new)
        return y, h
    y = ssd_scan_cuda(x, dt, A, Bm, Cm, D, h)
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


def bound_bytes(x, dt, Bm, h) -> int:
    """Bytes the function must move: x, dt, B and C read and y written
    once, and the state read and written once (A and D, 8 H bytes, are
    left out)."""
    return (2 * x.numel() * x.element_size()
            + dt.numel() * dt.element_size()
            + 2 * Bm.numel() * Bm.element_size()
            + 2 * h.numel() * h.element_size())


def flops(x, Bm) -> int:
    """Float32 operations of the recurrence: per token, head and state
    element the decay multiply, the update's multiply and add and the
    output's multiply-add (5 P N); per row dt x and the D x
    multiply-add (3 P); one exp per (token, head)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    return Bsz * S * H * (5 * P * N + 3 * P + 1)
