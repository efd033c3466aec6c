"""Mamba-2 SSD scan (K4): dispatcher between the CUDA kernels and their
plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel
``kernels/ssd_scan/kernel.py::ssd_scan`` (its ``pallas_call`` at
``kernel.py:93``).  Three CUDA C++ kernels for Hopper, built for
``sm_90a`` at first use and called through ctypes, chosen by
:func:`scan_route`; all read and write the decode state's own
[B, H, P, N] layout in place:

- ``"wgmma"`` (``csrc/ssd_scan_wgmma.cu``), bf16 x, B and C with P 64
  and N 64 or 128 (mamba2-370m) at S >= :data:`SCAN_WGMMA_MIN_S`
  tokens: the chunked dual form of the TPU kernel, chunks of 64 tokens
  on ``wgmma``, the state in the warpgroup's accumulator across chunks,
  the float32 operands as three bf16 terms;
- ``"step"`` (``csrc/ssd_step.cu``), the same shapes at S = 1 (the
  decode step): each (sequence, head) cut into four blocks of rows, a
  lane's four state columns a 16-byte load and an evict-first store,
  every load issued before the arithmetic;
- ``"fma"`` (``csrc/ssd_scan.cu``), every other shape (T = 2, float32,
  the smoke widths): one block per (sequence, head) with the float32
  state [P, N] in registers, one token after the other.

Bound on an H100: bytes.  The least time is the state read and written
once plus x, y, B, C and dt over 3.35 TB/s (:func:`bound_bytes`); the
operations are the sequential form's float32 ones (:func:`flops`) or
the dual form's tensor-core products (:func:`dual_flops`).

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel of its route or raises (nothing falls back from one
route to the other).  ``ssd_scan.launches`` counts kernel launches,
``ssd_scan.routes`` the same by route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .ref import ssd_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the fewest tokens a call takes to the wgmma route: below it the
#: sequential kernel is the faster one on an H100 (chip_smoke.py phase
#: 11 times both routes at S = 2-64; PERF.md)
SCAN_WGMMA_MIN_S = 3
#: tokens a chunk of the dual form
CHUNK = 64


def _wgmma_takes(dtype, P: int, N: int) -> bool:
    """The wgmma kernel's shapes: bf16 x, B and C, P 64, N 64 or 128."""
    return dtype == torch.bfloat16 and P == 64 and N in (64, 128)


def scan_route(dtype, S: int, P: int, N: int) -> str:
    """K4's kernel for x of ``dtype``, ``S`` tokens, head dim ``P`` and
    state size ``N``: at bf16, P 64, N 64 or 128, ``"step"`` for S = 1
    and ``"wgmma"`` for S >= :data:`SCAN_WGMMA_MIN_S`; else ``"fma"``."""
    if _wgmma_takes(dtype, P, N):
        if S == 1:
            return "step"
        if S >= SCAN_WGMMA_MIN_S:
            return "wgmma"
    return "fma"


@functools.cache
def _fn():
    from ..build import load
    fn = load("ssd_scan").ssd_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _wgmma_fn():
    from ..build import load
    fn = load("ssd_scan_wgmma").ssd_scan_wgmma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _step_fn():
    from ..build import load
    fn = load("ssd_step").ssd_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def ssd_scan_cuda(x, dt, A, Bm, Cm, D, h, route=None):
    """Launch the kernel of ``route`` (by default :func:`scan_route` of
    these inputs) on PyTorch's current stream (no sync): returns y and
    updates ``h`` in place."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if route is None:
        route = scan_route(x.dtype, S, P, N)
    if route in ("wgmma", "step"):
        if not _wgmma_takes(x.dtype, P, N):
            raise ValueError(f"ssd_scan: the {route} route takes bfloat16 "
                             f"x, B and C at P 64 and N 64 or 128, got "
                             f"{x.dtype}, P {P}, N {N}")
        if route == "step" and S != 1:
            raise ValueError(f"ssd_scan: the step route takes one token, "
                             f"got S {S}")
    elif route != "fma":
        raise ValueError(f"ssd_scan: no route {route!r}")
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
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), h.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma":
        if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
            raise ValueError("ssd_scan: the wgmma route needs x, B and C "
                             "on 16-byte boundaries")
        err = _wgmma_fn()(*ptrs, Bsz, S, H, P, N, stream)
    elif route == "step":
        if h.data_ptr() % 16 or any(t.data_ptr() % 8 for t in (Bm, Cm)):
            raise ValueError("ssd_scan: the step route needs h on 16-byte "
                             "and B and C on 8-byte boundaries")
        err = _step_fn()(*ptrs, Bsz, H, P, N, stream)
    else:
        err = _fn()(*ptrs, _DTYPES[x.dtype], Bsz, S, H, P, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel ({route}) launch failed: "
                           f"cudaError {err} (P={P}, N={N})")
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
    route = scan_route(x.dtype, x.shape[1], x.shape[3], Bm.shape[-1])
    y = ssd_scan_cuda(x, dt, A, Bm, Cm, D, h, route)
    ssd_scan.launches += 1
    ssd_scan.routes[route] += 1
    return y, h


ssd_scan.launches = 0
ssd_scan.routes = {"wgmma": 0, "step": 0, "fma": 0}


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


def dual_flops(x, Bm) -> int:
    """Tensor-core operations of the wgmma route's dual form: per
    (sequence, head) and chunk of 64 tokens, C B^T once and C h^T, W X
    and X^T B_w once for each of the three bf16 terms of their float32
    operand (the last chunk counted whole, as the kernel runs it)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = CHUNK
    per_chunk = 2 * Q * Q * N + 3 * (2 * Q * P * N + 2 * Q * Q * P
                                     + 2 * P * N * Q)
    return Bsz * H * -(-S // Q) * per_chunk
