"""Wrapper for the batch-formation scan kernel (``csrc/batch_scan.cu``,
kernel S1).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.batch_scan.ref import batch_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int] + \
    [ctypes.c_double] * 4 + [ctypes.c_void_p]


def _check(arr, tok, elastic, b_max):
    if arr.dtype != torch.float64 or tok.dtype != torch.float64 \
            or b_max.dtype != torch.float64 or elastic.dtype != torch.bool:
        raise TypeError(f"batch_scan takes float64 arr, tok and b_max and a "
                        f"bool elastic, got {arr.dtype}/{tok.dtype}/"
                        f"{b_max.dtype}/{elastic.dtype}")
    if arr.dim() != 2 or tok.shape != arr.shape \
            or elastic.shape != arr.shape[1:] or b_max.shape != arr.shape[1:]:
        raise ValueError(f"shapes arr {tuple(arr.shape)}, tok "
                         f"{tuple(tok.shape)}, elastic {tuple(elastic.shape)}, "
                         f"b_max {tuple(b_max.shape)}: need [n, lanes] and "
                         f"[lanes]")


def ring_depth() -> int:
    """Requests a lane the kernel's shared-memory ring holds (its
    ``batch_scan_ring_depth``).  Needs the built kernel."""
    fn = K.library("batch_scan").batch_scan_ring_depth
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def batch_scan(arr, tok, elastic, b_max, k1, k2, k3, k4):
    """Dynamic / elastic batch formation, one lane per sweep cell.

    arr, tok: [n, lanes] float64 arrivals and output tokens, lanes minor;
    elastic: [lanes] bool (Eq 26 batch time, else padded Eq 18); b_max:
    [lanes] float64 batch cap (``ref.NO_CAP`` for none); k1..k4: the batch
    latency law.  Returns (starts [n, lanes] float64, closed [n, lanes]
    bool)."""
    _check(arr, tok, elastic, b_max)
    k = tuple(float(x) for x in (k1, k2, k3, k4))
    if not K.on_cuda(arr, tok, elastic, b_max):
        return batch_scan_reference(arr, tok, elastic, b_max, *k)
    arr, tok = arr.contiguous(), tok.contiguous()
    elastic, b_max = elastic.contiguous(), b_max.contiguous()
    n, lanes = arr.shape
    starts = torch.empty_like(arr)
    closed = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    if n == 0 or lanes == 0:
        return starts, closed
    fn = K.library("batch_scan").batch_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), elastic.data_ptr(),
                b_max.data_ptr(), starts.data_ptr(), closed.data_ptr(), n,
                lanes, *k, K.stream_ptr(arr))
    K.check_status("batch_scan", status)
    K.LAUNCHES["batch_scan"] += 1
    return starts, closed
