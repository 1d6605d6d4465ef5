"""Wrapper for the WAIT batch-formation kernel (``csrc/wait_scan.cu``,
kernel S4).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.wait_scan.ref import wait_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int] + \
    [ctypes.c_double] * 4 + [ctypes.c_void_p]


def _check(arr, tok, k, timeout, b_max):
    if arr.dtype != torch.float64 or tok.dtype != torch.float64 \
            or timeout.dtype != torch.float64 or k.dtype != torch.int64 \
            or b_max.dtype != torch.int64:
        raise TypeError(f"wait_scan takes float64 arr, tok and timeout and "
                        f"int64 k and b_max, got {arr.dtype}/{tok.dtype}/"
                        f"{timeout.dtype}/{k.dtype}/{b_max.dtype}")
    if arr.dim() != 2 or tok.shape != arr.shape \
            or any(x.shape != arr.shape[1:] for x in (k, timeout, b_max)):
        raise ValueError(f"shapes arr {tuple(arr.shape)}, tok "
                         f"{tuple(tok.shape)}, k {tuple(k.shape)}, timeout "
                         f"{tuple(timeout.shape)}, b_max "
                         f"{tuple(b_max.shape)}: need [n, lanes] and [lanes]")


def window() -> int:
    """Requests the kernel's shared-memory window holds from the chunk of
    its cursor on (its ``wait_scan_window``): a trigger k - 1 requests
    ahead of the head is read there while it lies inside, else from device
    memory.  Needs the built kernel."""
    fn = K.library("wait_scan").wait_scan_window
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def max_requests() -> int:
    """The most requests a lane the kernel takes (its ``wait_scan_max_n``):
    its positions are 32-bit ints.  Needs the built kernel."""
    fn = K.library("wait_scan").wait_scan_max_n
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return fn()


def wait_scan(arr, tok, k, timeout, b_max, k1, k2, k3, k4):
    """WAIT threshold-admission batch formation, one lane per sweep cell.

    arr, tok: [n, lanes] float64 sorted arrivals and output tokens, lanes
    minor; k: [lanes] int64 trigger count (< 1 counts as 1); timeout:
    [lanes] float64 head timer (+inf for none; >= 0); b_max: [lanes] int64
    batch cap (<= 0 for none); k1..k4: the batch latency law.  Returns
    (starts [n, lanes] float64, first [n, lanes] bool): each request's
    batch start and whether it is its batch's head."""
    _check(arr, tok, k, timeout, b_max)
    lat = tuple(float(x) for x in (k1, k2, k3, k4))
    if not K.on_cuda(arr, tok, k, timeout, b_max):
        return wait_scan_reference(arr, tok, k, timeout, b_max, *lat)
    n, lanes = arr.shape
    if n > max_requests():
        raise ValueError(f"wait_scan takes at most {max_requests()} requests "
                         f"a lane on the card, got {n}")
    arr, tok, k, timeout, b_max = (x.contiguous() for x in
                                   (arr, tok, k, timeout, b_max))
    starts = torch.empty_like(arr)
    first = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    if n == 0 or lanes == 0:
        return starts, first
    fn = K.library("wait_scan").wait_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), k.data_ptr(),
                timeout.data_ptr(), b_max.data_ptr(), starts.data_ptr(),
                first.data_ptr(), n, lanes, *lat, K.stream_ptr(arr))
    K.check_status("wait_scan", status)
    K.LAUNCHES["wait_scan"] += 1
    return starts, first
