"""Wrapper for the multi-bin batch-formation kernel
(``csrc/multibin_scan.cu``, kernel S3).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.multibin_scan.ref import multibin_scan_reference

MAX_BINS = 64          # the kernel's per-lane cursor arrays

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int] + \
    [ctypes.c_double] * 4 + [ctypes.c_void_p]


def _check(arr, tok, bins, num_bins, b_max):
    if arr.dtype != torch.float64 or tok.dtype != torch.float64 \
            or bins.dtype != torch.int64 or b_max.dtype != torch.int64:
        raise TypeError(f"multibin_scan takes float64 arr and tok and int64 "
                        f"bins and b_max, got {arr.dtype}/{tok.dtype}/"
                        f"{bins.dtype}/{b_max.dtype}")
    if arr.dim() != 2 or tok.shape != arr.shape or bins.shape != arr.shape \
            or b_max.shape != arr.shape[1:]:
        raise ValueError(f"shapes arr {tuple(arr.shape)}, tok "
                         f"{tuple(tok.shape)}, bins {tuple(bins.shape)}, "
                         f"b_max {tuple(b_max.shape)}: need [n, lanes] and "
                         f"[lanes]")
    if not 1 <= num_bins <= MAX_BINS:
        raise ValueError(f"num_bins {num_bins}: need 1..{MAX_BINS}")
    if bins.numel() and (int(bins.min()) < 0 or int(bins.max()) >= num_bins):
        raise ValueError(f"bins outside [0, {num_bins})")


def multibin_scan(arr, tok, bins, num_bins, b_max, k1, k2, k3, k4):
    """Multi-bin batch formation, one lane per sweep cell.

    arr, tok: [n, lanes] float64 sorted arrivals and output tokens, lanes
    minor; bins: [n, lanes] int64 bin of each request in [0, num_bins);
    b_max: [lanes] int64 batch cap (<= 0 for none); k1..k4: the batch
    latency law.  Returns (starts [n, lanes] float64, first [n, lanes]
    bool): each request's batch start and whether it is its batch's
    head."""
    num_bins = int(num_bins)
    _check(arr, tok, bins, num_bins, b_max)
    lat = tuple(float(x) for x in (k1, k2, k3, k4))
    if not K.on_cuda(arr, tok, bins, b_max):
        return multibin_scan_reference(arr, tok, bins, num_bins, b_max, *lat)
    arr, tok, bins, b_max = (x.contiguous() for x in (arr, tok, bins, b_max))
    n, lanes = arr.shape
    starts = torch.empty_like(arr)
    first = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    if n == 0 or lanes == 0:
        return starts, first
    fn = K.library("multibin_scan").multibin_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), bins.data_ptr(),
                b_max.data_ptr(), starts.data_ptr(), first.data_ptr(), n,
                lanes, num_bins, *lat, K.stream_ptr(arr))
    K.check_status("multibin_scan", status)
    K.LAUNCHES["multibin_scan"] += 1
    return starts, first
