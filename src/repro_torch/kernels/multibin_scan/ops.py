"""Wrapper for the multi-bin batch-formation kernel
(``csrc/multibin_scan.cu``, kernel S3).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other.  On the card it lays out
what the kernel reads (``layout``: each lane's requests grouped by bin, the
reference's per-bin rows); the kernel forms every batch itself.  The
layout is plain torch, so the CPU tests hold it too."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.multibin_scan.ref import multibin_scan_reference

MAX_BINS = 64          # two bins a thread of the kernel's warp
MAX_N = 2 ** 31 - 1    # the kernel's int32 positions

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
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
    if arr.shape[0] > MAX_N:
        raise ValueError(f"{arr.shape[0]} requests a lane: need <= {MAX_N}")
    if bins.numel() and (int(bins.min()) < 0 or int(bins.max()) >= num_bins):
        raise ValueError(f"bins outside [0, {num_bins})")


def group_by_bin(bins, num_bins: int):
    """Each lane's requests stably sorted by bin: a bin's members contiguous
    and in arrival order, as the reference's per-bin rows.  bins: [n, lanes]
    int64.  Returns (perm [lanes, n] int64, the request at each sorted
    position; offs [lanes, num_bins + 1] int64, bin b's members at sorted
    positions offs[:, b] .. offs[:, b + 1] - 1)."""
    keys = bins.t()
    perm = torch.sort(keys, dim=1, stable=True).indices
    counts = torch.zeros((keys.shape[0], num_bins), dtype=torch.int64,
                         device=bins.device)
    counts.scatter_add_(1, keys, torch.ones_like(keys))
    return perm, torch.nn.functional.pad(counts.cumsum(1), (1, 0))


def layout(arr, tok, bins, num_bins: int):
    """What the kernel reads, each contiguous: (arr, tok [lanes, n] float64
    and perm [lanes, n] int32 in :func:`group_by_bin`'s order, offs [lanes,
    num_bins + 1] int32).  (A sort along the rows of a transposed view
    returns its indices in the view's strides.)"""
    perm, offs = group_by_bin(bins, num_bins)
    return tuple(x.contiguous() for x in (
        arr.t().gather(1, perm), tok.t().gather(1, perm),
        perm.to(torch.int32), offs.to(torch.int32)))


def launch(laid, num_bins: int, b_max, lat, starts, first):
    """The kernel alone on :func:`layout`'s tensors ``laid``; writes starts
    [n, lanes] float64 and first [n, lanes] bool in request order."""
    arr, tok, perm, offs = laid
    lanes, n = arr.shape
    fn = K.library("multibin_scan").multibin_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), perm.data_ptr(),
                offs.data_ptr(), b_max.data_ptr(), starts.data_ptr(),
                first.data_ptr(), n, lanes, num_bins, *lat,
                K.stream_ptr(arr))
    K.check_status("multibin_scan", status)
    K.LAUNCHES["multibin_scan"] += 1
    return starts, first


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
    starts = torch.empty(arr.shape, dtype=torch.float64, device=arr.device)
    first = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    if arr.numel() == 0:
        return starts, first
    return launch(layout(arr, tok, bins, num_bins), num_bins,
                  b_max.contiguous(), lat, starts, first)
