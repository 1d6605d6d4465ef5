"""Wrapper for the SRPT batch-formation kernel (``csrc/srpt_scan.cu``,
kernel S5).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.srpt_scan.ref import srpt_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong] + \
    [ctypes.c_double] * 4 + [ctypes.c_void_p]


def _check(arr, tok, order, b_max):
    if arr.dtype != torch.float64 or tok.dtype != torch.float64 \
            or order.dtype != torch.int64 or b_max.dtype != torch.int64:
        raise TypeError(f"srpt_scan takes float64 arr and tok and int64 "
                        f"order and b_max, got {arr.dtype}/{tok.dtype}/"
                        f"{order.dtype}/{b_max.dtype}")
    if arr.dim() != 2 or tok.shape != arr.shape or order.shape != arr.shape \
            or b_max.shape != arr.shape[1:]:
        raise ValueError(f"shapes arr {tuple(arr.shape)}, tok "
                         f"{tuple(tok.shape)}, order {tuple(order.shape)}, "
                         f"b_max {tuple(b_max.shape)}: need [n, lanes] and "
                         f"[lanes]")
    if order.numel() and (int(order.min()) < 0
                          or int(order.max()) >= arr.shape[0]):
        raise ValueError(f"order outside [0, {arr.shape[0]})")


def lane_words(n: int) -> int:
    """The float64 words of scratch the kernel takes for a lane of ``n``
    requests (its ``srpt_scan_lane_words``, which owns the tree's layout):
    4 n for the lane's arrays, and more once the tree's lower levels
    outgrow shared memory.  Needs the built kernel."""
    fn = K.library("srpt_scan").srpt_scan_lane_words
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_longlong
    words = fn(n)
    if words < 0:
        raise ValueError(f"srpt_scan takes 1 to {2 ** 31 - 33} requests a "
                         f"lane, got {n}")
    return words


def srpt_scan(arr, tok, order, b_max, k1, k2, k3, k4):
    """SRPT-like shortest-first batch formation, one lane per sweep cell.

    arr, tok: [n, lanes] float64 arrivals and true output tokens, lanes
    minor; order: [n, lanes] int64, each lane a permutation of 0..n-1 (the
    requests in rank order: a stable argsort of the predicted lengths);
    b_max: [lanes] int64 batch cap (<= 0 for none); k1..k4: the batch
    latency law.  Returns (starts [n, lanes] float64, first [n, lanes]
    bool): each request's batch start and whether it was its batch's first
    member.  A request that a NaN arrival leaves unserved has first False
    and, from the kernel, start NaN (the plain version leaves its start
    unset)."""
    _check(arr, tok, order, b_max)
    lat = tuple(float(x) for x in (k1, k2, k3, k4))
    if not K.on_cuda(arr, tok, order, b_max):
        return srpt_scan_reference(arr, tok, order, b_max, *lat)
    arr, tok, order, b_max = (x.contiguous() for x in (arr, tok, order, b_max))
    n, lanes = arr.shape
    starts = torch.empty_like(arr)
    first = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    if n == 0 or lanes == 0:
        return starts, first
    words = lane_words(n)
    # each lane's requests in time order (NaN last): the kernel inserts
    # them into its tree as the batch start passes their arrivals
    torder = torch.argsort(arr, dim=0, stable=True)
    scratch = torch.empty((lanes, words), dtype=torch.float64,
                          device=arr.device)
    fn = K.library("srpt_scan").srpt_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), order.data_ptr(),
                torder.data_ptr(), b_max.data_ptr(), starts.data_ptr(),
                first.data_ptr(), scratch.data_ptr(), n, lanes, words, *lat,
                K.stream_ptr(arr))
    K.check_status("srpt_scan", status)
    K.LAUNCHES["srpt_scan"] += 1
    return starts, first
