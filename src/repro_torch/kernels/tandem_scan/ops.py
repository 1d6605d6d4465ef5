"""Wrapper for the memory-gated tandem kernel (``csrc/tandem_scan.cu``,
kernel S7).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.tandem_scan.ref import tandem_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_int] + \
    [ctypes.c_double] * 4 + [ctypes.c_void_p]


def _check(arr, tok, fp_cum, cap, b_max):
    if any(x.dtype != torch.float64 for x in (arr, tok, fp_cum, cap, b_max)):
        raise TypeError(f"tandem_scan takes float64 arr, tok, fp_cum, cap "
                        f"and b_max, got {arr.dtype}/{tok.dtype}/"
                        f"{fp_cum.dtype}/{cap.dtype}/{b_max.dtype}")
    if arr.dim() != 2 or tok.shape != arr.shape \
            or fp_cum.shape != (arr.shape[0] + 1, arr.shape[1]) \
            or cap.shape != arr.shape[1:] or b_max.shape != arr.shape[1:]:
        raise ValueError(f"shapes arr {tuple(arr.shape)}, tok "
                         f"{tuple(tok.shape)}, fp_cum {tuple(fp_cum.shape)}, "
                         f"cap {tuple(cap.shape)}, b_max {tuple(b_max.shape)}"
                         f": need [n, lanes], [n + 1, lanes] and [lanes]")


def tandem_scan(arr, tok, fp_cum, cap, b_max, k1, k2, k3, k4):
    """The prefill/decode tandem under a KV budget, dynamic formation, one
    lane per cell.

    arr, tok: [n, lanes] float64 sorted arrivals and output tokens, lanes
    minor (a lane's padding rows: +inf arrivals); fp_cum: [n + 1, lanes]
    float64 prefix sums of the footprints (0 first, +inf past the lane's
    requests), summed in order on the host; cap: [lanes] float64 KV
    budget; b_max: [lanes] float64 batch cap (``batch_scan.NO_CAP`` for
    none); k1..k4: the batch latency law.  Returns (starts, ends, dends,
    nb, blocked, blocked_t, deferred): per batch j < nb its start, end
    index (exclusive) and decode end ([n, lanes] float64, int64, float64;
    rows from nb on are unspecified), and per lane the batch count, the
    batches whose start a full budget delayed, the time they were delayed
    and the requests deferred to a later batch ([lanes] int64, int64,
    float64, int64)."""
    _check(arr, tok, fp_cum, cap, b_max)
    lat = tuple(float(x) for x in (k1, k2, k3, k4))
    if not K.on_cuda(arr, tok, fp_cum, cap, b_max):
        return tandem_scan_reference(arr, tok, fp_cum, cap, b_max, *lat)
    arr, tok, fp_cum, cap, b_max = (x.contiguous() for x in
                                    (arr, tok, fp_cum, cap, b_max))
    n, lanes = arr.shape
    f64 = dict(dtype=torch.float64, device=arr.device)
    i64 = dict(dtype=torch.int64, device=arr.device)
    starts, dends = torch.empty(n, lanes, **f64), torch.empty(n, lanes, **f64)
    ends = torch.empty(n, lanes, **i64)
    nb, blocked, deferred = (torch.zeros(lanes, **i64) for _ in range(3))
    blocked_t = torch.zeros(lanes, **f64)
    if n == 0 or lanes == 0:
        return starts, ends, dends, nb, blocked, blocked_t, deferred
    fn = K.library("tandem_scan").tandem_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), fp_cum.data_ptr(),
                cap.data_ptr(), b_max.data_ptr(), starts.data_ptr(),
                ends.data_ptr(), dends.data_ptr(), nb.data_ptr(),
                blocked.data_ptr(), blocked_t.data_ptr(), deferred.data_ptr(),
                n, lanes, *lat, K.stream_ptr(arr))
    K.check_status("tandem_scan", status)
    K.LAUNCHES["tandem_scan"] += 1
    return starts, ends, dends, nb, blocked, blocked_t, deferred
