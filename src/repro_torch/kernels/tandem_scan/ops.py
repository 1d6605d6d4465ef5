"""Wrapper for the memory-gated tandem kernel (``csrc/tandem_scan.cu``,
kernel S7).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other.  On the card it lays out
what the kernel reads and writes lanes major (``layout``: each lane's
stream contiguous, for the kernel's bulk copies) and transposes the
outputs back; the layout is plain torch, so the CPU tests hold it too."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.tandem_scan.ref import tandem_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + \
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int] + \
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


def _lanes_major(x, ld):
    """x [rows, lanes] as [lanes, ld]: each lane's row contiguous and
    16-byte aligned, the columns past ``rows`` unset."""
    out = torch.empty((x.shape[1], ld), dtype=x.dtype, device=x.device)
    out[:, :x.shape[0]].copy_(x.t())
    return out


def layout(arr, tok, fp_cum):
    """What the kernel reads: (arr, tok, fp_cum [lanes, ld] float64, lanes
    major), ld being n + 1 rounded up to even, so that every tile of a row
    is 16-byte aligned and a whole number of 16-byte chunks."""
    ld = (arr.shape[0] + 2) // 2 * 2
    return tuple(_lanes_major(x, ld) for x in (arr, tok, fp_cum))


def _lib():
    return K.library("tandem_scan")


def _shape_constant(name: str) -> int:
    fn = getattr(_lib(), f"tandem_scan_{name}")
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def tile() -> int:
    """Requests a stage of the kernel's shared-memory ring holds.  Needs
    the built kernel."""
    return _shape_constant("tile")


def ring_depth() -> int:
    """Requests a lane the kernel's ring holds, all its stages.  Needs the
    built kernel."""
    return _shape_constant("ring_depth")


def ledger() -> int:
    """Batches a lane the kernel's on-chip release ledger holds.  Needs the
    built kernel."""
    return _shape_constant("ledger")


def max_requests() -> int:
    """The most requests a lane the kernel takes (positions are 32-bit).
    Needs the built kernel."""
    return _shape_constant("max_n")


def launch(laid, cap, b_max, n: int, k1, k2, k3, k4):
    """The kernel alone on :func:`layout`'s tensors ``laid`` and the
    contiguous [lanes] cap and b_max; returns (starts, ends, dends [lanes,
    ld], lanes major, the columns from each lane's nb on unset; nb,
    blocked, blocked_t, deferred [lanes])."""
    arr, tok, fp_cum = laid
    lanes = arr.shape[0]
    f64 = dict(dtype=torch.float64, device=arr.device)
    i64 = dict(dtype=torch.int64, device=arr.device)
    starts, dends = torch.empty_like(arr), torch.empty_like(arr)
    ends = torch.empty(arr.shape, **i64)
    nb, blocked, deferred = (torch.empty(lanes, **i64) for _ in range(3))
    blocked_t = torch.empty(lanes, **f64)
    fn = _lib().tandem_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), tok.data_ptr(), fp_cum.data_ptr(),
                arr.shape[1], cap.data_ptr(), b_max.data_ptr(),
                starts.data_ptr(), ends.data_ptr(), dends.data_ptr(),
                nb.data_ptr(), blocked.data_ptr(), blocked_t.data_ptr(),
                deferred.data_ptr(), n, lanes, float(k1), float(k2),
                float(k3), float(k4), K.stream_ptr(arr))
    K.check_status("tandem_scan", status)
    K.LAUNCHES["tandem_scan"] += 1
    return starts, ends, dends, nb, blocked, blocked_t, deferred


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
    n, lanes = arr.shape
    if n == 0 or lanes == 0:
        f64 = dict(dtype=torch.float64, device=arr.device)
        i64 = dict(dtype=torch.int64, device=arr.device)
        return (torch.empty(n, lanes, **f64), torch.empty(n, lanes, **i64),
                torch.empty(n, lanes, **f64),
                *(torch.zeros(lanes, **i64) for _ in range(2)),
                torch.zeros(lanes, **f64), torch.zeros(lanes, **i64))
    if n > max_requests():
        raise ValueError(f"tandem_scan takes at most {max_requests()} "
                         f"requests a lane, got {n}")
    out = launch(layout(arr, tok, fp_cum), cap.contiguous(),
                 b_max.contiguous(), n, *lat)
    return (*(x[:, :n].t().contiguous() for x in out[:3]), *out[3:])
