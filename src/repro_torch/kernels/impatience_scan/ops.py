"""Wrapper for the impatience scan kernel (``csrc/impatience_scan.cu``,
kernel S2).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other.  On the card it lays out
what the kernel reads and writes lanes major (``layout``: each lane's
stream contiguous, for the kernel's bulk copies and stores) and transposes
the outputs back; the layout is plain torch, so the CPU tests hold it
too."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.impatience_scan.ref import impatience_scan_reference

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + \
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _check(inter, service, tau):
    if {inter.dtype, service.dtype, tau.dtype} != {torch.float64}:
        raise TypeError(f"impatience_scan takes float64 inter, service and "
                        f"tau, got {inter.dtype}/{service.dtype}/{tau.dtype}")
    if inter.dim() != 2 or service.shape != inter.shape \
            or tau.shape != inter.shape[1:]:
        raise ValueError(f"shapes inter {tuple(inter.shape)}, service "
                         f"{tuple(service.shape)}, tau {tuple(tau.shape)}: "
                         f"need [n, lanes] and [lanes]")


def _lanes_major(x, ld):
    """x [n, lanes] as [lanes, ld]: each lane's stream contiguous and
    16-byte aligned, the columns past n unset.  An [n, 1] tensor that is
    so already (n a multiple of 8) is returned as its [1, n] view, with no
    copy."""
    n, lanes = x.shape
    xt = x.t()
    if ld == n and xt.is_contiguous() and xt.data_ptr() % 16 == 0:
        return xt
    out = torch.empty((lanes, ld), dtype=x.dtype, device=x.device)
    out[:, :n].copy_(xt)
    return out


def layout(inter, service):
    """What the kernel reads: (inter, service [lanes, ld] float64, lanes
    major), ld being n rounded up to a multiple of 8, so that every tile of
    a lane is 16-byte aligned and a whole number of 16-byte chunks, and
    every group of 8 loss flags the kernel writes in the same layout is
    8-byte aligned."""
    ld = -(-inter.shape[0] // 8) * 8
    return _lanes_major(inter, ld), _lanes_major(service, ld)


def _lib():
    return K.library("impatience_scan")


def tile() -> int:
    """Requests a stage of the kernel's shared-memory ring holds (its
    ``impatience_scan_tile``).  Needs the built kernel."""
    fn = _lib().impatience_scan_tile
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def ring_depth() -> int:
    """Requests a lane the kernel's ring holds, all its stages (its
    ``impatience_scan_ring_depth``).  Needs the built kernel."""
    fn = _lib().impatience_scan_ring_depth
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def launch(laid, tau, n: int):
    """The kernel alone on :func:`layout`'s tensors ``laid`` and the
    contiguous [lanes] tau; returns waits [lanes, ld] float64 and lost
    [lanes, ld] bool, lanes major (the columns from n on unset)."""
    inter, service = laid
    waits = torch.empty_like(inter)
    lost = torch.empty(inter.shape, dtype=torch.bool, device=inter.device)
    fn = _lib().impatience_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(inter.data_ptr(), service.data_ptr(), inter.shape[1],
                tau.data_ptr(), waits.data_ptr(), lost.data_ptr(), n,
                inter.shape[0], K.stream_ptr(inter))
    K.check_status("impatience_scan", status)
    K.LAUNCHES["impatience_scan"] += 1
    return waits, lost


def impatience_scan(inter, service, tau):
    """M/G/1 waits under deterministic impatience, one lane per cell.

    inter, service: [n, lanes] float64, lanes minor; tau: [lanes] float64.
    Returns (waits [n, lanes] float64, lost [n, lanes] bool)."""
    _check(inter, service, tau)
    if not K.on_cuda(inter, service, tau):
        return impatience_scan_reference(inter, service, tau)
    n = inter.shape[0]
    if inter.numel() == 0:
        return (torch.empty(inter.shape, dtype=torch.float64,
                            device=inter.device),
                torch.empty(inter.shape, dtype=torch.bool,
                            device=inter.device))
    waits, lost = launch(layout(inter, service), tau.contiguous(), n)
    return waits[:, :n].t().contiguous(), lost[:, :n].t().contiguous()
