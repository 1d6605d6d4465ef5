"""Wrapper for the impatience scan kernel (``csrc/impatience_scan.cu``,
kernel S2).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.impatience_scan.ref import impatience_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def _check(inter, service, tau):
    if {inter.dtype, service.dtype, tau.dtype} != {torch.float64}:
        raise TypeError(f"impatience_scan takes float64 inter, service and "
                        f"tau, got {inter.dtype}/{service.dtype}/{tau.dtype}")
    if inter.dim() != 2 or service.shape != inter.shape \
            or tau.shape != inter.shape[1:]:
        raise ValueError(f"shapes inter {tuple(inter.shape)}, service "
                         f"{tuple(service.shape)}, tau {tuple(tau.shape)}: "
                         f"need [n, lanes] and [lanes]")


def impatience_scan(inter, service, tau):
    """M/G/1 waits under deterministic impatience, one lane per cell.

    inter, service: [n, lanes] float64, lanes minor; tau: [lanes] float64.
    Returns (waits [n, lanes] float64, lost [n, lanes] bool)."""
    _check(inter, service, tau)
    if not K.on_cuda(inter, service, tau):
        return impatience_scan_reference(inter, service, tau)
    inter, service, tau = inter.contiguous(), service.contiguous(), \
        tau.contiguous()
    n, lanes = inter.shape
    waits = torch.empty_like(inter)
    lost = torch.empty(inter.shape, dtype=torch.bool, device=inter.device)
    if n == 0 or lanes == 0:
        return waits, lost
    fn = K.library("impatience_scan").impatience_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(inter.data_ptr(), service.data_ptr(), tau.data_ptr(),
                waits.data_ptr(), lost.data_ptr(), n, lanes,
                K.stream_ptr(inter))
    K.check_status("impatience_scan", status)
    K.LAUNCHES["impatience_scan"] += 1
    return waits, lost
