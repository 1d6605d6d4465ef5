"""Wrapper for the virtual-backlog routing kernel (``csrc/backlog_scan.cu``,
kernel S6).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other.  On the card it lays out
what the kernel reads: each request's up-flags packed into one word
(``pack_up``) and the kernel template the replica count runs
(``template_of``); both are plain torch, so the CPU tests hold them too."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.backlog_scan.ref import backlog_scan_reference

MAX_REPLICAS = 64       # one 64-bit word of up-flags a request
TEMPLATES = (2, 3, 4, 5, 6, 7, 8, 16, 32, 64)   # the kernel's replica counts

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def template_of(R: int) -> int:
    """The kernel template that routes R >= 2 replicas: R itself up to 8,
    else the next of 16, 32 and 64 (its padding replicas never win)."""
    return next(t for t in TEMPLATES if t >= R)


def pack_up(up: torch.Tensor) -> torch.Tensor:
    """[n, R, lanes] uint8 up-flags (nonzero: up) as [n, lanes] int64 words
    whose bit r is replica r's flag (at R = 64 bit 63 is the sign bit)."""
    R = up.shape[1]
    bit = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=up.device),
        torch.arange(R, dtype=torch.int64, device=up.device))
    return ((up != 0).to(torch.int64) * bit[None, :, None]).sum(dim=1)


def _check(arr, work, R, up):
    if arr.dtype != torch.float64 or work.dtype != torch.float64:
        raise TypeError(f"backlog_scan takes float64 arr and work, got "
                        f"{arr.dtype}/{work.dtype}")
    if arr.dim() != 2 or work.shape != arr.shape:
        raise ValueError(f"shapes arr {tuple(arr.shape)}, work "
                         f"{tuple(work.shape)}: need [n, lanes]")
    if not 1 <= R <= MAX_REPLICAS:
        raise ValueError(f"R = {R} replicas: need 1 <= R <= {MAX_REPLICAS}")
    if up is not None:
        if up.dtype != torch.uint8:
            raise TypeError(f"backlog_scan takes a uint8 up mask, got "
                            f"{up.dtype}")
        if up.shape != (arr.shape[0], R, arr.shape[1]):
            raise ValueError(f"up mask {tuple(up.shape)}: need [n, R, lanes] "
                             f"= {(arr.shape[0], R, arr.shape[1])}")


def launch(arr, work, bits, R: int, out):
    """The kernel alone on laid-out inputs: contiguous [n, lanes] arr and
    work, ``bits`` from :func:`pack_up` or None, 2 <= R; writes ``out``
    [n, lanes] int64."""
    n, lanes = arr.shape
    fn = K.library("backlog_scan").backlog_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(arr.data_ptr(), work.data_ptr(),
                None if bits is None else bits.data_ptr(), out.data_ptr(), n,
                lanes, R, template_of(R), K.stream_ptr(arr))
    K.check_status("backlog_scan", status)
    K.LAUNCHES["backlog_scan"] += 1
    return out


def backlog_scan(arr, work, R: int, up=None):
    """Join-least-backlog routing (the jsq and least_work routers), one lane
    per routing problem.

    arr, work: [n, lanes] float64 arrival times (ascending in each lane) and
    each request's work estimate, lanes minor; R: the replica count; up:
    [n, R, lanes] uint8, 0 where a replica is down at that arrival (None:
    every replica up).  Returns [n, lanes] int64 replica ids.  R = 1 routes
    everything to replica 0 without a launch."""
    R = int(R)
    _check(arr, work, R, up)
    tensors = (arr, work) if up is None else (arr, work, up)
    if not K.on_cuda(*tensors):
        return backlog_scan_reference(arr, work, R, up)
    n, lanes = arr.shape
    if R == 1 or n == 0 or lanes == 0:
        return torch.zeros(arr.shape, dtype=torch.int64, device=arr.device)
    out = torch.empty(arr.shape, dtype=torch.int64, device=arr.device)
    return launch(arr.contiguous(), work.contiguous(),
                  None if up is None else pack_up(up), R, out)
