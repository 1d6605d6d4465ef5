"""Wrapper for the fused residual-add + RMSNorm kernel
(``csrc/fused_rmsnorm.cu``).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(x, residual, weight, eps, round_sum):
    if x.dtype not in _DTYPES or residual.dtype != x.dtype \
            or weight.dtype != x.dtype:
        raise TypeError(f"fused_rmsnorm takes fp32 or bf16 x, residual and "
                        f"weight of one dtype, got {x.dtype}/{residual.dtype}"
                        f"/{weight.dtype}")
    d = x.shape[-1]
    if residual.shape != x.shape or weight.shape != (d,):
        raise ValueError(f"shapes x {tuple(x.shape)}, residual "
                         f"{tuple(residual.shape)}, weight "
                         f"{tuple(weight.shape)}")
    if (d * x.element_size()) % 16 or d > 12288:
        raise ValueError(f"kernel takes rows of whole 16-byte vectors up to "
                         f"12288 elements, got D={d} in {x.dtype}")
    x, residual, weight = (t.contiguous() for t in (x, residual, weight))
    for name, t in (("x", x), ("residual", residual), ("weight", weight)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    rows = x.numel() // d
    s, n = torch.empty_like(x), torch.empty_like(x)
    if rows == 0:
        return s, n
    fn = K.library("fused_rmsnorm").fused_rmsnorm
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
                s.data_ptr(), n.data_ptr(), rows, d, eps, _DTYPES[x.dtype],
                int(round_sum), K.stream_ptr(x))
    K.check_status("fused_rmsnorm", status)
    K.LAUNCHES["fused_rmsnorm"] += 1
    return s, n


def fused_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
                  round_sum: bool = False):
    """x, residual: [..., D]; weight: [D], stored as w - 1.  Returns
    (x + residual, rmsnorm(x + residual) * (1 + weight)) in x's dtype,
    computed in fp32; any number of rows.  ``round_sum`` normalises the
    sum as returned, rounded to x's dtype (no change in fp32)."""
    if K.on_cuda(x, residual, weight):
        return _launch(x, residual, weight, float(eps), round_sum)
    return rmsnorm_reference(x, residual, weight, eps, round_sum)
