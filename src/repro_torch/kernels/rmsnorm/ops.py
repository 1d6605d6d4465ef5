"""Wrapper for the fused residual-add + RMSNorm kernel
(``csrc/fused_rmsnorm.cu``) and its backward (``csrc/fused_rmsnorm_bwd.cu``).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``, which autograd differentiates.  Under autograd (grad enabled
and an input that requires grad) a CUDA call goes through
``_FusedRMSNorm``, whose backward launches the backward kernel.  The
wrapper checks what the kernels take and raises on the rest; it never
falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.rmsnorm.ref import rmsnorm_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (rows' dtype, weight's dtype) pairs the kernels take: one dtype, or an
# fp32 weight beside bf16 rows (fp32 master weights, bf16 activations)
_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32))
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the widest row the wrapper takes, in elements, and the backward's in
# fp32 (512 threads of at most four 16-byte vectors)
_MAX_D = 12288
_MAX_D_BWD = {torch.float32: 8192, torch.bfloat16: _MAX_D}


def _check(x, residual, weight):
    if (x.dtype, weight.dtype) not in _PAIRS or residual.dtype != x.dtype:
        raise TypeError(f"fused_rmsnorm takes fp32 or bf16 x and residual of "
                        f"one dtype with a weight of that dtype (or fp32 "
                        f"beside bf16), got {x.dtype}/{residual.dtype}/"
                        f"{weight.dtype}")
    d = x.shape[-1]
    if residual.shape != x.shape or weight.shape != (d,):
        raise ValueError(f"shapes x {tuple(x.shape)}, residual "
                         f"{tuple(residual.shape)}, weight "
                         f"{tuple(weight.shape)}")
    if (d * x.element_size()) % 16 or d > _MAX_D:
        raise ValueError(f"kernel takes rows of whole 16-byte vectors up to "
                         f"{_MAX_D} elements, got D={d} in {x.dtype}")
    return d


def _aligned(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(x, residual, weight, eps, round_sum):
    d = _check(x, residual, weight)
    x, residual, weight = (t.contiguous() for t in (x, residual, weight))
    _aligned(x=x, residual=residual, weight=weight)
    rows = x.numel() // d
    s, n = torch.empty_like(x), torch.empty_like(x)
    if rows == 0:
        return s, n
    fn = K.library("fused_rmsnorm").fused_rmsnorm
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
                s.data_ptr(), n.data_ptr(), rows, d, eps, _DTYPES[x.dtype],
                _DTYPES[weight.dtype], int(round_sum), K.stream_ptr(x))
    K.check_status("fused_rmsnorm", status)
    K.LAUNCHES["fused_rmsnorm"] += 1
    return s, n


def _launch_bwd(x, residual, weight, ds, dn, eps, round_sum):
    """(dx, dweight) of ``fused_rmsnorm(x, residual, weight)`` for the
    upstream grads ``ds`` and ``dn`` of its two outputs; dx is also the
    residual's grad.  The rows kernel, then the column sums of dweight."""
    d = _check(x, residual, weight)
    if d > _MAX_D_BWD[x.dtype]:
        raise ValueError(f"backward kernel takes rows of up to "
                         f"{_MAX_D_BWD[x.dtype]} elements in {x.dtype}, got "
                         f"D={d}")
    x, residual, weight = (t.contiguous() for t in (x, residual, weight))
    ds, dn = (g.to(x.dtype).contiguous() for g in (ds, dn))
    _aligned(x=x, residual=residual, weight=weight, ds=ds, dn=dn)
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight)
    lib = K.library("fused_rmsnorm_bwd")
    lib.fused_rmsnorm_bwd_blocks.argtypes = [ctypes.c_int]
    lib.fused_rmsnorm_bwd_blocks.restype = ctypes.c_int
    part = torch.empty((lib.fused_rmsnorm_bwd_blocks(rows), d),
                       dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weight)
    fn = lib.fused_rmsnorm_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    status = fn(x.data_ptr(), residual.data_ptr(), weight.data_ptr(),
                ds.data_ptr(), dn.data_ptr(), dx.data_ptr(), part.data_ptr(),
                dw.data_ptr(), rows, d, eps, _DTYPES[x.dtype],
                _DTYPES[weight.dtype], int(round_sum), K.stream_ptr(x))
    K.check_status("fused_rmsnorm_bwd", status)
    K.LAUNCHES["fused_rmsnorm_bwd"] += 1
    return dx, dw


class _FusedRMSNorm(torch.autograd.Function):
    """The forward kernel, and the backward kernel for its gradient.  It
    keeps x and the residual (not the sum) so that the backward re-forms
    the fp32 sum the forward normalised, unrounded in bf16."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps, round_sum):
        s, n = _launch(x, residual, weight, eps, round_sum)
        ctx.save_for_backward(x, residual, weight)
        ctx.eps, ctx.round_sum = eps, round_sum
        return s, n

    @staticmethod
    def backward(ctx, ds, dn):
        x, residual, weight = ctx.saved_tensors
        dx, dw = _launch_bwd(x, residual, weight, ds, dn, ctx.eps,
                             ctx.round_sum)
        return dx, dx, dw.view(weight.shape), None, None


def fused_rmsnorm(x, residual, weight, *, eps: float = 1e-6,
                  round_sum: bool = False):
    """x, residual: [..., D]; weight: [D], stored as w - 1.  Returns
    (x + residual, rmsnorm(x + residual) * (1 + weight)) in x's dtype,
    computed in fp32; any number of rows.  ``round_sum`` normalises the
    sum as returned, rounded to x's dtype (no change in fp32).
    Differentiable: on CUDA through the backward kernel, on the CPU
    through the plain version."""
    if K.on_cuda(x, residual, weight):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, residual, weight)):
            return _FusedRMSNorm.apply(x, residual, weight, float(eps),
                                       round_sum)
        return _launch(x, residual, weight, float(eps), round_sum)
    return rmsnorm_reference(x, residual, weight, eps, round_sum)
