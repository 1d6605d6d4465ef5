"""Plain PyTorch version of fused residual-add + RMSNorm: a copy of the
reference package's ``rmsnorm_reference``.  The wrapper runs it for CPU
tensors (autograd differentiates it there); the tests and
``chip_smoke.py`` hold the kernel against it, and the backward kernel
against ``rmsnorm_bwd_reference``, its gradient by the explicit formulas
the kernel computes."""

from __future__ import annotations

import torch


def rmsnorm_reference(x, residual, weight, eps: float = 1e-6,
                      round_sum: bool = False):
    """s = x + residual and n = s * rsqrt(mean(s^2) + eps) * (1 + weight),
    both computed in fp32 and returned in x's dtype (``weight`` is stored
    as w - 1); with ``round_sum``, n normalises s rounded to x's dtype."""
    s = x.float() + residual.float()
    if round_sum:
        s = s.to(x.dtype).float()
    var = (s * s).mean(dim=-1, keepdim=True)
    n = s * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return s.to(x.dtype), n.to(x.dtype)


def rmsnorm_bwd_reference(x, residual, weight, ds, dn, eps: float = 1e-6,
                          round_sum: bool = False):
    """(dx, dweight) of ``rmsnorm_reference(x, residual, weight)`` for the
    upstream grads ``ds`` and ``dn`` of its two outputs (dx is also the
    residual's grad), by the kernel's formulas in fp32: with s the sum the
    forward normalised (rounded to x's dtype with ``round_sum``; the
    gradient passes that rounding unchanged), inv = rsqrt(mean(s^2) + eps)
    and g = dn (1 + w), dx = ds + inv g - s inv^3 sum(g s) / D and dweight
    = sum over rows of dn s inv.  dx in x's dtype, dweight in w's."""
    d = x.shape[-1]
    s = x.float() + residual.float()
    if round_sum:
        s = s.to(x.dtype).float()
    inv = torch.rsqrt((s * s).mean(dim=-1, keepdim=True) + eps)
    dnf = dn.float()
    g = dnf * (1.0 + weight.float())
    gs = (g * s).sum(dim=-1, keepdim=True)
    dx = ds.float() + inv * g - s * inv ** 3 * gs / d
    dw = (dnf * s * inv).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)
