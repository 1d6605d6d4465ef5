"""Plain PyTorch version of fused residual-add + RMSNorm: a copy of the
reference package's ``rmsnorm_reference``.  The wrapper runs it for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it."""

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
