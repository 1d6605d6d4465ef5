"""Plain PyTorch version of the batch-formation scan (kernel S1): the
recursion of the reference's ``repro.core.fastsim._batching_core`` as a
Python loop over requests, every lane at once.  The wrapper runs it for
CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against it.

Every product and sum is its own PyTorch op in float64, in the oracle's
order, so nothing is contracted into a fused multiply-add and the result
equals the NumPy oracle bit for bit."""

from __future__ import annotations

import torch

NEG = -1e30          # start of the empty batch before request 0
NO_CAP = 1e18        # "b_max=None" as a finite cap (inf would poison carries)


def batch_scan_reference(arr, tok, elastic, b_max, k1, k2, k3, k4):
    """arr, tok: [n, lanes] float64 arrivals and output tokens; elastic:
    [lanes] bool; b_max: [lanes] float64.  Returns (starts [n, lanes]
    float64, closed [n, lanes] bool): each request's batch start, and
    whether it closed the batch before it (see ``csrc/batch_scan.cu``)."""
    n, lanes = arr.shape
    t_cur = torch.full((lanes,), NEG, dtype=torch.float64, device=arr.device)
    cnt = b_max + 1.0
    ssum = torch.zeros_like(t_cur)
    smax = torch.zeros_like(t_cur)
    starts = torch.empty_like(arr)
    closed = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    for i in range(n):
        a, t = arr[i], tok[i]
        pre = k1 * cnt + k2
        h = torch.where(elastic, pre + k3 * ssum + k4 * smax,
                        pre + (k3 * cnt + k4) * smax)
        t_free = t_cur + h
        joins = (a <= t_cur) & (cnt < b_max)
        t_cur = torch.where(joins, t_cur, torch.where(a >= t_free, a, t_free))
        cnt = torch.where(joins, cnt + 1.0, 1.0)
        ssum = torch.where(joins, ssum + t, t)
        smax = torch.where(joins, torch.maximum(smax, t), t)
        starts[i] = t_cur
        closed[i] = ~joins
    return starts, closed
