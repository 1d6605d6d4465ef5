"""Plain PyTorch version of the impatience scan (kernel S2): the workload
recursion of the reference's ``repro.core.fastsim._impatience_scan`` as a
Python loop over requests, every lane at once, in float64.  The wrapper
runs it for CPU tensors; the tests and ``chip_smoke.py`` hold the kernel
against it."""

from __future__ import annotations

import torch


def impatience_scan_reference(inter, service, tau):
    """inter, service: [n, lanes] float64 inter-arrival and service times;
    tau: [lanes] float64 patience.  Returns (waits [n, lanes] float64,
    lost [n, lanes] bool): v = max(0, v - a); lost = v >= tau; wait =
    tau if lost else v; v += s unless lost."""
    n, lanes = inter.shape
    v = torch.zeros(lanes, dtype=torch.float64, device=inter.device)
    waits = torch.empty_like(inter)
    lost = torch.empty(inter.shape, dtype=torch.bool, device=inter.device)
    for i in range(n):
        v = torch.clamp(v - inter[i], min=0.0)
        gone = v >= tau
        waits[i] = torch.where(gone, tau, v)
        lost[i] = gone
        v = torch.where(gone, v, v + service[i])
    return waits, lost
