"""Plain PyTorch version of the virtual-backlog routing scan (kernel S6):
the recursion of the reference's ``repro.core.fastsim._backlog_scan`` and
``_masked_backlog_scan`` in PyTorch ops, a Python loop over requests,
vectorised over lanes and replicas.  The wrapper runs it for CPU tensors;
the tests and ``chip_smoke.py`` hold the kernel against it."""

from __future__ import annotations

import math

import torch


def backlog_scan_reference(arr, work, R: int, up=None):
    """arr, work: [n, lanes] float64 arrival times and work estimates;
    ``up``: [n, R, lanes] uint8 availability mask or None (every replica
    up).  Returns [n, lanes] int64 replica ids (see
    ``csrc/backlog_scan.cu``).  ``torch.argmin`` returns the first index
    among equal minima, as ``np.argmin`` does; a row with every replica
    down is all +inf and routes to replica 0."""
    n, lanes = arr.shape
    dev = arr.device
    v = torch.zeros((lanes, R), dtype=torch.float64, device=dev)
    t_prev = torch.zeros(lanes, dtype=torch.float64, device=dev)
    out = torch.empty((n, lanes), dtype=torch.int64, device=dev)
    rows = torch.arange(lanes, device=dev)
    for i in range(n):
        a = arr[i]
        v = torch.clamp_min(v - (a - t_prev)[:, None], 0.0)
        t_prev = a
        key = v if up is None else torch.where(up[i].T.bool(), v, math.inf)
        r = torch.argmin(key, dim=1)
        v[rows, r] += work[i]
        out[i] = r
    return out
