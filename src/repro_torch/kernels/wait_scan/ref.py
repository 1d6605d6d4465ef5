"""Plain PyTorch version of the WAIT batch-formation loop (kernel S4): the
loop of the reference's ``repro.core.fastsim._wait_loop`` in PyTorch ops,
a Python loop over lanes and, within a lane, over batches, each batch's
members handled at once.  The wrapper runs it for CPU tensors; the tests
and ``chip_smoke.py`` hold the kernel against it."""

from __future__ import annotations

import torch

from repro_torch.kernels.batch_time import batch_end


def wait_scan_reference(arr, tok, k, timeout, b_max, k1, k2, k3, k4):
    """arr, tok: [n, lanes] float64 sorted arrivals and output tokens; k,
    b_max: [lanes] int64 (k < 1 counts as 1, b_max <= 0 is no cap);
    timeout: [lanes] float64 (+inf for none).  Returns (starts [n, lanes]
    float64, first [n, lanes] bool): each request's batch start, and
    whether it is the head of its batch (see ``csrc/wait_scan.cu``)."""
    n, lanes = arr.shape
    starts = torch.empty_like(arr)
    first = torch.zeros(arr.shape, dtype=torch.bool, device=arr.device)
    for lane in range(lanes):
        a, t = arr[:, lane].contiguous(), tok[:, lane]
        kk = max(int(k[lane]), 1)
        cap = int(b_max[lane])
        cap = cap if 0 < cap < n else n
        t_free = torch.zeros((), dtype=torch.float64, device=arr.device)
        head = 0
        while head < n:
            kth = a[min(head + kk - 1, n - 1)]
            timer = a[head] + timeout[lane]
            trigger = torch.where(timer < kth, timer, kth)
            start = torch.where(trigger > t_free, trigger, t_free)
            hi = int(torch.searchsorted(a, start.reshape(1), right=True))
            hi = max(min(hi, head + cap), head + 1)
            starts[head:hi, lane] = start
            first[head, lane] = True
            t_free = batch_end(start, hi - head, t[head:hi].max(), k1, k2,
                               k3, k4)
            head = hi
    return starts, first
