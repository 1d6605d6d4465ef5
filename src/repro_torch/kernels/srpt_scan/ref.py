"""Plain PyTorch version of the SRPT batch-formation loop (kernel S5): the
loop of the reference's ``repro.core.fastsim._srpt_core`` in PyTorch ops,
a Python loop over lanes and, within a lane, over batches.  Where the
kernel descends a segment tree once per member, this version finds a
batch's members in one pass over the lane: the lowest ranks among the
unserved requests that have arrived by the start.  The wrapper runs it
for CPU tensors; the tests and ``chip_smoke.py`` hold the kernel against
it."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.batch_time import batch_end


def srpt_scan_reference(arr, tok, order, b_max, k1, k2, k3, k4):
    """arr, tok: [n, lanes] float64 arrivals and (true) output tokens;
    order: [n, lanes] int64 requests in rank order (a stable argsort of the
    predicted lengths); b_max: [lanes] int64 (<= 0 is no cap).  Returns
    (starts [n, lanes] float64, first [n, lanes] bool): each request's
    batch start, and whether it was the first member popped into its batch
    (see ``csrc/srpt_scan.cu``)."""
    n, lanes = arr.shape
    dev = arr.device
    starts = torch.empty_like(arr)
    first = torch.zeros(arr.shape, dtype=torch.bool, device=dev)
    for lane in range(lanes):
        cap = int(b_max[lane])
        cap = cap if cap > 0 else n
        o = order[:, lane]
        a, t = arr[o, lane], tok[o, lane]          # rank order
        served = torch.zeros(n, dtype=torch.bool, device=dev)
        s_rank = torch.empty_like(a)
        f_rank = torch.zeros(n, dtype=torch.bool, device=dev)
        t_free = torch.zeros((), dtype=torch.float64, device=dev)
        done = 0
        while done < n:
            root = torch.where(served, math.inf, a).min()
            idle = bool(root > t_free)
            start = root if idle else t_free
            idx = torch.nonzero(~served & (a <= start)).flatten()
            idx = idx[:1 if idle else cap]
            if len(idx) == 0:       # a NaN arrival: nothing can be popped
                break
            s_rank[idx] = start
            f_rank[idx[0]] = True
            served[idx] = True
            t_free = batch_end(start, len(idx), t[idx].max(), k1, k2, k3, k4)
            done += len(idx)
        starts[o, lane] = s_rank
        first[o, lane] = f_rank
    return starts, first
