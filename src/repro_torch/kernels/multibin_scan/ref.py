"""Plain PyTorch version of the multi-bin batch-formation loop (kernel
S3): the loop of the reference's ``repro.core.fastsim._multibin_loop`` in
PyTorch ops, a Python loop over lanes and, within a lane, over batches,
each batch's members handled at once.  The wrapper runs it for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.batch_time import batch_end


def multibin_scan_reference(arr, tok, bins, num_bins, b_max, k1, k2, k3, k4):
    """arr, tok: [n, lanes] float64 sorted arrivals and output tokens;
    bins: [n, lanes] int64 bin of each request, in [0, num_bins); b_max:
    [lanes] int64 (<= 0 is no cap).  Returns (starts [n, lanes] float64,
    first [n, lanes] bool): each request's batch start, and whether it is
    the head of its batch (see ``csrc/multibin_scan.cu``)."""
    n, lanes = arr.shape
    dev = arr.device
    starts = torch.empty_like(arr)
    first = torch.zeros(arr.shape, dtype=torch.bool, device=dev)
    for lane in range(lanes):
        cap = int(b_max[lane])
        cap = cap if cap > 0 else n
        # per-bin member lists in arrival order, and each bin's arrivals,
        # tokens and (filled below) starts
        members = [torch.nonzero(bins[:, lane] == j).flatten()
                   for j in range(num_bins)]
        a_bin = [arr[m, lane].contiguous() for m in members]
        t_bin = [tok[m, lane] for m in members]
        s_bin = [torch.empty_like(a) for a in a_bin]
        f_bin = [torch.zeros(len(a), dtype=torch.bool, device=dev)
                 for a in a_bin]
        heads = [0] * num_bins
        a_head = torch.tensor([math.inf] * num_bins, dtype=torch.float64,
                              device=dev)
        for j, a in enumerate(a_bin):
            if len(a):
                a_head[j] = a[0]
        t_free = torch.zeros((), dtype=torch.float64, device=dev)
        for _ in range(n):
            if all(h == len(a) for h, a in zip(heads, a_bin)):
                break
            j = int(torch.argmin(a_head))      # first of equal heads
            lo, a = heads[j], a_bin[j]
            idle = bool(a_head[j] >= t_free)
            start = a_head[j].clone() if idle else t_free
            hi = lo + 1
            if not idle:
                hi = int(torch.searchsorted(a, t_free.reshape(1), right=True))
                hi = max(min(hi, lo + cap), lo + 1)
            s_bin[j][lo:hi] = start
            f_bin[j][lo] = True
            t_free = batch_end(start, hi - lo, t_bin[j][lo:hi].max(), k1, k2,
                               k3, k4)
            heads[j] = hi
            a_head[j] = a[hi] if hi < len(a) else math.inf
        for m, s, f in zip(members, s_bin, f_bin):
            starts[m, lane] = s
            first[m, lane] = f
    return starts, first
