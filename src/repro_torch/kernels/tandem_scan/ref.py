"""Plain PyTorch version of the memory-gated tandem loop (kernel S7): the
reference's ``repro.core.fastsim._tandem_loop`` transcribed lane by lane,
one step a batch, with ``torch.searchsorted`` over the lane's arrivals,
footprint prefix sums and release ledger.  The wrapper runs it for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it.

The clocks are Python floats (IEEE float64, each product and sum rounded
on its own), in the order of the NumPy oracle
(:func:`repro_torch.core.memory.tandem_oracle`), so the result equals the
oracle bit for bit; nothing is contracted into a fused multiply-add."""

from __future__ import annotations

import math

import torch


def _right(seq, x) -> int:
    return int(torch.searchsorted(seq, x, right=True))


def _left(seq, x) -> int:
    return int(torch.searchsorted(seq, x, right=False))


def tandem_scan_reference(arr, tok, fp_cum, cap, b_max, k1, k2, k3, k4):
    """arr, tok: [L, lanes] float64 sorted arrivals and output tokens, a
    lane's rows past its requests +inf arrivals; fp_cum: [L + 1, lanes]
    float64 footprint prefix sums (0 first, +inf past the lane's
    requests); cap, b_max: [lanes] float64.  Returns (starts, ends, dends,
    nb, blocked, blocked_t, deferred): per batch j < nb[lane] its start,
    end index and decode end ([L, lanes] float64, int64, float64; rows
    from nb on are 0), and per lane the batch count, the blocked batches,
    the blocked time and the deferred requests ([lanes] int64, int64,
    float64, int64).  See ``csrc/tandem_scan.cu``."""
    L, lanes = arr.shape
    f64 = dict(dtype=torch.float64, device=arr.device)
    i64 = dict(dtype=torch.int64, device=arr.device)
    starts, dends = torch.zeros(L, lanes, **f64), torch.zeros(L, lanes, **f64)
    ends = torch.zeros(L, lanes, **i64)
    nbs, blocks, defers = (torch.zeros(lanes, **i64) for _ in range(3))
    blocked_ts = torch.zeros(lanes, **f64)
    for lane in range(lanes):
        a_l = arr[:, lane].contiguous()
        t_l = tok[:, lane]
        f_l = fp_cum[:, lane].contiguous()
        n = int((a_l < math.inf).sum())
        M, bm = float(cap[lane]), float(b_max[lane])
        b_cap = L if bm >= L else int(bm)
        # the release ledger: a batch's members all free at its decode end
        rel_t = torch.full((L,), math.inf, **f64)
        rel_cum = torch.full((L + 1,), math.inf, **f64)
        rel_cum[0] = 0.0
        head, nb, blocked, deferred = 0, 0, 0, 0
        t_pf = t_dec = blocked_t = 0.0
        while head < n:
            a = float(a_l[head])
            idle = a >= t_pf
            start0 = a if idle else t_pf
            hi = head + 1 if idle else min(_right(a_l, t_pf), head + b_cap)
            # releases banked by the candidate start
            target = M + float(rel_cum[_right(rel_t, start0)])
            first = float(f_l[head + 1])
            if first <= target:
                start = start0
            else:
                # delayed start: the earliest release instant freeing `need`
                rs = _left(rel_cum, first - M)
                start = float(rel_t[max(rs - 1, 0)])
                target = M + float(rel_cum[_right(rel_t, start)])
                blocked += 1
                blocked_t += start - start0
            # longest admissible prefix over the footprint prefix sums
            e = max(min(hi, _right(f_l, target) - 1), head + 1)
            deferred += hi - e
            # tandem service: prefill, then decode from max(p_end, t_dec)
            bf = float(e - head)
            rm = float(t_l[head:e].max())
            pf = k1 * bf + k2
            h = k1 * bf + k2 + (k3 * bf + k4) * rm
            p_end = start + pf
            d_end = max(p_end, t_dec) + (h - pf)
            starts[nb, lane], ends[nb, lane], dends[nb, lane] = start, e, d_end
            rel_t[nb] = d_end
            rel_cum[nb + 1] = f_l[e]
            nb += 1
            head, t_pf, t_dec = e, p_end, d_end
        nbs[lane], blocks[lane], defers[lane] = nb, blocked, deferred
        blocked_ts[lane] = blocked_t
    return starts, ends, dends, nbs, blocks, blocked_ts, defers
