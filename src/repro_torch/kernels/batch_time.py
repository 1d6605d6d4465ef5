"""The batch end that the plain versions of the batch-event kernels (S3-S5)
share: start + k1*m + k2 + (k3*m + k4)*mx (padded decode, paper Eq 18),
every product and sum its own float64 op, in the NumPy oracle's order, so
nothing is contracted into a fused multiply-add (the kernels round each
with ``__dmul_rn``/``__dadd_rn``)."""

from __future__ import annotations

import torch


def batch_end(start, members: int, mx, k1, k2, k3, k4):
    """``start`` and ``mx`` are float64 0-d tensors; ``members`` the batch's
    size, taken as a float64 as the oracle's ``len(ns)`` is."""
    m = torch.full((), float(members), dtype=torch.float64,
                   device=start.device)
    return start + ((k1 * m + k2) + (k3 * m + k4) * mx)
