"""Inference latency models: a copy of the part of
``repro.core.latency_model`` the control plane uses (paper §II-B/C).

Single request (paper Fig 2a):        S(n)    = a*n + c
Batched inference (paper Eq 18):      H(b, l) = k1*b + k2 + (k3*b + k4)*l

The least-squares calibration of the constants on the card is ROADMAP.md
M4; until then callers pass the constants in.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """S = a*n + c  (seconds; n = output tokens)."""

    a: float
    c: float

    def service_time(self, n):
        return self.a * np.asarray(n, np.float64) + self.c

    def moments(self, dist, n_max: int = None):
        """E[S], E[S^2] under optional clipping (paper Eqs 4-5)."""
        if n_max is None:
            m1, m2 = dist.mean(), dist.second_moment()
        else:
            m1, m2 = dist.clipped_moments(n_max)
        es = self.a * m1 + self.c
        es2 = es ** 2 + self.a ** 2 * (m2 - m1 ** 2)
        return es, es2


@dataclasses.dataclass(frozen=True)
class BatchLatencyModel:
    """H(b, l) = k1*b + k2 + (k3*b + k4)*l   (paper Eq 18).

    k1*b + k2     : first-token (prefill) time, linear in batch size
    (k3*b + k4)*l : per-output-token decode time, linear in batch size,
                    l = max output tokens in the batch (padding semantics)
    """

    k1: float
    k2: float
    k3: float
    k4: float

    def batch_time(self, b, l):
        b = np.asarray(b, np.float64)
        l = np.asarray(l, np.float64)
        return self.k1 * b + self.k2 + (self.k3 * b + self.k4) * l

    def mean_batch_time(self, dist, b):
        """H^[b] = k1 b + k2 + (k3 b + k4) E[L_b]  (paper Eq 19/24)."""
        el = dist.max_order_stat_mean(b)
        return self.batch_time(b, el)

    def linear_envelope(self, dist, mode: str = "envelope",
                        b_range=None, quantile: float = 1.0):
        """(alpha, beta) with H^[b] <= alpha*b + beta, for Inoue's bound
        (paper Eq 20 for the uniform case; generalizes via L_inf)."""
        if mode == "envelope":
            linf = dist.max_order_stat_limit(quantile)
            return self.k1 + self.k3 * linf, self.k2 + self.k4 * linf
        bs = np.asarray(b_range if b_range is not None else np.arange(1, 129))
        h = self.mean_batch_time(dist, bs)
        # least-squares line, then shift up to dominate (exact envelope)
        A = np.stack([bs, np.ones_like(bs)], axis=1).astype(np.float64)
        coef, *_ = np.linalg.lstsq(A, h, rcond=None)
        alpha, beta = float(coef[0]), float(coef[1])
        beta += float(np.max(h - (alpha * bs + beta)))
        return alpha, beta
