"""Inference latency models and their calibration (paper §II-B/C, Fig 2):
a copy of ``repro.core.latency_model``.

Single request (paper Fig 2a):        S(n)    = a*n + c
Batched inference (paper Eq 18):      H(b, l) = k1*b + k2 + (k3*b + k4)*l
Elastic batch completion (Eq 26):     H_el    = k1*b + k2 + k3*sum(n_i) + k4*max(n_i)

``fit_*`` calibrate the constants from engine measurements by least
squares; ``chip_smoke.py`` (phase 7) fits k1..k4 on the H100 from the
engine's ``calibration_log``.
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


# Back-derived A100 / LLaMA-2-7b-chat constants from the paper's Table I:
# (128,512)->12.63s and (128,1024)->23.47s give a=(23.47-12.63)/512=0.0212,
# c = 12.63 - 512a = 1.79. Used to reproduce the paper's Fig 4 numbers.
PAPER_A100_LLAMA2_7B = LatencyModel(a=0.021171875, c=1.79)


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

    def prefill_time(self, b):
        """The first-token term k1*b + k2."""
        return self.k1 * np.asarray(b, np.float64) + self.k2

    def decode_time(self, b, l):
        """The per-token term (k3*b + k4)*l, so batch_time == prefill_time +
        decode_time exactly (Eq 18)."""
        b = np.asarray(b, np.float64)
        return (self.k3 * b + self.k4) * np.asarray(l, np.float64)

    def elastic_batch_time(self, ns):
        """Paper Eq (26): completion time of the slowest member when short
        replies exit early. ns: array of per-request output token counts."""
        ns = np.sort(np.asarray(ns, np.float64))
        b = len(ns)
        return self.k1 * b + self.k2 + self.k3 * ns.sum() + self.k4 * ns[-1]

    def elastic_completion_times(self, ns):
        """Per-request completion offsets within an elastic batch (sorted
        ascending): request j completes at
        k1*b + k2 + sum_{i<=j} (k3*(b-i) + k4) * (n_i - n_{i-1})."""
        ns = np.sort(np.asarray(ns, np.float64))
        b = len(ns)
        diffs = np.diff(np.concatenate([[0.0], ns]))
        rates = self.k3 * (b - np.arange(b)) + self.k4
        return self.k1 * b + self.k2 + np.cumsum(rates * diffs)

    def mean_batch_time(self, dist, b):
        """H^[b] = k1 b + k2 + (k3 b + k4) E[L_b]  (paper Eq 19/24)."""
        el = dist.max_order_stat_mean(b)
        return self.batch_time(b, el)

    def service_rate(self, dist, b):
        """mu^[b] = b / H^[b]  (paper Eq 24)."""
        b_arr = np.atleast_1d(np.asarray(b, np.float64))
        return b_arr / np.atleast_1d(self.mean_batch_time(dist, b_arr))

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


# ----------------------------------------------------------------------------
# Calibration
# ----------------------------------------------------------------------------

def fit_latency_model(tokens, seconds) -> LatencyModel:
    """Least-squares fit S = a*n + c (paper Fig 2a)."""
    n = np.asarray(tokens, np.float64)
    t = np.asarray(seconds, np.float64)
    A = np.stack([n, np.ones_like(n)], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    return LatencyModel(a=float(coef[0]), c=float(max(coef[1], 0.0)))


def fit_batch_latency_model(bs, ls, seconds) -> BatchLatencyModel:
    """Least-squares fit of Eq (18) from (batch, max_tokens, time) triples."""
    b = np.asarray(bs, np.float64)
    l = np.asarray(ls, np.float64)
    t = np.asarray(seconds, np.float64)
    A = np.stack([b, np.ones_like(b), b * l, l], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    k1, k2, k3, k4 = (float(max(c, 0.0)) for c in coef)
    return BatchLatencyModel(k1, k2, k3, k4)


def linear_fit_r2(x, y) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return 1.0 - ss_res / max(ss_tot, 1e-12)
