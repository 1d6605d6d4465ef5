"""Output-token length distributions: a copy of
``repro.core.distributions`` (the base class, the lognormal, uniform,
truncated Gaussian, deterministic and geometric families and the empirical
estimator).

Token counts are discrete; every distribution exposes a pmf over the integer
grid ``0..support`` plus the derived quantities the paper's analysis needs:

  * clipped moments under a max-token limit ``n_max``            (Eqs 2-3)
  * the maximum order statistic E[L | batch size b]              (Eq 23)
  * sampling (for the simulators and the engine workloads): one
    ``rng.choice`` over the pmf, so equal seeds draw equal token counts in
    both packages

Continuous families (lognormal / truncated Gaussian) are discretized by CDF
differences on integers, which is exactly how token counts realize them.
"""

from __future__ import annotations

import numpy as np
from scipy import stats


class TokenDistribution:
    """Base: subclasses fill ``self._pmf`` (numpy array over 0..support)."""

    name = "base"

    def __init__(self, pmf: np.ndarray):
        pmf = np.asarray(pmf, np.float64)
        pmf = np.clip(pmf, 0.0, None)
        s = pmf.sum()
        if not s > 0:
            raise ValueError("a token distribution needs positive mass")
        self._pmf = pmf / s
        self._cdf = np.cumsum(self._pmf)
        self._support = np.arange(len(pmf))

    # ------------------------------------------------------------------
    @property
    def pmf(self) -> np.ndarray:
        return self._pmf

    @property
    def cdf(self) -> np.ndarray:
        return self._cdf

    @property
    def support(self) -> np.ndarray:
        return self._support

    @property
    def max_tokens(self) -> int:
        return len(self._pmf) - 1

    def mean(self) -> float:
        return float((self._support * self._pmf).sum())

    def second_moment(self) -> float:
        return float((self._support.astype(np.float64) ** 2 * self._pmf).sum())

    def var(self) -> float:
        return self.second_moment() - self.mean() ** 2

    # ------------------------------------------------------------------
    # Paper Eqs (2)-(3): moments under max-token clipping
    def clipped_moments(self, n_max: int):
        """E[n_req], E[n_req^2] with outputs clipped at n_max."""
        n_max = int(n_max)
        if n_max >= self.max_tokens:
            return self.mean(), self.second_moment()
        n = self._support[:n_max]
        head_p = self._pmf[:n_max]
        tail = 1.0 - self._cdf[n_max - 1]
        m1 = float((n * head_p).sum() + n_max * tail)
        m2 = float((n.astype(np.float64) ** 2 * head_p).sum() + n_max ** 2 * tail)
        return m1, m2

    def clip(self, n_max: int) -> "TokenDistribution":
        """The distribution of min(N, n_max)."""
        n_max = int(n_max)
        if n_max >= self.max_tokens:
            return TokenDistribution(self._pmf.copy())
        pmf = self._pmf[: n_max + 1].copy()
        pmf[n_max] += 1.0 - self._cdf[n_max]
        return TokenDistribution(pmf)

    # ------------------------------------------------------------------
    # Paper Eq (23): E[L] = E[max of b iid draws]; discrete identity
    # E[L] = sum_{x>=0} (1 - F(x)^b).
    def max_order_stat_mean(self, b) -> np.ndarray:
        b = np.atleast_1d(np.asarray(b, np.float64))
        surv = 1.0 - self._cdf[None, :] ** b[:, None]
        out = surv.sum(axis=1)
        return out if out.size > 1 else float(out[0])

    def max_order_stat_limit(self, quantile: float = 1.0) -> float:
        """Upper bound used for linear envelopes: the (quantile-)max support."""
        if quantile >= 1.0:
            return float(self.max_tokens)
        return float(np.searchsorted(self._cdf, quantile))

    # ------------------------------------------------------------------
    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        return rng.choice(len(self._pmf), size=size, p=self._pmf)

    def utility_after_clip(self, n_max: int) -> float:
        """Paper Eq (10): E[u | n_max], u = 1 if n<=n_max else 1-(n-n_max)/n."""
        n_max = int(n_max)
        if n_max >= self.max_tokens:
            return 1.0
        n = self._support[n_max + 1:]
        tail_p = self._pmf[n_max + 1:]
        head = self._cdf[n_max]
        u_tail = (1.0 - (n - n_max) / np.maximum(n, 1)) * tail_p
        return float(head + u_tail.sum())


# ----------------------------------------------------------------------------


class LogNormalTokens(TokenDistribution):
    """Heavy-tailed family used throughout the paper (log mean 7, log std 0.7)."""

    name = "lognormal"

    def __init__(self, log_mean: float = 7.0, log_std: float = 0.7,
                 support: int = 32768):
        self.log_mean, self.log_std = log_mean, log_std
        d = stats.lognorm(s=log_std, scale=np.exp(log_mean))
        grid = np.arange(support + 1, dtype=np.float64)
        cdf = d.cdf(grid + 0.5)
        pmf = np.diff(np.concatenate([[0.0], cdf]))
        pmf[-1] += 1.0 - cdf[-1]
        pmf[0] = 0.0   # zero-token replies don't occur
        super().__init__(pmf)


class UniformTokens(TokenDistribution):
    """Uniform lo..m (paper §IV-B1 / Fig 5)."""

    name = "uniform"

    def __init__(self, m: int = 1000, lo: int = 0):
        pmf = np.zeros(m + 1)
        pmf[lo:] = 1.0
        super().__init__(pmf)
        self.m = m


class TruncGaussianTokens(TokenDistribution):
    """Truncated Gaussian on [0, inf) (paper §IV-B2, Eqs 21-22)."""

    name = "trunc_gaussian"

    def __init__(self, mean: float = 800.0, std: float = 20.0,
                 support: int = None):
        support = int(support or (mean + 8 * std))
        a = (0.0 - mean) / std
        d = stats.truncnorm(a, np.inf, loc=mean, scale=std)
        grid = np.arange(support + 1, dtype=np.float64)
        cdf = d.cdf(grid + 0.5)
        pmf = np.diff(np.concatenate([[0.0], cdf]))
        pmf[-1] += 1.0 - cdf[-1]
        super().__init__(pmf)
        self.mu, self.sigma = mean, std


class DeterministicTokens(TokenDistribution):
    name = "deterministic"

    def __init__(self, n: int):
        pmf = np.zeros(n + 1)
        pmf[n] = 1.0
        super().__init__(pmf)


class GeometricTokens(TokenDistribution):
    """Memoryless discrete analogue of exponential service."""

    name = "geometric"

    def __init__(self, mean: float, support: int = None):
        p = 1.0 / mean
        support = int(support or mean * 12)
        n = np.arange(support + 1, dtype=np.float64)
        pmf = p * (1 - p) ** np.maximum(n - 1, 0)
        pmf[0] = 0.0
        super().__init__(pmf)


class EmpiricalTokens(TokenDistribution):
    """Built from observed output lengths (the control plane's estimator)."""

    name = "empirical"

    def __init__(self, samples, support: int = None):
        samples = np.asarray(samples, np.int64)
        support = int(support or samples.max())
        pmf = np.bincount(np.clip(samples, 0, support), minlength=support + 1)
        super().__init__(pmf.astype(np.float64))
