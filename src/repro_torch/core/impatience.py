"""M/G/1 with impatient users (paper §III-B, Eqs 6-9): a copy of
``repro.core.impatience``.

Users abandon if their queueing wait would exceed ``tau``. Two solvers:

1. ``dekok_tijms`` — the paper's approach: interpolate between the
   deterministic-service and exponential-service endpoints with the squared
   coefficient of variation zeta^2 (De Kok & Tijms 1985, Eqs 6-8), requiring
   0 <= zeta^2 <= 1.

2. ``exact_impatience`` — the stationary virtual waiting time density of
   M/G/1+D satisfies the level-crossing Volterra equation

       f(x) = lam * [ P0 * Bbar(x) + int_0^{min(x,tau)} f(y) Bbar(x-y) dy ]

   which is linear in P0; ``level_crossing`` solves u = f/P0 by forward
   substitution on a grid and normalizes.  Works for ANY service
   distribution (including the actual clipped token-latency law) with no
   zeta^2 restriction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import LatencyModel


@dataclasses.dataclass(frozen=True)
class ImpatienceResult:
    lam: float
    tau: float
    pi: float            # loss fraction pi(tau)
    wq_all: float        # E[W_q]: served + lost users  (lost wait tau)
    wq_served: float     # E[W_qs]
    p0: float            # P(V = 0)
    rho_offered: float   # lam * E[S]


def _service_survival_from_dist(dist: TokenDistribution, lat: LatencyModel,
                                n_max: Optional[int]):
    d = dist if n_max is None else dist.clip(n_max)
    atoms = lat.service_time(d.support)       # sorted ascending
    cdf = d.cdf

    def surv(u):
        # P(S > u): S takes value atoms[n] w.p. pmf[n]
        idx = np.searchsorted(atoms, u, side="right") - 1
        idx = np.clip(idx, -1, len(cdf) - 1)
        out = np.where(idx < 0, 1.0, 1.0 - cdf[np.maximum(idx, 0)])
        return out

    s_max = float(atoms[-1])
    return surv, s_max


def level_crossing(surv: Callable, lam: float, tau: float, s_max: float,
                   h: float = None) -> ImpatienceResult:
    """Solve the M/G/1+D virtual-wait density; see module docstring."""
    x_max = tau + s_max + 1e-9
    if h is None:
        h = max(x_max / 8000.0, 1e-4)
    n = int(np.ceil(x_max / h)) + 1
    xs = np.arange(n) * h
    i_tau = min(int(np.floor(tau / h)), n - 1)
    bbar = np.asarray(surv(xs), np.float64)

    trapz = np.trapezoid if hasattr(np, "trapezoid") else np.trapz

    u = np.zeros(n)
    u[0] = lam * bbar[0]
    denom = 1.0 - lam * h * 0.5 * bbar[0]
    for i in range(1, n):
        jmax = min(i, i_tau)
        # trapezoid sum of u_j * bbar_{i-j} over j = 0..jmax (known part)
        acc = 0.5 * u[0] * bbar[i]
        if jmax >= 2:
            js = np.arange(1, jmax)
            acc += float(u[js] @ bbar[i - js])
        if jmax == i:
            # endpoint j == i involves the unknown u_i: solve implicitly
            u[i] = lam * (bbar[i] + h * acc) / denom
        else:
            acc += 0.5 * u[jmax] * bbar[i - jmax]
            u[i] = lam * (bbar[i] + h * acc)
    # normalize: P0 * (1 + int u) = 1
    integral_u = float(trapz(u, dx=h))
    p0 = 1.0 / (1.0 + integral_u)
    f = p0 * u
    # loss fraction: P(V >= tau)
    pi = float(trapz(f[i_tau:], dx=h))
    head_x = float(trapz(f[: i_tau + 1] * xs[: i_tau + 1], dx=h))
    wq_all = head_x + tau * pi
    p_served = max(1.0 - pi, 1e-12)
    wq_served = (wq_all - tau * pi) / p_served
    return ImpatienceResult(lam=lam, tau=tau, pi=pi, wq_all=wq_all,
                            wq_served=wq_served, p0=p0,
                            rho_offered=float("nan"))


def exact_impatience(dist: TokenDistribution, lat: LatencyModel, lam: float,
                     tau: float, n_max: Optional[int] = None,
                     h: float = None) -> ImpatienceResult:
    """Level-crossing solve with the actual (clipped) service distribution."""
    surv, s_max = _service_survival_from_dist(dist, lat, n_max)
    res = level_crossing(surv, lam, tau, s_max, h)
    es, _ = lat.moments(dist, n_max)
    return dataclasses.replace(res, rho_offered=lam * es)


def mm1_impatience_closed_form(lam: float, mu: float, tau: float) -> ImpatienceResult:
    """Closed-form M/M/1+D endpoint (unit-test oracle).

    f(x) = lam*P0*e^{-(mu-lam)x} on (0,tau); lam*P0*e^{lam*tau}e^{-mu x} beyond.
    """
    rho = lam / mu
    d = mu - lam
    if abs(d) < 1e-12:
        d = 1e-12
    e = np.exp(-d * tau)
    z = 1.0 + (rho / (1.0 - rho)) * (1.0 - e) + rho * e if rho != 1.0 else np.inf
    p0 = 1.0 / z
    pi = rho * p0 * e
    # E[min(V,tau)] = P0 * int_0^tau x lam e^{-dx} dx + tau*pi
    integ = lam * (1.0 - e * (1.0 + d * tau)) / d ** 2
    wq_all = p0 * integ + tau * pi
    wq_served = (wq_all - tau * pi) / max(1.0 - pi, 1e-12)
    return ImpatienceResult(lam=lam, tau=tau, pi=pi, wq_all=wq_all,
                            wq_served=wq_served, p0=p0, rho_offered=rho)


def dekok_tijms(dist: TokenDistribution, lat: LatencyModel, lam: float,
                tau: float, n_max: Optional[int] = None,
                h: float = None) -> ImpatienceResult:
    """Paper Eqs (6)-(9): zeta^2 interpolation between det and exp endpoints."""
    es, es2 = lat.moments(dist, n_max)
    zeta2 = (es2 - es ** 2) / max(es ** 2, 1e-300)
    zeta2 = float(np.clip(zeta2, 0.0, 1.0))   # approximation's validity range

    mu = 1.0 / es
    # deterministic endpoint: service == es
    det = level_crossing(lambda u: (u < es).astype(np.float64), lam, tau, es, h)
    # exponential endpoint (closed form; also available via the solver)
    ex = mm1_impatience_closed_form(lam, mu, tau)

    pi = (1.0 - zeta2) * det.pi + zeta2 * ex.pi
    wq_all = (1.0 - zeta2) * det.wq_all + zeta2 * ex.wq_all
    wq_served = (wq_all - tau * pi) / max(1.0 - pi, 1e-12)   # Eq (9)
    return ImpatienceResult(lam=lam, tau=tau, pi=pi, wq_all=wq_all,
                            wq_served=wq_served,
                            p0=(1.0 - zeta2) * det.p0 + zeta2 * ex.p0,
                            rho_offered=lam * es)
