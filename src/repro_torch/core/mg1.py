"""M/G/1 FCFS queueing delay with max-token clipping (paper §III-A, Eqs
1-5), and its feedback form for re-entrant sessions: a copy of
``repro.core.mg1``.

The Pollaczek-Khinchine mean waiting time

    E[W] = lambda * E[S^2] / (2 * (1 - rho)),   rho = lambda * E[S]

with the service time S = a*n + c driven by the (clipped) output-token
distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import LatencyModel


@dataclasses.dataclass(frozen=True)
class MG1Result:
    lam: float
    n_max: Optional[int]
    es: float          # E[S]
    es2: float         # E[S^2]
    rho: float
    wait: float        # E[W] queueing delay (excluding service)
    sojourn: float     # E[W] + E[S]
    stable: bool
    scv: float         # squared coefficient of variation zeta^2 (Eq 8)


def pollaczek_khinchine(lam: float, es: float, es2: float) -> float:
    rho = lam * es
    if rho >= 1.0:
        return np.inf
    return lam * es2 / (2.0 * (1.0 - rho))


def mg1_wait(dist: TokenDistribution, lat: LatencyModel, lam: float,
             n_max: Optional[int] = None) -> MG1Result:
    """Paper Eqs (1)-(5): queueing delay under a max-token limit n_max."""
    es, es2 = lat.moments(dist, n_max)
    rho = lam * es
    wait = pollaczek_khinchine(lam, es, es2)
    scv = (es2 - es ** 2) / max(es ** 2, 1e-300)
    return MG1Result(lam=lam, n_max=n_max, es=es, es2=es2, rho=rho,
                     wait=wait, sojourn=wait + es, stable=rho < 1.0, scv=scv)


def wait_curve(dist: TokenDistribution, lat: LatencyModel, lam: float,
               n_max_grid) -> np.ndarray:
    """E[W] as a function of the max-token limit (paper Fig 4a)."""
    return np.array([mg1_wait(dist, lat, lam, int(n)).wait for n in n_max_grid])


def mg1_feedback_wait(dist: TokenDistribution, lat: LatencyModel, lam: float,
                      sessions, n_max: Optional[int] = None) -> MG1Result:
    """M/G/1 with feedback (re-entrant sessions): a session of K turns
    visits the queue K times, so the server sees the effective arrival
    rate λ_eff = λ·E[K] with unchanged per-visit service moments.
    Takács' feedback decomposition reduces the per-visit mean wait to
    P-K at λ_eff (exact for Poisson re-entry; the think-time delays of
    :mod:`repro_torch.core.sessions` push re-arrivals toward Poisson, the
    Kleinrock independence approximation).  ``sessions`` is a session
    model, name, or spec; stability is ρ_eff = λ·E[K]·E[S] < 1."""
    from repro_torch.core.sessions import session_from_spec
    model = session_from_spec(sessions)
    return mg1_wait(dist, lat, lam * model.mean_turns(), n_max)
