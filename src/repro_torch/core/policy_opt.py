"""Optimal max-token limit (paper §III-C, Eqs 10-13): a copy of
``repro.core.policy_opt``.

V1 (all users patient):     V1(n_max) = theta*E[u|n_max] - (1-theta)*E[W(n_max)]
V2 (impatient users):       V2(n_max) = theta*E[u|n_max] - (1-theta)*E[Wq(n_max)]
                                        - pi(n_max)*loss_cost

Note: the paper's Eq (11) prints "+(1-theta)E[W]"; a positive delay reward
contradicts Eq (10) and §V-B's discussion ("optimal limit decreases delay"),
so the evident sign (-) is implemented, as in the reference.
"""

from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import LatencyModel
from repro_torch.core.mg1 import mg1_wait
from repro_torch.core.impatience import dekok_tijms, exact_impatience


@dataclasses.dataclass(frozen=True)
class TokenLimitChoice:
    n_max: int
    objective: float
    utility: float
    wait: float
    loss_frac: float
    curve: dict


def optimize_token_limit_v1(dist: TokenDistribution, lat: LatencyModel,
                            lam: float, theta: float,
                            grid=None) -> TokenLimitChoice:
    """Paper Eqs (10)/(12)-(13) with patient users (M/G/1 wait)."""
    if grid is None:
        grid = np.unique(np.linspace(1, dist.max_tokens, 256).astype(int))
    utils, waits, vals = [], [], []
    for n in grid:
        u = dist.utility_after_clip(int(n))
        w = mg1_wait(dist, lat, lam, int(n)).wait
        utils.append(u)
        waits.append(w)
        vals.append(theta * u - (1.0 - theta) * (w if np.isfinite(w) else 1e12))
    i = int(np.argmax(vals))
    return TokenLimitChoice(
        n_max=int(grid[i]), objective=float(vals[i]), utility=float(utils[i]),
        wait=float(waits[i]), loss_frac=0.0,
        curve={"grid": np.asarray(grid), "objective": np.asarray(vals),
               "utility": np.asarray(utils), "wait": np.asarray(waits)})


def optimize_token_limit_v2(dist: TokenDistribution, lat: LatencyModel,
                            lam: float, theta: float, tau: float,
                            loss_cost: float, grid=None,
                            solver: str = "dekok") -> TokenLimitChoice:
    """Paper Eq (11): impatient users; pi and E[Wq] from the chosen solver
    ('dekok' = paper's interpolation, 'exact' = level-crossing)."""
    if grid is None:
        grid = np.unique(np.linspace(1, dist.max_tokens, 128).astype(int))
    fn = dekok_tijms if solver == "dekok" else exact_impatience
    utils, waits, losses, vals = [], [], [], []
    for n in grid:
        u = dist.utility_after_clip(int(n))
        r = fn(dist, lat, lam, tau, int(n))
        utils.append(u)
        waits.append(r.wq_all)
        losses.append(r.pi)
        vals.append(theta * u - (1.0 - theta) * r.wq_all - r.pi * loss_cost)
    i = int(np.argmax(vals))
    return TokenLimitChoice(
        n_max=int(grid[i]), objective=float(vals[i]), utility=float(utils[i]),
        wait=float(waits[i]), loss_frac=float(losses[i]),
        curve={"grid": np.asarray(grid), "objective": np.asarray(vals),
               "utility": np.asarray(utils), "wait": np.asarray(waits),
               "loss": np.asarray(losses)})
