"""Adaptive control plane: a copy of ``repro.core.control``'s
``AdaptiveController`` with no KV budget.

``AdaptiveController`` watches the live request stream (arrival times,
completed output-token counts), maintains an empirical output-token
distribution and arrival-rate estimate, and derives the serving
configuration from the paper's models:

  * ``n_max``  — optimal max-token limit (V1 or V2, Eqs 10-13)
  * ``b_max``  — optimal dynamic-batching cap: b* from the M/D^b/1 analysis
                 when the tail is heavy (paper §IV-C finding), unbounded for
                 light tails
  * ``policy`` — 'elastic' when the engine supports early-exit batching
                 (minimal delay for every distribution, paper §IV-D);
                 otherwise 'multibin' for heavy tails (binning by length
                 recovers most of elastic's win under padded decode,
                 Guldogan et al. 2024) and 'dynamic' for light tails
  * ``bin_edges`` — load-dependent multi-bin boundaries
                 (:func:`repro_torch.core.bulk.optimize_bin_edges`) whenever
                 the recommended policy is 'multibin'
  * ``predictor`` — which length predictor
                 (:mod:`repro_torch.core.predictors` registry name) should
                 feed the recommended policy's length-based routing; set
                 whenever the policy or router consumes predicted lengths
                 ('multibin', 'least_work'), None otherwise
  * ``replicas`` / ``router`` — the fleet axis
                 (:mod:`repro_torch.core.fleet`): the smallest replica
                 count keeping per-replica batched utilization under
                 ``replica_target_util`` (``fleet.recommend_replicas``),
                 and the router to put in front of it — 'least_work' for
                 heavy tails, 'jsq' otherwise; enabled by
                 ``max_replicas > 1``, and discounted by the availability
                 learned from ``observe_episode``

The serving loop polls ``recommendation()`` between batches; hysteresis
avoids thrashing.  The KV-memory axis (``memory``) is not ported yet
(ROADMAP.md M7d) and raises ``NotImplementedError``; the closed-loop
``simulate_controlled`` is M7e.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.core.bulk import optimal_fixed_batch, optimize_bin_edges
from repro_torch.core.policies import not_ported
from repro_torch.core.distributions import EmpiricalTokens, TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.core.policy_opt import (
    optimize_token_limit_v1, optimize_token_limit_v2)


@dataclasses.dataclass
class Recommendation:
    n_max: Optional[int]
    b_max: Optional[int]
    policy: str
    heavy_tailed: bool
    lam_hat: float
    details: dict
    bin_edges: Optional[tuple] = None   # set when policy == 'multibin'
    predictor: Optional[str] = None     # registry name, when the policy
    #                                     routes on predicted length
    replicas: int = 1                   # fleet size
    router: Optional[str] = None        # fleet router, when replicas > 1
    availability: float = 1.0           # learned replica availability
    shed_prob: float = 0.0              # admission drop prob. keeping the
    #                                     fleet under target util
    memory_budget: Optional[float] = None   # per-replica KV-token capacity


def tail_index(dist: TokenDistribution) -> float:
    """Heavy-tail heuristic: squared coefficient of variation of N."""
    m, v = dist.mean(), dist.var()
    return v / max(m * m, 1e-12)


class AdaptiveController:
    def __init__(self, single_lat: LatencyModel, batch_lat: BatchLatencyModel,
                 *, theta: float = 0.95, tau: Optional[float] = None,
                 loss_cost: float = 4.0, elastic_available: bool = True,
                 window: int = 4096, min_samples: int = 64,
                 heavy_tail_scv: float = 0.5, b_search: int = 64,
                 num_bins: int = 4, length_predictor: str = "oracle",
                 max_replicas: int = 1, replica_target_util: float = 0.7,
                 memory=None):
        if memory is not None:
            not_ported("the controller's KV-memory axis", "M7d (KV memory)")
        # which length predictor backs length-based routing; validated
        # against the registry so recommendations stay actionable
        from repro_torch.core.predictors import PREDICTORS
        if length_predictor not in PREDICTORS:
            raise ValueError(f"length predictor {length_predictor!r} not in "
                             f"{sorted(PREDICTORS)}")
        if max_replicas < 1:
            raise ValueError(f"max_replicas must be >= 1, got {max_replicas}")
        if not 0.0 < replica_target_util < 1.0:
            raise ValueError(f"replica_target_util must be in (0, 1), got "
                             f"{replica_target_util}")
        self.single_lat = single_lat
        self.batch_lat = batch_lat
        self.theta = theta
        self.tau = tau
        self.loss_cost = loss_cost
        self.elastic_available = elastic_available
        self.min_samples = min_samples
        self.heavy_tail_scv = heavy_tail_scv
        self.b_search = b_search
        self.num_bins = num_bins
        self.length_predictor = length_predictor
        self.max_replicas = int(max_replicas)
        self.replica_target_util = float(replica_target_util)
        self._tokens = deque(maxlen=window)
        self._arrivals = deque(maxlen=window)
        self._episodes = deque(maxlen=window)   # (up_seconds, down_seconds)
        self._last: Optional[Recommendation] = None

    # ---------------- stream ingestion ----------------
    def observe_arrival(self, t: float):
        self._arrivals.append(t)

    def observe_completion(self, output_tokens: int):
        self._tokens.append(int(output_tokens))

    def observe_episode(self, up_seconds: float, down_seconds: float):
        """One replica failure/repair renewal cycle: ``up_seconds`` of
        service followed by ``down_seconds`` of repair."""
        self._episodes.append((float(up_seconds), float(down_seconds)))

    def availability_hat(self) -> float:
        """Empirical availability MTBF/(MTBF+MTTR); 1.0 before any
        observed failure (the fault-free prior)."""
        if not self._episodes:
            return 1.0
        up = sum(u for u, _ in self._episodes)
        down = sum(d for _, d in self._episodes)
        return up / max(up + down, 1e-12)

    def shed_probability(self, lam: float, dist) -> float:
        """Admission drop probability keeping the AVAILABLE fleet under
        ``replica_target_util``: per-request marginal work is the elastic
        envelope slope alpha = k1 + k3*E[N] (the same capacity law as
        ``fleet.recommend_replicas``), each of the ``max_replicas``
        replicas contributes ``availability_hat()`` of a server, so shed
        p = max(0, 1 - a*R*target/(lam*alpha))."""
        if lam <= 0 or dist is None:
            return 0.0
        alpha = self.batch_lat.k1 + self.batch_lat.k3 * dist.mean()
        cap = (self.availability_hat() * self.max_replicas
               * self.replica_target_util)
        return float(max(0.0, 1.0 - cap / max(lam * alpha, 1e-12)))

    def lam_hat(self) -> float:
        if len(self._arrivals) < 2:
            return 0.0
        span = self._arrivals[-1] - self._arrivals[0]
        return (len(self._arrivals) - 1) / max(span, 1e-9)

    def empirical_dist(self) -> Optional[TokenDistribution]:
        if len(self._tokens) < self.min_samples:
            return None
        return EmpiricalTokens(list(self._tokens))

    # ---------------- recommendation ----------------
    def recommendation(self, force: bool = False) -> Recommendation:
        dist = self.empirical_dist()
        lam = self.lam_hat()
        if dist is None or lam <= 0:
            return Recommendation(n_max=None, b_max=None,
                                  policy="dynamic", heavy_tailed=False,
                                  lam_hat=lam, details={"reason": "warmup"})

        scv = tail_index(dist)
        heavy = scv > self.heavy_tail_scv

        # optimal token limit (paper Eqs 10-13)
        if self.tau is None:
            ch = optimize_token_limit_v1(dist, self.single_lat, lam, self.theta)
        else:
            ch = optimize_token_limit_v2(dist, self.single_lat, lam,
                                         self.theta, self.tau, self.loss_cost)
        n_max = ch.n_max

        # batching policy (paper §IV conclusions + Guldogan et al. 2024)
        clipped = dist.clip(n_max)
        b_max = None
        policy = "elastic" if self.elastic_available else "dynamic"
        if heavy:
            fb = optimal_fixed_batch(clipped, self.batch_lat, lam,
                                     b_max=self.b_search)
            b_max = fb["b_star"]
            if not self.elastic_available:
                # padded decode pays the full max-token padding on a heavy
                # tail: route by predicted length instead (bin_edges below)
                policy = "multibin"

        # fleet axis (repro_torch.core.fleet): smallest replica count
        # keeping per-replica batched utilization under target; a heavy
        # tail wants length-aware dispatch (predicted-work balancing), a
        # light tail only needs burst balancing
        replicas, router = 1, None
        avail = self.availability_hat()
        if self.max_replicas > 1:
            from repro_torch.core.fleet import ROUTERS, recommend_replicas
            # availability-discounted effective-lambda transfer
            # (faults.effective_lambda): a replica that is up a fraction
            # `avail` of the time sizes like load lam/avail
            replicas = recommend_replicas(
                lam / max(avail, 1e-12), clipped, self.batch_lat,
                target_util=self.replica_target_util,
                max_replicas=self.max_replicas)
            if replicas > 1:
                router = "least_work" if heavy else "jsq"
                assert router in ROUTERS, router

        rec = Recommendation(
            n_max=n_max, b_max=b_max, policy=policy, heavy_tailed=heavy,
            lam_hat=lam, replicas=replicas, router=router,
            availability=avail,
            shed_prob=self.shed_probability(lam, clipped),
            details={"scv": scv, "objective": ch.objective,
                     "expected_wait": ch.wait, "loss_frac": ch.loss_frac,
                     "b_mem": None, "memory_binding": False},
            # multibin and least_work route on predicted length: name the
            # predictor that should feed them
            predictor=(self.length_predictor
                       if policy == "multibin" or router == "least_work"
                       else None))
        # hysteresis: ignore <10% n_max moves (bin_edges revert alongside,
        # so the recommendation stays internally consistent)
        if (not force and self._last is not None
                and self._last.n_max and n_max
                and abs(n_max - self._last.n_max) < 0.1 * self._last.n_max):
            rec = dataclasses.replace(
                rec, n_max=self._last.n_max, b_max=self._last.b_max,
                bin_edges=(self._last.bin_edges
                           if rec.policy == "multibin" else None))
        if rec.policy == "multibin" and rec.bin_edges is None:
            # the coordinate descent is the expensive step: reuse the last
            # edges unless the operating point (n_max, lam) actually moved
            last = self._last
            if (last is not None and last.bin_edges is not None
                    and last.n_max == rec.n_max
                    and abs(lam - last.lam_hat)
                    < 0.1 * max(last.lam_hat, 1e-9)):
                edges = last.bin_edges
            else:
                edges = tuple(optimize_bin_edges(
                    dist.clip(rec.n_max), self.batch_lat, lam,
                    num_bins=self.num_bins))
            rec = dataclasses.replace(rec, bin_edges=edges)
        self._last = rec
        return rec
