"""Adaptive control plane: a copy of ``repro.core.control``'s
``AdaptiveController``.

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
  * ``memory_budget`` — the KV-memory axis (``memory=``,
                 :mod:`repro_torch.core.memory`): b_max is capped at the
                 effective b(M), and where the gate binds formation is
                 throttled to a fixed batch

The serving loop polls ``recommendation()`` between batches; hysteresis
avoids thrashing.  The closed-loop ``simulate_controlled`` is not ported
yet (ROADMAP.md M7e).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.core.bulk import optimal_fixed_batch, optimize_bin_edges
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
    #                                     the recommendation was sized for;
    #                                     b_max is then capped at the
    #                                     effective b(M) (memory.MemoryBudget
    #                                     .max_batch) so recommended batches
    #                                     always fit the budget


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
                 memory=None, memory_quantile: float = 1.0,
                 prefix_discount: float = 0.0):
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
        if not 0.0 < memory_quantile <= 1.0:
            raise ValueError(f"memory_quantile must be in (0, 1], got "
                             f"{memory_quantile}")
        if not 0.0 <= prefix_discount < 1.0:
            raise ValueError(f"prefix_discount must be in [0, 1), got "
                             f"{prefix_discount}")
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
        # KV-memory axis (repro_torch.core.memory): recommendations trade
        # batch size against KV headroom by capping b_max at the effective
        # b(M).  ``prefix_discount`` gamma composes with sessions' KV reuse:
        # a reused prefix holds only (1-gamma) of its prompt tokens, so the
        # per-request footprint shrinks and b(M) grows accordingly.
        from repro_torch.core.memory import memory_from_spec
        budget = memory_from_spec(memory)
        self.memory = None if budget.is_null else budget
        self.memory_quantile = float(memory_quantile)
        self.prefix_discount = float(prefix_discount)
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

        # KV-memory axis (repro_torch.core.memory): trade batch size
        # against KV headroom.  The effective b(M) = floor(M /
        # footprint(L_q)) caps b_max so a recommended batch always FITS the
        # budget.  When the gate BINDS (the tandem bound's memory arm
        # dominates its slack arm), serve-all formation is the wrong
        # discipline: the prefill stage races ahead of decode, fills the
        # budget, and admissions fragment into small poorly-amortized
        # batches.  The controller then throttles formation with a count
        # trigger sized so TWO batches in flight (one decoding, one
        # prefilled) fit worst-case: b_pipe = max(1, b_mem // 2), refined
        # by the fixed-batch optimizer below that cap.  Sessions' prefix
        # reuse (gamma) shrinks the footprint, so a cache-heavy workload
        # earns a larger b(M).
        b_mem = None
        mem_binding = False
        if self.memory is not None:
            from repro_torch.core.bulk import tandem_bound
            budget = self.memory
            if self.prefix_discount > 0.0:
                budget = dataclasses.replace(
                    budget, prompt_tokens=budget.prompt_tokens
                    * (1.0 - self.prefix_discount))
            tb = tandem_bound(clipped, self.batch_lat, lam, memory=budget,
                              quantile=self.memory_quantile)
            b_mem = tb["b_mem"]
            b_max = b_mem if b_max is None else min(b_max, b_mem)
            # the memory arm approaches the slack arm from above as the
            # budget loosens (it carries an extra beta/b_mem amortization
            # term), so "binding" needs a margin, not a plain comparison
            mem_binding = (not tb["stable"]
                           or tb["memory_arm"] >= 1.5 * tb["slack_arm"])
            if mem_binding:
                b_pipe = max(1, b_mem // 2)
                fb = optimal_fixed_batch(clipped, self.batch_lat, lam,
                                         b_max=b_pipe)
                policy = "fixed"
                b_max = fb["b_star"]

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
            memory_budget=(float(self.memory.capacity)
                           if self.memory is not None else None),
            details={"scv": scv, "objective": ch.objective,
                     "expected_wait": ch.wait, "loss_frac": ch.loss_frac,
                     "b_mem": b_mem, "memory_binding": mem_binding},
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
