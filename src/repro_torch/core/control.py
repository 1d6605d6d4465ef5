"""Adaptive control plane: a copy of ``repro.core.control``, the
``AdaptiveController`` and the closed-loop ``simulate_controlled``.

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
avoids thrashing.  ``simulate_controlled`` closes the loop on the
simulators: a windowed fleet whose replicas, router, bin edges and shed
probability the controller re-picks between windows, each window's
replicas run on the policy's kernel (``fast=True``, on ``device``) or on
the NumPy oracle.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

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


# ----------------------------------------------------------------------------
# Closed-loop time-sliced control: the controller ACTS
# ----------------------------------------------------------------------------
#
# ``simulate_controlled`` slices the run into fixed-length windows; after
# each window the controller ingests the window's realized arrivals and
# completions and re-picks the next window's serving configuration:
# ``replicas`` (clamped to powers of two), ``router``, ``bin_edges``
# (multibin) and ``shed_prob``, from the same analytic laws
# ``recommendation()`` uses.
#
# Replica carry across windows rides a SYNTHETIC head request: a replica
# still busy at the window boundary W (busy-until f > W) is modeled by
# prepending a request at W with token count l0 = (f - W - c)/a (single
# law S(n) = a n + c, so its solo service time is exactly f - W).  For
# every carry-safe policy an idle server starts its earliest arrival
# ALONE (``_DynamicFormation`` semantics; SRPT's idle start caps at one;
# multibin picks the synthetic's bin: it is the sole head), so the
# synthetic occupies the server precisely over the carried interval and
# the real requests queue behind it.  When f - W <= c the residual is
# below one prefill and is dropped (the server is treated as free), a
# bounded approximation applied identically to the oracle and fast
# runners, which therefore stay trajectory-equal.  A replica scaled DOWN
# simply stops receiving work and drains its carry.

_CARRY_SAFE = ("fcfs", "dynamic", "elastic", "multibin", "srpt")


def pow2_replicas(r: int, max_replicas: int) -> int:
    """Smallest power of two >= r, clamped to the largest power of two
    <= max_replicas."""
    if max_replicas < 1:
        raise AssertionError(f"max_replicas must be >= 1, got {max_replicas}")
    cap = 1
    while cap * 2 <= max_replicas:
        cap *= 2
    p = 1
    while p < max(r, 1):
        p *= 2
    return min(p, cap)


@dataclasses.dataclass(frozen=True)
class WindowAction:
    """The controller's decision for one window (equal seeds and
    observations yield equal action sequences)."""
    window: int
    t0: float
    t1: float
    replicas: int
    router: str
    shed_prob: float = 0.0
    bin_edges: Optional[tuple] = None


@dataclasses.dataclass
class ControlledResult:
    """One closed-loop run.  ``objective`` is the cost-aware score the
    regret benchmark compares: mean served wait + replica_cost * the
    time-average replica count (+ shed_cost * shed fraction)."""
    waits: np.ndarray            # per request; NaN where shed
    lost: np.ndarray             # shed mask
    actions: List[WindowAction]
    windows: List[dict]
    mean_wait: float
    served: int
    shed: int
    avg_replicas: float
    replica_cost: float
    shed_cost: float
    objective: float


def _carry_backlog_assign(arrivals, work, R: int, v0, t0: float):
    """The state-dependent routers' backlog recursion
    (``fleet._backlog_assign_np``) seeded with each replica's residual
    busy time at the window start; a host loop, as in the reference."""
    v = np.asarray(v0, np.float64).copy()
    t_prev = float(t0)
    out = np.empty(len(arrivals), np.int64)
    for i, (a, w) in enumerate(zip(arrivals, work)):
        v = np.maximum(0.0, v - (a - t_prev))
        t_prev = float(a)
        r = int(np.argmin(v))
        v[r] += w
        out[i] = r
    return out


def _with_bin_edges(policy, bin_edges):
    """Rebuild a multibin policy around the controller's re-picked
    edges; every other policy ignores the knob."""
    if bin_edges is None or policy.name != "multibin":
        return policy
    from repro_torch.core.policies import MultiBinPolicy
    return MultiBinPolicy(edges=bin_edges, n_max=policy.n_max,
                          b_max=policy.b_max, predictor=policy.predictor,
                          bound_quantile=policy.bound_quantile)


def _default_controller(lam: float, window: float, single, batch_lat,
                        policy, max_replicas: int, kw: dict
                        ) -> "AdaptiveController":
    """Controller sized for windowed control: the arrival deque spans
    roughly two windows so ``lam_hat`` tracks the modulation instead of
    the long-run average."""
    kw = dict(kw or {})
    kw.setdefault("window", int(max(128, 2.0 * lam * window)))
    kw.setdefault("min_samples", 32)
    kw.setdefault("max_replicas", max_replicas)
    kw.setdefault("elastic_available", policy.name == "elastic")
    return AdaptiveController(single, batch_lat, **kw)


def simulate_controlled(policy, lam: float, dist, lat, *, traffic=None,
                        num_requests: int = 20_000, seed: int = 0,
                        window: float = 200.0, max_replicas: int = 8,
                        replica_cost: float = 0.0, shed_cost: float = 0.0,
                        router_default: str = "round_robin",
                        controller: Optional[AdaptiveController] = None,
                        controller_kwargs: Optional[dict] = None,
                        fixed: Optional[Tuple[int, str]] = None,
                        clairvoyant: bool = False,
                        candidate_routers: Sequence[str] = (
                            "round_robin", "least_work"),
                        fast: bool = True, device=None) -> ControlledResult:
    """Time-sliced closed-loop fleet control over a (possibly modulated)
    arrival stream: one driver, two runners (``fast``: the kernels on
    ``device``, one launch a replica a window; else the NumPy oracle), so
    both see identical actions and trajectory-equal waits.

    Modes (mutually exclusive):
      * adaptive (default)    ``AdaptiveController`` observes each window
        and re-picks replicas/router/bin_edges/shed_prob for the next one;
        actions are rng-free given the observations.
      * ``fixed=(R, router)`` a static configuration run through the SAME
        windowed machinery (the regret benchmark's baseline).
      * ``clairvoyant=True``  per-window greedy oracle: every (power-of-two
        R, candidate router) pair is simulated on the window's actual
        arrivals from the current carry state and the cheapest (window
        mean wait + replica_cost * R) is committed.

    Windows run under ``no_warmup`` with replica busy-carry via the
    synthetic-head construction above.  ``device`` is the fast runner's
    (None: the card, and an error without one); the oracle takes none."""
    from repro_torch.core.fastsim import simulate_policy_fast
    from repro_torch.core.fleet import recommend_replicas, router_from_spec
    from repro_torch.core.policies import Workload, single_from_batch
    from repro_torch.core.simulate import no_warmup, simulate_policy
    from repro_torch.core.traffic import (
        _SHED_LANE, _traffic_rng, warp_workload)
    from repro_torch.kernels import resolve_device

    if policy.name not in _CARRY_SAFE:
        raise AssertionError(
            f"windowed carry needs idle-start-alone semantics, got "
            f"{policy.name!r} (supported: {_CARRY_SAFE})")
    if getattr(policy, "tau", None) is not None:
        raise AssertionError(
            "impatience is not supported in the windowed driver")
    if fixed is not None and clairvoyant:
        raise AssertionError("fixed= and clairvoyant= are exclusive")
    if not (window > 0.0 and max_replicas >= 1):
        raise AssertionError(f"window {window}, max_replicas {max_replicas}")

    batch_lat = lat if isinstance(lat, BatchLatencyModel) else None
    single = lat if isinstance(lat, LatencyModel) else single_from_batch(lat)
    wl = policy.sample_workload(lam, dist, num_requests, seed)
    wl = warp_workload(wl, traffic, seed)
    arr, tok, pred = wl.arrivals, wl.tokens, wl.predicted
    n = len(arr)
    work = np.asarray(single.service_time(wl.predicted_or_true), np.float64)
    horizon = float(arr[-1]) if n else window
    n_windows = int(horizon // window) + 1

    adaptive = fixed is None and not clairvoyant
    if adaptive:
        if batch_lat is None or dist is None:
            raise AssertionError(
                "adaptive control needs a BatchLatencyModel and a dist")
        if controller is None:
            controller = _default_controller(lam, window, single, batch_lat,
                                             policy, max_replicas,
                                             controller_kwargs)
        r0 = pow2_replicas(recommend_replicas(
            lam, dist, batch_lat,
            target_util=controller.replica_target_util,
            max_replicas=max_replicas), max_replicas)
        cur = (r0, router_default, 0.0, None)
    elif fixed is not None:
        R_fix = pow2_replicas(int(fixed[0]), max_replicas)
        cur = (R_fix, str(fixed[1]), 0.0, None)
    else:
        cand_R = []
        p = 1
        while p <= max_replicas:
            cand_R.append(p)
            p *= 2
        cur = (cand_R[0], str(candidate_routers[0]), 0.0, None)

    if fast:
        device = resolve_device(device)

        def sim(pol, workload):
            return simulate_policy_fast(pol, lam, dist, lat,
                                        workload=workload, device=device)
    else:
        def sim(pol, workload):
            return simulate_policy(pol, lam, dist, lat, workload=workload)

    def _run_window(idx: np.ndarray, t0: float, R: int, router_name: str,
                    bin_edges, free: np.ndarray):
        """Route + simulate one window's requests on R active replicas
        from carry state ``free`` (absolute busy-until per slot, copied
        here: a clairvoyant window tries every pair from the same carry).
        Returns (per-request waits, new free array)."""
        free = free.copy()
        if not len(idx):
            return np.zeros(0), free
        a_w, w_w = arr[idx], work[idx]
        router = router_from_spec(router_name)
        if R == 1:
            rep = np.zeros(len(idx), np.int64)
        elif router.state_dependent:
            rep = _carry_backlog_assign(
                a_w, router._work_units(w_w), R,
                np.maximum(free[:R] - t0, 0.0), t0)
        else:
            rep = np.asarray(router.assign(a_w, w_w, R, (seed, len(idx))),
                             np.int64)
        pol_w = _with_bin_edges(policy, bin_edges)
        lat_eff = single if pol_w.uses_single_latency else lat
        waits_w = np.empty(len(idx))
        for r in range(R):
            mask = rep == r
            if not mask.any():
                continue
            ai = a_w[mask]
            ti = tok[idx][mask]
            pi = None if pred is None else pred[idx][mask]
            syn = free[r] - t0 > single.c + 1e-12
            if syn:
                t_s = t0 - 1e-9
                l0 = (free[r] - t_s - single.c) / single.a
                ai = np.concatenate(([t_s], ai))
                ti = np.concatenate(([l0], ti))
                if pi is not None:
                    pi = np.concatenate(([l0], pi))
            sub = Workload(arrivals=ai, tokens=ti,
                           inter=np.diff(ai, prepend=0.0), predicted=pi)
            with no_warmup():
                res = sim(pol_w, sub)
            w_all = np.asarray(res["waits"], np.float64)
            starts = ai + w_all
            # busy-until = end of the LAST batch (serial server): members
            # share a start; 1e-6 absorbs float reconstruction noise
            # (real batch gaps are >= one prefill, orders larger)
            s_last = float(starts.max())
            members = ti[np.abs(starts - s_last)
                         <= 1e-6 * max(1.0, abs(s_last))]
            free[r] = s_last + float(pol_w.batch_time(members, lat_eff))
            waits_w[mask] = w_all[1:] if syn else w_all
        return waits_w, free

    free = np.zeros(max_replicas)
    waits = np.full(n, np.nan)
    lost = np.ones(n, bool)
    actions: List[WindowAction] = []
    windows: List[dict] = []
    rep_time = 0.0

    for w_i in range(n_windows):
        t0, t1 = w_i * window, (w_i + 1) * window
        lo = int(np.searchsorted(arr, t0, side="left"))
        hi = int(np.searchsorted(arr, t1, side="left"))
        idx = np.arange(lo, hi)

        if clairvoyant:
            best = None
            for R_c in cand_R:
                for rt in candidate_routers:
                    w_c, f_c = _run_window(idx, t0, int(R_c), str(rt),
                                           None, free)
                    mw = float(w_c.mean()) if len(w_c) else 0.0
                    score = mw + replica_cost * R_c
                    if best is None or score < best[0] - 1e-12:
                        best = (score, int(R_c), str(rt), w_c, f_c)
            _, R_w, rt_w, waits_w, free_new = best
            shed_p, edges_w = 0.0, None
            adm = idx
        else:
            R_w, rt_w, shed_p, edges_w = cur
            adm = idx
            if shed_p > 0.0 and len(idx):
                keep = _traffic_rng(seed, _SHED_LANE, w_i
                                    ).random(len(idx)) >= shed_p
                adm = idx[keep]
            waits_w, free_new = _run_window(adm, t0, R_w, rt_w, edges_w,
                                            free)

        actions.append(WindowAction(w_i, t0, t1, R_w, rt_w, shed_p,
                                    edges_w))
        if len(adm):
            waits[adm] = waits_w
            lost[adm] = False
        free = free_new
        dur = max(min(t1, horizon) - t0, 0.0) or (t1 - t0)
        rep_time += R_w * dur
        backlog = float(np.maximum(free - t1, 0.0).sum())
        windows.append({
            "window": w_i, "t0": t0, "t1": t1, "replicas": R_w,
            "router": rt_w, "shed_prob": shed_p,
            "arrived": int(len(idx)), "shed": int(len(idx) - len(adm)),
            "mean_wait": float(waits_w.mean()) if len(waits_w) else 0.0,
            "backlog": backlog,
        })

        if adaptive:
            for a in arr[idx]:
                controller.observe_arrival(float(a))
            # completions in arrival order, as the reference feeds them
            for t in tok[adm]:
                controller.observe_completion(int(t))
            rec = controller.recommendation()
            if rec.details.get("reason") != "warmup":
                cur = (pow2_replicas(max(rec.replicas, 1), max_replicas),
                       rec.router or router_default,
                       float(rec.shed_prob),
                       rec.bin_edges if policy.name == "multibin" else None)

    served = int((~lost).sum())
    shed = int(n - served)
    mean_wait = float(waits[~lost].mean()) if served else 0.0
    total_t = max(n_windows * window, 1e-12)
    avg_rep = rep_time / total_t
    objective = (mean_wait + replica_cost * avg_rep
                 + shed_cost * (shed / max(n, 1)))
    return ControlledResult(
        waits=waits, lost=lost, actions=actions, windows=windows,
        mean_wait=mean_wait, served=served, shed=shed,
        avg_replicas=float(avg_rep), replica_cost=float(replica_cost),
        shed_cost=float(shed_cost), objective=float(objective))
