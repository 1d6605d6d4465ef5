"""Fleet layer: prediction-aware routing across parallel batched replicas,
a copy of ``repro.core.fleet``.

Everything below :mod:`repro_torch.core.policies` describes ONE server; the
heavy-traffic regime the ROADMAP targets (millions of users) is served by
R replicas behind a dispatcher.  Dai et al. 2025 analyze exactly this
multi-server WAIT setting, and AugServe (Wang et al. 2025) shows adaptive
request routing is where real serving systems win.  This module makes the
*router* a first-class registered component, mirroring the policy and
predictor registries: a :class:`RoutingPolicy` splits one Poisson(λ)
arrival stream across R replicas, and EACH replica runs any registered
:class:`~repro_torch.core.policies.BatchPolicy` unchanged.

The architectural decision that keeps every layer simple: a router is a
function of the *arrival stream and its (predicted) per-request work* —
never of the replicas' internal service evolution.  A real dispatcher
cannot see inside a replica's batch formation anyway; it tracks what it
assigned.  The state-dependent routers therefore carry a **virtual work
backlog** per replica (a Lindley-style recursion on single-request service
estimates: decay by elapsed time, add the assigned request's estimated
work), which is computable on arrivals alone.  Consequence: routing can be
computed FIRST and each replica's sub-stream then runs through the
existing single-server machinery unchanged — ``_oracle_batches`` on the
oracle layer, the card's kernels on the fast layer, ``PolicyScheduler``
on the serving layer.

Registered routers (``ROUTERS``):

  * ``random``       — iid uniform replica choice.  On the sampled-workload
    layers it is realized by *exact superposition*: R independent
    Poisson(λ/R) single-server workloads merged into one stream (the
    superposition theorem: this IS a Poisson(λ) stream with iid uniform
    routing), so each replica is bit-equal to the existing single-server
    model at λ/R and **every** ``analytic_kind`` transfers for free — the
    exact M/G/R split.
  * ``round_robin``  — request i -> replica i mod R; each replica sees an
    Erlang-R arrival stream (no analytic form, delay between jsq and
    random).
  * ``power_of_d``   — hashed power-of-d choices: a salted rng draws d
    candidate replicas per request and the one with the fewest requests
    *assigned so far* wins.  State-independent in the queue sense (the
    balance counter is assignment history, not service state), so it
    lowers to split-then-kernel exactly like random/round_robin.
  * ``jsq``          — join-shortest-queue on the virtual work backlog
    with a length-BLIND work estimate (every request costs the stream's
    mean single-request service time): queue length measured in mean
    service units.
  * ``least_work``   — join-least-predicted-work: the backlog increments
    by the request's PREDICTED single-request service time, using any
    registered :class:`~repro_torch.core.predictors.LengthPredictor` (the
    router's own ``predictor`` overrides the workload's predicted column;
    oracle semantics otherwise) — length-aware dispatch, the second
    consumer of the predictor subsystem.

Three layers, mirroring the policy core:

  1. :func:`route_oracle` — NumPy reference: split, then reuse the
     single-server oracle event loops per replica, unchanged.
  2. ``repro_torch.core.fastsim.simulate_fleet_fast`` — same split (the
     backlog recursion is kernel S6, ``kernels/backlog_scan``, carrying the
     per-replica backlog vector), then the per-policy kernels per replica;
     :func:`sweep` runs (R, λ) grids for scaling curves.
  3. :func:`fleet_analytic_delay` — the analytic cross-check surface:
     ``random`` transfers the per-replica single-server closed form at
     λ/R with the policy's own ``analytic_kind``; ``jsq`` gets a
     Whitt-style two-moment balanced-split approximation
     (:func:`split_qna_wait`, QNA scaling of the same P-K service
     moments) for single-service policies, ``analytic_kind='approx'``;
     the pooled M/G/R Erlang-C form (:func:`mgr_whitt_wait`) is exposed
     as the resource-pooling delay floor every router is compared
     against.

``tests/test_torch_fleet.py`` holds every layer to the reference package
on equal seeds: assignments bit for bit, oracle waits bit for bit, the
fast path within 1e-10 s of the reference's compiled path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Type

import numpy as np

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.core.policies import (
    BatchPolicy, FCFSPolicy, Workload, single_from_batch)

# Salt for router rng streams (random assignment, power-of-d candidates):
# independent of both the workload stream and the predictor stream.
_ROUTE_SALT = 0x5DEECE66
# Key-lane for a router-owned predictor, so its noise draw is independent
# of a policy-owned predictor keyed on the same workload seed.
_ROUTE_PRED_LANE = 7919


def _route_rng(seed) -> np.random.Generator:
    parts = [int(k) for k in seed] if isinstance(seed, (tuple, list)) \
        else [int(seed)]
    return np.random.default_rng(np.random.SeedSequence([_ROUTE_SALT] + parts))


# ----------------------------------------------------------------------------
# Fleet workload: one arrival stream, split across R replicas
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetWorkload:
    """The routed stream: per-replica single-server sub-workloads plus the
    merged global view.  ``replicas[r]`` is a plain
    :class:`~repro_torch.core.policies.Workload`, so every single-server layer
    consumes it unchanged; ``replica_of`` maps each global request (in
    arrival order) to its replica."""

    replicas: List[Workload]
    replica_of: np.ndarray       # int replica id per global request
    arrivals: np.ndarray         # merged global arrival times (sorted)
    R: int

    @property
    def counts(self) -> np.ndarray:
        return np.bincount(self.replica_of, minlength=self.R)


def _sub_workload(wl: Workload, idx: np.ndarray) -> Workload:
    """Replica sub-stream of a global workload.  ``inter`` is re-derived
    from the sub-arrivals (gap from t=0 for the first request), which is
    what the FCFS oracle's recursions expect."""
    arr = wl.arrivals[idx]
    return Workload(
        arrivals=arr,
        tokens=wl.tokens[idx],
        inter=np.diff(arr, prepend=0.0),
        predicted=None if wl.predicted is None else wl.predicted[idx],
        session=None if wl.session is None else wl.session[idx],
        turn=None if wl.turn is None else wl.turn[idx])


def served_slice(policy: BatchPolicy, wl: Workload) -> Workload:
    """Truncate a sub-workload to what the policy actually serves (fixed
    batching serves a multiple of b; everything else serves all)."""
    n = len(wl.arrivals)
    m = policy.schedule_length(n)
    if m == n:
        return wl
    return Workload(
        arrivals=wl.arrivals[:m], tokens=wl.tokens[:m],
        inter=None if wl.inter is None else wl.inter[:m],
        predicted=None if wl.predicted is None else wl.predicted[:m],
        session=None if wl.session is None else wl.session[:m],
        turn=None if wl.turn is None else wl.turn[:m])


# ----------------------------------------------------------------------------
# Routing-policy protocol + registry
# ----------------------------------------------------------------------------

ROUTERS: Dict[str, Type["RoutingPolicy"]] = {}


def register_router(cls: Type["RoutingPolicy"]) -> Type["RoutingPolicy"]:
    ROUTERS[cls.name] = cls
    return cls


def get_router(name: str, **kwargs) -> "RoutingPolicy":
    return ROUTERS[name](**kwargs)


def router_from_spec(spec) -> "RoutingPolicy":
    """``RoutingPolicy`` | name | ``{"kind": name, **params}`` -> instance."""
    if isinstance(spec, RoutingPolicy):
        return spec
    if isinstance(spec, str):
        return get_router(spec)
    spec = dict(spec)
    return get_router(spec.pop("kind"), **spec)


def default_routers(d: int = 2) -> Dict[str, "RoutingPolicy"]:
    """One representative instance per registered router — the set the
    fleet agreement tests and the registry-driven benchmarks iterate."""
    return {
        "random": RandomRouter(),
        "round_robin": RoundRobinRouter(),
        f"power_of_{d}": PowerOfDRouter(d=d),
        "jsq": JSQRouter(),
        "least_work": LeastWorkRouter(),
        "session_affinity": SessionAffinityRouter(),
    }


class RoutingPolicy:
    """One dispatch discipline, defined once for every layer.

    Class attributes (the structural dispatch surface):
      name              registry key
      state_dependent   True -> assignment is the virtual-backlog recursion
                        (the fast layer runs it as kernel S6)

    ``predictor`` (a :class:`repro_torch.core.predictors.LengthPredictor`,
    registry name, or spec dict) overrides the workload's predicted column
    for the router's work estimate — None uses ``Workload.predicted`` when
    the POLICY carries a predictor, and the true lengths otherwise (oracle
    semantics).  Only the work estimate is affected: membership inside
    each replica still follows the policy's own predicted column.
    """

    name = "base"
    state_dependent = False

    def __init__(self, predictor=None):
        if predictor is not None:
            from repro_torch.core.predictors import predictor_from_spec
            predictor = predictor_from_spec(predictor)
        self.predictor = predictor

    # -------------------- work estimate --------------------
    def routing_work(self, wl: Workload, lat, seed,
                     prompts=None) -> np.ndarray:
        """Per-request work estimate in single-request service seconds:
        ``S(pred) = (k1+k2) + (k3+k4)·pred`` on the router's predicted
        lengths.  ``lat=None`` (uncalibrated serving layers) falls back to
        raw predicted tokens as the work unit.  ``prompts`` reaches a
        router-owned predictor (the serving layers pass the request
        prompts, so prompt-feature predictors actually see them; the
        sampled-workload layers have none)."""
        key = wl.predicted_or_true
        if self.predictor is not None:
            key = self.predictor.predict((seed, _ROUTE_PRED_LANE),
                                         wl.tokens, prompts)
        return self.work_from_lengths(key, lat)

    @staticmethod
    def work_from_lengths(lengths: np.ndarray, lat) -> np.ndarray:
        lengths = np.asarray(lengths, np.float64)
        if lat is None:
            return lengths
        single = lat if isinstance(lat, LatencyModel) else \
            single_from_batch(lat)
        return np.asarray(single.service_time(lengths), np.float64)

    # -------------------- assignment law --------------------
    def assign(self, arrivals: np.ndarray, work: np.ndarray, R: int,
               seed, fast: bool = False, sessions=None, device=None,
               launch_out: Optional[dict] = None) -> np.ndarray:
        """Replica id per request.  Must depend only on (arrivals, work,
        R, seed) — never on downstream service state — so that routing
        can be computed before any replica is simulated.  ``sessions``
        is the workload's session-id column (None on session-free
        streams): sticky routers key on it, everything else ignores it.
        ``fast`` runs a state-dependent router's recursion as kernel S6 on
        ``device`` (see :func:`repro_torch.core.fastsim.backlog_route`,
        which fills ``launch_out``); the stateless routers ignore the
        three."""
        raise NotImplementedError

    # -------------------- fleet workload --------------------
    def fleet_workload(self, policy: BatchPolicy, lam: float,
                       dist: Optional[TokenDistribution], lat,
                       num_requests: int, seed: int, R: int,
                       fast: bool = False, traffic=None, device=None,
                       launch_out: Optional[dict] = None) -> FleetWorkload:
        """Sample the global stream through the policy's workload law and
        split it.  R=1 passes the policy's native workload through
        untouched, so a one-replica fleet is bit-equal to the
        single-server path for every router.

        ``traffic`` (a :mod:`repro_torch.core.traffic` model, name or spec)
        warps the sampled arrivals through the modulation's
        time-rescaling transform BEFORE routing — every router sees the
        same modulated instants; a null model leaves the stream
        bit-identical."""
        wl = policy.sample_workload(lam, dist, num_requests, seed)
        if traffic is not None:
            from repro_torch.core.traffic import warp_workload
            wl = warp_workload(wl, traffic, seed)
        if R == 1:
            return FleetWorkload([wl], np.zeros(len(wl.arrivals), np.int64),
                                 wl.arrivals, 1)
        work = self.routing_work(wl, lat, seed)
        rep = np.asarray(self.assign(wl.arrivals, work, R, seed, fast=fast,
                                     sessions=wl.session, device=device,
                                     launch_out=launch_out),
                         np.int64)
        subs = [_sub_workload(wl, np.nonzero(rep == r)[0]) for r in range(R)]
        return FleetWorkload(subs, rep, wl.arrivals, R)

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items() if v is not None}
        return f"{type(self).__name__}({keys})"


def _backlog_assign_np(arrivals: np.ndarray, work: np.ndarray,
                       R: int) -> np.ndarray:
    """Reference virtual-backlog recursion: decay every replica's backlog
    by the elapsed time, join the least-loaded (first index on ties), add
    the request's work."""
    v = np.zeros(R)
    t_prev = 0.0
    out = np.empty(len(arrivals), np.int64)
    for i, (a, w) in enumerate(zip(arrivals, work)):
        v = np.maximum(0.0, v - (a - t_prev))
        t_prev = a
        r = int(np.argmin(v))
        v[r] += w
        out[i] = r
    return out


def _masked_backlog_assign_np(arrivals: np.ndarray, work: np.ndarray,
                              R: int, up: np.ndarray) -> np.ndarray:
    """Availability-masked reference backlog recursion
    (:mod:`repro_torch.core.faults`): a replica that is down at an arrival
    instant (``up[i, r]`` False) has its virtual backlog masked to +inf
    in the argmin, so it receives no work until it recovers.  With every
    replica up this is bit-equal to :func:`_backlog_assign_np`; the
    kernel twin is ``fastsim.masked_backlog_route`` (S6)."""
    v = np.zeros(R)
    t_prev = 0.0
    out = np.empty(len(arrivals), np.int64)
    for i, (a, w) in enumerate(zip(arrivals, work)):
        v = np.maximum(0.0, v - (a - t_prev))
        t_prev = a
        r = int(np.argmin(np.where(up[i], v, np.inf)))
        v[r] += w
        out[i] = r
    return out


class _BacklogRouter(RoutingPolicy):
    """Shared base for the state-dependent routers (jsq / least_work)."""

    state_dependent = True

    def _work_units(self, work: np.ndarray) -> np.ndarray:
        return work

    def assign(self, arrivals, work, R, seed, fast: bool = False,
               sessions=None, device=None, launch_out=None):
        w = self._work_units(np.asarray(work, np.float64))
        if fast:
            from repro_torch.core.fastsim import backlog_route
            return backlog_route(arrivals, w, R, device=device,
                                 launch_out=launch_out)
        return _backlog_assign_np(np.asarray(arrivals, np.float64), w, R)


@register_router
class RandomRouter(RoutingPolicy):
    """iid uniform replica choice.  On the sampled-workload layers the
    fleet workload is built by exact superposition (R independent λ/R
    single-server streams merged), so each replica IS the single-server
    model at λ/R — bit-equal, with the full analytic transfer.  On the
    request-list serving layers, where the stream is given, ``assign``
    draws from the salted router rng (the same law)."""

    name = "random"

    def assign(self, arrivals, work, R, seed, fast: bool = False,
               sessions=None, device=None, launch_out=None):
        return _route_rng(seed).integers(0, R, len(arrivals))

    def fleet_workload(self, policy, lam, dist, lat, num_requests, seed, R,
                       fast: bool = False, traffic=None, device=None,
                       launch_out=None) -> FleetWorkload:
        if R == 1:
            return super().fleet_workload(policy, lam, dist, lat,
                                          num_requests, seed, R, fast,
                                          traffic=traffic)
        n_per = max(num_requests // R, 1)
        subs = [policy.sample_workload(lam / R, dist, n_per, (seed, r))
                for r in range(R)]
        if traffic is not None:
            # superposition transfers to modulated arrivals: each λ/R
            # sub-stream is warped through the SAME profile (base seed,
            # one shared environment), so the merge is the inhomogeneous
            # Poisson(λ·m(t)) process with iid uniform replica marks
            from repro_torch.core.traffic import warp_workload
            subs = [warp_workload(wl, traffic, seed) for wl in subs]
        arr = np.concatenate([wl.arrivals for wl in subs])
        rep = np.concatenate([np.full(len(wl.arrivals), r, np.int64)
                              for r, wl in enumerate(subs)])
        order = np.argsort(arr, kind="stable")
        return FleetWorkload(subs, rep[order], arr[order], R)


@register_router
class RoundRobinRouter(RoutingPolicy):
    """Request i -> replica i mod R: perfectly balanced counts, blind to
    burstiness and lengths; each replica sees Erlang-R interarrivals."""

    name = "round_robin"

    def assign(self, arrivals, work, R, seed, fast: bool = False,
               sessions=None, device=None, launch_out=None):
        return np.arange(len(arrivals), dtype=np.int64) % R


@register_router
class PowerOfDRouter(RoutingPolicy):
    """Hashed power-of-d choices: the salted rng draws ``d`` candidate
    replicas per request; the candidate with the fewest requests assigned
    so far wins (first on ties).  The balance counter is assignment
    history — computable without simulating service — so the router stays
    state-independent in the queue sense and splits-then-simulates like
    random/round_robin, while interpolating between them and jsq in
    balance quality (Mitzenmacher's power of two choices)."""

    name = "power_of_d"

    def __init__(self, d: int = 2, predictor=None):
        super().__init__(predictor)
        assert d >= 1
        self.d = int(d)

    def assign(self, arrivals, work, R, seed, fast: bool = False,
               sessions=None, device=None, launch_out=None):
        cands = _route_rng(seed).integers(0, R, (len(arrivals), self.d))
        counts = np.zeros(R, np.int64)
        out = np.empty(len(arrivals), np.int64)
        for i in range(len(arrivals)):
            c = cands[i]
            r = int(c[np.argmin(counts[c])])
            counts[r] += 1
            out[i] = r
        return out


@register_router
class JSQRouter(_BacklogRouter):
    """Join-shortest-queue on the virtual work backlog, with a
    length-BLIND work estimate: every request costs the stream's mean
    single-request service time, so the backlog is queue length measured
    in mean service units.  Not length-aware (that is ``least_work``),
    and with CONSTANT increments the argmin cycles replicas in strict
    rotation while no backlog drains to the max(0, ·) clamp — at
    utilizations where interarrival gaps stay below the mean service
    time, jsq's assignments coincide with round_robin's exactly (the
    committed ``pr5_fleet`` router comparison shows identical numbers
    for the two at the heavy-tail operating point).  It departs from
    round robin only when idle gaps drain a replica, i.e. at low load or
    under bursty lulls — the regime where joining the truly-emptiest
    replica matters."""

    name = "jsq"

    def _work_units(self, work):
        return np.full(len(work), float(np.mean(work)) if len(work) else 0.0)


@register_router
class LeastWorkRouter(_BacklogRouter):
    """Join-least-predicted-work: the backlog increments by the request's
    PREDICTED single-request service time — length-aware dispatch driven
    by any registered :mod:`repro_torch.core.predictors` instance (``predictor``
    on the router; the workload's predicted column otherwise).  The
    prediction-aware twin of jsq: with an oracle predictor it is the
    classic least-workload rule; predictor noise erodes it (the reference's
    ``benchmarks/bench_fleet.py`` measures how far)."""

    name = "least_work"


def _seed_fold(seed) -> int:
    """Fold a scalar or tuple seed into one 64-bit salt word."""
    parts = [int(k) for k in seed] if isinstance(seed, (tuple, list)) \
        else [int(seed)]
    acc = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for p in parts:
            acc = (acc ^ np.uint64(p & 0xFFFFFFFFFFFFFFFF)) \
                * np.uint64(0xBF58476D1CE4E5B9)
    return int(acc)


def _affinity_hash(keys: np.ndarray, seed) -> np.ndarray:
    """splitmix64-style avalanche of per-request sticky keys (vectorized,
    deterministic, layer-independent — no rng stream is consumed)."""
    z = keys.astype(np.uint64)
    with np.errstate(over="ignore"):
        z = z + np.uint64(_seed_fold(seed))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


@register_router
class SessionAffinityRouter(RoutingPolicy):
    """Sticky hashing: replica = hash(session id) mod R, so every turn of
    a session lands on the same replica and its KV/prefix cache — the
    affinity side of the affinity-vs-``least_work`` trade-off
    (prefix reuse shrinks service; blind stickiness forgoes load
    balancing).  On session-free streams (``sessions=None``) each
    request is its own session — the hash of the request index, an iid
    uniform split in law.  Assignment depends only on (session id, seed):
    deterministic, identical on the oracle and fast layers, and STABLE
    across the feedback fixed point's re-sorted passes (arrival times
    never enter the hash).  Dead replicas fall back through the fault
    layer's masking: :meth:`masked_assign` probes ``hash + k`` until an
    up replica is found, so only turns whose home replica is down move."""

    name = "session_affinity"

    def assign(self, arrivals, work, R, seed, fast: bool = False,
               sessions=None, device=None, launch_out=None):
        keys = np.arange(len(arrivals), dtype=np.uint64) \
            if sessions is None else np.asarray(sessions, np.uint64)
        return (_affinity_hash(keys, seed) % np.uint64(R)).astype(np.int64)

    def masked_assign(self, arrivals, work, R, seed, up, fast: bool = False,
                      sessions=None, device=None, launch_out=None):
        """Availability-masked stickiness (hook consumed by
        :func:`repro_torch.core.faults.masked_assign`): linear probing from the
        home replica, so sessions keep their home whenever it is up and
        deterministically overflow to ``home + k`` while it is down."""
        rep = np.asarray(self.assign(arrivals, work, R, seed, fast=fast,
                                     sessions=sessions), np.int64)
        up = np.asarray(up, bool)
        offs = np.zeros(len(rep), np.int64)
        rows = np.arange(len(rep))
        for _ in range(R):
            cur = (rep + offs) % R
            bad = ~up[rows, cur]
            if not bad.any():
                break
            offs[bad] += 1
        return (rep + offs) % R


# ----------------------------------------------------------------------------
# Layer 1: the NumPy reference oracle (reuses the single-server event loops)
# ----------------------------------------------------------------------------

def _aggregate(per: List[Optional[dict]], fw: FleetWorkload) -> dict:
    """Fleet-level stats from per-replica single-server results.  Each
    replica's result is already warmup-trimmed by its own oracle/kernel;
    the aggregate concatenates the trimmed waits (request-weighted)."""
    live = [p for p in per if p is not None]
    waits = np.concatenate([p["waits"] for p in live]) if live else \
        np.zeros(0)
    out = {
        "mean_wait": float(waits.mean()) if waits.size else 0.0,
        "p50_wait": float(np.percentile(waits, 50)) if waits.size else 0.0,
        "p95_wait": float(np.percentile(waits, 95)) if waits.size else 0.0,
        "p99_wait": float(np.percentile(waits, 99)) if waits.size else 0.0,
        "per_replica": per,
        "replica_counts": fw.counts,
        "replica_of": fw.replica_of,
    }
    if live and all("mean_batch" in p for p in live):
        # total requests / total batches across the fleet
        nb = sum(len(p["waits"]) / max(p["mean_batch"], 1e-12) for p in live)
        out["mean_batch"] = float(waits.size / max(nb, 1e-12))
    if live and all("memory" in p for p in live):
        ms = [p["memory"] for p in live]
        ws = np.array([max(len(p["waits"]), 1) for p in live], np.float64)
        out["memory"] = {
            "capacity": ms[0]["capacity"],           # per-replica budget
            "kv_peak": max(m["kv_peak"] for m in ms),
            "kv_mean": float(np.average([m["kv_mean"] for m in ms],
                                        weights=ws)),
            "utilization": max(m["utilization"] for m in ms),
            "allocated": float(sum(m["allocated"] for m in ms)),
            "freed": float(sum(m["freed"] for m in ms)),
            "blocked_batches": int(sum(m["blocked_batches"] for m in ms)),
            "blocked_time": float(sum(m["blocked_time"] for m in ms)),
            "deferred_requests": int(sum(m["deferred_requests"]
                                         for m in ms)),
        }
    return out


def run_fleet(fw: FleetWorkload, policy: BatchPolicy, lat,
              dist: Optional[TokenDistribution],
              run: Callable[[List[Workload]], List[dict]]) -> dict:
    """Drive the non-empty replicas' sub-workloads (in replica order)
    through ``run`` (the oracle or the fast twin, a replica at a time or
    all at once), which returns one result for each, and aggregate.
    Empty replicas contribute None."""
    wls = [served_slice(policy, wl) for wl in fw.replicas]
    live = [i for i, wl in enumerate(wls) if len(wl.arrivals)]
    per: List[Optional[dict]] = [None] * len(wls)
    for i, r in zip(live, run([wls[i] for i in live]) if live else []):
        per[i] = r
    return _aggregate(per, fw)


def route_oracle(router, policy: BatchPolicy, lam: float, R: int,
                 dist: Optional[TokenDistribution], lat,
                 num_requests: int = 100_000, seed: int = 0,
                 traffic=None, sessions=None,
                 prefix_discount: float = 0.0, memory=None) -> dict:
    """Fleet reference oracle: route, then reuse the single-server
    reference event loops (``repro_torch.core.simulate``) per replica,
    unchanged.  ``router``: a RoutingPolicy, registry name, or spec.
    ``traffic`` modulates the arrival stream before routing.
    ``sessions`` / ``prefix_discount`` re-enter completed turns through
    the fleet feedback fixed point
    (:func:`repro_torch.core.sessions.simulate_fleet_sessions`); a null
    model takes the session-free path.  Host NumPy: it takes no device.
    ``memory`` gives EACH replica its own KV budget (per-replica HBM)
    through the unchanged single-server tandem oracle; a session fleet
    runs without it, as the reference's does (ROADMAP.md queue 3)."""
    from repro_torch.core.simulate import simulate_policy
    router = router_from_spec(router)
    if sessions is not None:
        from repro_torch.core.sessions import (session_from_spec,
                                               simulate_fleet_sessions)
        model = session_from_spec(sessions)
        if not model.is_null:
            return simulate_fleet_sessions(
                router, policy, lam, R, dist, lat, num_requests, seed,
                model, prefix_discount=prefix_discount, traffic=traffic,
                fast=False)
    fw = router.fleet_workload(policy, lam, dist, lat, num_requests, seed, R,
                               traffic=traffic)
    return run_fleet(fw, policy, lat, dist,
                     lambda wls: [simulate_policy(
                         policy, lam, dist, lat, workload=wl, memory=memory)
                         for wl in wls])


# ----------------------------------------------------------------------------
# Layer 2 entry point (the kernels are driven from repro_torch.core.fastsim)
# ----------------------------------------------------------------------------

def sweep(R_grid, lam_grid, router, policy: BatchPolicy,
          dist: Optional[TokenDistribution], lat,
          num_requests: int = 50_000, seed: int = 0, device=None,
          launch_out: Optional[dict] = None) -> dict:
    """Scaling curves on the fast path: mean wait over the (R, λ) grid —
    λ is the TOTAL fleet arrival rate, so reading along R at fixed λ is
    the 'how many replicas do I need' question.  Returns
    ``{"mean_wait": [len(R_grid), len(lam_grid)], "R_grid", "lams"}``.
    Runs on the card unless ``device="cpu"``; a ``launch_out`` dict is
    filled with each cell's routing launch, {(R, λ index): the dict that
    :func:`repro_torch.core.fastsim.backlog_route` fills}, for the cells
    whose router launched kernel S6."""
    from repro_torch.core.fastsim import simulate_fleet_fast
    from repro_torch.kernels import resolve_device
    device = resolve_device(device)
    router = router_from_spec(router)
    R_grid = [int(r) for r in R_grid]
    lam_grid = [float(l) for l in lam_grid]
    out = np.empty((len(R_grid), len(lam_grid)))
    for ri, R in enumerate(R_grid):
        for li, lam in enumerate(lam_grid):
            cell = {} if launch_out is not None else None
            out[ri, li] = simulate_fleet_fast(
                router, policy, lam, R, dist, lat,
                num_requests=num_requests, seed=seed, device=device,
                launch_out=cell)["mean_wait"]
            if cell:
                launch_out[R, li] = cell
    return {"mean_wait": out, "R_grid": np.asarray(R_grid),
            "lams": np.asarray(lam_grid)}


# ----------------------------------------------------------------------------
# Layer 3: analytic cross-checks
# ----------------------------------------------------------------------------

def erlang_c(R: int, a: float) -> float:
    """Erlang-C delay probability for M/M/R at offered load a = λ·E[S]
    (stable only for a < R), via the numerically-stable Erlang-B
    recursion B(j) = a·B(j-1) / (j + a·B(j-1))."""
    if a >= R:
        return 1.0
    b = 1.0
    for j in range(1, R + 1):
        b = a * b / (j + a * b)
    rho = a / R
    return b / (1.0 - rho + rho * b)


def mgr_whitt_wait(lam: float, R: int, es: float, es2: float) -> float:
    """Two-moment *pooled* M/G/R mean-wait approximation (Whitt 1993):

        E[W] ≈ (1 + C_s²)/2 · E[W_{M/M/R}]
             = (1 + C_s²)/2 · C(R, a) · E[S] / (R − a)

    with a = λ·E[S] and C_s² = Var[S]/E[S]² from the SAME service moments
    the single-server P-K terms use (``LatencyModel.moments``).  The
    pooled single-queue system dominates every dispatch rule (resource
    pooling), so this is the fleet's delay *floor* under the router
    comparison."""
    a = lam * es
    if a >= R:
        return np.inf
    cs2 = max(es2 - es ** 2, 0.0) / max(es ** 2, 1e-300)
    return 0.5 * (1.0 + cs2) * erlang_c(R, a) * es / (R - a)


def split_qna_wait(lam: float, R: int, es: float, es2: float) -> float:
    """Two-moment mean-wait approximation for a *balanced split* of a
    Poisson(λ) stream across R single servers — Whitt's QNA scaling of
    the P-K terms:

        E[W] ≈ (C_a² + C_s²)/2 · ρ/(1−ρ) · E[S],   ρ = (λ/R)·E[S]

    with arrival SCV C_a² = 1/R: a deterministic 1-in-R count split of a
    Poisson stream gives each replica exactly Erlang-R interarrivals
    (that part is exact for ``round_robin``; the G/G/1 two-moment formula
    is the approximation).  The backlog ``jsq`` router balances
    assignment counts the same way at steady state, so the same formula
    serves as its two-moment handle."""
    rho = (lam / R) * es
    if rho >= 1.0:
        return np.inf
    ca2 = 1.0 / R
    cs2 = max(es2 - es ** 2, 0.0) / max(es ** 2, 1e-300)
    return 0.5 * (ca2 + cs2) * rho / (1.0 - rho) * es


def fleet_analytic_kind(router, policy: BatchPolicy) -> Optional[str]:
    """How literally to read :func:`fleet_analytic_delay`:

      * ``random`` — exact superposition split: each replica is the
        single-server model at λ/R, so the POLICY's own ``analytic_kind``
        transfers verbatim ('exact' stays exact, 'bound' stays a bound).
      * ``jsq`` — 'approx' for single-service (FCFS-family) policies via
        the two-moment balanced-split formula (:func:`split_qna_wait`):
        the backlog rule balances assignment counts, so each replica sees
        ≈ Erlang-R interarrivals at λ/R; the G/G/1 two-moment scaling is
        the approximation (within ~10% at the cross-checked loads).
      * everything else — None (no closed form; round_robin's exactly-
        Erlang arrivals sit in the regime where the two-moment formula
        degrades, power_of_d feeds back assignment history, least_work
        couples backlogs to lengths, and batched policies couple the
        split to batch formation)."""
    router = router_from_spec(router)
    if router.name == "random":
        return policy.analytic_kind
    if router.name == "jsq" and isinstance(policy, FCFSPolicy) \
            and policy.tau is None:
        return "approx"
    return None


def fleet_analytic_delay(router, policy: BatchPolicy, lam: float, R: int,
                         dist: TokenDistribution, lat) -> Optional[float]:
    """Mean queueing delay of the fleet from the transferred single-server
    closed forms; None when :func:`fleet_analytic_kind` is None."""
    router = router_from_spec(router)
    kind = fleet_analytic_kind(router, policy)
    if kind is None:
        return None
    if router.name == "random":
        return policy.analytic_delay(lam / R, dist, lat)
    # jsq + single-service policy: QNA balanced split on the P-K moments
    single = lat if isinstance(lat, LatencyModel) else single_from_batch(lat)
    es, es2 = single.moments(dist, policy.n_max)
    return split_qna_wait(lam, R, es, es2)


def recommend_replicas(lam: float, dist: TokenDistribution,
                       lat: BatchLatencyModel, target_util: float = 0.7,
                       max_replicas: int = 64) -> int:
    """Smallest replica count keeping the per-replica batched utilization
    under ``target_util``.  The per-request marginal work at large batch
    is the elastic envelope slope α = k1 + k3·E[N] (paper Eq 26): one
    replica's capacity is 1/α requests per second, so
    R = ceil(λ·α / target_util)."""
    alpha = lat.k1 + lat.k3 * dist.mean()
    return int(min(max(1, math.ceil(lam * alpha / target_util)),
                   max_replicas))


__all__ = [
    "FleetWorkload", "JSQRouter", "LeastWorkRouter", "PowerOfDRouter",
    "ROUTERS", "RandomRouter", "RoundRobinRouter", "RoutingPolicy",
    "SessionAffinityRouter",
    "default_routers", "erlang_c", "fleet_analytic_delay",
    "fleet_analytic_kind", "get_router", "mgr_whitt_wait",
    "recommend_replicas", "register_router", "route_oracle",
    "router_from_spec", "run_fleet", "served_slice", "split_qna_wait",
    "sweep",
]
