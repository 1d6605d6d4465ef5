"""Fault-tolerant fleet serving: replica death, retry, hedging, shedding;
a copy of ``repro.serving.resilience``.

:mod:`repro_torch.serving.router` runs a routed fleet on the assumption
that every replica survives the run.  This module is the degradation
path: the same router and runner machinery, but replicas can DIE mid-run
(from a :mod:`repro_torch.core.faults` model's crash episodes or an
explicit ``kill_at`` map), and the scheduler

  * drains the dead replica's backlog: every entry not completed by the
    death epoch (in-flight batch included) is killed,
  * re-dispatches killed work through the same router with the dead
    replica masked out, at ``epoch + retry_backoff * 2**attempt``
    (exponential backoff, capped at ``max_retries``),
  * hedges requests whose predicted wait exceeds ``hedge_slo`` with a
    duplicate dispatch on the next-best replica: first completion wins,
    the loser is discarded (exactly once),
  * sheds admission-dropped requests up front (the fault model's drop
    mask plus an explicit ``shed_prob`` drawn on the fault PRNG's drop
    lane), so overload degrades into bounded loss instead of divergence.

Victim selection at a death epoch uses the policy's own virtual timeline
when a batch latency law is known, else the work-conserving FCFS progress
proxy of :func:`repro_torch.core.faults.simulate_fleet_faulty`: host
NumPy, in router work units.  The runner executes each replica's FINAL
entry list exactly once, so the engine fleet pays R runs, not R × epochs;
on the card every batch of those runs goes through the engine's kernels
(K1, K3, K4, and K2 under elastic batching).

With no fault model, no kill map and ``shed_prob=0`` the router never
enters this module: :class:`~repro_torch.serving.router.FleetScheduler`
keeps the fault-free body.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.faults import (
    _DROP_LANE, _RETRY_LANE, _fault_rng, fault_from_spec, masked_assign,
    replay_backlog)
from repro_torch.core.fleet import router_from_spec
from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.policies import (
    BatchPolicy, ContinuousPolicy, Workload, single_from_batch)
from repro_torch.data.pipeline import Request
from repro_torch.serving.scheduler import (
    ModelClock, PolicyScheduler, ScheduleResult, _request_predictions,
    run_engine_schedule)


@dataclasses.dataclass
class ResilienceReport:
    """Fault accounting for one resilient fleet run.  Conservation:
    ``served + shed + failed == arrived`` (hedged duplicates are not
    separate requests: first completion wins, the loser is discarded)."""

    arrived: int
    served: int
    shed: int
    failed: int
    retries: int
    hedged: int
    hedge_wins: int
    kill_events: List[Tuple[float, int]]
    availability: List[float]


@dataclasses.dataclass
class ResilientFleetResult:
    """``FleetScheduleResult``-compatible (``summarize`` consumes it)
    plus the fault accounting.  ``lost`` covers shed and failed
    requests."""

    waits: np.ndarray
    e2e: np.ndarray
    lost: np.ndarray
    batch_sizes: List[int]
    makespan: float
    replica_of: np.ndarray
    per_replica: List[Optional[ScheduleResult]]
    resilience: ResilienceReport


@dataclasses.dataclass
class _Copy:
    """One dispatch attempt of one request on the serving timeline."""
    req: int
    arrival: float
    attempt: int
    replica: int
    hedge: bool = False


def _death_spans(trace, kill_time: Optional[float],
                 horizon: float) -> List[Tuple[float, float]]:
    """Down intervals of one replica: the fault trace's zero-speed
    episodes plus an explicit kill (dead until past the horizon)."""
    spans = []
    if trace is not None and not trace.empty and trace.speed == 0.0:
        spans += [(float(s), float(e))
                  for s, e in zip(trace.starts, trace.ends)]
    if kill_time is not None:
        spans.append((float(kill_time), horizon * 2.0 + 1.0))
    return sorted(spans)


def scale_spans(schedule: List[Tuple[float, int]], R: int,
                horizon: float) -> List[List[Tuple[float, float]]]:
    """Autoscale schedule -> per-replica down spans.

    ``schedule`` is ``[(t, active), ...]``: from time ``t`` on, replicas
    ``0..active-1`` are in service (before the first entry all ``R``
    are).  Replica ``r`` is DOWN exactly while ``active <= r``, so a
    scale-down is a planned death (the drain and re-dispatch of
    :func:`run_resilient_fleet` apply unchanged) and a replica scaled up
    at ``t`` is masked out of routing on ``[0, t)``."""
    end = horizon * 2.0 + 1.0
    sched = sorted((float(t), int(a)) for t, a in schedule)
    times = [0.0] + [t for t, _ in sched] + [end]
    active = [R] + [min(max(a, 0), R) for _, a in sched]
    spans: List[List[Tuple[float, float]]] = [[] for _ in range(R)]
    for r in range(R):
        for k, a in enumerate(active):
            if a <= r and times[k] < times[k + 1]:
                if spans[r] and spans[r][-1][1] == times[k]:
                    s, _ = spans[r].pop()
                    spans[r].append((s, times[k + 1]))
                else:
                    spans[r].append((times[k], times[k + 1]))
    return spans


def _up_row(spans_of: List[List[Tuple[float, float]]], t: float
            ) -> np.ndarray:
    up = np.array([not any(s <= t < e for s, e in spans)
                   for spans in spans_of])
    if not up.any():
        # all replicas down: dispatch to the first to recover
        rec = [min((e for s, e in spans if s <= t < e), default=t)
               for spans in spans_of]
        up[int(np.argmin(rec))] = True
    return up


def _fcfs_completion(copies: List[_Copy], work_of: np.ndarray
                     ) -> np.ndarray:
    """Work-conserving FCFS progress proxy: completion time per copy
    (arrival order), the victim picker of last resort (no service
    clock)."""
    arr = np.array([c.arrival for c in copies])
    svc = work_of[[c.req for c in copies]]
    c = np.concatenate(([0.0], np.cumsum(svc[:-1])))
    start = np.maximum.accumulate(arr - c) + c
    return start + svc


def _virtual_completion(policy, clock, reqs, copies: List[_Copy],
                        predicted, predict_seed: int) -> np.ndarray:
    """Completion time per copy from the policy's own virtual timeline
    (batch formation included).  Impatience abandonments leave the queue
    at ``arrival + tau``; the ragged tail a policy never schedules counts
    as in queue forever."""
    sub = [dataclasses.replace(reqs[c.req], arrival=c.arrival)
           for c in copies]
    psl = None if predicted is None else \
        predicted[[c.req for c in copies]]
    res = PolicyScheduler(policy, clock, predict_seed=predict_seed).run(
        sub, predicted=psl)
    comp = np.full(len(copies), np.inf)
    arr = np.array([c.arrival for c in copies])
    m = len(res.waits)
    comp[:m] = arr[:m] + np.asarray(res.e2e[:m])
    lost = np.asarray(res.lost[:m], bool)
    comp[:m][lost] = arr[:m][lost] + np.asarray(res.waits[:m])[lost]
    return comp


def run_resilient_fleet(router, policy: BatchPolicy, reqs: List[Request],
                        work_lat, predictor, predict_seed: int, R: int,
                        runner, *, faults=None,
                        kill_at: Optional[Dict[int, float]] = None,
                        seed: int = 0, shed_prob: float = 0.0,
                        hedge_slo: Optional[float] = None,
                        max_retries: Optional[int] = None,
                        retry_backoff: Optional[float] = None,
                        scale_schedule: Optional[
                            List[Tuple[float, int]]] = None,
                        down_spans: Optional[
                            List[List[Tuple[float, float]]]] = None,
                        batch_lat=None, clock=None) -> ResilientFleetResult:
    """The resilient twin of ``router._route_and_dispatch``: same router,
    same global prediction column, same per-replica ``runner(replica,
    sub_reqs, predicted_slice)`` contract, plus death handling, retries,
    hedging and shedding (module docstring).

    ``scale_schedule`` (``[(t, active), ...]``, see :func:`scale_spans`)
    and ``down_spans`` (explicit per-replica ``[(start, end), ...]``)
    overlay planned unavailability on the fault traces: scale-downs drain
    through the same masked re-dispatch as crashes, scale-ups receive no
    traffic before their start."""
    router = router_from_spec(router)
    fault = fault_from_spec(faults)
    n = len(reqs)
    arrivals = np.array([r.arrival for r in reqs], np.float64)
    horizon = float(arrivals[-1]) * 2.0 + 1.0 if n else 1.0
    max_retries = fault.max_retries if max_retries is None else max_retries
    retry_backoff = (fault.retry_backoff if retry_backoff is None
                     else retry_backoff)

    traces = [fault.trace(seed, r, horizon) for r in range(R)]
    kill_at = dict(kill_at or {})
    spans_of = [_death_spans(traces[r], kill_at.get(r), horizon)
                for r in range(R)]
    if scale_schedule is not None:
        planned = scale_spans(list(scale_schedule), R, horizon)
        spans_of = [sorted(spans_of[r] + planned[r]) for r in range(R)]
    if down_spans is not None:
        spans_of = [sorted(spans_of[r] + [(float(s), float(e))
                                          for s, e in down_spans[r]])
                    for r in range(R)]

    # ---- admission shedding ------------------------------------------
    shed = fault.drop_mask(seed, n).copy()
    if shed_prob > 0.0:
        shed |= _fault_rng(seed, _DROP_LANE, 7).random(n) < shed_prob

    # ---- global predictions and routing work (the fault-free path's) --
    ns = np.array([policy.clip(r.target_output_tokens) for r in reqs],
                  np.float64)
    predicted = _request_predictions(policy, predictor, predict_seed, ns,
                                     reqs)
    wl = Workload(arrivals=arrivals, tokens=ns, predicted=predicted)
    work = router.routing_work(wl, work_lat, predict_seed,
                               prompts=[r.prompt_tokens for r in reqs])
    adm = np.nonzero(~shed)[0]

    # ---- primary dispatch: availability-masked routing ---------------
    up = np.stack([_up_row(spans_of, float(t)) for t in arrivals[adm]]) \
        if len(adm) else np.ones((0, R), bool)
    rep = masked_assign(router, arrivals[adm], work[adm], R, predict_seed,
                        up) if len(adm) else np.zeros(0, np.int64)

    by_rep: List[List[_Copy]] = [[] for _ in range(R)]
    backlog = np.zeros(R)
    t_prev = 0.0
    hedged = 0
    # Progress and backlog work units: the amortized per-request batch
    # cost k1 + k3*len when a batch latency law is known -- the
    # single-request law overstates in-system time by the batch width and
    # would mass-kill on every death epoch.
    if batch_lat is None and isinstance(work_lat, BatchLatencyModel):
        batch_lat = work_lat
    if batch_lat is not None and not policy.uses_single_latency:
        wu = batch_lat.k1 + batch_lat.k3 * np.asarray(
            wl.predicted_or_true, np.float64)
    elif work_lat is not None:
        wu = router.work_from_lengths(wl.predicted_or_true, work_lat)
    else:
        wu = work
    for i, g in enumerate(adm):
        by_rep[int(rep[i])].append(
            _Copy(int(g), float(arrivals[g]), 0, int(rep[i])))
        # hedging: predicted wait = replica backlog at arrival (Lindley
        # replay of the frozen assignment); an over-SLO request gets a
        # duplicate on the least-loaded OTHER up replica
        a = float(arrivals[g])
        backlog = np.maximum(0.0, backlog - (a - t_prev))
        t_prev = a
        if hedge_slo is not None and backlog[int(rep[i])] > hedge_slo:
            alt = np.where(up[i], backlog, np.inf).copy()
            alt[int(rep[i])] = np.inf
            r2 = int(np.argmin(alt))
            if np.isfinite(alt[r2]):
                by_rep[r2].append(_Copy(int(g), a, 0, r2, hedge=True))
                backlog[r2] += wu[g]
                hedged += 1
        backlog[int(rep[i])] += wu[g]

    # ---- death epochs in global time order (drain and re-dispatch) ---
    events = sorted((s, r) for r in range(R) for s, _ in spans_of[r])
    failed: set = set()
    retries = 0
    kill_events: List[Tuple[float, int]] = []
    for f, r in events:
        victims_src = [c for c in by_rep[r] if c.arrival < f]
        if not victims_src:
            continue
        victims_src.sort(key=lambda c: (c.arrival, c.req, c.attempt))
        if clock is not None and not isinstance(policy, ContinuousPolicy):
            comp = _virtual_completion(policy, clock, reqs, victims_src,
                                       predicted, predict_seed)
        else:
            comp = _fcfs_completion(victims_src, wu)
        kill = [c for c, t_c in zip(victims_src, comp) if t_c > f]
        if not kill:
            continue
        kill_events.append((f, r))
        dead = set(id(c) for c in kill)
        by_rep[r] = [c for c in by_rep[r] if id(c) not in dead]
        u = _fault_rng(seed, _RETRY_LANE, int(round(f * 1e6)) % (1 << 31)
                       ).random(len(kill))
        for j, c in enumerate(kill):
            alive = any(x.req == c.req for lst in by_rep for x in lst)
            if alive:
                continue        # a hedge twin survives: first completion wins
            if c.attempt + 1 > max_retries:
                failed.add(c.req)
                continue
            t_new = f + retry_backoff * (2.0 ** c.attempt) + (j + 1) * 1e-9
            row = _up_row(spans_of, t_new)
            if router.state_dependent:
                flat = [x for lst in by_rep for x in lst]
                flat.sort(key=lambda x: (x.arrival, x.req, x.attempt))
                v = replay_backlog(
                    [x.arrival for x in flat],
                    router._work_units(wu[[x.req for x in flat]]),
                    [x.replica for x in flat], R, t=t_new)
                r_new = int(np.argmin(np.where(row, v, np.inf)))
            else:
                cand = np.nonzero(row)[0]
                r_new = int(cand[int(u[j] * len(cand)) % len(cand)])
            by_rep[r_new].append(_Copy(c.req, float(t_new), c.attempt + 1,
                                       r_new, hedge=c.hedge))
            retries += 1

    # ---- one real run per replica on its FINAL entry list ------------
    waits = np.zeros(n)
    e2e = np.zeros(n)
    lost = np.ones(n, bool)
    best_e2e = np.full(n, np.inf)
    win_is_hedge = np.zeros(n, bool)
    replica_of = np.full(n, -1, np.int64)
    sizes: List[int] = []
    makespan = 0.0
    per: List[Optional[ScheduleResult]] = [None] * R
    for r in range(R):
        if not by_rep[r]:
            continue
        by_rep[r].sort(key=lambda c: (c.arrival, c.req, c.attempt))
        sub = [dataclasses.replace(reqs[c.req], arrival=c.arrival)
               for c in by_rep[r]]
        psl = None if predicted is None else \
            predicted[[c.req for c in by_rep[r]]]
        res = runner(r, sub, psl)
        per[r] = res
        sizes += list(res.batch_sizes)
        makespan = max(makespan, res.makespan)
        for i, c in enumerate(by_rep[r][:len(res.waits)]):
            if res.lost[i] or c.req in failed:
                continue
            # shift back to the request's ORIGINAL arrival
            off = c.arrival - float(arrivals[c.req])
            tot = float(res.e2e[i]) + off
            if tot < best_e2e[c.req]:        # first completion wins
                best_e2e[c.req] = tot
                waits[c.req] = float(res.waits[i]) + off
                e2e[c.req] = tot
                lost[c.req] = False
                replica_of[c.req] = r
                win_is_hedge[c.req] = c.hedge

    lost[list(failed)] = True
    lost[shed] = True
    served = int((~lost).sum())
    T = float(arrivals[-1]) if n else 0.0
    report = ResilienceReport(
        arrived=n, served=served, shed=int(shed.sum()),
        failed=int(n - served - int(shed.sum())), retries=retries,
        hedged=hedged, hedge_wins=int(win_is_hedge.sum()),
        kill_events=kill_events,
        availability=[
            1.0 - sum(min(e, T) - min(s, T) for s, e in spans_of[r])
            / max(T, 1e-12) for r in range(R)])
    return ResilientFleetResult(waits, e2e, lost, sizes, makespan,
                                replica_of, per, report)


class ResilientFleetScheduler:
    """Virtual-timeline fleet with the resilience path: the fault-aware
    twin of :class:`repro_torch.serving.router.FleetScheduler`.  The same
    constructor plus the fault knobs of :func:`run_resilient_fleet`."""

    def __init__(self, router, policy: BatchPolicy, clock: ModelClock,
                 R: int, predictor=None, predict_seed: int = 0, *,
                 faults=None, kill_at: Optional[Dict[int, float]] = None,
                 seed: int = 0, shed_prob: float = 0.0,
                 hedge_slo: Optional[float] = None,
                 max_retries: Optional[int] = None,
                 retry_backoff: Optional[float] = None,
                 scale_schedule: Optional[List[Tuple[float, int]]] = None,
                 down_spans: Optional[
                     List[List[Tuple[float, float]]]] = None):
        assert R >= 1
        self.router = router_from_spec(router)
        self.policy = policy
        self.clock = clock
        self.R = int(R)
        self.predictor = predictor
        self.predict_seed = predict_seed
        self.fault_kw = dict(
            faults=faults, kill_at=kill_at, seed=seed, shed_prob=shed_prob,
            hedge_slo=hedge_slo, max_retries=max_retries,
            retry_backoff=retry_backoff, scale_schedule=scale_schedule,
            down_spans=down_spans)

    def run(self, reqs: List[Request]) -> ResilientFleetResult:
        pol = self.policy

        def runner(r, sub, predicted):
            if isinstance(pol, ContinuousPolicy):
                return pol.scheduler(self.clock).run(sub)
            return PolicyScheduler(pol, self.clock,
                                   predict_seed=self.predict_seed).run(
                sub, predicted=predicted)

        return run_resilient_fleet(
            self.router, pol, reqs, getattr(self.clock, "single", None),
            self.predictor, self.predict_seed, self.R, runner,
            batch_lat=getattr(self.clock, "batch", None),
            clock=self.clock if isinstance(self.clock, ModelClock) else None,
            **self.fault_kw)


def run_resilient_engine_fleet(router, policy: BatchPolicy, engines,
                               reqs: List[Request],
                               R: Optional[int] = None, lat=None,
                               predictor=None, predict_seed: int = 0,
                               **fault_kw) -> ResilientFleetResult:
    """Engine-layer resilient fleet: the fault-aware twin of
    :func:`repro_torch.serving.router.run_fleet_schedule`.  Each
    replica's FINAL entry list (after kills, retries and hedges) runs on a
    real engine; with a ``BatchLatencyModel`` as ``lat``, victims are
    picked on the policy's virtual timeline under that law."""
    if isinstance(engines, (list, tuple)):
        engine_of = list(engines)
        if R is None:
            R = len(engine_of)
        assert R == len(engine_of)
    else:
        assert R is not None and R >= 1, "pass R with a single shared engine"
        engine_of = [engines] * R

    def runner(r, sub, predicted):
        return run_engine_schedule(policy, engine_of[r], sub,
                                   predict_seed=predict_seed,
                                   predicted=predicted)

    clock = None
    if isinstance(lat, BatchLatencyModel):
        clock = ModelClock(single_from_batch(lat), lat)
    return run_resilient_fleet(router, policy, reqs, lat, predictor,
                               predict_seed, R, runner, clock=clock,
                               **fault_kw)


__all__ = ["ResilienceReport", "ResilientFleetResult",
           "ResilientFleetScheduler", "run_resilient_engine_fleet",
           "run_resilient_fleet", "scale_spans"]
