"""Fleet serving layer: a RoutingPolicy in front of R replica schedulers,
a copy of ``repro.serving.router``.

:mod:`repro_torch.core.fleet` defines *what* a router is (assignment as a
function of arrivals + predicted work, never of replica service state) and
runs it on the simulator layers; this module runs the same routers on the
request-list layers:

  * :class:`FleetScheduler` — the virtual-timeline fleet: route a request
    list, then drive R independent :class:`~repro_torch.serving.scheduler.
    PolicyScheduler` timelines (one per replica, any registered
    ``BatchPolicy``) and merge the results back into global request order.
  * :func:`run_fleet_schedule` — the engine fleet: each replica's batches
    execute on a REAL engine (one :class:`~repro_torch.serving.engine.
    Engine` per replica, or one engine shared across replica-tagged
    batches: replica timelines are virtual, so wall-clock batch durations
    compose either way).

Both resolve the predicted-length column ONCE for the whole fleet
(:func:`repro_torch.core.predictors.resolve_predictions`) and hand each
replica its slice, so routing (``least_work`` backlogs) and membership
(SRPT ordering, multi-bin routing) see one consistent set of predictions.
Routing runs the host NumPy recursion, as the reference's serving layer
does (``router.assign`` without ``fast``).

``faults=`` or any resilience knob (``kill_at``, ``shed_prob``,
``hedge_slo``, ...) reroutes both through the fault-aware twins of
:mod:`repro_torch.serving.resilience`; ``FleetScheduler.run_sessions``
runs re-entrant sessions (:mod:`repro_torch.core.sessions`) with a routing
pass per fixed-point iteration.  ``memory=`` gives each replica its own KV
budget (:mod:`repro_torch.core.memory`); it is not composed with the
resilience path, nor with sessions.

:func:`summarize_fleet` reports aggregate + per-replica serving metrics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.fleet import router_from_spec
from repro_torch.core.policies import (
    BatchPolicy, ContinuousPolicy, Workload)
from repro_torch.data.pipeline import Request
from repro_torch.serving.metrics import summarize
from repro_torch.serving.resilience import (
    ResilientFleetScheduler, run_resilient_engine_fleet)
from repro_torch.serving.scheduler import (
    ModelClock, PolicyScheduler, ScheduleResult, _request_predictions,
    run_engine_schedule)


@dataclasses.dataclass
class FleetScheduleResult:
    """ScheduleResult-compatible aggregate (``summarize`` consumes it
    directly) plus the routing decomposition.  Requests a replica's policy
    never serves (fixed batching's ragged tail) are marked ``lost``."""

    waits: np.ndarray            # global request order
    e2e: np.ndarray
    lost: np.ndarray
    batch_sizes: List[int]
    makespan: float              # latest replica makespan
    replica_of: np.ndarray
    per_replica: List[ScheduleResult]
    # per-session accounting (repro_torch.core.sessions); None on
    # session-free runs
    sessions: Optional[dict] = None
    # fleet KV-occupancy accounting (repro_torch.core.memory); None on
    # budget-free runs
    memory: Optional[dict] = None


def _fleet_memory(per) -> Optional[dict]:
    """Fleet roll-up of per-replica KV accounting: each replica has its
    OWN budget (per-replica HBM, not a pooled resource), so peaks and
    utilizations take the worst replica and token/event counts sum."""
    live = [p for p in per if p is not None]
    ms = [getattr(p, "memory", None) for p in live]
    if not ms or any(m is None for m in ms):
        return None
    ws = np.array([max(len(p.waits), 1) for p in live], np.float64)
    out = {
        "capacity": ms[0]["capacity"],
        "kv_peak": max(m["kv_peak"] for m in ms),
        "kv_mean": float(np.average([m["kv_mean"] for m in ms],
                                    weights=ws)),
        "utilization": max(m["utilization"] for m in ms),
        "allocated": float(sum(m["allocated"] for m in ms)),
        "freed": float(sum(m["freed"] for m in ms)),
        "deferred_requests": int(sum(m.get("deferred_requests", 0)
                                     for m in ms)),
    }
    if all("blocked_batches" in m for m in ms):
        out["blocked_batches"] = int(sum(m["blocked_batches"] for m in ms))
        out["blocked_time"] = float(sum(m["blocked_time"] for m in ms))
    return out


def _fleet_predictions(policy, predictor, predict_seed: int,
                       ns: np.ndarray, reqs: List[Request]):
    """(membership predictions, the routing view of the stream): both
    drawn once, globally — a router's own predictor (if any) overrides
    only its work estimate inside ``routing_work``, never the membership
    column."""
    predicted = _request_predictions(policy, predictor, predict_seed, ns,
                                     reqs)
    sess = np.array([r.session for r in reqs], np.int64)
    has_sessions = bool(len(sess)) and bool((sess >= 0).any())
    return predicted, Workload(
        arrivals=np.array([r.arrival for r in reqs]),
        tokens=ns, predicted=predicted,
        session=sess if has_sessions else None,
        turn=(np.array([r.turn for r in reqs], np.int64)
              if has_sessions else None))


def _merge_replicas(reqs, rep, per, n_total) -> FleetScheduleResult:
    waits = np.zeros(n_total)
    e2e = np.zeros(n_total)
    lost = np.ones(n_total, bool)      # un-served stays lost (ragged tails)
    sizes: List[int] = []
    makespan = 0.0
    for r, res in enumerate(per):
        if res is None:
            continue
        gi = np.nonzero(rep == r)[0][:len(res.waits)]
        waits[gi] = res.waits
        e2e[gi] = res.e2e
        lost[gi] = res.lost
        sizes += list(res.batch_sizes)
        makespan = max(makespan, res.makespan)
    return FleetScheduleResult(waits, e2e, lost, sizes, makespan,
                               rep, per, memory=_fleet_memory(per))


def _route_and_dispatch(router, policy: BatchPolicy, reqs: List[Request],
                        work_lat, predictor, predict_seed: int, R: int,
                        runner) -> FleetScheduleResult:
    """The one serving-layer fleet body shared by :class:`FleetScheduler`
    and :func:`run_fleet_schedule`: resolve the global predicted column,
    estimate routing work (request prompts reach a router-owned
    predictor), assign, then hand each replica's sub-list + prediction
    slice to ``runner(replica, sub_reqs, predicted_slice)``."""
    router = router_from_spec(router)
    ns = np.array([policy.clip(r.target_output_tokens) for r in reqs],
                  np.float64)
    predicted, wl = _fleet_predictions(policy, predictor, predict_seed,
                                       ns, reqs)
    work = router.routing_work(wl, work_lat, predict_seed,
                               prompts=[r.prompt_tokens for r in reqs])
    rep = np.asarray(router.assign(wl.arrivals, work, R, predict_seed,
                                   sessions=wl.session),
                     np.int64)
    per: List[Optional[ScheduleResult]] = []
    for r in range(R):
        idx = np.nonzero(rep == r)[0]
        if not len(idx):
            per.append(None)
            continue
        per.append(runner(r, [reqs[i] for i in idx],
                          None if predicted is None else predicted[idx]))
    return _merge_replicas(reqs, rep, per, len(reqs))


class FleetScheduler:
    """Bind a router + a batch policy to R virtual-timeline replicas.

    ``router``: a :mod:`repro_torch.core.fleet` RoutingPolicy, registry
    name, or spec dict.  ``policy`` is the template every replica runs
    (policies are stateless between runs, so one instance serves all
    replicas).  ``predictor`` overrides the policy's length predictor
    exactly like :class:`~repro_torch.serving.scheduler.PolicyScheduler`'s
    parameter.  ``faults`` (a fault model, name or spec) or any knob of
    :class:`~repro_torch.serving.resilience.ResilientFleetScheduler`
    (``kill_at``, ``shed_prob``, ``hedge_slo``, ...) makes :meth:`run`
    the fault-aware twin; without them it keeps the fault-free body.
    ``memory`` gives every replica its own copy of a KV budget (its own
    HBM): each runs :class:`PolicyScheduler`'s memory-gated tandem."""

    def __init__(self, router, policy: BatchPolicy, clock: ModelClock,
                 R: int, predictor=None, predict_seed: int = 0,
                 faults=None, memory=None, **fault_kw):
        assert R >= 1
        self.router = router_from_spec(router)
        self.policy = policy
        self.clock = clock
        self.R = int(R)
        self.predictor = predictor
        self.predict_seed = predict_seed
        self.faults = faults
        self.fault_kw = fault_kw
        from repro_torch.core.memory import (
            check_policy_supports_memory, memory_from_spec)
        budget = memory_from_spec(memory)
        if budget.is_null:
            self.memory = None
        else:
            check_policy_supports_memory(policy)
            if faults is not None or fault_kw:
                raise ValueError(
                    "memory= is not composed with the serving resilience "
                    "path; use the core layers (simulate/fastsim) for "
                    "faults x memory")
            self.memory = budget

    def run(self, reqs: List[Request]) -> FleetScheduleResult:
        pol = self.policy
        if self.faults is not None or self.fault_kw:
            return ResilientFleetScheduler(
                self.router, pol, self.clock, self.R,
                predictor=self.predictor, predict_seed=self.predict_seed,
                faults=self.faults, **self.fault_kw).run(reqs)

        def runner(r, sub, predicted):
            if isinstance(pol, ContinuousPolicy):
                # continuous batching binds its own scheduler (slot refill
                # has no formation(); admission is FCFS, prediction-free)
                return pol.scheduler(self.clock).run(sub)
            return PolicyScheduler(pol, self.clock,
                                   predict_seed=self.predict_seed,
                                   memory=self.memory).run(
                sub, predicted=predicted)

        return _route_and_dispatch(self.router, pol, reqs,
                                   getattr(self.clock, "single", None),
                                   self.predictor, self.predict_seed,
                                   self.R, runner)

    def run_sessions(self, reqs: List[Request],
                     prefix_discount: float = 0.0) -> FleetScheduleResult:
        """Session-aware fleet timeline: the feedback fixed point of
        :mod:`repro_torch.core.sessions` with a routing pass per
        iteration: turn t+1 re-enters the GLOBAL queue at turn t's
        completion + ``think`` and is re-routed (sticky routers key on
        the session column).  ``prefix_discount`` γ: a turn >= 2 landing
        on its parent's replica finds the session's KV there and serves
        ``tokens·(1−γ)``; on any other replica the full length is served.
        A stream with no multi-turn rows takes the plain :meth:`run`
        path.  The resilience path is not composed with sessions."""
        if all(r.turn <= 1 for r in reqs):
            return self.run(reqs)
        if self.faults is not None or self.fault_kw:
            raise ValueError("sessions are not composed with the serving "
                             "resilience path; construct the "
                             "FleetScheduler without faults/knobs")
        if self.memory is not None:
            raise ValueError(
                "sessions x memory is not supported: turn re-entry holds "
                "KV across think times, which the per-batch "
                "allocate/release ledger does not model")
        from repro_torch.core.sessions import (
            _MAX_PASSES, _TOL, _cascade_cancel, _session_summary,
            check_policy_supports_sessions, plan_from_requests)
        pol = self.policy
        check_policy_supports_sessions(pol)
        router = self.router
        m = len(reqs)
        turn = np.array([r.turn for r in reqs], np.int64)
        plan, order_sm, lb = plan_from_requests(reqs)
        ns_full = np.array([pol.clip(r.target_output_tokens) for r in reqs],
                           np.float64)
        predicted, _ = _fleet_predictions(pol, self.predictor,
                                          self.predict_seed, ns_full, reqs)
        prompts = [r.prompt_tokens for r in reqs]
        tok_true = np.array([r.target_output_tokens for r in reqs],
                            np.int64)
        disc_tok = tok_true.copy()
        if prefix_discount > 0.0:
            later = turn > 1
            disc_tok[later] = np.maximum(
                1, np.round(tok_true[later]
                            * (1.0 - prefix_discount)).astype(np.int64))
        arr = lb.copy()
        child = np.nonzero(plan.parent >= 0)[0]
        cancelled = np.zeros(m, bool)
        lost = np.zeros(m, bool)
        rep_row = np.full(m, -1, np.int64)
        ids = np.arange(m)
        w_row = np.zeros(m)
        e2e_row = np.zeros(m)
        comp = np.full(m, np.inf)
        per: List[Optional[ScheduleResult]] = []
        sizes: List[int] = []
        makespan = 0.0
        canc_pass = cancelled
        seen_states = set()
        for _ in range(_MAX_PASSES):
            canc_pass = cancelled   # the set that defines this pass's ids
            active = np.nonzero(~cancelled)[0]
            ids = active[np.lexsort((active, arr[active]))]
            ridx = order_sm[ids]
            wl = Workload(
                arrivals=arr[ids], tokens=ns_full[ridx],
                predicted=None if predicted is None else predicted[ridx],
                session=plan.session[ids], turn=plan.turn[ids])
            work = router.routing_work(wl, getattr(self.clock, "single",
                                                   None),
                                       self.predict_seed,
                                       prompts=[prompts[i] for i in ridx])
            rep_s = np.asarray(router.assign(wl.arrivals, work, self.R,
                                             self.predict_seed,
                                             sessions=wl.session), np.int64)
            new_rep = np.full(m, -1, np.int64)
            new_rep[ids] = rep_s
            sticky = np.zeros(m, bool)
            sticky[child] = (new_rep[child] >= 0) & \
                (new_rep[child] == new_rep[plan.parent[child]])
            comp = np.full(m, np.inf)
            w_row = np.zeros(m)
            e2e_row = np.zeros(m)
            lost_row = np.zeros(m, bool)
            per = []
            sizes = []
            makespan = 0.0
            for r in range(self.R):
                mask = rep_s == r
                sub_p = ids[mask]
                if not len(sub_p):
                    per.append(None)
                    continue
                sub_r = order_sm[sub_p]
                sub_reqs = [dataclasses.replace(
                    reqs[i], arrival=float(arr[p]),
                    target_output_tokens=int(
                        disc_tok[i] if sticky[p] else tok_true[i]))
                    for p, i in zip(sub_p, sub_r)]
                res = PolicyScheduler(
                    pol, self.clock,
                    predict_seed=self.predict_seed).run(
                    sub_reqs, predicted=(None if predicted is None
                                         else predicted[sub_r]))
                per.append(res)
                srv = ~res.lost
                comp[sub_p[srv]] = arr[sub_p[srv]] + res.e2e[srv]
                w_row[sub_p] = res.waits
                e2e_row[sub_p] = res.e2e
                lost_row[sub_p] = res.lost
                sizes += list(res.batch_sizes)
                makespan = max(makespan, res.makespan)
            new_cancelled = _cascade_cancel(plan, lost_row)
            new_arr = arr.copy()
            new_arr[child] = comp[plan.parent[child]] + plan.think[child]
            unresolved = child[~np.isfinite(new_arr[child])]
            new_arr[unresolved] = lb[unresolved]
            new_arr[new_cancelled] = lb[new_cancelled]
            live = child[~new_cancelled[child]]
            delta = float(np.max(np.abs(new_arr[live] - arr[live]))) \
                if len(live) else 0.0
            stable = (np.array_equal(new_cancelled, cancelled)
                      and np.array_equal(lost_row, lost)
                      and np.array_equal(new_rep, rep_row))
            arr, cancelled, lost, rep_row = (new_arr, new_cancelled,
                                             lost_row, new_rep)
            if stable and delta <= _TOL:
                break
            if not stable:
                # shedding can cycle the lost/cancel sets (no fixed
                # point); a repeated set state never converges
                state = (new_cancelled.tobytes(), lost_row.tobytes(),
                         new_rep.tobytes())
                if state in seen_states:
                    break
                seen_states.add(state)
        # report the last SIMULATED pass's cancel set: identical on a
        # converged break, self-consistent on pass exhaustion
        cancelled = canc_pass
        return FleetScheduleResult(
            w_row[ids], e2e_row[ids], lost[ids], sizes, makespan,
            rep_row[ids], per,
            sessions=_session_summary(plan, arr, w_row, comp, cancelled,
                                      lost))


def run_fleet_schedule(router, policy: BatchPolicy,
                       engines, reqs: List[Request],
                       R: Optional[int] = None, lat=None,
                       predictor=None, predict_seed: int = 0,
                       faults=None, memory=None,
                       **fault_kw) -> FleetScheduleResult:
    """Execute a routed fleet on the REAL engine layer: form each
    replica's batches on the virtual arrival timeline and run them through
    :func:`~repro_torch.serving.scheduler.run_engine_schedule` (prefill +
    fused chunked decode, wall-clock batch durations).

    ``engines``: a list of R :class:`~repro_torch.serving.engine.Engine`
    instances, or ONE engine shared by every replica (replica timelines
    are virtual, so batches are simply replica-tagged work on the same
    hardware).  ``lat`` (a ``BatchLatencyModel``/``LatencyModel``)
    calibrates the router's work units in seconds; without it the backlog
    routers fall back to raw predicted tokens as the work unit.

    ``faults`` (a :mod:`repro_torch.core.faults` model, name or spec) or
    any resilience knob (``kill_at``, ``shed_prob``, ``hedge_slo``, ...)
    reroutes through
    :func:`repro_torch.serving.resilience.run_resilient_engine_fleet`;
    without them the fault-free body runs.

    ``memory`` (budget spec, :mod:`repro_torch.core.memory`): each replica
    admits against its OWN KV budget via
    :func:`~repro_torch.serving.scheduler.run_engine_schedule`'s
    real-footprint gate (not composed with the resilience path)."""
    if memory is not None and (faults is not None or fault_kw):
        raise ValueError(
            "memory= is not composed with the serving resilience path; "
            "use the core layers (simulate/fastsim) for faults x memory")
    if faults is not None or fault_kw:
        return run_resilient_engine_fleet(
            router, policy, engines, reqs, R=R, lat=lat,
            predictor=predictor, predict_seed=predict_seed,
            faults=faults, **fault_kw)
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
                                   predicted=predicted, memory=memory)

    return _route_and_dispatch(router, policy, reqs, lat, predictor,
                               predict_seed, R, runner)


def summarize_fleet(result: FleetScheduleResult,
                    warmup_frac: float = 0.1) -> dict:
    """Aggregate serving metrics plus the per-replica breakdown and the
    load split (requests per replica)."""
    out = summarize(result, warmup_frac=warmup_frac)
    rep = result.replica_of
    out["replica_requests"] = np.bincount(
        rep[rep >= 0], minlength=len(result.per_replica)).tolist()
    out["per_replica"] = [
        None if res is None else summarize(res, warmup_frac=warmup_frac)
        for res in result.per_replica]
    return out


__all__ = ["FleetScheduleResult", "FleetScheduler", "run_fleet_schedule",
           "summarize_fleet"]
