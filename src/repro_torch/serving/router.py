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

The resilience path (``faults=`` and its knobs: kill, shed, hedge) is not
ported yet (ROADMAP.md M7b, serving resilience), nor are per-replica KV
budgets (M7d) or sessions (M7c); each raises ``NotImplementedError``.

:func:`summarize_fleet` reports aggregate + per-replica serving metrics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.fleet import router_from_spec
from repro_torch.core.policies import (
    BatchPolicy, ContinuousPolicy, Workload, not_ported)
from repro_torch.data.pipeline import Request
from repro_torch.serving.metrics import summarize
from repro_torch.serving.scheduler import (
    ModelClock, PolicyScheduler, ScheduleResult, _request_predictions,
    run_engine_schedule)


def _check_ported(faults, fault_kw, memory):
    if faults is not None or fault_kw:
        not_ported("the serving resilience path (faults= and its knobs "
                   "kill_at, shed_prob, hedge_slo, ...)",
                   "M7b, serving resilience")
    if memory is not None:
        not_ported("per-replica KV budgets (memory=)", "M7d (KV memory)")


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
    return FleetScheduleResult(waits, e2e, lost, sizes, makespan, rep, per)


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
    parameter."""

    def __init__(self, router, policy: BatchPolicy, clock: ModelClock,
                 R: int, predictor=None, predict_seed: int = 0,
                 faults=None, memory=None, **fault_kw):
        _check_ported(faults, fault_kw, memory)
        assert R >= 1
        self.router = router_from_spec(router)
        self.policy = policy
        self.clock = clock
        self.R = int(R)
        self.predictor = predictor
        self.predict_seed = predict_seed

    def run(self, reqs: List[Request]) -> FleetScheduleResult:
        pol = self.policy

        def runner(r, sub, predicted):
            if isinstance(pol, ContinuousPolicy):
                # continuous batching binds its own scheduler (slot refill
                # has no formation(); admission is FCFS, prediction-free)
                return pol.scheduler(self.clock).run(sub)
            return PolicyScheduler(pol, self.clock,
                                   predict_seed=self.predict_seed).run(
                sub, predicted=predicted)

        return _route_and_dispatch(self.router, pol, reqs,
                                   getattr(self.clock, "single", None),
                                   self.predictor, self.predict_seed,
                                   self.R, runner)

    def run_sessions(self, reqs: List[Request],
                     prefix_discount: float = 0.0) -> FleetScheduleResult:
        not_ported("the session-aware fleet timeline", "M7c (sessions)")


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
    routers fall back to raw predicted tokens as the work unit."""
    _check_ported(faults, fault_kw, memory)
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
