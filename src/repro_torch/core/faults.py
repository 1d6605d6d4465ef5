"""Fault models: deterministic failure injection for every layer, a copy
of ``repro.core.faults``.

The paper's queueing models (and the fleet built on them) assume servers
never fail.  This module makes faults a first-class *registered*
component, mirroring the policy / predictor / router registries: a
:class:`FaultModel` describes how replicas break, and the SAME model is
injected into the simulator and analytic layers —

  * the reference oracle and the card's kernels through an
    **operational-time transform** (below) plus a shared host-side
    retry loop (:func:`simulate_fleet_faulty`),
  * the analytic layer through :func:`repro_torch.core.bulk.breakdown_wait`
    (M/G/1-with-breakdowns completion-time decomposition) and the
    availability-discounted :func:`effective_lambda` transfer.

The serving layer's resilience path (drain, re-dispatch, hedging, dedup
on real schedulers and engines) is not ported yet (ROADMAP.md M7b, serving
resilience).

Registered models (``FAULTS``):

  * ``none``     — the null model; every layer is bit-equal to its
    fault-free behaviour.
  * ``crash``    — replica crash/repair as an **alternating renewal
    process**: up-times ~ Exp(mtbf), down-times ~ Exp(mttr).  While
    down a replica serves nothing and accepts no arrivals; at a crash
    epoch the replica's in-flight batch AND local queue are lost and the
    affected requests are re-dispatched (exponential backoff) to the
    back of a surviving replica's queue.  ``lose_work=False`` switches
    to preemptive-resume semantics (service freezes, nothing is lost) —
    the exactly-analyzable M/G/1-with-breakdowns mode the closed form in
    :func:`repro_torch.core.bulk.breakdown_wait` is validated against.
  * ``slowdown`` — straggler episodes (alternating renewal like crash)
    during which the replica runs at ``1/factor`` speed: the latency law
    is scaled, nothing is lost, arrivals are still accepted.
  * ``drop``     — per-request admission drop with probability ``p``
    (shed at the dispatcher; never enters any queue).

Determinism: every random draw comes from ``np.random.default_rng`` on a
``SeedSequence`` salted with ``_FAULT_SALT`` — a stream independent of
the workload, predictor (``_PRED_SALT``) and router (``_ROUTE_SALT``)
streams, so turning a fault model on NEVER perturbs the sampled workload
(bit-identical arrivals/tokens), and the same (seed, replica) always
yields the same failure epochs on every layer.

The operational-time transform
------------------------------

A replica with episodes ``[s_k, e_k)`` running at speed ``phi`` during
an episode (0 for crash, 1/factor for slowdown) accumulates service
capacity ``A(t) = \\int_0^t speed(u) du``.  A work-conserving queue on a
breaking server is EXACTLY the fault-free queue run in operational time:
map arrivals ``t -> A(t)``, run the unchanged single-server event loop /
kernel, and map service starts back through the inverse ``A^{-1}``.
Batch-formation timers (WAIT timeouts, dynamic triggers) run on the
replica's operational clock — the clock freezes while the replica is
down — which is what makes the transform exact rather than approximate.
Crash-mode work LOSS is layered on top by the retry loop: at each
crash epoch, entries still in system are removed and re-dispatched, and
the replica trajectory is recomputed — identical across oracle and
fastsim because the loop is shared and only the per-replica simulator
(reference loop vs the card's kernel) differs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Type

import numpy as np

from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.policies import BatchPolicy, Workload
from repro_torch.kernels import resolve_device

# Salt for every fault-model rng stream: independent of the workload
# stream, the predictor stream (_PRED_SALT) and the router stream
# (_ROUTE_SALT), so fault injection never perturbs the sampled workload.
_FAULT_SALT = 0xFA111E57
# Key lanes inside the fault stream (episode draws use the replica id
# as the lane), kept disjoint from replica ids by a large offset.
_DROP_LANE = 1_000_003
_REROUTE_LANE = 1_000_033
_RETRY_LANE = 1_000_081


def _fault_rng(seed, *lanes) -> np.random.Generator:
    parts = [int(k) for k in seed] if isinstance(seed, (tuple, list)) \
        else [int(seed)]
    return np.random.default_rng(np.random.SeedSequence(
        [_FAULT_SALT] + parts + [int(x) for x in lanes]))


# ----------------------------------------------------------------------------
# Replica fault trace + the operational-time transform
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaTrace:
    """One replica's failure epochs: disjoint sorted episodes
    ``[starts_k, ends_k)`` served at ``speed`` (0 = down, (0,1) =
    straggling).  All transform math lives here so the oracle and the
    fast layer share bit-identical host-side arithmetic."""

    starts: np.ndarray
    ends: np.ndarray
    speed: float = 0.0

    @property
    def empty(self) -> bool:
        return len(self.starts) == 0

    # capacity lost inside episodes before each episode start (cum[k] =
    # capacity lost in episodes 0..k-1); one extra entry for "after all"
    def _cumloss(self) -> np.ndarray:
        lost = (1.0 - self.speed) * (self.ends - self.starts)
        return np.concatenate([[0.0], np.cumsum(lost)])

    def op_time(self, t) -> np.ndarray:
        """A(t): cumulative service capacity by wall time t."""
        t = np.asarray(t, np.float64)
        if self.empty:
            return t.copy()
        cum = self._cumloss()
        j = np.searchsorted(self.starts, t, side="right")
        inside = (j > 0) & (t < self.ends[np.maximum(j - 1, 0)])
        k = np.maximum(j - 1, 0)
        # written so that speed=0 yields EXACTLY starts[k] - cum[k] (the
        # same float ops wall_time uses for its flat levels), keeping the
        # flat-skip branch bit-stable under rounding
        a_in = (self.starts[k] - cum[k]) + self.speed * (t - self.starts[k])
        a_out = t - cum[j]
        return np.where(inside, a_in, a_out)

    def wall_time(self, u) -> np.ndarray:
        """Inverse transform: earliest wall time at which the replica has
        accumulated capacity u, skipping zero-speed flats (a service
        event landing exactly on a down episode's capacity level resumes
        at the episode END — the server is down until then)."""
        u = np.asarray(u, np.float64)
        if self.empty:
            return u.copy()
        cum = self._cumloss()
        a_starts = self.starts - cum[:-1]          # A at episode starts
        a_ends = self.ends - cum[1:]               # A at episode ends
        j = np.searchsorted(a_starts, u, side="right")
        k = np.maximum(j - 1, 0)
        inside = (j > 0) & (u <= a_ends[k])
        if self.speed > 0.0:
            t_in = self.starts[k] + (u - a_starts[k]) / self.speed
        else:
            t_in = self.ends[k]                    # skip the flat
        t_out = u + cum[j]
        return np.where(inside, t_in, t_out)

    def up_at(self, t) -> np.ndarray:
        """Accepting arrivals at wall time t?  Down only inside a
        speed-0 (crash) episode; straggling replicas still accept."""
        t = np.asarray(t, np.float64)
        if self.empty or self.speed > 0.0:
            return np.ones(t.shape, bool)
        j = np.searchsorted(self.starts, t, side="right")
        return ~((j > 0) & (t < self.ends[np.maximum(j - 1, 0)]))

    def next_up(self, t) -> np.ndarray:
        """Earliest wall time >= t at which the replica accepts again."""
        t = np.asarray(t, np.float64)
        if self.empty or self.speed > 0.0:
            return t.copy()
        j = np.searchsorted(self.starts, t, side="right")
        k = np.maximum(j - 1, 0)
        inside = (j > 0) & (t < self.ends[k])
        return np.where(inside, self.ends[k], t)

    def crash_starts(self) -> np.ndarray:
        return self.starts if self.speed == 0.0 else np.zeros(0)

    def availability(self, T: float) -> float:
        """Fraction of [0, T] the replica is up (speed-0 episodes only)."""
        if self.empty or self.speed > 0.0 or T <= 0:
            return 1.0
        down = np.clip(np.minimum(self.ends, T)
                       - np.minimum(self.starts, T), 0.0, None).sum()
        return float(1.0 - down / T)


_EMPTY_TRACE = ReplicaTrace(np.zeros(0), np.zeros(0), 0.0)


def _renewal_episodes(rng: np.random.Generator, mean_up: float,
                      mean_down: float, horizon: float):
    """Alternating renewal episodes on [0, horizon]: up ~ Exp(mean_up),
    down ~ Exp(mean_down), starting up at t=0.  Infinite means yield no
    episodes / episodes clamped at the horizon."""
    if not np.isfinite(mean_up) or mean_up <= 0 or horizon <= 0:
        return np.zeros(0), np.zeros(0)
    md = mean_down if np.isfinite(mean_down) else 0.0
    cycle = mean_up + md
    starts_parts: List[np.ndarray] = []
    ends_parts: List[np.ndarray] = []
    t = 0.0
    while t < horizon:
        # Draw a block of whole up/down cycles at once; expected count plus
        # a safety margin so almost every horizon needs a single block.
        est = (horizon - t) / cycle
        m = int(est + 6.0 * math.sqrt(est + 1.0)) + 16
        ups = rng.exponential(mean_up, m)
        downs = rng.exponential(mean_down, m) if np.isfinite(mean_down) \
            else np.full(m, math.inf)
        s = t + np.cumsum(ups) + np.concatenate(
            ([0.0], np.cumsum(downs)[:-1]))
        e = np.minimum(s + downs, horizon)
        keep = s < horizon
        starts_parts.append(s[keep])
        ends_parts.append(e[keep])
        if not keep.all():          # horizon reached inside this block
            t = horizon
            break
        t = float(e[-1])
        if not np.isfinite(mean_down):
            break
    starts = np.concatenate(starts_parts) if starts_parts else np.zeros(0)
    ends = np.concatenate(ends_parts) if ends_parts else np.zeros(0)
    # A down period pinned at the horizon absorbs everything after it.
    cut = np.searchsorted(ends, horizon, "left") + 1
    return starts[:cut], ends[:cut]


# ----------------------------------------------------------------------------
# Fault-model registry
# ----------------------------------------------------------------------------

FAULTS: Dict[str, Type["FaultModel"]] = {}


def register_fault(cls: Type["FaultModel"]) -> Type["FaultModel"]:
    FAULTS[cls.name] = cls
    return cls


def get_fault(name: str, **kwargs) -> "FaultModel":
    return FAULTS[name](**kwargs)


def fault_from_spec(spec) -> "FaultModel":
    """``FaultModel`` | registry name | ``{"kind": name, **params}`` |
    None (the null model) -> instance."""
    if spec is None:
        return NoFaults()
    if isinstance(spec, FaultModel):
        return spec
    if isinstance(spec, str):
        return get_fault(spec)
    spec = dict(spec)
    return get_fault(spec.pop("kind"), **spec)


def default_faults() -> Dict[str, "FaultModel"]:
    """One representative instance per registered model — the set the
    fault tests and the registry-driven benchmarks iterate."""
    return {
        "none": NoFaults(),
        "crash": CrashRepair(mtbf=200.0, mttr=10.0),
        "slowdown": Slowdown(mtbf=150.0, duration=15.0, factor=3.0),
        "drop": RequestDrop(p=0.05),
    }


class FaultModel:
    """One failure discipline, defined once for every layer.

    ``trace(seed, replica, horizon)`` draws that replica's episodes from
    the salted fault stream; ``drop_mask(seed, n)`` the per-request
    admission drops; ``capacity()`` the long-run service-capacity factor
    the analytic layer discounts λ by (:func:`effective_lambda`)."""

    name = "base"
    lose_work = False            # crash-mode work loss (retry loop)
    max_retries = 3
    retry_backoff = 0.0

    def trace(self, seed, replica: int, horizon: float) -> ReplicaTrace:
        return _EMPTY_TRACE

    def drop_mask(self, seed, n: int) -> np.ndarray:
        return np.zeros(n, bool)

    def capacity(self) -> float:
        return 1.0

    @property
    def is_null(self) -> bool:
        return True

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items() if v is not None}
        return f"{type(self).__name__}({keys})"


@register_fault
class NoFaults(FaultModel):
    """The null model: no episodes, no drops.  Every layer run under it
    is bit-equal to the fault-free path (pinned in tests)."""

    name = "none"


@register_fault
class CrashRepair(FaultModel):
    """Replica crash/repair as an alternating renewal process: up-times
    ~ Exp(``mtbf``), down-times ~ Exp(``mttr``).  Down replicas accept
    no arrivals and serve nothing.  ``lose_work=True`` (default): at a
    crash epoch the in-flight batch and the local queue are lost and
    re-dispatched with backoff ``retry_backoff * 2**attempt`` (at most
    ``max_retries`` attempts, then the request is failed).
    ``lose_work=False``: preemptive-resume — the replica freezes and
    continues after repair; nothing is re-dispatched (the exactly-
    analyzable M/G/1-with-breakdowns mode)."""

    name = "crash"

    def __init__(self, mtbf: float = 200.0, mttr: float = 10.0,
                 lose_work: bool = True, retry_backoff: float = 0.1,
                 max_retries: int = 3):
        assert mtbf > 0 and mttr > 0
        self.mtbf = float(mtbf)
        self.mttr = float(mttr)
        self.lose_work = bool(lose_work)
        self.retry_backoff = float(retry_backoff)
        self.max_retries = int(max_retries)

    def trace(self, seed, replica: int, horizon: float) -> ReplicaTrace:
        rng = _fault_rng(seed, replica)
        s, e = _renewal_episodes(rng, self.mtbf, self.mttr, horizon)
        return ReplicaTrace(s, e, 0.0)

    def capacity(self) -> float:
        if not np.isfinite(self.mtbf):
            return 1.0
        return self.mtbf / (self.mtbf + self.mttr)

    @property
    def is_null(self) -> bool:
        return not np.isfinite(self.mtbf)


@register_fault
class Slowdown(FaultModel):
    """Straggler episodes: alternating renewal with normal periods
    ~ Exp(``mtbf``) and episodes ~ Exp(``duration``) during which the
    replica serves at 1/``factor`` speed (the latency law is scaled).
    Nothing is lost and arrivals are still accepted — delay comes purely
    through the operational-time stretch."""

    name = "slowdown"

    def __init__(self, mtbf: float = 150.0, duration: float = 15.0,
                 factor: float = 3.0):
        assert factor >= 1.0 and mtbf > 0 and duration > 0
        self.mtbf = float(mtbf)
        self.duration = float(duration)
        self.factor = float(factor)

    def trace(self, seed, replica: int, horizon: float) -> ReplicaTrace:
        rng = _fault_rng(seed, replica)
        s, e = _renewal_episodes(rng, self.mtbf, self.duration, horizon)
        return ReplicaTrace(s, e, 1.0 / self.factor)

    def capacity(self) -> float:
        if not np.isfinite(self.mtbf):
            return 1.0
        frac = self.duration / (self.mtbf + self.duration)
        return 1.0 - (1.0 - 1.0 / self.factor) * frac

    @property
    def is_null(self) -> bool:
        return not np.isfinite(self.mtbf) or self.factor == 1.0


@register_fault
class RequestDrop(FaultModel):
    """Per-request admission drop with probability ``p``: the dispatcher
    sheds the request before it enters any queue (counted, never
    served).  Replicas themselves never fail."""

    name = "drop"

    def __init__(self, p: float = 0.05):
        assert 0.0 <= p <= 1.0
        self.p = float(p)

    def drop_mask(self, seed, n: int) -> np.ndarray:
        if self.p <= 0.0:
            return np.zeros(n, bool)
        return _fault_rng(seed, _DROP_LANE).random(n) < self.p

    @property
    def is_null(self) -> bool:
        return self.p <= 0.0


def effective_lambda(lam: float, fault) -> float:
    """Availability-discounted arrival rate: a server delivering capacity
    factor a serves the same offered load as a fault-free server at
    λ/a — the transfer that carries every single-server closed form to
    the faulty regime (exact for preemptive-resume crash in operational
    time; first-order for slowdown)."""
    return float(lam) / fault_from_spec(fault).capacity()


# ----------------------------------------------------------------------------
# Availability-masked routing
# ----------------------------------------------------------------------------

def up_matrix(traces: List[ReplicaTrace], times: np.ndarray) -> np.ndarray:
    """[n, R] availability mask at each arrival instant.  A row with
    every replica down is patched to admit the replica that recovers
    first (the dispatcher holds the request until then), so masked
    assignment always has a candidate."""
    times = np.asarray(times, np.float64)
    up = np.stack([tr.up_at(times) for tr in traces], axis=1)
    dead = ~up.any(axis=1)
    if dead.any():
        rec = np.stack([tr.next_up(times) for tr in traces], axis=1)
        first = np.argmin(rec, axis=1)
        up[dead, first[dead]] = True
    return up


def masked_assign(router, arrivals, work, R: int, seed, up: np.ndarray,
                  fast: bool = False, sessions=None, device=None,
                  launch_out: Optional[dict] = None) -> np.ndarray:
    """Availability-aware replica assignment.  Backlog routers get the
    mask INSIDE the recursion (down replicas' virtual work is +inf in
    the argmin — with ``fast`` the masked kernel S6 carries the same mask
    row per arrival, on ``device``, and fills ``launch_out``); routers
    that define their own
    ``masked_assign`` (session affinity's sticky probing) keep their
    law; other stateless routers assign as usual and any request landing
    on a down replica is re-drawn uniformly among the up ones from the
    fault-salted rng.  With every replica up all paths reduce exactly to
    the fault-free assignment."""
    from repro_torch.core.fleet import router_from_spec
    router = router_from_spec(router)
    arrivals = np.asarray(arrivals, np.float64)
    work = np.asarray(work, np.float64)
    up = np.asarray(up, bool)
    if hasattr(router, "masked_assign"):
        return np.asarray(
            router.masked_assign(arrivals, work, R, seed, up, fast=fast,
                                 sessions=sessions, device=device,
                                 launch_out=launch_out), np.int64)
    if router.state_dependent:
        w = router._work_units(work)
        if fast:
            from repro_torch.core.fastsim import masked_backlog_route
            return masked_backlog_route(arrivals, w, up, R, device=device,
                                        launch_out=launch_out)
        from repro_torch.core.fleet import _masked_backlog_assign_np
        return _masked_backlog_assign_np(arrivals, w, R, up)
    rep = np.asarray(router.assign(arrivals, work, R, seed, fast=fast,
                                   sessions=sessions),
                     np.int64)
    bad = np.nonzero(~up[np.arange(len(rep)), rep])[0]
    if len(bad):
        u = _fault_rng(seed, _REROUTE_LANE).random(len(rep))
        for i in bad:
            cand = np.nonzero(up[i])[0]
            rep[i] = int(cand[int(u[i] * len(cand)) % len(cand)])
    return rep


def replay_backlog(arrivals, work, rep, R: int,
                   t: Optional[float] = None) -> np.ndarray:
    """Virtual per-replica work backlog after replaying FROZEN
    assignments (Lindley decay + add assigned work), evaluated at time
    ``t`` (default: just after the last arrival).  Used to route retry
    re-dispatches against the live backlog state and to estimate
    per-request waits for SLO hedging (the serving layer's resilience
    path, not ported yet)."""
    v = np.zeros(R)
    t_prev = 0.0
    for a, w, r in zip(arrivals, work, rep):
        v = np.maximum(0.0, v - (a - t_prev))
        t_prev = a
        v[int(r)] += w
    if t is not None:
        v = np.maximum(0.0, v - (max(float(t), t_prev) - t_prev))
    return v


# ----------------------------------------------------------------------------
# The fault-injected fleet simulation (shared by oracle and fastsim)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class _Entry:
    """One dispatch attempt of one request."""
    req: int
    arrival: float
    replica: int
    attempt: int


def _entry_workload(entries: List[_Entry], wl: Workload,
                    trace: ReplicaTrace):
    """A replica's current entries as an operational-time Workload (plus
    the sorted entry list and op arrivals).  Sorting is deterministic:
    (arrival, request id, attempt)."""
    entries = sorted(entries, key=lambda e: (e.arrival, e.req, e.attempt))
    arr = np.array([e.arrival for e in entries], np.float64)
    op_arr = trace.op_time(arr)
    idx = np.array([e.req for e in entries], np.int64)
    sub = Workload(
        arrivals=op_arr, tokens=wl.tokens[idx],
        inter=np.diff(op_arr, prepend=0.0),
        predicted=None if wl.predicted is None else wl.predicted[idx])
    return entries, arr, op_arr, sub


def _replica_waits(policy: BatchPolicy, sub: Workload, lam, dist, lat,
                   fast: bool, device=None) -> np.ndarray:
    """Full (untrimmed) operational-time waits for a replica's entry
    workload — reference loop or the card's kernel, unchanged."""
    from repro_torch.core.simulate import no_warmup, simulate_policy
    with no_warmup():
        if fast:
            from repro_torch.core.fastsim import simulate_policy_fast
            res = simulate_policy_fast(policy, lam, dist, lat, workload=sub,
                                       device=device)
        else:
            res = simulate_policy(policy, lam, dist, lat, workload=sub)
    return np.asarray(res["waits"], np.float64)


def simulate_fleet_faulty(router, policy: BatchPolicy, lam: float, R: int,
                          dist, lat, fault, num_requests: int = 20_000,
                          seed: int = 0, fast: bool = False,
                          traffic=None, device=None,
                          launch_out: Optional[dict] = None) -> dict:
    """Fault-injected fleet simulation — ONE loop for both layers
    (``fast=False``: reference event loops, host NumPy, no device;
    ``fast=True``: the kernels on ``device``, the card unless
    ``device="cpu"``), so oracle and fastsim see identical failure epochs,
    identical masked routing and identical retry re-dispatches.

    Null fault models delegate verbatim to the fault-free fleet paths
    (:func:`repro_torch.core.fleet.route_oracle` /
    :func:`repro_torch.core.fastsim.simulate_fleet_fast`) — fault rate 0 is
    bit-equal to the fault-free fleet by construction.

    With faults on: the global stream is sampled unchanged (fault draws
    live on their own salted stream), admission drops are shed, primary
    dispatch uses availability-masked routing, and each crash epoch —
    processed in global time order — kills the victims still in system
    on that replica (in-flight batch + local queue), re-dispatching them
    to a surviving replica at ``epoch + backoff * 2**attempt``.  Waits
    are reported against each request's ORIGINAL arrival.  Returns the
    fleet aggregate plus fault accounting (conservation:
    ``served + shed + failed + unserved == arrived``).

    ``traffic`` (a :mod:`repro_torch.core.traffic` model, name or spec)
    modulates the arrival rate via the time-rescaling warp; the fault
    stream is salted independently, so modulation never perturbs the
    failure epochs (and vice versa).

    A ``launch_out`` dict is filled with the routing launch of kernel S6
    (the primary dispatch), on the fast path of a state-dependent
    router."""
    from repro_torch.core.fleet import router_from_spec
    from repro_torch.core.simulate import _warm
    if fast:
        device = resolve_device(device)
    fault = fault_from_spec(fault)
    router = router_from_spec(router)

    wl = policy.sample_workload(lam, dist, num_requests, seed)
    if traffic is not None:
        from repro_torch.core.traffic import warp_workload
        wl = warp_workload(wl, traffic, seed)
    n = len(wl.arrivals)
    horizon = float(wl.arrivals[-1]) * 2.0 + 1.0
    traces = [fault.trace(seed, r, horizon) for r in range(R)]
    drop = fault.drop_mask(seed, n)

    if all(tr.empty for tr in traces) and not drop.any():
        if fast:
            from repro_torch.core.fastsim import simulate_fleet_fast
            res = simulate_fleet_fast(router, policy, lam, R, dist, lat,
                                      num_requests=num_requests, seed=seed,
                                      traffic=traffic, device=device,
                                      launch_out=launch_out)
        else:
            from repro_torch.core.fleet import route_oracle
            res = route_oracle(router, policy, lam, R, dist, lat,
                               num_requests=num_requests, seed=seed,
                               traffic=traffic)
        res.update(shed=0, retries=0, failed=0, unserved=0,
                   availability=[1.0] * R, n_arrived=n, n_served=n)
        return res

    # ---- admitted stream + per-request routing work -------------------
    adm = np.nonzero(~drop)[0]
    gwl = Workload(arrivals=wl.arrivals[adm], tokens=wl.tokens[adm],
                   inter=np.diff(wl.arrivals[adm], prepend=0.0),
                   predicted=None if wl.predicted is None
                   else wl.predicted[adm])
    work_adm = router.routing_work(gwl, lat, seed)
    work_of = np.zeros(n)
    work_of[adm] = work_adm                   # per-request work estimate
    proxy = np.zeros(n)                       # service proxy (op seconds)
    if lat is None or policy.uses_single_latency \
            or not isinstance(lat, BatchLatencyModel):
        proxy[adm] = router.work_from_lengths(gwl.tokens, lat)
    else:
        # Amortized per-request cost under large-batch serving — the same
        # alpha = k1 + k3*len the control layer uses for capacity; the
        # single-request law would overstate in-system time by the batch
        # width and mass-kill on every epoch.
        proxy[adm] = lat.k1 + lat.k3 * np.asarray(gwl.tokens, np.float64)

    # ---- primary dispatch: availability-masked routing ----------------
    up = up_matrix(traces, gwl.arrivals)
    rep = masked_assign(router, gwl.arrivals, work_adm, R, seed, up,
                        fast=fast, device=device, launch_out=launch_out)
    by_rep: List[List[_Entry]] = [[] for _ in range(R)]
    for i, g in enumerate(adm):
        by_rep[int(rep[i])].append(_Entry(int(g), float(gwl.arrivals[i]),
                                          int(rep[i]), 0))
    failed: List[int] = []
    retries = 0

    # ---- crash epochs in global time order (kill + re-dispatch) -------
    if fault.lose_work:
        epochs = sorted((float(f), r) for r in range(R)
                        for f in traces[r].crash_starts())
        for f, r in epochs:
            if not by_rep[r]:
                continue
            entries, arr, op_arr, sub = _entry_workload(by_rep[r], wl,
                                                        traces[r])
            m = policy.schedule_length(len(entries))
            # Victims are picked by a work-conserving FCFS progress proxy
            # (Lindley on the routing work units, in operational time).
            # The proxy is host-side and layer-independent, so oracle and
            # fastsim kill identical victim sets regardless of float-level
            # differences in their per-replica trajectories; the policy
            # sim runs once per replica at the end for reported waits.
            svc = proxy[[e.req for e in entries]]
            c = np.concatenate(([0.0], np.cumsum(svc[:-1])))
            start = np.maximum.accumulate(op_arr - c) + c
            comp = start + svc
            if m < len(entries):
                comp[m:] = np.inf        # never scheduled => still queued
            a_f = float(traces[r].op_time([f])[0])
            kill = np.nonzero((arr < f) & (comp > a_f))[0]
            if not len(kill):
                continue
            keep = set(range(len(entries))) - set(int(k) for k in kill)
            by_rep[r] = [entries[i] for i in sorted(keep)]
            u = _fault_rng(seed, _RETRY_LANE, int(round(f * 1e6)) % (1 << 31)
                           ).random(len(kill))
            for j, k in enumerate(kill):
                e = entries[int(k)]
                if e.attempt + 1 > fault.max_retries:
                    failed.append(e.req)
                    continue
                # (j+1)*1e-9 spaces victims re-entering at the same epoch:
                # exactly-tied arrivals sit on a batch-formation boundary
                # where oracle and kernel may disagree ('<' vs '<=').
                t_new = f + fault.retry_backoff * (2.0 ** e.attempt) \
                    + (j + 1) * 1e-9
                row = up_matrix(traces, np.array([t_new]))[0]
                if router.state_dependent:
                    flat = [x for lst in by_rep for x in lst]
                    flat.sort(key=lambda x: (x.arrival, x.req, x.attempt))
                    v = replay_backlog(
                        [x.arrival for x in flat],
                        router._work_units(work_of[[x.req for x in flat]]),
                        [x.replica for x in flat], R, t=t_new)
                    r_new = int(np.argmin(np.where(row, v, np.inf)))
                else:
                    cand = np.nonzero(row)[0]
                    r_new = int(cand[int(u[j] * len(cand)) % len(cand)])
                by_rep[r_new].append(_Entry(e.req, float(t_new), r_new,
                                            e.attempt + 1))
                retries += 1

    # ---- final trajectories -------------------------------------------
    waits_of = np.full(n, np.nan)
    final_rep = np.full(n, -1, np.int64)
    unserved: List[int] = []
    for r in range(R):
        if not by_rep[r]:
            continue
        entries, arr, op_arr, sub = _entry_workload(by_rep[r], wl,
                                                    traces[r])
        m = policy.schedule_length(len(entries))
        for e in entries[m:]:
            unserved.append(e.req)
        if m == 0:
            continue
        waits = _replica_waits(policy, Workload(
            arrivals=sub.arrivals[:m], tokens=sub.tokens[:m],
            inter=None if sub.inter is None else sub.inter[:m],
            predicted=None if sub.predicted is None
            else sub.predicted[:m]), lam, dist, lat, fast, device)
        start_wall = traces[r].wall_time(op_arr[:m] + waits)
        for i, e in enumerate(entries[:m]):
            waits_of[e.req] = float(start_wall[i]) - float(wl.arrivals[e.req])
            final_rep[e.req] = r

    served = np.isfinite(waits_of)
    served[failed] = False
    w_all = waits_of[served]
    w = _warm(w_all)                    # warm-trim in request order
    T = float(wl.arrivals[-1])
    out = {
        "mean_wait": float(w.mean()) if w.size else 0.0,
        "p50_wait": float(np.percentile(w, 50)) if w.size else 0.0,
        "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
        "p99_wait": float(np.percentile(w, 99)) if w.size else 0.0,
        "waits": w,
        "waits_by_request": waits_of,
        "served_mask": served,
        "replica_of": final_rep,
        "shed": int(drop.sum()),
        "retries": int(retries),
        "failed": int(len(set(failed))),
        "unserved": int(len(set(unserved) - set(failed))),
        "availability": [tr.availability(T) for tr in traces],
        "n_arrived": int(n),
        "n_served": int(served.sum()),
    }
    return out


__all__ = [
    "FAULTS", "CrashRepair", "FaultModel", "NoFaults", "ReplicaTrace",
    "RequestDrop", "Slowdown", "default_faults", "effective_lambda",
    "fault_from_spec", "get_fault", "masked_assign", "register_fault",
    "replay_backlog", "simulate_fleet_faulty", "up_matrix",
]
