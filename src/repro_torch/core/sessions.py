"""Re-entrant agentic sessions, M/G/1 with feedback, at every layer: a
copy of ``repro.core.sessions``.

Agentic workloads re-enter the queue: a request finishes a turn, leaves
for a tool call or user think time, and RETURNS as a new arrival of the
same session (Dai et al., "Throughput-Optimal Scheduling for LLM
Inference and AI Agents"; AugServe).  This module is the one definition
of that structure for every layer:

  * **Session models** (registry): ``single`` (null, 1 turn),
    ``geometric`` (Bernoulli feedback with return probability p),
    ``chain`` (fixed k-turn agents), ``toolcall`` (capped geometric with
    exponential think time between turns).
  * **Expansion**: :func:`plan_sessions` / :func:`expand_workload` turn
    one sampled arrival stream of n sessions into per-turn rows
    (session id, turn index, parent row, think delay).  Turn counts,
    think times and the extra turns' token lengths are drawn from salted
    ``_session_rng`` lanes, so the base workload, predictor, fault and
    traffic streams stay bit-identical: a null model returns the
    original stream untouched.
  * **Simulation** (oracle and fast): one fixed-point runner per
    topology.  Turn t+1 of a session arrives at ``completion(turn t) +
    think``; completions depend on arrivals, so the re-arrival times are
    resolved by iterating the unchanged single-server engines (the NumPy
    event loops when ``fast=False``; with ``fast=True`` the card's
    kernels, one launch of S1, S3, S4 or S5 a pass and a replica) until
    the arrival vector is self-consistent.  Both layers share this
    control flow; only the inner pass differs.
  * **Fleet**: the same fixed point with a routing pass per iteration
    (S6 for the backlog routers when ``fast=True``); a
    ``session_affinity`` router (:mod:`repro_torch.core.fleet`) makes
    turns sticky, and ``prefix_discount`` γ models KV/prefix reuse: a
    turn >= 2 landing on its parent's replica serves ``tokens·(1−γ)``.
    Routing work estimates stay undiscounted: routers see only arrivals
    and predictions, never downstream cache state.
  * **Analytics**: :func:`repro_torch.core.mg1.mg1_feedback_wait` and
    :func:`repro_torch.core.bulk.feedback_policy_delay`, the effective
    load transfer λ_eff = λ·E[turns] with per-visit service moments.

Boundaries (enforced with ``ValueError``): ``continuous`` has no discrete
per-turn completion events, and fixed-size batching deadlocks on the
remnant tail under feedback; :func:`check_policy_supports_sessions`
rejects both.  The fleet fault simulation
(``faults.simulate_fleet_faulty``) is not composed with sessions;
single-server session runs accept a ``fault_trace`` through the
operational-time transform (think time stays wall-clock).  FCFS with
impatience (tau) resolves causally on the host
(:func:`_tau_event_loop`), on either layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

import numpy as np

from repro_torch.core.policies import BatchPolicy, Workload, single_from_batch
from repro_torch.core.latency_model import BatchLatencyModel

# Salted PRNG lane (same pattern as traffic.py's _TRAFFIC_SALT): session
# draws never consume the workload / predictor / fault / traffic streams.
_SESSION_SALT = 0x5E551011
_TURNS_LANE = 11        # per-session turn counts
_THINK_LANE = 13        # think-time delays for turns >= 2
_TOKENS_LANE = 17       # output-token lengths of turns >= 2
_PROMPT_LANE = 19       # serving-layer prompts of turns >= 2
_SESSION_PRED_LANE = 104729   # predicted lengths of turns >= 2

_MAX_PASSES = 200
_TOL = 1e-9


def _session_rng(seed, *lanes) -> np.random.Generator:
    parts = [int(k) for k in seed] if isinstance(seed, (tuple, list)) \
        else [int(seed)]
    return np.random.default_rng(np.random.SeedSequence(
        [_SESSION_SALT] + parts + [int(x) for x in lanes]))


# ----------------------------------------------------------------------------
# Session-model protocol + registry
# ----------------------------------------------------------------------------

SESSIONS: Dict[str, Type["SessionModel"]] = {}


def register_session(cls: Type["SessionModel"]) -> Type["SessionModel"]:
    SESSIONS[cls.name] = cls
    return cls


def get_session(name: str, **kwargs) -> "SessionModel":
    return SESSIONS[name](**kwargs)


def session_from_spec(spec) -> "SessionModel":
    """``SessionModel`` | name | ``{"name": ..., **params}`` -> instance;
    None means the null single-turn model."""
    if spec is None:
        return SingleSession()
    if isinstance(spec, SessionModel):
        return spec
    if isinstance(spec, str):
        return get_session(spec)
    spec = dict(spec)
    return get_session(spec.pop("name"), **spec)


def default_sessions() -> Dict[str, "SessionModel"]:
    """One representative (non-null where possible) instance per
    registered model — the set the conformance tests and the
    registry-coverage benchmark iterate."""
    return {
        "single": SingleSession(),
        "geometric": GeometricSession(p=0.5, think_mean=2.0),
        "chain": ChainSession(k=3, think=1.0),
        "toolcall": ToolcallSession(p=0.5, think_mean=1.0, max_turns=8),
    }


def null_sessions() -> Dict[str, "SessionModel"]:
    """A NULL (single-turn) instance per registered model, for the
    bit-equality conformance tests."""
    return {
        "single": SingleSession(),
        "geometric": GeometricSession(p=0.0),
        "chain": ChainSession(k=1),
        "toolcall": ToolcallSession(p=0.0),
    }


class SessionModel:
    """One re-entry law, defined once for every layer.

    ``is_null`` is the conformance switch: a null model (every session
    is exactly one turn) makes every entry point return the SAME objects
    / trajectories as the session-free code path, with zero extra rng
    draws — bit-equality by construction, like ``warp_workload``
    returning ``wl`` unchanged for null traffic."""

    name = "base"

    @property
    def is_null(self) -> bool:
        return False

    def mean_turns(self) -> float:
        """E[turns per session] — the feedback multiplier in
        λ_eff = λ·E[turns]."""
        raise NotImplementedError

    def draw_turns(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Turn counts (>= 1) for n sessions."""
        raise NotImplementedError

    def draw_think(self, rng: np.random.Generator, m: int) -> np.ndarray:
        """Think delays (>= 0) for m re-entries (turn >= 2 rows)."""
        raise NotImplementedError

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items() if v is not None}
        return f"{type(self).__name__}({keys})"


@register_session
class SingleSession(SessionModel):
    """The null model: every session is one turn.  All session entry
    points short-circuit to the historical code paths."""

    name = "single"

    @property
    def is_null(self) -> bool:
        return True

    def mean_turns(self) -> float:
        return 1.0

    def draw_turns(self, rng, n):
        return np.ones(n, np.int64)

    def draw_think(self, rng, m):
        return np.zeros(m)


@register_session
class GeometricSession(SessionModel):
    """Bernoulli feedback: after each turn the session returns with
    probability p, so turns ~ Geometric(1-p) with E[turns] = 1/(1-p) —
    the classic M/G/1-with-feedback model.  ``think_mean`` > 0 adds an
    exponential tool-call / user delay before each re-entry."""

    name = "geometric"

    def __init__(self, p: float = 0.5, think_mean: float = 0.0):
        assert 0.0 <= p < 1.0
        assert think_mean >= 0.0
        self.p = float(p)
        self.think_mean = float(think_mean)

    @property
    def is_null(self) -> bool:
        return self.p == 0.0

    def mean_turns(self) -> float:
        return 1.0 / (1.0 - self.p)

    def draw_turns(self, rng, n):
        if self.p == 0.0:
            return np.ones(n, np.int64)
        return rng.geometric(1.0 - self.p, n).astype(np.int64)

    def draw_think(self, rng, m):
        if self.think_mean == 0.0:
            return np.zeros(m)
        return rng.exponential(self.think_mean, m)


@register_session
class ChainSession(SessionModel):
    """Fixed k-turn agents (a deterministic plan: plan -> act -> ... ->
    summarize), with a deterministic think delay between turns."""

    name = "chain"

    def __init__(self, k: int = 3, think: float = 0.0):
        assert k >= 1 and think >= 0.0
        self.k = int(k)
        self.think = float(think)

    @property
    def is_null(self) -> bool:
        return self.k == 1

    def mean_turns(self) -> float:
        return float(self.k)

    def draw_turns(self, rng, n):
        return np.full(n, self.k, np.int64)

    def draw_think(self, rng, m):
        return np.full(m, self.think)


@register_session
class ToolcallSession(SessionModel):
    """Tool-calling agent: geometric feedback CAPPED at ``max_turns``
    (agents have an iteration budget), exponential think time (the tool
    round-trip).  E[turns] = (1 - p^max_turns) / (1 - p)."""

    name = "toolcall"

    def __init__(self, p: float = 0.5, think_mean: float = 1.0,
                 max_turns: int = 8):
        assert 0.0 <= p < 1.0 and think_mean >= 0.0 and max_turns >= 1
        self.p = float(p)
        self.think_mean = float(think_mean)
        self.max_turns = int(max_turns)

    @property
    def is_null(self) -> bool:
        return self.p == 0.0 or self.max_turns == 1

    def mean_turns(self) -> float:
        if self.p == 0.0:
            return 1.0
        return (1.0 - self.p ** self.max_turns) / (1.0 - self.p)

    def draw_turns(self, rng, n):
        if self.p == 0.0:
            return np.ones(n, np.int64)
        k = rng.geometric(1.0 - self.p, n).astype(np.int64)
        return np.minimum(k, self.max_turns)

    def draw_think(self, rng, m):
        if self.think_mean == 0.0:
            return np.zeros(m)
        return rng.exponential(self.think_mean, m)


# ----------------------------------------------------------------------------
# Expansion: one arrival stream of n sessions -> per-turn rows
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SessionPlan:
    """Session-major row layout: rows ``offsets[s] .. offsets[s] +
    turns[s] - 1`` are session s's turns 1..K_s in order; ``parent`` is
    the previous turn's row (-1 for turn 1); ``think`` is the delay
    between the parent's completion and this row's re-arrival (0 on
    first turns)."""

    session: np.ndarray     # int64 [total]
    turn: np.ndarray        # int64 [total], 1-based
    parent: np.ndarray      # int64 [total], -1 for first turns
    think: np.ndarray       # float64 [total], 0.0 for first turns
    turns: np.ndarray       # int64 [n_sessions]
    offsets: np.ndarray     # int64 [n_sessions], first row of each session

    @property
    def total(self) -> int:
        return len(self.session)

    @property
    def n_sessions(self) -> int:
        return len(self.turns)


def plan_sessions(model: SessionModel, n: int, seed) -> SessionPlan:
    """Draw the per-session structure from the salted session lanes."""
    turns = np.asarray(model.draw_turns(_session_rng(seed, _TURNS_LANE), n),
                       np.int64)
    total = int(turns.sum())
    session = np.repeat(np.arange(n, dtype=np.int64), turns)
    offsets = np.concatenate(([0], np.cumsum(turns)))[:-1].astype(np.int64)
    row = np.arange(total, dtype=np.int64)
    turn = row - np.repeat(offsets, turns) + 1
    parent = np.where(turn == 1, -1, row - 1).astype(np.int64)
    think = np.zeros(total)
    extra = np.nonzero(turn >= 2)[0]
    if len(extra):
        think[extra] = np.asarray(
            model.draw_think(_session_rng(seed, _THINK_LANE), len(extra)),
            np.float64)
    return SessionPlan(session=session, turn=turn, parent=parent,
                       think=think, turns=turns, offsets=offsets)


def plan_from_requests(reqs) -> tuple:
    """:class:`SessionPlan` view of an expanded serving request list
    (session-major reordering — request lists may arrive in any order).
    Returns ``(plan, order, lower_bound_arrivals)`` where ``order[p]``
    is the request index of plan row p."""
    sess = np.array([r.session for r in reqs], np.int64)
    turn = np.array([r.turn for r in reqs], np.int64)
    order_sm = np.lexsort((turn, sess))
    _, counts = np.unique(sess[order_sm], return_counts=True)
    counts = counts.astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(counts)))[:-1].astype(np.int64)
    t_in = turn[order_sm]
    row = np.arange(len(reqs), dtype=np.int64)
    plan = SessionPlan(
        session=np.repeat(np.arange(len(counts), dtype=np.int64), counts),
        turn=t_in, parent=np.where(t_in == 1, -1, row - 1),
        think=np.array([float(reqs[i].think) for i in order_sm]),
        turns=counts, offsets=offsets)
    lb = np.array([float(reqs[i].arrival) for i in order_sm])
    return plan, order_sm, lb


def expand_workload(wl: Workload, model: SessionModel,
                    dist, policy: BatchPolicy, seed):
    """Expand a base n-session workload into per-turn rows.  Turn-1 rows
    carry the base stream's tokens/predictions untouched; turns >= 2
    draw fresh lengths from the ``_TOKENS_LANE`` (clipped by the policy)
    and predictions from the ``_SESSION_PRED_LANE``.  The expanded
    arrivals are the LOWER BOUND ``base + cumulative think`` — the
    feedback fixed point raises each re-entry to its parent's completion
    + think.  Returns ``(Workload, SessionPlan)``."""
    n = len(wl.arrivals)
    plan = plan_sessions(model, n, seed)
    total = plan.total
    first = plan.offsets
    extra = np.nonzero(plan.turn >= 2)[0]
    tok = np.empty(total, np.float64)
    tok[first] = wl.tokens
    if len(extra):
        rng = _session_rng(seed, _TOKENS_LANE)
        et = dist.sample(rng, len(extra)).astype(np.float64) \
            if dist is not None else np.zeros(len(extra))
        tok[extra] = np.asarray(policy.clip(et), np.float64)
    pred = None
    if wl.predicted is not None:
        pred = np.empty(total, np.float64)
        pred[first] = wl.predicted
        if len(extra):
            ep = policy.predict_lengths((seed, _SESSION_PRED_LANE),
                                        tok[extra])
            pred[extra] = tok[extra] if ep is None else ep
    cs = np.cumsum(plan.think)
    cum = cs - np.repeat(cs[plan.offsets], plan.turns)
    arr = np.repeat(wl.arrivals, plan.turns) + cum
    ewl = Workload(arrivals=arr, tokens=tok, predicted=pred,
                   session=plan.session, turn=plan.turn)
    return ewl, plan


# ----------------------------------------------------------------------------
# Policy support gate
# ----------------------------------------------------------------------------

def check_policy_supports_sessions(policy: BatchPolicy) -> None:
    """Sessions need a discrete completion event per turn and must serve
    every offered row: continuous (iteration-level) batching has
    neither, and fixed-size batching deadlocks on the < b remnant tail
    once re-arrivals stop coming."""
    if policy.oracle_kind == "continuous":
        raise ValueError(
            "continuous batching has no per-turn completion events; "
            "sessions= is not supported (use the serving-layer engine "
            "path for iteration-level realism)")
    if any(policy.schedule_length(k) != k for k in (3, 7, 1001)):
        raise ValueError(
            "fixed-size batching deadlocks on the remnant tail under "
            "feedback (the last < b turns never form a batch); "
            "sessions= is not supported for this policy")


# ----------------------------------------------------------------------------
# Shared fixed-point machinery (oracle and fast differ only in the pass)
# ----------------------------------------------------------------------------

def _single_pass(policy, lam, dist, lat, seed, swl: Workload,
                 fast: bool, device=None) -> dict:
    """One single-server run on a fully materialized sorted workload,
    returning FULL per-row waits (no warmup trim) aligned to ``swl``'s
    row order.  ``fast`` runs the policy's kernel on ``device`` (a
    resolved device: the card, or ``"cpu"`` for the plain versions)."""
    from repro_torch.core.simulate import ORACLES, no_warmup
    with no_warmup():
        if fast and policy.fast_kernel is not None:
            from repro_torch.core.fastsim import KERNELS
            return KERNELS[policy.fast_kernel](
                policy, lam, dist, lat, len(swl.arrivals), seed,
                workload=swl, device=device)
        return ORACLES[policy.oracle_kind](policy, swl, lat, dist)


def _pass_completions(policy, lat, starts: np.ndarray, tokens: np.ndarray,
                      lost: np.ndarray) -> np.ndarray:
    """Per-row completion times recovered from service starts.  FCFS
    (oracle_kind 'mg1') serves one request per start; batch policies
    share one start per batch — on a single server consecutive batch
    starts are separated by at least one batch occupancy (>> float
    round-trip noise), so grouping equal starts recovers the batches and
    ``policy.batch_time`` the shared completion.  Lost rows (impatience)
    never occupy the server: completion = +inf."""
    comp = np.full(len(starts), np.inf)
    srv = np.nonzero(~lost)[0]
    if len(srv) == 0:
        return comp
    if policy.oracle_kind == "mg1":
        comp[srv] = starts[srv] + np.asarray(
            lat.service_time(tokens[srv]), np.float64)
        return comp
    order = srv[np.argsort(starts[srv], kind="stable")]
    ss = starts[order]
    brk = np.empty(len(ss), bool)
    brk[0] = True
    if len(ss) > 1:
        brk[1:] = np.diff(ss) > _TOL * np.maximum(1.0, np.abs(ss[1:]))
    bounds = np.nonzero(brk)[0]
    ends = np.append(bounds[1:], len(ss))
    for b0, b1 in zip(bounds, ends):
        members = order[b0:b1]
        comp[members] = ss[b0] + policy.batch_time(tokens[members], lat)
    return comp


def _nudge_ties(a: np.ndarray) -> np.ndarray:
    """Strictify a sorted arrival vector: exact re-arrival ties (children
    of one batch share a completion epoch, and chain/toolcall think times
    can be deterministic) are kept in row order but pushed one ulp apart.
    A re-arrival landing EXACTLY on a batch-formation epoch is a knife
    edge the reference event loops and the vectorized kernels resolve
    differently (>= vs >) — Poisson streams never produce exact ties, so
    only the feedback fixed point needs this.  Ulp-sized nudges shift
    waits by ~1e-14 and never move a row across a genuine gap."""
    if len(a) < 2:
        return a
    d = np.diff(a)
    if np.all(d > 0):
        return a
    new_run = np.concatenate(([True], d > 0))
    first = np.maximum.accumulate(
        np.where(new_run, np.arange(len(a)), 0))
    rank = np.arange(len(a)) - first
    out = a + rank * np.spacing(a)
    while True:                 # rare rounding collisions: fix up
        bad = np.nonzero(np.diff(out) <= 0)[0]
        if not len(bad):
            return out
        i = int(bad[0]) + 1
        out[i] = np.nextafter(out[i - 1], np.inf)


def _cascade_cancel(plan: SessionPlan, lost_row: np.ndarray) -> np.ndarray:
    """Rows whose ANY ancestor turn (within the session chain) was lost:
    those turns never re-enter the queue."""
    x = lost_row.astype(np.int64)
    cs = np.cumsum(x)
    before = cs - x                       # lost count among rows < i
    base = np.repeat(before[plan.offsets], plan.turns)
    return (before - base) > 0


def _session_summary(plan: SessionPlan, arr: np.ndarray, waits: np.ndarray,
                     comp: np.ndarray, cancelled: np.ndarray,
                     lost: np.ndarray) -> dict:
    """Per-session accounting shared by both simulator layers (and the
    scheduler wrappers): turn conservation (arrived = served + lost) and
    end-to-end latency of fully-served sessions (last-turn completion −
    first-turn arrival)."""
    arrived = ~cancelled
    served = arrived & ~lost
    n = plan.n_sessions
    srv_count = np.bincount(plan.session[served], minlength=n)
    complete = srv_count == plan.turns
    last_rows = plan.offsets + plan.turns - 1
    e2e = comp[last_rows[complete]] - arr[plan.offsets[complete]]
    out = {
        "n_sessions": int(n),
        "mean_turns": float(plan.turns.mean()),
        "turns_total": int(plan.total),
        "turns_arrived": int(arrived.sum()),
        "turns_served": int(served.sum()),
        "turns_lost": int(lost.sum()),
        "turns_cancelled": int(cancelled.sum()),
        "sessions_completed": int(complete.sum()),
        "mean_session_e2e": float(e2e.mean()) if e2e.size else 0.0,
        "p95_session_e2e": float(np.percentile(e2e, 95)) if e2e.size
        else 0.0,
        # per-row trajectories for conformance / consistency checks
        "rows": {
            "session": plan.session, "turn": plan.turn,
            "parent": plan.parent, "think": plan.think,
            "arrival": arr, "wait": waits, "completion": comp,
            "cancelled": cancelled, "lost": lost,
        },
    }
    return out


def _effective_tokens(tok: np.ndarray, plan: SessionPlan,
                      prefix_discount: float,
                      sticky: Optional[np.ndarray] = None) -> np.ndarray:
    """KV/prefix-reuse service law: a turn >= 2 whose KV cache survived
    (single server: always; fleet: landed on its parent's replica)
    serves ``tokens·(1−γ)``.  Membership predictions stay undiscounted."""
    if prefix_discount <= 0.0:
        return tok
    eff = tok.copy()
    reuse = plan.turn >= 2
    if sticky is not None:
        reuse = reuse & sticky
    eff[reuse] *= (1.0 - prefix_discount)
    return eff


def _tau_event_loop(plan: SessionPlan, tok: np.ndarray, lat, tau: float,
                    lb: np.ndarray, trace=None) -> tuple:
    """Causal engine for FCFS-with-impatience under feedback.  Shedding
    makes the generic fixed point non-contractive (losing a turn cancels
    its descendants, which empties the queue, which un-loses the turn —
    a two-cycle with no fixed point), so tau runs chronologically
    instead: pop the next arrival, apply the oracle's impatience
    workload recursion (a lost row spends exactly tau in queue and adds
    no service, Eq 9), and enqueue the child at completion + think only
    when the turn was served.  The queue runs in operational time when a
    fault ``trace`` is given; think delays stay wall-clock.  On a null
    plan this IS the session-free recursion bit for bit (arrivals pop in
    the base order, identical float ops)."""
    import heapq
    total = plan.total
    service = np.asarray(lat.service_time(tok), np.float64)
    arr = lb.copy()
    w_row = np.full(total, np.nan)
    comp = np.full(total, np.inf)
    lost = np.zeros(total, bool)
    seen = np.zeros(total, bool)
    heap = [(float(lb[r]), int(r)) for r in plan.offsets]
    heapq.heapify(heap)
    order = []
    v = 0.0        # residual workload at the previous arrival (op time)
    t_prev = 0.0   # previous arrival epoch (op time)
    while heap:
        a_wall, r = heapq.heappop(heap)
        seen[r] = True
        arr[r] = a_wall
        order.append(r)
        a_q = float(trace.op_time(np.array([a_wall]))[0]) \
            if trace is not None else a_wall
        v = max(0.0, v - (a_q - t_prev))
        t_prev = a_q
        served = v < tau
        if served:
            w_row[r] = v
            c_q = a_q + v + service[r]
            v += service[r]
            comp[r] = float(trace.wall_time(np.array([c_q]))[0]) \
                if trace is not None else c_q
        else:
            w_row[r] = tau
            lost[r] = True
        nxt = r + 1
        if served and nxt < total and plan.parent[nxt] == r:
            heapq.heappush(heap, (comp[r] + float(plan.think[nxt]), nxt))
    ids = np.asarray(order, np.int64)
    return ids, arr, w_row, comp, lost, ~seen


# ----------------------------------------------------------------------------
# Single-server session runner (oracle when fast=False, kernels when True)
# ----------------------------------------------------------------------------

def simulate_policy_sessions(policy: BatchPolicy, lam: float, dist, lat,
                             num_requests: int, seed, model: SessionModel,
                             fault_trace=None, traffic=None,
                             prefix_discount: float = 0.0,
                             fast: bool = False, device=None) -> dict:
    """Single-server M/G/1-with-feedback: expand ``num_requests``
    sessions into per-turn rows and iterate the policy's unchanged
    engine until every re-arrival equals its parent's completion +
    think (the feedback fixed point).  FCFS impatience (tau) sheds
    turns: a lost turn terminates its session (descendants are
    cancelled and never arrive).  ``fault_trace`` composes through the
    operational-time transform per pass: the queue runs in operational
    time, think delays stay wall-clock.  ``fast=True`` runs every pass
    on the policy's kernel on ``device`` (None: the card, an error
    without one; ``"cpu"``: the plain versions)."""
    from repro_torch.core.simulate import _warm
    check_policy_supports_sessions(policy)
    if fast:
        from repro_torch.kernels import resolve_device
        device = resolve_device(device)
    if policy.uses_single_latency and isinstance(lat, BatchLatencyModel):
        lat = single_from_batch(lat)
    wl = policy.sample_workload(lam, dist, num_requests, seed)
    if traffic is not None:
        from repro_torch.core.traffic import warp_workload
        wl = warp_workload(wl, traffic, seed)
    ewl, plan = expand_workload(wl, model, dist, policy, seed)
    trace = fault_trace if (fault_trace is not None
                            and not fault_trace.empty) else None
    total = plan.total
    tok = _effective_tokens(ewl.tokens, plan, prefix_discount)
    pred = ewl.predicted
    tau = getattr(policy, "tau", None)
    lb = ewl.arrivals.copy()
    if tau is not None:
        # impatience shedding: no contractive fixed point exists (see
        # _tau_event_loop) — resolve causally; fast and oracle coincide.
        ids, arr, w_row, comp, lost, cancelled = _tau_event_loop(
            plan, tok, lat, float(tau), lb, trace)
        w = _warm(w_row[ids])
        lw = _warm(lost[ids])
        srv = w[~lw] if len(lw) == len(w) else w
        return {
            "mean_wait": float(w.mean()) if w.size else 0.0,
            "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
            "waits": w,
            "converged": True,
            "passes": 1,
            "loss_frac": float(lw.mean()) if lw.size else 0.0,
            "mean_wait_served": float(srv.mean()) if srv.size else 0.0,
            "sessions": _session_summary(plan, arr, w_row, comp,
                                         cancelled, lost),
        }
    arr = lb.copy()
    child_rows = np.nonzero(plan.parent >= 0)[0]
    cancelled = np.zeros(total, bool)
    lost = np.zeros(total, bool)
    converged = False
    w_row = np.full(total, np.nan)
    comp = np.full(total, np.inf)
    ids = np.arange(total)
    last_res: dict = {}
    passes = 0
    for passes in range(1, _MAX_PASSES + 1):
        canc_pass = cancelled       # the set that defines this pass's ids
        active = np.nonzero(~cancelled)[0]
        order = np.lexsort((active, arr[active]))
        ids = active[order]
        a_wall = arr[ids]
        a_q = trace.op_time(a_wall) if trace is not None else a_wall
        a_q = _nudge_ties(a_q)   # after op_time: down episodes flatten
        swl = Workload(arrivals=a_q, tokens=tok[ids],
                       inter=np.diff(a_q, prepend=0.0),
                       predicted=None if pred is None else pred[ids],
                       session=plan.session[ids], turn=plan.turn[ids])
        last_res = _single_pass(policy, lam, dist, lat, seed, swl, fast,
                                device)
        waits_q = np.asarray(last_res["waits"], np.float64)
        lost_s = (waits_q >= tau - 1e-12) if tau is not None \
            else np.zeros(len(ids), bool)
        start_q = a_q + waits_q
        comp_q = _pass_completions(policy, lat, start_q, tok[ids], lost_s)
        if trace is not None:
            start_wall = trace.wall_time(start_q)
            fin = np.isfinite(comp_q)
            comp_wall = np.full(len(ids), np.inf)
            comp_wall[fin] = trace.wall_time(comp_q[fin])
        else:
            start_wall, comp_wall = start_q, comp_q
        comp = np.full(total, np.inf)
        comp[ids] = comp_wall
        w_row = np.full(total, np.nan)
        w_row[ids] = start_wall - a_wall
        lost_row = np.zeros(total, bool)
        lost_row[ids] = lost_s
        new_cancelled = _cascade_cancel(plan, lost_row)
        new_arr = arr.copy()
        new_arr[child_rows] = comp[plan.parent[child_rows]] \
            + plan.think[child_rows]
        # a parent not scheduled this pass (it was cancelled and the
        # cancel set just shrank) has comp=inf: park its live children
        # at the lower bound; the next passes re-resolve them
        unresolved = child_rows[~np.isfinite(new_arr[child_rows])]
        new_arr[unresolved] = lb[unresolved]
        new_arr[new_cancelled] = lb[new_cancelled]   # inert, keep finite
        live = child_rows[~new_cancelled[child_rows]]
        delta = float(np.max(np.abs(new_arr[live] - arr[live]))) \
            if len(live) else 0.0
        stable_sets = (np.array_equal(new_cancelled, cancelled)
                       and np.array_equal(lost_row, lost))
        arr, cancelled, lost = new_arr, new_cancelled, lost_row
        if stable_sets and delta <= _TOL:
            converged = True
            break
    # report the state of the LAST SIMULATED PASS: on the converged break
    # canc_pass == cancelled already; on pass exhaustion this keeps the
    # (ids, waits, completions, lost) tuple self-consistent instead of
    # pairing a post-update cancel set with the pre-update simulation
    cancelled = canc_pass
    waits_final = w_row[ids]
    w = _warm(waits_final)
    out = {
        "mean_wait": float(w.mean()) if w.size else 0.0,
        "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
        "waits": w,
        "converged": converged,
        "passes": passes,
        "sessions": _session_summary(plan, arr, w_row, comp, cancelled,
                                     lost),
    }
    if "mean_batch" in last_res:
        out["mean_batch"] = last_res["mean_batch"]
    if tau is not None:
        lost_final = lost[ids]
        lw = _warm(lost_final)
        srv = w[~lw] if len(lw) == len(w) else w
        out["loss_frac"] = float(lw.mean()) if lw.size else 0.0
        out["mean_wait_served"] = float(srv.mean()) if srv.size else 0.0
    return out


# ----------------------------------------------------------------------------
# Fleet session runner (routing pass per iteration; prefix-reuse discount)
# ----------------------------------------------------------------------------

def simulate_fleet_sessions(router, policy: BatchPolicy, lam: float, R: int,
                            dist, lat, num_requests: int, seed,
                            model: SessionModel,
                            prefix_discount: float = 0.0,
                            traffic=None, fast: bool = False,
                            device=None) -> dict:
    """Fleet M/G/1-with-feedback: each fixed-point pass re-routes the
    materialized turn rows (routers see arrivals + UNdiscounted
    predictions, with the session column available for sticky hashing),
    runs every replica's sub-stream through the unchanged single-server
    engine, and re-enqueues turn t+1 at completion(t) + think.  With
    ``prefix_discount`` γ > 0 a turn >= 2 landing on its parent's
    replica serves ``tokens·(1−γ)`` — KV/prefix reuse, the quantity the
    affinity-vs-least_work trade-off is about.  Oracle (``fast=False``)
    and the fast path (``fast=True``: kernels on ``device``, S6 for the
    backlog routers) share this control flow."""
    from repro_torch.core.fleet import router_from_spec
    from repro_torch.core.simulate import _warm
    router = router_from_spec(router)
    check_policy_supports_sessions(policy)
    if fast:
        from repro_torch.kernels import resolve_device
        device = resolve_device(device)
    lat_run = single_from_batch(lat) if (policy.uses_single_latency and
                                         isinstance(lat, BatchLatencyModel)) \
        else lat
    wl = policy.sample_workload(lam, dist, num_requests, seed)
    if traffic is not None:
        from repro_torch.core.traffic import warp_workload
        wl = warp_workload(wl, traffic, seed)
    ewl, plan = expand_workload(wl, model, dist, policy, seed)
    total = plan.total
    tok, pred = ewl.tokens, ewl.predicted
    tau = getattr(policy, "tau", None)
    lb = ewl.arrivals.copy()
    arr = lb.copy()
    child_rows = np.nonzero(plan.parent >= 0)[0]
    cancelled = np.zeros(total, bool)
    lost = np.zeros(total, bool)
    rep_row = np.full(total, -1, np.int64)
    converged = False
    w_row = np.full(total, np.nan)
    comp = np.full(total, np.inf)
    ids = np.arange(total)
    batch_stats = []
    passes = 0
    seen_states = set()
    for passes in range(1, _MAX_PASSES + 1):
        canc_pass = cancelled       # the set that defines this pass's ids
        active = np.nonzero(~cancelled)[0]
        order = np.lexsort((active, arr[active]))
        ids = active[order]
        swl = Workload(arrivals=arr[ids], tokens=tok[ids],
                       inter=np.diff(arr[ids], prepend=0.0),
                       predicted=None if pred is None else pred[ids],
                       session=plan.session[ids], turn=plan.turn[ids])
        work = router.routing_work(swl, lat, seed)
        rep_s = np.asarray(router.assign(swl.arrivals, work, R, seed,
                                         fast=fast, sessions=swl.session,
                                         device=device),
                           np.int64)
        new_rep = np.full(total, -1, np.int64)
        new_rep[ids] = rep_s
        sticky = np.zeros(total, bool)
        sticky[child_rows] = (new_rep[child_rows] >= 0) & \
            (new_rep[child_rows] == new_rep[plan.parent[child_rows]])
        eff = _effective_tokens(tok, plan, prefix_discount, sticky)
        comp = np.full(total, np.inf)
        w_row = np.full(total, np.nan)
        lost_row = np.zeros(total, bool)
        batch_stats = []
        for r in range(R):
            sub = ids[rep_s == r]
            if len(sub) == 0:
                continue
            a_r = _nudge_ties(arr[sub])
            rwl = Workload(arrivals=a_r, tokens=eff[sub],
                           inter=np.diff(a_r, prepend=0.0),
                           predicted=None if pred is None else pred[sub],
                           session=plan.session[sub], turn=plan.turn[sub])
            res = _single_pass(policy, lam, dist, lat_run, seed, rwl, fast,
                               device)
            waits_r = np.asarray(res["waits"], np.float64)
            lost_r = (waits_r >= tau - 1e-12) if tau is not None \
                else np.zeros(len(sub), bool)
            start_r = a_r + waits_r
            comp[sub] = _pass_completions(policy, lat_run, start_r,
                                          eff[sub], lost_r)
            w_row[sub] = waits_r
            lost_row[sub] = lost_r
            if "mean_batch" in res:
                batch_stats.append((len(sub), res["mean_batch"]))
        new_cancelled = _cascade_cancel(plan, lost_row)
        new_arr = arr.copy()
        new_arr[child_rows] = comp[plan.parent[child_rows]] \
            + plan.think[child_rows]
        unresolved = child_rows[~np.isfinite(new_arr[child_rows])]
        new_arr[unresolved] = lb[unresolved]
        new_arr[new_cancelled] = lb[new_cancelled]
        live = child_rows[~new_cancelled[child_rows]]
        delta = float(np.max(np.abs(new_arr[live] - arr[live]))) \
            if len(live) else 0.0
        stable_sets = (np.array_equal(new_cancelled, cancelled)
                       and np.array_equal(lost_row, lost)
                       and np.array_equal(new_rep, rep_row))
        arr, cancelled, lost, rep_row = (new_arr, new_cancelled, lost_row,
                                         new_rep)
        if stable_sets and delta <= _TOL:
            converged = True
            break
        if not stable_sets:
            # shedding can cycle the lost/cancel sets (no fixed point —
            # see _tau_event_loop); a repeated set state will never
            # converge, so stop early and report it honestly
            state = (new_cancelled.tobytes(), lost_row.tobytes(),
                     new_rep.tobytes())
            if state in seen_states:
                break
            seen_states.add(state)
    # see simulate_policy_sessions: keep the reported state aligned with
    # the last simulated pass when the loop exhausts without converging
    cancelled = canc_pass
    waits_final = w_row[ids]
    w = _warm(waits_final)
    out = {
        "mean_wait": float(w.mean()) if w.size else 0.0,
        "p50_wait": float(np.percentile(w, 50)) if w.size else 0.0,
        "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
        "p99_wait": float(np.percentile(w, 99)) if w.size else 0.0,
        "waits": w,
        "replica_of": rep_row[ids],
        "replica_counts": np.bincount(rep_row[ids], minlength=R),
        "converged": converged,
        "passes": passes,
        "prefix_discount": float(prefix_discount),
        "sessions": _session_summary(plan, arr, w_row, comp, cancelled,
                                     lost),
    }
    if batch_stats:
        nb = sum(m / max(mb, 1e-12) for m, mb in batch_stats)
        out["mean_batch"] = float(sum(m for m, _ in batch_stats)
                                  / max(nb, 1e-12))
    if tau is not None:
        lost_final = lost[ids]
        lw = _warm(lost_final)
        srv = w[~lw] if len(lw) == len(w) else w
        out["loss_frac"] = float(lw.mean()) if lw.size else 0.0
        out["mean_wait_served"] = float(srv.mean()) if srv.size else 0.0
    return out


__all__ = [
    "SESSIONS",
    "ChainSession",
    "GeometricSession",
    "SessionModel",
    "SessionPlan",
    "SingleSession",
    "ToolcallSession",
    "check_policy_supports_sessions",
    "default_sessions",
    "expand_workload",
    "get_session",
    "null_sessions",
    "plan_from_requests",
    "plan_sessions",
    "register_session",
    "session_from_spec",
    "simulate_fleet_sessions",
    "simulate_policy_sessions",
]
