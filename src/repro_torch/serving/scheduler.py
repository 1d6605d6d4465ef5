"""Virtual-timeline schedulers and the engine layer: a copy of
``repro.serving.scheduler`` without memory budgets (ROADMAP.md M7d) and
sessions (M7c); each raises ``NotImplementedError``.

A :class:`~repro_torch.core.policies.BatchPolicy` bound to a clock walks
the virtual timeline: the next batch starts at max(server_free, trigger),
exactly like the reference oracle, and its duration comes from

  * ``ModelClock``   the calibrated BatchLatencyModel (paper-scale
                     experiments in host time), or
  * ``EngineClock``  the real engine (wall-clock ground truth).

``PolicyScheduler(policy, clock)`` is the generic adapter; the named
scheduler classes are one-line bindings:

  FCFSScheduler            FCFSPolicy      (M/G/1, incl. impatience tau)
  DynamicBatchScheduler    DynamicPolicy   (paper §IV-A/B)
  FixedBatchScheduler      FixedPolicy     (paper §IV-C)
  ElasticBatchScheduler    ElasticPolicy   (paper §IV-D, Eq 26)
  MultiBinBatchScheduler   MultiBinPolicy  [Guldogan et al. 2024]
  WaitBatchScheduler       WaitPolicy      [Dai et al. 2025]
  SRPTBatchScheduler       SRPTPolicy      shortest-first formation
  ContinuousBatchScheduler iteration-level refill [beyond paper; Orca-style]

``run_engine_schedule`` executes a policy's batches on the engine.

Both the adapter and ``run_engine_schedule`` accept a length predictor
(:mod:`repro_torch.core.predictors`): batch membership and ordering are
driven by PREDICTED output lengths while clipping and service use the
true ones, the convention of the simulator layers.  Resolution goes
through the one shared :func:`repro_torch.core.predictors.
resolve_predictions`; the fleet layer (:mod:`repro_torch.serving.router`)
reuses it and drives R of these schedulers behind a routing policy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.core.policies import (
    BatchPolicy, DynamicPolicy, ElasticPolicy, FCFSPolicy, FixedPolicy,
    MultiBinPolicy, SRPTPolicy, WaitPolicy, not_ported)
from repro_torch.data.pipeline import Request


# ----------------------------------------------------------------------------
# Clocks
# ----------------------------------------------------------------------------

class ModelClock:
    def __init__(self, single: LatencyModel, batch: BatchLatencyModel):
        self.single = single
        self.batch = batch

    def single_time(self, n_tokens: int) -> float:
        return float(self.single.service_time(n_tokens))

    def batch_time(self, ns) -> float:
        ns = np.asarray(ns, np.float64)
        return float(self.batch.batch_time(len(ns), ns.max()))

    def elastic_times(self, ns) -> np.ndarray:
        """Per-request completion offsets, ordered like sorted(ns)."""
        return self.batch.elastic_completion_times(ns)

    def decode_step_time(self, b: int) -> float:
        return float(self.batch.k3 * b + self.batch.k4)

    def prefill_time(self, b: int) -> float:
        return float(self.batch.k1 * b + self.batch.k2)


class EngineClock:
    """Wall-clock service times from the real engine."""

    def __init__(self, engine):
        self.engine = engine

    def run_batch(self, reqs: List[Request], elastic: bool,
                  n_max: Optional[int]):
        res = self.engine.generate(
            [r.prompt_tokens for r in reqs],
            [r.target_output_tokens for r in reqs],
            elastic=elastic, n_max=n_max)
        return res["completion_seconds"], res["batch_seconds"]


def _request_predictions(policy: BatchPolicy, predictor, predict_seed: int,
                         ns: np.ndarray, reqs: List[Request]):
    """Predicted-length column for a request list: a thin prompt-plumbing
    wrapper over the one shared resolver
    (:func:`repro_torch.core.predictors.resolve_predictions`), used by
    ``PolicyScheduler``, ``run_engine_schedule`` and the fleet layer
    alike."""
    from repro_torch.core.predictors import resolve_predictions
    prompts = [r.prompt_tokens for r in reqs[:len(ns)]]
    return resolve_predictions(policy, predictor, predict_seed, ns, prompts)


@dataclasses.dataclass
class ScheduleResult:
    waits: np.ndarray           # queueing delay per request (paper's E[W])
    e2e: np.ndarray             # arrival -> reply complete
    lost: np.ndarray            # impatience abandonments (bool)
    batch_sizes: List[int]
    makespan: float


class PolicyScheduler:
    """Bind a :class:`repro_torch.core.policies.BatchPolicy` to a clock.

    The policy supplies formation (trigger + members) and per-batch
    completion semantics (``service_clock``); this adapter only walks the
    virtual timeline and collects waits / end-to-end latencies.

    ``predictor`` overrides the policy's own length predictor for this
    scheduler (None keeps it); formation sees the PREDICTED lengths while
    clipping and the service clock keep the true ``target_output_tokens``.
    ``predict_seed`` keys the predictor's rng stream.  A KV-memory budget
    is not ported yet and raises (ROADMAP.md M7d)."""

    def __init__(self, policy: BatchPolicy, clock: ModelClock,
                 predictor=None, predict_seed: int = 0, memory=None):
        if memory is not None:
            not_ported("a KV-memory budget (the prefill/decode tandem)",
                       "M7d (KV memory)")
        self.policy = policy
        self.clock = clock
        if predictor is not None:
            from repro_torch.core.predictors import predictor_from_spec
            predictor = predictor_from_spec(predictor)
        self.predictor = predictor
        self.predict_seed = predict_seed

    def run(self, reqs: List[Request],
            predicted: Optional[np.ndarray] = None) -> ScheduleResult:
        """``predicted`` overrides the per-request predicted lengths (the
        fleet layer passes slices of ONE globally drawn column, so routing
        and membership see the same predictions); None resolves them from
        the configured predictor."""
        pol = self.policy
        n = pol.schedule_length(len(reqs))
        arr = np.array([r.arrival for r in reqs[:n]])
        ns = np.array([pol.clip(r.target_output_tokens) for r in reqs[:n]],
                      np.float64)
        tau = getattr(pol, "tau", None)
        waits = np.zeros(n)
        e2e = np.zeros(n)
        lost = np.zeros(n, bool)
        sizes = []
        if predicted is None:
            predicted = _request_predictions(
                pol, self.predictor, self.predict_seed, ns, reqs)
        fs = pol.formation(arr, ns, predicted=(
            None if predicted is None else predicted[:n]))
        t_free = 0.0
        while (nb := fs.next_batch(t_free)) is not None:
            start, idx = nb
            w = start - arr[idx]
            if tau is not None and len(idx) == 1 and w[0] >= tau:
                waits[idx] = tau        # abandoned: spends tau in queue
                lost[idx] = True
                continue                # server never starts this request
            h, offsets = pol.service_clock(ns[idx], self.clock)
            waits[idx] = w
            e2e[idx] = w + offsets
            sizes.append(len(idx))
            t_free = start + h
        return ScheduleResult(waits, e2e, lost, sizes, t_free)

    def run_sessions(self, reqs: List[Request], predicted=None,
                     prefix_discount: float = 0.0) -> ScheduleResult:
        not_ported("the session-aware timeline", "M7c (sessions)")


class FCFSScheduler(PolicyScheduler):
    """Single-request FCFS: the paper's M/G/1 (§III), incl. impatience."""

    def __init__(self, clock, n_max: Optional[int] = None,
                 tau: Optional[float] = None):
        super().__init__(FCFSPolicy(n_max=n_max, tau=tau), clock)


class DynamicBatchScheduler(PolicyScheduler):
    """Batch everything waiting when the server frees (cap b_max); padded
    decode: the batch runs to its longest member (paper Eq 18)."""

    def __init__(self, clock, n_max=None, b_max: Optional[int] = None):
        super().__init__(DynamicPolicy(n_max=n_max, b_max=b_max), clock)


class FixedBatchScheduler(PolicyScheduler):
    """Wait until exactly b requests are present (paper §IV-C)."""

    def __init__(self, clock, b: int, n_max=None):
        super().__init__(FixedPolicy(b=b, n_max=n_max), clock)


class ElasticBatchScheduler(PolicyScheduler):
    """Paper §IV-D: batch like dynamic batching, but short replies exit
    early (per-request completion via Eq 26) and the batch ends at the
    slowest member's completion."""

    def __init__(self, clock, n_max=None, b_max: Optional[int] = None):
        super().__init__(ElasticPolicy(n_max=n_max, b_max=b_max), clock)


class MultiBinBatchScheduler(PolicyScheduler):
    """Multi-bin batching (Guldogan et al. 2024): per-bin dynamic batching
    keyed by (predicted) output length (with neither ``edges`` nor a
    distribution, the edges are empirical quantiles of the key); one
    shared server picks the bin whose head request arrived earliest."""

    def __init__(self, clock, num_bins: int = 4, edges=None, n_max=None,
                 b_max: Optional[int] = None, predictor=None):
        super().__init__(MultiBinPolicy(num_bins=num_bins, edges=edges,
                                        n_max=n_max, b_max=b_max,
                                        predictor=predictor), clock)


class WaitBatchScheduler(PolicyScheduler):
    """WAIT threshold admission (Dai et al. 2025): hold batch formation
    until k requests are buffered or the head has waited ``timeout``."""

    def __init__(self, clock, k: int = 8, timeout: Optional[float] = None,
                 n_max=None, b_max: Optional[int] = None):
        super().__init__(WaitPolicy(k=k, timeout=timeout, n_max=n_max,
                                    b_max=b_max), clock)


class SRPTBatchScheduler(PolicyScheduler):
    """SRPT-like shortest-first batch formation: the ``b_max`` waiting
    requests with the shortest predicted lengths (the clipped targets
    without a predictor) form the next batch."""

    def __init__(self, clock, b_max: Optional[int] = 8, n_max=None,
                 predictor=None):
        super().__init__(SRPTPolicy(b_max=b_max, n_max=n_max,
                                    predictor=predictor), clock)


# ----------------------------------------------------------------------------
# Continuous (iteration-level) batching
# ----------------------------------------------------------------------------

def run_continuous_virtual(arrivals: np.ndarray, tokens: np.ndarray, *,
                           slots: int, chunk: int,
                           prefill_time: Callable[[int], float],
                           decode_step_time: Callable[[int], float]):
    """The continuous-batching virtual timeline, shared by the scheduler
    adapter and the reference oracle (``ContinuousPolicy``).

    ``slots`` decode streams run concurrently; a finished slot is refilled
    immediately from the queue (one prefill joins the running batch).
    Queue wait ends when the request's prefill starts.  ``chunk`` mirrors
    the engine's fused decode loop: admission/refill only at chunk
    boundaries, and a chunk is cut short at the earliest remaining
    completion while work is queued.  Returns (waits, e2e, makespan)."""
    n = len(arrivals)
    waits = np.zeros(n)
    e2e = np.zeros(n)
    remaining = {}                 # slot -> tokens_left
    t = 0.0
    head = 0
    while head < n or remaining:
        # admit (chunk boundary)
        while head < n and arrivals[head] <= t and len(remaining) < slots:
            waits[head] = t - arrivals[head]
            t += prefill_time(1)   # prefill piggybacked
            remaining[head] = tokens[head]
            head += 1
        if not remaining:
            t = max(t, arrivals[head])
            continue
        # one fused chunk of decode iterations for all active slots
        b = len(remaining)
        rem = list(remaining.values())
        steps = min(chunk, min(rem) if head < n else max(rem))
        steps = max(int(steps), 1)
        dt_step = decode_step_time(b)
        done = []
        for rid in list(remaining):
            if remaining[rid] <= steps:
                # completes mid-chunk; the real engine interpolates the
                # same way from the scan's per-step active mask
                e2e[rid] = t + remaining[rid] * dt_step - arrivals[rid]
                done.append(rid)
            else:
                remaining[rid] -= steps
        t += steps * dt_step
        for rid in done:
            del remaining[rid]
    return waits, e2e, t


class ContinuousBatchScheduler:
    """Beyond paper: iteration-level scheduling (Orca/vLLM).  Thin adapter
    over :func:`run_continuous_virtual` with the clock's prefill/decode-step
    laws; ``chunk=1`` is the legacy per-step discipline."""

    def __init__(self, clock: ModelClock, slots: int, n_max=None,
                 chunk: int = 1):
        self.clock = clock
        self.n_max = n_max
        self.slots = slots
        assert chunk >= 1
        self.chunk = chunk

    def run(self, reqs: List[Request]) -> ScheduleResult:
        n = len(reqs)
        arr = np.array([r.arrival for r in reqs])
        ns = np.array([min(r.target_output_tokens, self.n_max) if self.n_max
                       else r.target_output_tokens for r in reqs], np.int64)
        waits, e2e, t = run_continuous_virtual(
            arr, ns, slots=self.slots, chunk=self.chunk,
            prefill_time=self.clock.prefill_time,
            decode_step_time=self.clock.decode_step_time)
        return ScheduleResult(waits, e2e, np.zeros(n, bool), [], t)


# ----------------------------------------------------------------------------
# Engine layer: execute a policy's batches on the real engine
# ----------------------------------------------------------------------------

def run_engine_schedule(policy: BatchPolicy, engine, reqs: List[Request],
                        predictor=None, predict_seed: int = 0,
                        predicted: Optional[np.ndarray] = None,
                        memory=None) -> ScheduleResult:
    """Form batches with ``policy`` on the request stream's virtual arrival
    timeline and execute each batch on the engine (prefill + fused chunked
    decode); batch durations are wall-clock seconds.  Elastic policies run
    the engine in elastic mode, the others padded.

    ``predictor`` (a :mod:`repro_torch.core.predictors` instance, name, or
    spec; None keeps ``policy.predictor``) feeds formation's membership
    and ordering with PREDICTED lengths; the engine still decodes each
    request to its true ``target_output_tokens``.  ``predicted`` bypasses
    the resolution with an explicit column (the fleet layer).  Memory
    budgets are not ported yet and raise (ROADMAP.md M7d)."""
    if memory is not None:
        not_ported("run_engine_schedule: a KV-memory budget",
                   "M7d (KV memory)")
    clock = EngineClock(engine)
    n = policy.schedule_length(len(reqs))
    arr = np.array([r.arrival for r in reqs[:n]])
    ns = np.array([policy.clip(r.target_output_tokens) for r in reqs[:n]],
                  np.float64)
    elastic = isinstance(policy, ElasticPolicy)
    waits = np.zeros(n)
    e2e = np.zeros(n)
    sizes = []
    if predicted is None:
        predicted = _request_predictions(policy, predictor, predict_seed,
                                         ns, reqs)
    fs = policy.formation(arr, ns, predicted=(
        None if predicted is None else predicted[:n]))
    t_free = 0.0
    while (nb := fs.next_batch(t_free)) is not None:
        start, idx = nb
        comp, total = clock.run_batch([reqs[i] for i in idx], elastic,
                                      policy.n_max)
        waits[idx] = start - arr[idx]
        e2e[idx] = waits[idx] + np.asarray(comp)[:len(idx)]
        sizes.append(len(idx))
        t_free = start + total
    return ScheduleResult(waits, e2e, np.zeros(n, bool), sizes, t_free)


def run_schedule(scheduler, reqs: List[Request]) -> ScheduleResult:
    return scheduler.run(reqs)
