"""The batching-policy core: a copy of ``repro.core.policies`` for the
paper's disciplines (M/G/1 FCFS with clipping and impatience; dynamic,
elastic and fixed batching), the batch-event disciplines beyond the paper
(multi-bin, WAIT threshold admission, SRPT-like shortest-first) and
iteration-level continuous batching.

Each discipline is defined once for every layer:

  * **workload law**: ``sample_workload`` fixes the rng call order
    (arrivals, token counts, clipping), so the oracle
    (:mod:`repro_torch.core.simulate`), the fast path
    (:mod:`repro_torch.core.fastsim`) and the reference package see the
    same trajectory for equal seeds;
  * **batch formation**: ``formation()`` returns an iterator-style state
    whose ``next_batch(t_free)`` encodes the trigger (when service starts)
    and the member selection (who is in the batch);
  * **service law**: ``batch_time`` (simulator layer, a
    ``BatchLatencyModel``/``LatencyModel``) and ``service_clock``
    (scheduler layer, a clock) give the batch occupancy and the
    per-member completion offsets;
  * **analytic delay**: ``analytic_delay`` exposes the paper's closed
    forms and bounds (Pollaczek-Khinchine, Inoue Eq 16, M/D^b/1 Eq 25).

Length-aware membership (SRPT's ordering, multi-bin's routing) keys off
the workload's PREDICTED-length column (:mod:`repro_torch.core.predictors`),
while clipping and the service law keep the true lengths.

Consumers dispatch structurally: ``simulate_policy`` on ``oracle_kind``,
``fastsim`` on ``fast_kernel``.  Not ported yet, and raising
``NotImplementedError``: the tandem ``stage_split`` (ROADMAP.md M7d, KV
memory).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Type

import numpy as np

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel


# ----------------------------------------------------------------------------
# Workload: the sampled request stream a policy operates on
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """Arrivals + (clipped) output-token counts, sampled in a fixed rng
    order so every layer sees the same trajectory for equal seeds.

    ``predicted`` is the predicted-length column (see
    :mod:`repro_torch.core.predictors`): policies key membership and
    ordering off it while clipping and the service law keep the TRUE
    ``tokens``.  It is drawn from a salted rng stream separate from the
    workload rng, so arrivals and tokens are bit-identical with or without
    a predictor; None (no predictor) means "use the true lengths"."""

    arrivals: np.ndarray          # absolute arrival times (cumsum of expos)
    tokens: np.ndarray            # float64 output-token counts (clipped)
    inter: Optional[np.ndarray] = None   # inter-arrival times (FCFS oracle)
    predicted: Optional[np.ndarray] = None   # predictor output (float64)
    # session id and 1-based turn index per row: None until re-entrant
    # sessions are ported (ROADMAP.md M7c); the routers read ``session``
    session: Optional[np.ndarray] = None
    turn: Optional[np.ndarray] = None

    @property
    def predicted_or_true(self) -> np.ndarray:
        return self.tokens if self.predicted is None else self.predicted


def single_from_batch(lat: BatchLatencyModel) -> LatencyModel:
    """A single-request latency law derived from the batch law: S(n) =
    H(1, n) = (k1 + k2) + (k3 + k4) n.  Used when a single-service policy
    (FCFS) is swept with only a ``BatchLatencyModel`` in hand."""
    return LatencyModel(a=lat.k3 + lat.k4, c=lat.k1 + lat.k2)


def not_ported(what: str, item: str):
    """Raise for a part of the reference that the port does not have yet,
    naming its ROADMAP.md item."""
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


# ----------------------------------------------------------------------------
# Formation states (trigger + member selection, shared by oracle & scheduler)
# ----------------------------------------------------------------------------

class _DynamicFormation:
    """Serve everything waiting when the server frees (cap ``b_max``); an
    idle server starts the next arrival alone at its arrival time."""

    def __init__(self, arrivals: np.ndarray, b_max: Optional[int]):
        self.arrivals = arrivals
        self.b_max = b_max
        self.head = 0

    def next_batch(self, t_free: float):
        arr, head = self.arrivals, self.head
        if head >= len(arr):
            return None
        if arr[head] >= t_free:
            start, hi = arr[head], head + 1
        else:
            start = t_free
            hi = int(np.searchsorted(arr, t_free, side="right"))
        if self.b_max:
            hi = min(hi, head + self.b_max)
        self.head = hi
        return float(start), np.arange(head, hi)

    def rewind(self, k: int):
        """Defer the last ``k`` members of the batch just formed: they
        rejoin the head of the queue for the next trigger."""
        self.head -= k


class _FixedFormation:
    """Wait until exactly ``b`` requests are present (paper §IV-C)."""

    def __init__(self, arrivals: np.ndarray, b: int):
        self.arrivals = arrivals
        self.b = b
        self.head = 0
        self.n = (len(arrivals) // b) * b

    def next_batch(self, t_free: float):
        head, b = self.head, self.b
        if head >= self.n:
            return None
        # hi == head + b always, except after a rewind left a < b remnant
        # near the truncated end: flush it
        hi = min(head + b, self.n)
        start = max(t_free, float(self.arrivals[hi - 1]))
        self.head = hi
        return start, np.arange(head, hi)

    def rewind(self, k: int):
        self.head -= k


class _MultiBinFormation:
    """Per-bin FIFO queues, one shared server.  When the server frees it
    serves min(waiting, b_max) requests from the non-empty bin whose head
    arrived earliest (FCFS across bins); an idle server starts the next
    arrival alone, exactly like dynamic batching."""

    def __init__(self, arrivals: np.ndarray, bin_of: np.ndarray,
                 num_bins: int, b_max: Optional[int]):
        self.b_max = b_max
        # per-bin request-index lists (arrival order is preserved because
        # the global stream is already sorted by arrival)
        self.members = [np.nonzero(bin_of == j)[0] for j in range(num_bins)]
        self.arr = [arrivals[m] for m in self.members]
        self.heads = [0] * num_bins
        self._last_bin = -1

    def next_batch(self, t_free: float):
        a_min, j_min = np.inf, -1
        for j, h in enumerate(self.heads):
            if h < len(self.arr[j]) and self.arr[j][h] < a_min:
                a_min, j_min = float(self.arr[j][h]), j
        if j_min < 0:
            return None
        h = self.heads[j_min]
        if a_min >= t_free:
            start, hi = a_min, h + 1
        else:
            start = t_free
            hi = int(np.searchsorted(self.arr[j_min], t_free, side="right"))
            if self.b_max:
                hi = min(hi, h + self.b_max)
        self.heads[j_min] = hi
        self._last_bin = j_min
        return start, self.members[j_min][h:hi]

    def rewind(self, k: int):
        self.heads[self._last_bin] -= k


class _WaitFormation:
    """WAIT-style threshold admission (Dai et al. 2025): hold batch
    formation until at least ``k`` requests are buffered or the head
    request has waited ``timeout`` seconds; then serve everything that has
    arrived by the start instant (cap ``b_max``).  Fewer than ``k``
    requests remaining in the stream are flushed once the last of them has
    arrived (or the timer fires), so the tail of a finite workload is
    never stranded."""

    def __init__(self, arrivals: np.ndarray, k: int,
                 timeout: Optional[float], b_max: Optional[int]):
        self.arrivals = arrivals
        self.k = k
        self.timeout = timeout
        self.b_max = b_max
        self.head = 0

    def next_batch(self, t_free: float):
        arr, head = self.arrivals, self.head
        n = len(arr)
        if head >= n:
            return None
        trigger = float(arr[min(head + self.k - 1, n - 1)])
        if self.timeout is not None:
            trigger = min(trigger, float(arr[head]) + self.timeout)
        start = max(t_free, trigger)
        hi = int(np.searchsorted(arr, start, side="right"))
        if self.b_max:
            hi = min(hi, head + self.b_max)
        self.head = hi
        return start, np.arange(head, hi)

    def rewind(self, k: int):
        self.head -= k


class _SRPTFormation:
    """SRPT-like shortest-predicted-first selection: the waiting room is
    ordered by (predicted token count, arrival order) and batch formation
    takes the ``b_max`` shortest waiting requests — preempting FCFS order
    at formation time (admitted batches are never preempted).  An idle
    server starts the earliest next arrival, exactly like dynamic
    batching."""

    def __init__(self, arrivals: np.ndarray, predicted: np.ndarray,
                 b_max: Optional[int]):
        self.arrivals = arrivals
        self.predicted = predicted      # ordering key ONLY (never service)
        self.b_max = b_max
        self.head = 0
        self.heap: List = []
        self._last_pops: List = []

    def _admit(self, t: float):
        import heapq
        arr, tok, n = self.arrivals, self.predicted, len(self.arrivals)
        while self.head < n and arr[self.head] <= t:
            heapq.heappush(self.heap, (float(tok[self.head]), self.head))
            self.head += 1

    def next_batch(self, t_free: float):
        import heapq
        self._admit(t_free)
        if not self.heap:
            if self.head >= len(self.arrivals):
                return None
            start = float(self.arrivals[self.head])
            self._admit(start)
            cap = 1                       # idle server: next arrival alone
        else:
            start = t_free
            cap = self.b_max if self.b_max else len(self.heap)
        take = min(cap, len(self.heap))
        pops = [heapq.heappop(self.heap) for _ in range(take)]
        self._last_pops = pops
        return start, np.array([p[1] for p in pops])

    def rewind(self, k: int):
        import heapq
        # deferred members keep their (predicted, arrival) heap key, so
        # they compete on equal terms at the next trigger
        for p in self._last_pops[len(self._last_pops) - k:]:
            heapq.heappush(self.heap, p)


# ----------------------------------------------------------------------------
# BatchPolicy protocol + registry
# ----------------------------------------------------------------------------

REGISTRY: Dict[str, Type["BatchPolicy"]] = {}


def register(cls: Type["BatchPolicy"]) -> Type["BatchPolicy"]:
    REGISTRY[cls.name] = cls
    return cls


def get_policy(name: str, **kwargs) -> "BatchPolicy":
    return REGISTRY[name](**kwargs)


def policy_from_spec(spec: dict) -> "BatchPolicy":
    """Legacy ``{"kind": ..., **params}`` spec dicts -> policy instance."""
    spec = dict(spec)
    kind = spec.pop("kind")
    if kind not in REGISTRY:
        raise ValueError(kind)
    return REGISTRY[kind](**spec)


def default_policies(b: int = 4, b_max: Optional[int] = 8,
                     num_bins: int = 4, wait_k: int = 8,
                     srpt_b: int = 8) -> Dict[str, "BatchPolicy"]:
    """One representative instance per registered discipline — the set the
    cross-layer agreement tests and the registry-driven benchmarks iterate."""
    return {
        "fcfs": FCFSPolicy(),
        "dynamic": DynamicPolicy(),
        f"dynamic_b{b_max}": DynamicPolicy(b_max=b_max),
        "elastic": ElasticPolicy(),
        f"fixed_b{b}": FixedPolicy(b=b),
        f"multibin_{num_bins}": MultiBinPolicy(num_bins=num_bins),
        f"wait_k{wait_k}": WaitPolicy(k=wait_k),
        f"srpt_b{srpt_b}": SRPTPolicy(b_max=srpt_b),
        "continuous": ContinuousPolicy(slots=16),
    }


class BatchPolicy:
    """One serving discipline, defined once for every layer.

    Class attributes (the structural dispatch surface):
      name               registry key
      oracle_kind        event-loop family in ``repro_torch.core.simulate``
      fast_kernel        kernel in ``repro_torch.core.fastsim`` (None ->
                         the fast layer runs the oracle)
      analytic_kind      'exact' | 'bound' | 'approx' | None
      uses_single_latency  True -> expects a ``LatencyModel`` (single
                         request); drivers convert a ``BatchLatencyModel``
                         via :func:`single_from_batch`

    ``predictor`` (a :class:`repro_torch.core.predictors.LengthPredictor`,
    a registry name, or a spec dict) fills the workload's ``predicted``
    column; None keeps the oracle behavior (predicted == true, zero extra
    rng calls).  Length-aware policies (SRPT ordering, multi-bin routing)
    consume the predicted column for MEMBERSHIP only; clipping and the
    service law always use the true lengths.
    """

    name = "base"
    oracle_kind = "batches"
    fast_kernel: Optional[str] = None
    analytic_kind: Optional[str] = None
    uses_single_latency = False

    def __init__(self, n_max: Optional[int] = None, predictor=None):
        self.n_max = n_max
        if predictor is not None:
            from repro_torch.core.predictors import predictor_from_spec
            predictor = predictor_from_spec(predictor)
        self.predictor = predictor

    # -------------------- prediction law --------------------
    def predict_lengths(self, key, tokens: np.ndarray,
                        prompts=None) -> Optional[np.ndarray]:
        """The policy's predicted-length column for ``tokens`` (true,
        already clipped); None when no predictor is configured (oracle
        semantics).  ``key`` seeds the predictor's salted rng stream:
        layers that pass the same key see the same predictions."""
        if self.predictor is None:
            return None
        return self.predictor.predict(key, tokens, prompts)

    # -------------------- workload law --------------------
    def sample_workload(self, lam: float, dist: Optional[TokenDistribution],
                        num_requests: int, seed: int) -> Workload:
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(1.0 / lam, num_requests))
        if dist is not None:
            tokens = dist.sample(rng, num_requests).astype(np.float64)
        else:
            tokens = np.zeros(num_requests)
        if self.n_max is not None:
            tokens = np.minimum(tokens, self.n_max)
        return Workload(arrivals=arrivals, tokens=tokens,
                        predicted=self.predict_lengths(seed, tokens))

    def clip(self, tokens):
        return (np.minimum(tokens, self.n_max) if self.n_max is not None
                else tokens)

    # -------------------- formation (trigger + membership) ------------
    def formation(self, arrivals: np.ndarray, tokens: np.ndarray,
                  dist: Optional[TokenDistribution] = None,
                  predicted: Optional[np.ndarray] = None):
        raise NotImplementedError

    def schedule_length(self, n: int) -> int:
        """How many of ``n`` offered requests this policy serves (fixed
        batching truncates to a multiple of b)."""
        return n

    # -------------------- service law --------------------
    def batch_time(self, ns: np.ndarray, lat) -> float:
        """Batch occupancy on the simulator layer (``lat`` is the policy's
        latency model: batch or single per ``uses_single_latency``)."""
        raise NotImplementedError

    def service_clock(self, ns: np.ndarray, clock):
        """(occupancy, per-member completion offsets) on the scheduler
        layer.  Default: padded semantics — everyone completes with the
        batch."""
        h = clock.batch_time(ns)
        return h, np.full(len(ns), h)

    def stage_split(self, ns: np.ndarray, lat):
        not_ported("the prefill/decode tandem split", "M7d (KV memory)")

    # -------------------- analytics --------------------
    def analytic_delay(self, lam: float, dist: TokenDistribution,
                       lat) -> Optional[float]:
        """Mean queueing delay from the paper's closed forms, or None when
        the discipline has no analytic form (see ``analytic_kind``)."""
        return None

    # -------------------- convenience layer entry points --------------
    def simulate(self, lam, dist, lat, num_requests: int = 200_000,
                 seed: int = 0) -> dict:
        from repro_torch.core.simulate import simulate_policy
        return simulate_policy(self, lam, dist, lat,
                               num_requests=num_requests, seed=seed)

    def simulate_fast(self, lam, dist, lat, num_requests: int = 200_000,
                      seed: int = 0, device=None) -> dict:
        from repro_torch.core.fastsim import simulate_policy_fast
        return simulate_policy_fast(self, lam, dist, lat,
                                    num_requests=num_requests, seed=seed,
                                    device=device)

    def scheduler(self, clock, predictor=None):
        from repro_torch.serving.scheduler import PolicyScheduler
        return PolicyScheduler(self, clock, predictor=predictor)

    # -------------------- fast-path hints --------------------
    def scan_lane(self):
        """(elastic_flag, b_max) when this policy can ride a lane of the
        shared batching scan (kernel S1), else None."""
        return None

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items() if v is not None}
        return f"{type(self).__name__}({keys})"


# ----------------------------------------------------------------------------
# The paper's disciplines
# ----------------------------------------------------------------------------

@register
class FCFSPolicy(BatchPolicy):
    """M/G/1 FCFS with max-token clipping and optional deterministic
    impatience tau (paper §III, Eqs 1-9)."""

    name = "fcfs"
    oracle_kind = "mg1"
    fast_kernel = "mg1"
    analytic_kind = "exact"
    uses_single_latency = True

    def __init__(self, n_max: Optional[int] = None,
                 tau: Optional[float] = None, predictor=None):
        super().__init__(n_max, predictor)
        self.tau = tau

    def sample_workload(self, lam, dist, num_requests, seed) -> Workload:
        # The FCFS oracle consumes inter-arrival times directly (same rng
        # call order as arrivals=cumsum(inter), so trajectories still align).
        rng = np.random.default_rng(seed)
        inter = rng.exponential(1.0 / lam, num_requests)
        tokens = self.clip(dist.sample(rng, num_requests))
        return Workload(arrivals=np.cumsum(inter), tokens=tokens, inter=inter,
                        predicted=self.predict_lengths(seed, tokens))

    def formation(self, arrivals, tokens, dist=None, predicted=None):
        return _DynamicFormation(arrivals, b_max=1)

    def batch_time(self, ns, lat) -> float:
        return float(lat.service_time(ns[0]))

    def service_clock(self, ns, clock):
        h = clock.single_time(ns[0])
        return h, np.array([h])

    def analytic_delay(self, lam, dist, lat) -> float:
        from repro_torch.core.mg1 import mg1_wait
        if isinstance(lat, BatchLatencyModel):
            lat = single_from_batch(lat)
        if self.tau is not None:
            from repro_torch.core.impatience import exact_impatience
            return exact_impatience(dist, lat, lam, self.tau, self.n_max).wq_all
        return mg1_wait(dist, lat, lam, self.n_max).wait

    def optimize_n_max(self, lam, dist, lat, theta: float,
                       loss_cost: float = 4.0) -> int:
        """The paper's optimal max-token limit (Eqs 10-13) for this
        discipline: V1 when users are patient, V2 under impatience tau."""
        from repro_torch.core.policy_opt import (
            optimize_token_limit_v1, optimize_token_limit_v2)
        if isinstance(lat, BatchLatencyModel):
            lat = single_from_batch(lat)
        if self.tau is None:
            return optimize_token_limit_v1(dist, lat, lam, theta).n_max
        return optimize_token_limit_v2(dist, lat, lam, theta, self.tau,
                                       loss_cost).n_max


@register
class DynamicPolicy(BatchPolicy):
    """Dynamic batching: serve all waiting (cap ``b_max``) with padded
    decode H[b, max] (paper §IV-A/B, Eq 18)."""

    name = "dynamic"
    fast_kernel = "batch_scan"
    analytic_kind = "bound"

    def __init__(self, n_max: Optional[int] = None,
                 b_max: Optional[int] = None, predictor=None):
        super().__init__(n_max, predictor)
        self.b_max = b_max
        if b_max is not None:
            # the Inoue bound assumes serve-ALL-waiting; capping batch size
            # lowers throughput, so the unbounded bound is not an upper
            # bound for the capped system — no closed form available
            self.analytic_kind = None

    def formation(self, arrivals, tokens, dist=None, predicted=None):
        return _DynamicFormation(arrivals, self.b_max)

    def batch_time(self, ns, lat) -> float:
        return float(lat.batch_time(len(ns), ns.max()))

    def scan_lane(self):
        return (False, self.b_max)

    def analytic_delay(self, lam, dist, lat) -> Optional[float]:
        from repro_torch.core.bulk import dynamic_batching_bound
        if self.b_max is not None:
            return None
        return dynamic_batching_bound(dist if self.n_max is None
                                      else dist.clip(self.n_max),
                                      lat, lam)["wait_bound"]


@register
class ElasticPolicy(DynamicPolicy):
    """Elastic batching: dynamic formation, but short replies exit early
    (completion via Eq 26) and the batch ends at the slowest member."""

    name = "elastic"

    def batch_time(self, ns, lat) -> float:
        return lat.elastic_batch_time(ns)

    def service_clock(self, ns, clock):
        comp = clock.elastic_times(ns)            # sorted ascending order
        order = np.argsort(ns, kind="stable")
        offsets = np.empty(len(ns))
        offsets[order] = comp
        return float(comp.max()), offsets

    def scan_lane(self):
        return (True, self.b_max)

    def analytic_delay(self, lam, dist, lat) -> Optional[float]:
        from repro_torch.core.bulk import elastic_batching_bound
        if self.b_max is not None:
            return None
        return elastic_batching_bound(dist if self.n_max is None
                                      else dist.clip(self.n_max),
                                      lat, lam)["wait_bound"]


@register
class FixedPolicy(BatchPolicy):
    """Fixed batching M/D^b/1: wait until exactly ``b`` requests are
    present (paper §IV-C, Eqs 24-25)."""

    name = "fixed"
    fast_kernel = "fixed_cummax"
    analytic_kind = "approx"     # Eq 25 treats H^[b] as deterministic

    def __init__(self, b: int = 4, n_max: Optional[int] = None,
                 predictor=None):
        super().__init__(n_max, predictor)
        self.b = b

    def sample_workload(self, lam, dist, num_requests, seed) -> Workload:
        return super().sample_workload(
            lam, dist, (num_requests // self.b) * self.b, seed)

    def formation(self, arrivals, tokens, dist=None, predicted=None):
        return _FixedFormation(arrivals, self.b)

    def schedule_length(self, n: int) -> int:
        return (n // self.b) * self.b

    def batch_time(self, ns, lat) -> float:
        return float(lat.batch_time(len(ns), ns.max()))

    def analytic_delay(self, lam, dist, lat) -> float:
        from repro_torch.core.bulk import mdb1_wait_exact
        d = dist if self.n_max is None else dist.clip(self.n_max)
        h = float(lat.mean_batch_time(d, self.b))
        return mdb1_wait_exact(lam, h, self.b)


@register
class MultiBinPolicy(BatchPolicy):
    """Multi-bin batching (Guldogan et al. 2024): requests are routed to
    bins by (predicted) output length; within a bin, dynamic batching with
    padded decode; the server picks the non-empty bin whose head request
    arrived earliest.  Because bin members have similar lengths, the
    H[b, max] padding waste shrinks, buying throughput at high load.

    ``edges``: ascending upper token boundaries (last bin open-ended).
    ``edges=None``: equal-probability-mass boundaries are derived from the
    workload's token distribution at run time (the paper's suggestion)."""

    name = "multibin"
    fast_kernel = "multibin"
    analytic_kind = "bound"       # two-arm envelope, see bulk.multibin_bound

    def __init__(self, num_bins: int = 4,
                 edges: Optional[Sequence[float]] = None,
                 n_max: Optional[int] = None,
                 b_max: Optional[int] = None,
                 predictor=None,
                 bound_quantile: float = 1.0):
        super().__init__(n_max, predictor)
        self.num_bins = int(num_bins if edges is None else len(edges) + 1)
        self.edges = None if edges is None else tuple(float(e) for e in edges)
        self.b_max = b_max
        self.bound_quantile = float(bound_quantile)
        if b_max is not None:
            # both bound arms assume serve-all-waiting within the picked
            # bin; a batch cap lowers throughput, so neither arm dominates
            # the capped system
            self.analytic_kind = None
        elif bound_quantile < 1.0:
            # the quantile-envelope round arm ignores the top (1-q) tail of
            # the padding support: finite on heavy tails, but no longer a
            # strict bound
            self.analytic_kind = "approx"

    def bin_edges(self, dist: Optional[TokenDistribution],
                  tokens: Optional[np.ndarray] = None) -> np.ndarray:
        """Boundaries actually used: explicit ``edges``; else equal-mass
        quantiles of ``dist`` (after clipping); else — on the scheduler
        layer, where only observed lengths exist — empirical quantiles of
        ``tokens``."""
        qs = np.arange(1, self.num_bins) / self.num_bins
        if self.edges is not None:
            return np.asarray(self.edges, np.float64)
        if dist is not None:
            d = dist if self.n_max is None else dist.clip(self.n_max)
            return np.asarray([np.searchsorted(d.cdf, q) for q in qs],
                              np.float64)
        assert tokens is not None, "multibin needs edges, a dist, or tokens"
        return np.quantile(np.asarray(tokens, np.float64), qs)

    def bin_of(self, tokens: np.ndarray,
               dist: Optional[TokenDistribution] = None) -> np.ndarray:
        return np.searchsorted(self.bin_edges(dist, tokens), tokens,
                               side="left")

    def formation(self, arrivals, tokens, dist=None, predicted=None):
        # routing keys off the PREDICTED length; the service law (padded
        # range max in batch_time) stays on the true tokens
        key = tokens if predicted is None else predicted
        return _MultiBinFormation(arrivals, self.bin_of(key, dist),
                                  self.num_bins, self.b_max)

    def batch_time(self, ns, lat) -> float:
        return float(lat.batch_time(len(ns), ns.max()))

    def analytic_delay(self, lam, dist, lat) -> Optional[float]:
        from repro_torch.core.bulk import multibin_bound
        if self.b_max is not None:
            return None
        d = dist if self.n_max is None else dist.clip(self.n_max)
        return multibin_bound(d, lat, lam, self.bin_edges(d),
                              quantile=self.bound_quantile)["wait_bound"]

    @classmethod
    def optimized(cls, lam: float, dist: TokenDistribution, lat,
                  num_bins: int = 4, **kwargs) -> "MultiBinPolicy":
        """Load-dependent boundaries (Guldogan et al. 2024) instead of the
        default equal-probability-mass quantiles; see
        :func:`repro_torch.core.bulk.optimize_bin_edges`."""
        from repro_torch.core.bulk import optimize_bin_edges
        edges = optimize_bin_edges(dist, lat, lam, num_bins=num_bins)
        return cls(edges=tuple(edges), **kwargs)


@register
class WaitPolicy(BatchPolicy):
    """WAIT-style threshold admission (Dai et al. 2025): hold batch
    formation until at least ``k`` requests are buffered or the head
    request has waited ``timeout`` seconds, then serve everything that has
    arrived (cap ``b_max``) with padded decode.  Holding trades queueing
    delay at low load for throughput at high load: formed batches amortize
    the per-batch overhead ``k1*b + k2`` and the padded decode over at
    least ``k`` requests, which is the mechanism behind the policy's
    heavy-traffic throughput optimality in Dai et al.  ``timeout=None`` is
    the pure threshold rule (the end of a finite stream still flushes the
    last ``< k`` stragglers).  No closed-form mean delay is known (Dai et
    al. prove throughput optimality, not a delay formula), but the
    M/D^k/1-like holding + clearing envelope
    :func:`repro_torch.core.bulk.wait_bound` (positional trigger hold, timer-capped, plus Inoue's
    serve-all-waiting arm) upper-bounds it — ``analytic_kind='bound'``
    whenever the serve-all assumption holds (``b_max=None``)."""

    name = "wait"
    fast_kernel = "wait"
    analytic_kind = "bound"       # holding + clearing envelope (bulk.wait_bound)

    def __init__(self, k: int = 8, timeout: Optional[float] = None,
                 n_max: Optional[int] = None, b_max: Optional[int] = None,
                 predictor=None):
        super().__init__(n_max, predictor)
        assert k >= 1
        self.k = int(k)
        self.timeout = timeout
        self.b_max = b_max
        if b_max is not None:
            # the clearing arm assumes serve-ALL-arrived at the trigger; a
            # batch cap lowers throughput, so the envelope no longer
            # dominates the capped system
            self.analytic_kind = None

    def formation(self, arrivals, tokens, dist=None, predicted=None):
        # membership is arrival-count/timer-driven: prediction-insensitive
        return _WaitFormation(arrivals, self.k, self.timeout, self.b_max)

    def batch_time(self, ns, lat) -> float:
        return float(lat.batch_time(len(ns), ns.max()))

    def analytic_delay(self, lam, dist, lat) -> Optional[float]:
        from repro_torch.core.bulk import wait_bound
        if self.b_max is not None:
            return None
        return wait_bound(dist if self.n_max is None
                          else dist.clip(self.n_max),
                          lat, lam, self.k, self.timeout)["wait_bound"]


@register
class SRPTPolicy(BatchPolicy):
    """SRPT-like shortest-predicted-first batching: the waiting room is
    ordered by predicted output length and batch formation takes the
    ``b_max`` shortest waiting requests (padded decode), preempting FCFS
    order at formation time — running batches are never preempted, which
    is what a serving engine can actually implement.  Short replies stop
    queueing behind long ones AND the selected batch is length-homogeneous,
    so the ``H[b, max]`` padding waste shrinks like multi-bin batching's.

    The ordering key is the PREDICTED output length: the default (no
    ``predictor``) is the oracle, the true sampled token count after
    ``n_max`` clipping, and any :mod:`repro_torch.core.predictors`
    instance can replace it.  The service law always uses the true
    lengths: a mispredicted-short request still decodes to its true
    length and pads the whole batch.  With ``b_max=None`` every
    waiting request is served, and membership degenerates to dynamic
    batching (order inside a padded batch is irrelevant) — so the
    discipline defaults to a finite cap.  No EXACT mean-delay formula is
    known for batched SRPT (classic SRPT analysis is per-request
    preemptive), but a size-interval envelope upper-bounds it:
    :func:`repro_torch.core.bulk.srpt_bound` treats the shortest-first
    room as priority classes by length quantile and pads each class's
    clearing time to its own upper edge — ``analytic_kind='bound'`` under
    oracle ordering (a noisy ``predictor`` scrambles the class membership
    the envelope assumes, so it downgrades to None)."""

    name = "srpt"
    fast_kernel = "srpt"
    analytic_kind = "bound"       # size-interval envelope (bulk.srpt_bound)

    def __init__(self, b_max: Optional[int] = 8,
                 n_max: Optional[int] = None, predictor=None):
        super().__init__(n_max, predictor)
        self.b_max = b_max
        if predictor is not None:
            # the envelope's class decomposition assumes true-length
            # ordering; misprediction leaks long requests into short
            # classes and the bound no longer dominates
            self.analytic_kind = None

    def formation(self, arrivals, tokens, dist=None, predicted=None):
        key = tokens if predicted is None else predicted
        return _SRPTFormation(arrivals, key, self.b_max)

    def batch_time(self, ns, lat) -> float:
        return float(lat.batch_time(len(ns), ns.max()))

    def analytic_delay(self, lam, dist, lat) -> Optional[float]:
        from repro_torch.core.bulk import srpt_bound
        if self.predictor is not None:
            return None
        d = dist if self.n_max is None else dist.clip(self.n_max)
        return srpt_bound(d, lat, lam, self.b_max)["wait_bound"]


@register
class ContinuousPolicy(BatchPolicy):
    """Iteration-level (Orca/vLLM-style) batching — beyond paper.  ``slots``
    decode streams; a freed slot refills immediately; admission and refill
    at ``chunk`` boundaries, mirroring the engine's fused decode loop."""

    name = "continuous"
    oracle_kind = "continuous"
    fast_kernel = None            # virtual-timeline loop IS the simulator

    def __init__(self, slots: int = 16, n_max: Optional[int] = None,
                 chunk: int = 1, predictor=None):
        super().__init__(n_max, predictor)
        assert chunk >= 1
        self.slots = slots
        self.chunk = chunk

    def scheduler(self, clock):
        from repro_torch.serving.scheduler import ContinuousBatchScheduler
        return ContinuousBatchScheduler(clock, slots=self.slots,
                                        n_max=self.n_max, chunk=self.chunk)


__all__ = [
    "BatchPolicy", "ContinuousPolicy", "DynamicPolicy", "ElasticPolicy",
    "FCFSPolicy", "FixedPolicy", "MultiBinPolicy", "REGISTRY", "SRPTPolicy",
    "WaitPolicy", "Workload", "default_policies", "get_policy",
    "policy_from_spec", "register", "single_from_batch",
]
