"""The policy-driven reference oracle (paper §V's validation methodology):
a copy of ``repro.core.simulate``.

Every serving discipline is defined once in
:mod:`repro_torch.core.policies`; this module holds the event loops that
drive a policy on a sampled workload:

  * ``_oracle_mg1``        single-server Lindley / workload recursion
    (FCFS with optional deterministic impatience tau; paper Figs 4a-4c)
  * ``_oracle_batches``    the batch-formation loop shared by dynamic,
    fixed and elastic batching (paper Figs 5-6) and by the batch-event
    disciplines multi-bin, WAIT and SRPT (each policy's ``formation``
    encodes its trigger and members)
  * ``_oracle_continuous`` iteration-level slot refill on a virtual clock
    (beyond paper; mirrors the engine's fused chunked decode)

``simulate_policy(policy, ...)`` dispatches on ``policy.oracle_kind``.
Waits are queueing delays (arrival -> service start), matching the paper.

These loops are host NumPy and favour obviousness over speed: they are
the oracle that :mod:`repro_torch.core.fastsim` (kernels S1-S5 on the
card) is held to, trajectory for trajectory.  Fault traces (the
operational-time transform of :mod:`repro_torch.core.faults`), traffic
models (:mod:`repro_torch.core.traffic`) and re-entrant sessions (the
feedback fixed point of :mod:`repro_torch.core.sessions`) wrap the loops
unchanged; a KV-memory budget swaps the batch loop for the prefill/decode
tandem of :func:`repro_torch.core.memory.tandem_oracle`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.core.policies import (
    BatchPolicy, DynamicPolicy, ElasticPolicy, FCFSPolicy, FixedPolicy,
    Workload, policy_from_spec, single_from_batch)


# Warmup trimming is host-side in every oracle AND every fastsim kernel
# (both call the one ``_warm`` below), so one stack-scoped switch disables
# it for callers that need per-request waits aligned to the full workload.
_WARMUP_ENABLED = [True]


@contextlib.contextmanager
def no_warmup():
    """Inside this context every oracle/kernel returns FULL per-request
    waits (no 10% warmup trim); summary stats then cover the full stream."""
    _WARMUP_ENABLED.append(False)
    try:
        yield
    finally:
        _WARMUP_ENABLED.pop()


def _warm(arr, frac=0.1):
    if not _WARMUP_ENABLED[-1]:
        return np.asarray(arr)
    k = int(len(arr) * frac)
    return np.asarray(arr[k:])


ORACLES: Dict[str, Callable] = {}


def oracle(kind: str):
    def deco(fn):
        ORACLES[kind] = fn
        return fn
    return deco


def simulate_policy(policy: BatchPolicy, lam: float,
                    dist: Optional[TokenDistribution], lat,
                    num_requests: int = 200_000, seed: int = 0,
                    workload: Optional[Workload] = None,
                    fault_trace=None, traffic=None, sessions=None,
                    prefix_discount: float = 0.0, memory=None) -> dict:
    """Run ``policy`` through its reference event loop.  ``lat`` is the
    policy's latency law (``LatencyModel`` for single-service policies,
    ``BatchLatencyModel`` otherwise — a batch law handed to a
    single-service policy is converted via ``single_from_batch``).

    ``workload`` overrides the policy's own sampling (``lam``,
    ``num_requests`` and ``seed`` are then ignored): the fleet layer
    (:mod:`repro_torch.core.fleet`) runs each routed sub-stream through
    the unchanged loops this way.

    ``fault_trace`` (a :class:`repro_torch.core.faults.ReplicaTrace`)
    injects failure epochs by the operational-time transform: arrivals
    are mapped onto the server's cumulative-capacity clock, the UNCHANGED
    loop runs in operational time, and service starts are mapped back to
    wall-clock (a work-conserving queue on a breaking server,
    preemptive-resume).

    ``traffic`` (a :mod:`repro_torch.core.traffic` model, name or spec)
    warps the sampled arrivals through the model's time-rescaling
    transform; a null model leaves the trajectory bit-identical.

    ``sessions`` (a :mod:`repro_torch.core.sessions` model, name or spec)
    makes requests re-enter: completed turns re-arrive at ``completion +
    think`` through the feedback fixed point of
    :func:`repro_torch.core.sessions.simulate_policy_sessions`, whose
    turns >= 2 serve ``tokens·(1−prefix_discount)``.  A null model takes
    the session-free path.

    ``memory`` (a :class:`repro_torch.core.memory.MemoryBudget`, bare
    capacity number, or spec dict) switches batch service to the
    prefill/decode TANDEM with KV-budget admission
    (:func:`repro_torch.core.memory.tandem_oracle`).  A null budget
    (capacity None/inf) takes the budget-free path, bit for bit: an
    unconstrained tandem pipeline is a different (faster) system than the
    serial ``H(b, l)`` gate, not a degenerate case of it."""
    mem = None
    if memory is not None:
        from repro_torch.core.memory import (check_policy_supports_memory,
                                             memory_from_spec)
        mem = memory_from_spec(memory)
        if mem.is_null:
            mem = None
        else:
            check_policy_supports_memory(policy)
    if sessions is not None:
        from repro_torch.core.sessions import (session_from_spec,
                                               simulate_policy_sessions)
        model = session_from_spec(sessions)
        if not model.is_null:
            if mem is not None:
                raise ValueError(
                    "sessions= x memory= is not supported: turn re-entry "
                    "holds KV across think times (a different occupancy "
                    "law); run the tandem on the expanded per-turn stream "
                    "instead")
            if workload is not None:
                raise ValueError("sessions= expands its own workload; "
                                 "pass lam/num_requests/seed instead of "
                                 "workload=")
            return simulate_policy_sessions(
                policy, lam, dist, lat, num_requests, seed, model,
                fault_trace=fault_trace, traffic=traffic,
                prefix_discount=prefix_discount, fast=False)
    if policy.uses_single_latency and isinstance(lat, BatchLatencyModel):
        lat = single_from_batch(lat)
    wl = workload if workload is not None else \
        policy.sample_workload(lam, dist, num_requests, seed)
    if traffic is not None:
        from repro_torch.core.traffic import warp_workload
        wl = warp_workload(wl, traffic, seed)
    if mem is not None:
        from repro_torch.core.memory import tandem_oracle

        def run(w):
            return tandem_oracle(policy, w, lat, dist, mem)
    else:
        def run(w):
            return ORACLES[policy.oracle_kind](policy, w, lat, dist)

    if fault_trace is not None and not fault_trace.empty:
        # the operational-time transform composes: the tandem (and its KV
        # admission clock) runs on the server's cumulative-capacity time
        return _with_fault_trace(run, wl, fault_trace)
    return run(wl)


def _with_fault_trace(run, wl: Workload, trace) -> dict:
    """The breakdown wrapper shared by the oracle and the fast path: run
    the fault-free simulator on the operational-time workload, then map
    the service starts back through the trace's inverse transform.  Works
    with or without warmup trimming (trimmed waits align to the stream
    tail)."""
    op_arr = trace.op_time(wl.arrivals)
    op_wl = Workload(arrivals=op_arr, tokens=wl.tokens,
                     inter=np.diff(op_arr, prepend=0.0),
                     predicted=wl.predicted)
    res = run(op_wl)
    op_waits = np.asarray(res["waits"], np.float64)
    off = len(wl.arrivals) - len(op_waits)          # warmup offset
    start_wall = trace.wall_time(op_arr[off:] + op_waits)
    waits = start_wall - np.asarray(wl.arrivals)[off:]
    out = dict(res)
    out.update({
        "waits": waits,
        "mean_wait": float(waits.mean()) if waits.size else 0.0,
        "p95_wait": float(np.percentile(waits, 95)) if waits.size else 0.0,
    })
    if "mean_wait_served" in res:
        out["mean_wait_served"] = out["mean_wait"]
    return out


# ----------------------------------------------------------------------------
# M/G/1 FCFS (single-service policies)
# ----------------------------------------------------------------------------

@oracle("mg1")
def _oracle_mg1(policy, wl: Workload, lat, dist) -> dict:
    inter, tokens = wl.inter, wl.tokens
    service = lat.service_time(tokens)
    tau = policy.tau
    num_requests = len(tokens)

    if tau is None:
        # vectorized Lindley recursion: W_{n+1} = max(0, W_n + S_n - A_{n+1})
        x = service[:-1] - inter[1:]
        c = np.concatenate([[0.0], np.cumsum(x)])
        waits = c - np.minimum.accumulate(c)
        waits = _warm(waits)
        return {
            "mean_wait": float(waits.mean()),
            "mean_wait_served": float(waits.mean()),
            "loss_frac": 0.0,
            "p95_wait": float(np.percentile(waits, 95)),
            "waits": waits,
        }

    # impatience: workload recursion with admission only when V < tau
    waits = np.empty(num_requests)
    lost = np.zeros(num_requests, bool)
    v = 0.0
    for i in range(num_requests):
        v = max(0.0, v - inter[i])
        if v >= tau:
            waits[i] = tau          # lost users spend tau in queue (Eq 9)
            lost[i] = True
        else:
            waits[i] = v
            v += service[i]
    waits_w, lost_w = _warm(waits), _warm(lost)
    served = waits_w[~lost_w]
    return {
        "mean_wait": float(waits_w.mean()),
        "mean_wait_served": float(served.mean()) if served.size else 0.0,
        "loss_frac": float(lost_w.mean()),
        "p95_wait": float(np.percentile(waits_w, 95)),
        "waits": waits_w,
    }


# ----------------------------------------------------------------------------
# Generic batch-formation loop (dynamic / fixed / elastic / multi-bin /
# WAIT / SRPT)
# ----------------------------------------------------------------------------

@oracle("batches")
def _oracle_batches(policy, wl: Workload, lat, dist) -> dict:
    arr, tok = wl.arrivals, wl.tokens
    # membership and ordering see the predicted column; batch_time below
    # sees the TRUE tokens
    fs = policy.formation(arr, tok, dist, predicted=wl.predicted)
    waits = np.empty(len(arr))
    batch_sizes = []
    t_free = 0.0
    while (nb := fs.next_batch(t_free)) is not None:
        start, idx = nb
        waits[idx] = start - arr[idx]
        h = policy.batch_time(tok[idx], lat)
        batch_sizes.append(len(idx))
        t_free = start + h
    w = _warm(waits)
    return {
        "mean_wait": float(w.mean()),
        "p95_wait": float(np.percentile(w, 95)),
        "mean_batch": float(np.mean(batch_sizes)),
        "waits": w,
    }


# ----------------------------------------------------------------------------
# Continuous (iteration-level) batching on a virtual clock
# ----------------------------------------------------------------------------

@oracle("continuous")
def _oracle_continuous(policy, wl: Workload, lat: BatchLatencyModel,
                       dist) -> dict:
    from repro_torch.serving.scheduler import run_continuous_virtual
    waits, _e2e, _makespan = run_continuous_virtual(
        wl.arrivals, wl.tokens.astype(np.int64), slots=policy.slots,
        chunk=policy.chunk,
        prefill_time=lambda b: float(lat.k1 * b + lat.k2),
        decode_step_time=lambda b: float(lat.k3 * b + lat.k4))
    w = _warm(waits)
    return {
        "mean_wait": float(w.mean()),
        "p95_wait": float(np.percentile(w, 95)),
        "mean_batch": float(policy.slots),
        "waits": w,
    }


# ----------------------------------------------------------------------------
# Legacy entry points (thin policy wrappers)
# ----------------------------------------------------------------------------

def simulate_mg1(lam: float, dist: TokenDistribution, lat: LatencyModel,
                 n_max: Optional[int] = None, tau: Optional[float] = None,
                 num_requests: int = 200_000, seed: int = 0) -> dict:
    return simulate_policy(FCFSPolicy(n_max=n_max, tau=tau), lam, dist, lat,
                           num_requests=num_requests, seed=seed)


def simulate_dynamic_batching(lam: float, dist: TokenDistribution,
                              lat: BatchLatencyModel,
                              b_max: Optional[int] = None,
                              elastic: bool = False,
                              n_max: Optional[int] = None,
                              num_requests: int = 200_000,
                              seed: int = 0) -> dict:
    """Dynamic batching: when the server frees, take min(waiting, b_max)
    requests in one batch (all of them when b_max is None). elastic=True uses
    the Eq-26 completion time instead of padded H[b, max]."""
    cls = ElasticPolicy if elastic else DynamicPolicy
    return simulate_policy(cls(n_max=n_max, b_max=b_max), lam, dist, lat,
                           num_requests=num_requests, seed=seed)


def simulate_fixed_batching(lam: float, b: int,
                            dist: Optional[TokenDistribution],
                            lat: Optional[BatchLatencyModel] = None,
                            batch_time: Optional[Callable] = None,
                            num_requests: int = 200_000,
                            seed: int = 0) -> dict:
    """Fixed batching: the server waits until exactly b requests are present
    (paper §IV-C), then serves them together.  ``batch_time`` overrides the
    policy's service law (used by the M/D^b/1 validation tests)."""
    pol = FixedPolicy(b=b)
    if batch_time is not None:
        pol.batch_time = lambda ns, _lat: float(batch_time(ns))
    else:
        assert lat is not None
    return simulate_policy(pol, lam, dist, lat,
                           num_requests=num_requests, seed=seed)


def simulate_policy_sweep(lam_grid, dist, lat, policies: dict,
                          num_requests: int = 100_000, seed: int = 0) -> dict:
    """Mean wait for each policy over an arrival-rate grid.  ``policies``:
    name -> BatchPolicy instance or legacy dict(kind=..., **kwargs)."""
    insts = {name: (spec if isinstance(spec, BatchPolicy)
                    else policy_from_spec(spec))
             for name, spec in policies.items()}
    out = {name: [] for name in insts}
    for lam in lam_grid:
        for name, pol in insts.items():
            r = simulate_policy(pol, lam, dist, lat,
                                num_requests=num_requests, seed=seed)
            out[name].append(r["mean_wait"])
    return {k: np.asarray(v) for k, v in out.items()}
