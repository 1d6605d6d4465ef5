"""KV-memory budget and the prefill/decode tandem service, a copy of
``repro.core.memory``.

The paper's service laws (Eqs 18-26) gate a batch on its size ``b`` alone
and serve it as ONE stage ``H(b, l)``.  Real engines are a *tandem*: a
prefill bulk stage (``k1*b + k2``, the first-token term of Eq 18) feeds a
decode continuous stage (``(k3*b + k4)*l``), and the binding constraint is
HBM for KV cache, not batch size: the premise of WAIT scheduling (Dai et
al. 2025) and of memory-aware admission in AugServe (Wang et al. 2025).

This module supplies both halves:

* :class:`MemoryBudget`: per-replica KV-token capacity ``M``; a request
  holds ``prompt_tokens + n_i`` KV tokens from its prefill start until its
  decode completion, when the footprint is freed.
* :class:`TandemClock`: the multi-stage latency law.  It wraps the
  :class:`~repro_torch.core.latency_model.BatchLatencyModel` and asks the
  *policy* for its stage split (``BatchPolicy.stage_split``): the default
  split is (prefill, uniform decode offsets); elastic overrides it with
  the Eq 26 per-request completion offsets.
* :func:`tandem_oracle`: the host NumPy event loop every other layer is
  held to.  Batches form exactly as before (same formation objects), but
  the batch occupies the prefill stage for ``k1*b + k2`` and then the
  decode stage for the remainder, so batch j+1's prefill overlaps batch
  j's decode (pipelining).  Admission is memory-gated: a member joins only
  if the alive KV footprint stays <= M; members that do not fit are
  deferred via ``formation.rewind`` and re-offered later; if even the
  first member does not fit the start is delayed to the earliest release
  instant that frees enough.  The fast path runs the dynamic lane of this
  loop as kernel S7 (``kernels/tandem_scan``).

A *null* budget (``capacity=None``/inf) takes every caller's budget-free
code path, bit for bit: an infinite-budget tandem PIPELINE is a different
(faster) system than the serial ``H(b, l)`` gate, not a degenerate case
of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

__all__ = [
    "MemoryBudget", "TandemClock", "memory_from_spec",
    "check_policy_supports_memory", "tandem_oracle", "occupancy_stats",
]


# ----------------------------------------------------------------------------
# Budget model
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """Per-replica KV-token budget.

    ``capacity``       : KV tokens of HBM available to one replica; None or
                         inf means unconstrained (the null model).
    ``prompt_tokens``  : KV tokens a request's prompt occupies on top of
                         its generated tokens — footprint(n) = prompt + n.
    """

    capacity: Optional[float] = None
    prompt_tokens: float = 0.0

    @property
    def is_null(self) -> bool:
        return self.capacity is None or math.isinf(self.capacity)

    def footprint(self, tokens):
        """KV tokens request(s) hold from prefill start to completion."""
        return self.prompt_tokens + np.asarray(tokens, np.float64)

    def max_batch(self, dist, quantile: float = 1.0) -> int:
        """Largest batch that fits worst-case members: b(M) = floor(M /
        footprint(L_inf)) with the token support capped at ``quantile``
        (heavy tails would otherwise drive L_inf, and b(M), to 0/inf)."""
        if self.is_null:
            raise ValueError("max_batch is undefined for a null budget")
        linf = float(dist.max_order_stat_limit(quantile))
        per = float(self.footprint(linf))
        return max(1, int(self.capacity / max(per, 1e-12)))


def memory_from_spec(spec) -> MemoryBudget:
    """None -> null budget; a MemoryBudget passes through; a number is a
    bare capacity; a dict maps to the constructor."""
    if spec is None:
        return MemoryBudget()
    if isinstance(spec, MemoryBudget):
        return spec
    if isinstance(spec, (int, float)):
        return MemoryBudget(capacity=float(spec))
    if isinstance(spec, dict):
        return MemoryBudget(**spec)
    raise ValueError(f"cannot build a MemoryBudget from {spec!r}")


def check_policy_supports_memory(policy) -> None:
    """The tandem needs discrete batch formation events to gate: FCFS
    (oracle_kind 'mg1') has no batch admission point, and continuous
    (iteration-level) batching admits per token, not per batch."""
    if policy.oracle_kind != "batches":
        raise ValueError(
            f"policy {policy.name!r} (oracle_kind={policy.oracle_kind!r}) "
            "has no batch-formation admission point; memory= is only "
            "supported for batch-formation policies")


# ----------------------------------------------------------------------------
# Multi-stage latency law
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TandemClock:
    """Two-stage generalization of the single ``H(b, l)`` service clock.

    Stage 1 (prefill, bulk):      P(b)    = k1*b + k2
    Stage 2 (decode, continuous): D(b, l) = (k3*b + k4)*l

    so H(b, l) = P(b) + D(b, l) exactly recovers Eq 18 when the stages are
    run back to back.  The per-request decode offsets come from the
    policy's ``stage_split`` so elastic early exit (Eq 26) splits
    correctly too.
    """

    batch: "BatchLatencyModel"

    def prefill_time(self, b):
        return self.batch.prefill_time(b)

    def decode_time(self, b, l):
        return self.batch.decode_time(b, l)

    def serial_time(self, b, l):
        """Back-to-back total — the PR-9 single-stage H(b, l)."""
        return self.batch.batch_time(b, l)

    def stage_split(self, policy, ns):
        """(prefill seconds, per-request decode offsets) for a batch."""
        return policy.stage_split(ns, self.batch)


# ----------------------------------------------------------------------------
# Reference tandem oracle
# ----------------------------------------------------------------------------

def tandem_oracle(policy, wl, lat, dist, budget: MemoryBudget) -> dict:
    """Exact pipelined tandem event loop with memory-gated admission.

    State: ``t_pf`` (prefill stage free), ``t_dec`` (decode stage free),
    ``A`` (total KV ever admitted) and a per-request release ledger
    (``rel_t`` sorted times / ``rel_cum`` prefix sums — sorted by
    construction because batch j+1's decode starts after batch j's ends).
    Alive KV at time t is ``A_admitted_before_t - released_before_t``.

    Admission per batch (membership fixed at the formation trigger):

    1. releases up to the candidate start are banked:
       ``target = M + rel_cum[searchsorted(rel_t, start, 'right')]``;
    2. if even the first member overflows, the start is DELAYED to the
       earliest release instant freeing enough (never re-formed);
    3. the longest prefix of members (in formation order) with cumulative
       footprint <= target is admitted; the rest are deferred via
       ``formation.rewind`` and re-offered at the next trigger.

    The batch then holds the prefill stage for ``pf`` and the decode stage
    from ``max(start + pf, t_dec)``; waits are measured to prefill start
    (the PR-9 convention: waits end when service begins).
    """
    from repro_torch.core.simulate import _warm

    arr, tok = wl.arrivals, wl.tokens
    n = len(arr)
    M = float(budget.capacity)
    fp = budget.footprint(tok)
    if n and float(fp.max()) > M:
        raise ValueError(
            f"memory budget {M} cannot hold the largest single request "
            f"(footprint {float(fp.max())}); no schedule exists")

    fs = policy.formation(arr, tok, dist, predicted=wl.predicted)
    waits = np.zeros(n)
    adm_start = np.zeros(n)          # prefill (allocation) instant
    adm_comp = np.zeros(n)           # completion (release) instant
    rel_t = np.empty(n)              # release ledger: times ...
    rel_cum = np.zeros(n + 1)        # ... and prefix footprint sums
    nr = 0
    t_pf = 0.0
    t_dec = 0.0
    A = 0.0
    batch_sizes = []
    blocked_batches = 0
    blocked_time = 0.0
    deferred = 0

    while (nb := fs.next_batch(t_pf)) is not None:
        start0, idx = nb
        start = float(start0)
        # -- releases banked by the candidate start --------------------
        r = int(np.searchsorted(rel_t[:nr], start, side="right"))
        target = M + rel_cum[r]
        if A + fp[idx[0]] > target:
            # delay to the earliest instant freeing enough; feasible
            # because rel_cum[nr] == A (every admitted token has a
            # scheduled release) and fp[idx[0]] <= M
            need = A + fp[idx[0]] - M
            r_star = int(np.searchsorted(rel_cum[1:nr + 1], need,
                                         side="left")) + 1
            start = float(rel_t[r_star - 1])
            blocked_batches += 1
            blocked_time += start - start0
            r = int(np.searchsorted(rel_t[:nr], start, side="right"))
            target = M + rel_cum[r]
        # -- longest admissible prefix, in formation order -------------
        admit = 0
        cum = A
        for i in idx:
            if cum + fp[i] <= target:
                cum += fp[i]
                admit += 1
            else:
                break
        if admit < len(idx):
            fs.rewind(len(idx) - admit)
            deferred += len(idx) - admit
            idx = idx[:admit]
        A = cum
        # -- tandem service --------------------------------------------
        pf, dec_off = policy.stage_split(tok[idx], lat)
        p_end = start + pf
        d_start = max(p_end, t_dec)
        comp = d_start + dec_off
        waits[idx] = start - arr[idx]
        adm_start[idx] = start
        adm_comp[idx] = comp
        batch_sizes.append(len(idx))
        # -- release ledger, in completion order -----------------------
        order = np.argsort(dec_off, kind="stable")
        for j in order:
            rel_t[nr] = comp[j]
            rel_cum[nr + 1] = rel_cum[nr] + fp[idx[j]]
            nr += 1
        t_pf = p_end
        t_dec = float(comp[order[-1]])

    w = _warm(waits)
    mem = occupancy_stats(adm_start, adm_comp, fp, M, served=nr)
    mem["blocked_batches"] = blocked_batches
    mem["blocked_time"] = float(blocked_time)
    mem["deferred_requests"] = deferred
    return {
        "mean_wait": float(w.mean()) if w.size else 0.0,
        "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
        "mean_batch": float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        "waits": w,
        "memory": mem,
        # untrimmed per-request views for the scheduler adapter
        # (PolicyScheduler drives this same loop through a ModelClock)
        "waits_all": waits,
        "completions": adm_comp,
        "batch_sizes": batch_sizes,
    }


def occupancy_stats(starts, comps, footprints, capacity: float,
                    served: Optional[int] = None) -> dict:
    """KV occupancy trajectory from per-request (allocate, free, size)
    triples: allocation events (+fp at start) and release events (-fp at
    completion), releases first on ties — consistent with the admission
    rule's 'right'-sided release search.  ``served`` limits to the first
    rows actually scheduled (fixed-b truncation leaves a tail)."""
    starts = np.asarray(starts, np.float64)
    comps = np.asarray(comps, np.float64)
    fp = np.asarray(footprints, np.float64)
    if served is not None and served < len(starts):
        # fixed-size batching truncates to a multiple of b: unserved tail
        # rows never allocate
        mask = comps > 0
        starts, comps, fp = starts[mask], comps[mask], fp[mask]
    n = len(starts)
    allocated = float(fp.sum())
    if n == 0:
        return {"capacity": float(capacity), "kv_peak": 0.0,
                "kv_mean": 0.0, "utilization": 0.0,
                "allocated": 0.0, "freed": 0.0}
    t = np.concatenate([starts, comps])
    d = np.concatenate([fp, -fp])
    # releases before allocations at ties (a freed slot is reusable at
    # the same instant)
    order = np.lexsort((np.sign(d), t))
    t, d = t[order], d[order]
    level = np.cumsum(d)
    peak = float(level.max())
    span = float(t[-1] - t[0])
    if span > 0:
        dt = np.diff(t)
        mean = float((level[:-1] * dt).sum() / span)
    else:
        mean = peak
    return {
        "capacity": float(capacity),
        "kv_peak": peak,
        "kv_mean": mean,
        "utilization": peak / capacity if capacity else 0.0,
        "allocated": allocated,
        "freed": float(-d[d < 0].sum()),
    }
