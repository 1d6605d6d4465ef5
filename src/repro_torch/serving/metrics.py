"""Serving metrics: a copy of ``repro.serving.metrics``.  The paper's
evaluation axis is latency (queueing delay, loss fraction); we add standard
serving percentiles.  The fault, memory and session blocks read attributes
that only the resilience (``serving/resilience.py``), memory
(``core/memory.py``) and session (``core/sessions.py``) layers set; a result
without them skips them."""

from __future__ import annotations

import numpy as np


def summarize(result, warmup_frac: float = 0.1) -> dict:
    k = int(len(result.waits) * warmup_frac)
    waits = result.waits[k:]
    lost = result.lost[k:]
    e2e = result.e2e[k:]
    served = ~lost
    out = {
        "mean_wait": float(waits.mean()) if waits.size else 0.0,
        "p50_wait": float(np.percentile(waits, 50)) if waits.size else 0.0,
        "p95_wait": float(np.percentile(waits, 95)) if waits.size else 0.0,
        "p99_wait": float(np.percentile(waits, 99)) if waits.size else 0.0,
        "loss_frac": float(lost.mean()) if lost.size else 0.0,
        "mean_wait_served": float(waits[served].mean()) if served.any() else 0.0,
        "mean_e2e": float(e2e[served].mean()) if served.any() else 0.0,
        "mean_batch": (float(np.mean(result.batch_sizes))
                       if result.batch_sizes else 0.0),
        "requests": int(len(waits)),
        "makespan": float(result.makespan),
    }
    rep = getattr(result, "resilience", None)
    if rep is not None:
        # fault accounting (repro.serving.resilience.ResilienceReport):
        # conservation served + shed + failed == arrived
        out.update({
            "served": int(rep.served), "shed": int(rep.shed),
            "failed": int(rep.failed), "retries": int(rep.retries),
            "hedged": int(rep.hedged), "hedge_wins": int(rep.hedge_wins),
            "kill_events": len(rep.kill_events),
            "availability": [float(a) for a in rep.availability],
        })
    memo = getattr(result, "memory", None)
    if memo is not None:
        # KV-occupancy accounting (repro.core.memory): peak/mean live KV
        # tokens vs the budget, plus admission blocking/deferral counts
        out["memory"] = {
            "capacity": memo["capacity"],
            "kv_peak": float(memo["kv_peak"]),
            "kv_mean": float(memo["kv_mean"]),
            "utilization": float(memo["utilization"]),
            "allocated": float(memo["allocated"]),
            "freed": float(memo["freed"]),
            "blocked_batches": int(memo.get("blocked_batches", 0)),
            "blocked_time": float(memo.get("blocked_time", 0.0)),
            "deferred_requests": int(memo.get("deferred_requests", 0)),
        }
    sess = getattr(result, "sessions", None)
    if sess is not None:
        # re-entrant session accounting (repro.core.sessions): per-turn
        # conservation arrived == served + lost, and per-session
        # end-to-end latency (first-turn arrival -> last-turn completion)
        out.update({
            "n_sessions": int(sess["n_sessions"]),
            "turns_arrived": int(sess["turns_arrived"]),
            "turns_served": int(sess["turns_served"]),
            "turns_lost": int(sess["turns_lost"]),
            "turns_cancelled": int(sess["turns_cancelled"]),
            "sessions_completed": int(sess["sessions_completed"]),
            "mean_session_e2e": float(sess["mean_session_e2e"]),
            "p95_session_e2e": float(sess["p95_session_e2e"]),
        })
    return out
