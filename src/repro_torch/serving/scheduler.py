"""Run a batching policy's batches on the engine: the engine layer of
``repro.serving.scheduler`` (``EngineClock``, ``ScheduleResult`` and
``run_engine_schedule``), without length predictors or memory budgets."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.policies import BatchPolicy, ElasticPolicy
from repro_torch.data.pipeline import Request


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


@dataclasses.dataclass
class ScheduleResult:
    waits: np.ndarray           # queueing delay per request (paper's E[W])
    e2e: np.ndarray             # arrival -> reply complete
    lost: np.ndarray            # impatience abandonments (bool)
    batch_sizes: List[int]
    makespan: float


def run_engine_schedule(policy: BatchPolicy, engine, reqs: List[Request],
                        predictor=None, memory=None) -> ScheduleResult:
    """Form batches with ``policy`` on the request stream's virtual arrival
    timeline and execute each batch on the engine (prefill + fused chunked
    decode); batch durations are wall-clock seconds.  Elastic policies run
    the engine in elastic mode, the others padded.  Length predictors and
    memory budgets are not ported yet: passing either raises."""
    if predictor is not None or memory is not None:
        raise NotImplementedError(
            "run_engine_schedule: predictor and memory are not ported yet "
            "(ROADMAP.md, queue 1)")
    clock = EngineClock(engine)
    n = policy.schedule_length(len(reqs))
    arr = np.array([r.arrival for r in reqs[:n]])
    ns = np.array([policy.clip(r.target_output_tokens) for r in reqs[:n]],
                  np.float64)
    elastic = isinstance(policy, ElasticPolicy)
    waits = np.zeros(n)
    e2e = np.zeros(n)
    sizes = []
    fs = policy.formation(arr, ns)
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
