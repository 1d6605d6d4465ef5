"""Poisson request workloads for serving: a copy of the reference
package's ``Request`` and ``make_request_stream`` (``repro.data.pipeline``)
with modulated traffic and without the session expansion (ROADMAP.md M7c).
The rng call order is the reference's, so equal seeds and an equal
``dist`` give equal streams."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.policies import not_ported


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_tokens: np.ndarray        # int32 [prompt_len]
    target_output_tokens: int        # "user requirement" n_req (paper SIII)
    # filled by the engine:
    start_time: float = -1.0
    finish_time: float = -1.0
    generated: int = 0
    # re-entrant sessions: -1/1/0.0 on session-free streams
    session: int = -1                # session id (-1: not part of one)
    turn: int = 1                    # 1-based turn index within the session
    think: float = 0.0               # delay after the previous turn's finish

    @property
    def queue_wait(self) -> float:
        return self.start_time - self.arrival


def correlated_prompt_len(out_tokens: float, corr: float,
                          rng: np.random.Generator,
                          lo: int = 4, hi: int = 512) -> int:
    """Prompt length correlated with the output requirement: longer asks
    tend to come with longer prompts (log-linear, plus noise)."""
    plen = corr * 10.0 * np.log1p(float(out_tokens)) + rng.normal(0.0, 2.0)
    return int(np.clip(round(plen), lo, hi))


def make_request_stream(num: int, lam: float, dist, vocab: int,
                        prompt_len_range=(8, 64), seed: int = 0,
                        prompt_len_corr: float = 0.0, traffic=None,
                        sessions=None):
    """Poisson arrivals + iid output-token requirements (the paper's model).

    ``dist`` is any object with ``sample(rng, size)`` returning token
    counts.  ``prompt_len_corr=0`` keeps prompt lengths uniform in
    ``prompt_len_range`` and independent of the output requirement;
    ``prompt_len_corr>0`` draws them from :func:`correlated_prompt_len`.

    ``traffic`` (a :mod:`repro_torch.core.traffic` model, registry name or
    spec) modulates the arrival RATE: the stationary arrivals are drawn in
    the exact historical rng call order, then pushed through the model's
    time-rescaling warp, so tokens and prompts are bit-identical with
    modulation on or off.  ``sessions`` (multi-turn expansion) is not
    ported yet and raises."""
    if sessions is not None:
        not_ported("the multi-turn session expansion", "M7c (sessions)")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, num))
    if traffic is not None:
        from repro_torch.core.traffic import traffic_from_spec
        arrivals = traffic_from_spec(traffic).warp(arrivals, seed)
    outs = dist.sample(rng, num)
    reqs = []
    for i in range(num):
        if prompt_len_corr:
            plen = correlated_prompt_len(outs[i], prompt_len_corr, rng)
        else:
            plen = int(rng.integers(*prompt_len_range))
        reqs.append(Request(
            rid=i, arrival=float(arrivals[i]),
            prompt_tokens=rng.integers(0, vocab, plen).astype(np.int32),
            target_output_tokens=int(max(outs[i], 1)),
        ))
    return reqs
