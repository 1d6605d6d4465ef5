"""Data: synthetic LM token streams for training and Poisson request
workloads for serving, copies of the reference package's
``SyntheticLMDataset``, ``Request`` and ``make_request_stream``
(``repro.data.pipeline``), with modulated traffic and the multi-turn
session expansion.  NumPy only; the rng call order is the reference's, so
equal seeds (and an equal ``dist``) give equal batches and streams, bit
for bit."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


class SyntheticLMDataset:
    """Zipf-distributed token sequences with structure (every even
    position a function of the token before it) so smoke training shows a
    real falling loss.  Batch ``index`` is drawn from its own generator
    seeded by (seed, index), so a restart that restores ``index`` from a
    checkpoint replays from the same position."""

    def __init__(self, cfg, seq_len: int, global_batch: int, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.index = 0
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks ** 1.1)
        self._probs /= self._probs.sum()

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, index))

    def batch(self, index: Optional[int] = None) -> dict:
        """Batch ``index`` (default: the next one, advancing ``index``) as
        NumPy arrays: ``labels`` and ``tokens`` (int32) or ``embeds``
        (fp32), and ``image_embeds`` (fp32) for a vision config."""
        idx = self.index if index is None else index
        rng = self._rng(idx)
        b, s, v = self.global_batch, self.seq_len, self.cfg.vocab_size
        base = rng.choice(v, size=(b, s + 1), p=self._probs)
        base[:, 2::2] = (base[:, 1:-1:2] * 7 + 13) % v
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        out = {"labels": labels}
        if self.cfg.embeddings_input:
            erng = self._rng(idx + 10 ** 9)
            out["embeds"] = erng.normal(
                0, 0.02, (b, s, self.cfg.d_model)).astype(np.float32)
            out["labels"] = labels % self.cfg.vocab_size
        else:
            out["tokens"] = tokens
        if self.cfg.vision_seq:
            irng = self._rng(idx + 2 * 10 ** 9)
            out["image_embeds"] = irng.normal(
                0, 0.02, (b, self.cfg.vision_seq, self.cfg.d_model)
            ).astype(np.float32)
        if index is None:
            self.index += 1
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch()


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
    modulation on or off.

    ``sessions`` (a :mod:`repro_torch.core.sessions` model, registry name
    or spec) expands the ``num`` base requests into multi-turn sessions:
    the base stream above is drawn first (turn-1 rows reuse it verbatim),
    then turns >= 2 draw their lengths and prompts from the salted session
    lanes; a null model returns the session-free list.  Expanded arrivals
    are the lower bound ``base + cumulative think``; a session-aware
    scheduler re-enqueues each turn at its predecessor's finish +
    ``think``."""
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
    if sessions is None:
        return reqs
    from repro_torch.core.sessions import (_PROMPT_LANE, _TOKENS_LANE,
                                           _session_rng, plan_sessions,
                                           session_from_spec)
    model = session_from_spec(sessions)
    if model.is_null:
        return reqs
    plan = plan_sessions(model, num, seed)
    trng = _session_rng(seed, _TOKENS_LANE)
    prng = _session_rng(seed, _PROMPT_LANE)
    extra_outs = dist.sample(trng, int((plan.turn >= 2).sum()))
    cs = np.cumsum(plan.think)
    out_reqs, j = [], 0
    for s in range(num):
        base = reqs[s]
        for t in range(int(plan.turns[s])):
            row = int(plan.offsets[s]) + t
            if t == 0:
                req = dataclasses.replace(
                    base, rid=row, session=s, turn=1, think=0.0)
            else:
                plen = int(prng.integers(*prompt_len_range))
                req = Request(
                    rid=row,
                    arrival=float(base.arrival + cs[row]
                                  - cs[plan.offsets[s]]),
                    prompt_tokens=prng.integers(0, vocab, plen)
                    .astype(np.int32),
                    target_output_tokens=int(max(extra_outs[j], 1)),
                    session=s, turn=t + 1,
                    think=float(plan.think[row]),
                )
                j += 1
            out_reqs.append(req)
    return out_reqs
