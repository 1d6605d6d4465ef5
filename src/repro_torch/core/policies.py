"""Batch formation for the paper's batching disciplines: a copy of the
formation part of ``repro.core.policies`` (dynamic, elastic and fixed
batching) with no analytics and no simulators.

``formation()`` returns an iterator-style state whose
``next_batch(t_free)`` encodes the trigger (when service starts) and the
member selection (who is in the batch); ``serving.scheduler`` walks it on
the arrival timeline and runs each batch on the engine.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np


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


REGISTRY: Dict[str, Type["BatchPolicy"]] = {}


def register(cls: Type["BatchPolicy"]) -> Type["BatchPolicy"]:
    REGISTRY[cls.name] = cls
    return cls


def get_policy(name: str, **kwargs) -> "BatchPolicy":
    if name not in REGISTRY:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet (ported: "
            f"{', '.join(sorted(REGISTRY))}); see ROADMAP.md")
    return REGISTRY[name](**kwargs)


class BatchPolicy:
    """One batching discipline's formation and clipping rules."""

    name = "base"

    def __init__(self, n_max: Optional[int] = None):
        self.n_max = n_max

    def clip(self, tokens):
        return (np.minimum(tokens, self.n_max) if self.n_max is not None
                else tokens)

    def formation(self, arrivals: np.ndarray, tokens: np.ndarray):
        raise NotImplementedError

    def schedule_length(self, n: int) -> int:
        """How many of ``n`` offered requests this policy serves (fixed
        batching truncates to a multiple of b)."""
        return n

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items() if v is not None}
        return f"{type(self).__name__}({keys})"


@register
class DynamicPolicy(BatchPolicy):
    """Dynamic batching: serve all waiting (cap ``b_max``) with padded
    decode H[b, max] (paper §IV-A/B, Eq 18)."""

    name = "dynamic"

    def __init__(self, n_max: Optional[int] = None,
                 b_max: Optional[int] = None):
        super().__init__(n_max)
        self.b_max = b_max

    def formation(self, arrivals, tokens):
        return _DynamicFormation(arrivals, self.b_max)


@register
class ElasticPolicy(DynamicPolicy):
    """Elastic batching: dynamic formation, but short replies exit early
    (completion via Eq 26) and the batch ends at the slowest member."""

    name = "elastic"


@register
class FixedPolicy(BatchPolicy):
    """Fixed batching M/D^b/1: wait until exactly ``b`` requests are
    present (paper §IV-C, Eqs 24-25)."""

    name = "fixed"

    def __init__(self, b: int = 4, n_max: Optional[int] = None):
        super().__init__(n_max)
        self.b = b

    def formation(self, arrivals, tokens):
        return _FixedFormation(arrivals, self.b)

    def schedule_length(self, n: int) -> int:
        return (n // self.b) * self.b


__all__ = ["BatchPolicy", "DynamicPolicy", "ElasticPolicy", "FixedPolicy",
           "REGISTRY", "get_policy", "register"]
