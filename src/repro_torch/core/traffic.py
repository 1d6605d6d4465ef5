"""Non-stationary arrival processes: a copy of ``repro.core.traffic``,
modulated traffic as a registry.

Every layer so far samples stationary Poisson(λ) arrivals.  Production
traffic from millions of users is diurnal and bursty; this module makes
the modulation a first-class *registered* component, mirroring the
policy / predictor / router / fault registries:

  * ``stationary`` — the null model: the historical Poisson(λ) stream,
    bit-identical to the unmodulated stream by construction (the warp is the
    identity and is never even applied).
  * ``sinusoid``   — diurnal rate λ(t) = λ·(1 + A·sin(2πt/period + φ)),
    |A| ≤ 1.  Amplitude 0 is the null model.
  * ``mmpp``       — Markov-modulated Poisson process: the rate
    multiplier is piecewise-constant over exponential state-dwell
    episodes (state k holds ~Exp(mean_dwell[k]), rate multiplier
    rates[k]); multipliers are normalized by the chain's stationary
    mean so the long-run rate is exactly λ.  All-equal rates is the
    null model.
  * ``trace``      — trace replay: piecewise-constant multipliers over
    explicit breakpoints, repeated cyclically with period ``period``
    and normalized by their time-average.  All-equal rates is the null
    model.

The time-rescaling construction
-------------------------------

An inhomogeneous Poisson process with rate λ(t) = λ·m(t), where the
multiplier m has long-run time-average 1, is EXACTLY a stationary
Poisson(λ) process pushed through the inverse integrated profile:

    P(t) = ∫₀ᵗ m(u) du          (slope-1 long run)
    a_i  = P⁻¹(s_i)             (s_i the stationary arrival times)

so every model here is implemented as a *warp* applied to the base
arrivals AFTER they are drawn in the exact historical rng call order.
Two consequences the conformance tests pin:

  * the workload PRNG stream is untouched — tokens / prompts /
    predictions are bit-identical with modulation on or off, only the
    arrival instants move (and not at all for a null model);
  * superposition transfers — warping R independent λ/R sub-streams
    through the SAME profile and merging is the modulated process at
    rate λ·m(t) with iid uniform replica marks, so
    ``RandomRouter.fleet_workload`` keeps its exact split construction.

Determinism: every random draw (MMPP dwell episodes) comes from
``np.random.default_rng`` on a ``SeedSequence`` salted with
``_TRAFFIC_SALT`` — a stream independent of the workload, predictor
(``_PRED_SALT``), router (``_ROUTE_SALT``) and fault (``_FAULT_SALT``)
streams.  The closed-loop controller's per-window shed draws live on
``_SHED_LANE`` of the same salt.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.policies import Workload

_TRAFFIC_SALT = 0x7AFF1C00
# key lanes inside the traffic stream, disjoint from model-internal lanes
_SHED_LANE = 2_000_003       # closed-loop admission shedding (control.py)


def _traffic_rng(seed, *lanes) -> np.random.Generator:
    parts = [int(k) for k in seed] if isinstance(seed, (tuple, list)) \
        else [int(seed)]
    return np.random.default_rng(np.random.SeedSequence(
        [_TRAFFIC_SALT] + parts + [int(x) for x in lanes]))


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

TRAFFIC: Dict[str, type] = {}


def register_traffic(cls):
    TRAFFIC[cls.name] = cls
    return cls


def get_traffic(name: str, **kw) -> "TrafficModel":
    return TRAFFIC[name](**kw)


def traffic_from_spec(spec) -> "TrafficModel":
    """None -> stationary; instance passes through; registry name or
    ``{"name": ..., **params}`` dict constructs."""
    if spec is None:
        return StationaryTraffic()
    if isinstance(spec, TrafficModel):
        return spec
    if isinstance(spec, str):
        return get_traffic(spec)
    spec = dict(spec)
    return get_traffic(spec.pop("name"), **spec)


def default_traffic() -> Dict[str, "TrafficModel"]:
    """One representative instance per registered model — the set the
    conformance tests and registry-driven benchmarks iterate."""
    return {
        "stationary": StationaryTraffic(),
        "sinusoid": SinusoidTraffic(amplitude=0.6, period=400.0),
        "mmpp": MMPPTraffic(rates=(0.5, 2.0), mean_dwell=(200.0, 100.0)),
        "trace": TraceTraffic(times=(0.0, 100.0, 200.0, 300.0),
                              rates=(0.5, 1.5, 1.0, 2.0), period=400.0),
    }


def null_traffic() -> Dict[str, "TrafficModel"]:
    """A zero-modulation instance of every registered model — each must
    reproduce the stationary trajectories bit-exactly (``is_null`` short-
    circuits the warp to the identity)."""
    return {
        "stationary": StationaryTraffic(),
        "sinusoid": SinusoidTraffic(amplitude=0.0, period=100.0),
        "mmpp": MMPPTraffic(rates=(1.0, 1.0), mean_dwell=(50.0, 50.0)),
        "trace": TraceTraffic(times=(0.0, 50.0), rates=(2.0, 2.0),
                              period=100.0),
    }


# ----------------------------------------------------------------------------
# Piecewise-constant profile machinery (shared by mmpp / trace)
# ----------------------------------------------------------------------------

def _piecewise_cumulative(t: np.ndarray, starts: np.ndarray,
                          rates: np.ndarray) -> np.ndarray:
    """P(t) = ∫₀ᵗ m for a piecewise-constant multiplier: segment k is
    [starts[k], starts[k+1]) at rate rates[k] (last segment open-ended).
    ``starts[0]`` must be 0."""
    cum = np.concatenate(
        ([0.0], np.cumsum(rates[:-1] * np.diff(starts))))
    k = np.clip(np.searchsorted(starts, t, side="right") - 1,
                0, len(starts) - 1)
    return cum[k] + rates[k] * (t - starts[k])


def _piecewise_inverse(u: np.ndarray, starts: np.ndarray,
                       rates: np.ndarray) -> np.ndarray:
    """P⁻¹(u) for the same piecewise profile.  Requires rates > 0 (a
    zero-rate segment has no inverse image) and enough segments that the
    terminal cumulative mass covers max(u)."""
    cum = np.concatenate(
        ([0.0], np.cumsum(rates[:-1] * np.diff(starts))))
    k = np.clip(np.searchsorted(cum, u, side="right") - 1,
                0, len(starts) - 1)
    return starts[k] + (u - cum[k]) / rates[k]


# ----------------------------------------------------------------------------
# Models
# ----------------------------------------------------------------------------

class TrafficModel:
    """One arrival-rate modulation, defined once for every layer.

    The multiplier ``m(t)`` is normalized to long-run time-average 1, so
    the instantaneous rate is λ·m(t) and the long-run rate stays exactly
    λ — replica-count recommendations and analytic baselines keep their
    meaning.  ``warp`` is the whole integration surface: layers draw the
    historical stationary stream first, then push the arrival instants
    through ``P⁻¹`` (module docstring), touching no other rng draw."""

    name = "base"

    @property
    def is_null(self) -> bool:
        """True when the model is the stationary process (multiplier
        ≡ 1): the warp is skipped entirely, so the arrivals array is the
        SAME object the historical path produced — bit-equality to the
        stationary trajectories by construction."""
        raise NotImplementedError

    # -- profile (normalized multiplier units) --------------------------
    def rate(self, t, seed: int = 0) -> np.ndarray:
        """Multiplier m(t) (instantaneous arrival rate / λ)."""
        raise NotImplementedError

    def cumulative(self, t, seed: int = 0) -> np.ndarray:
        """P(t) = ∫₀ᵗ m(u) du; the expected arrival count in [0, t] is
        λ·P(t) (the property tests' integrated-rate invariant)."""
        raise NotImplementedError

    def warp(self, arrivals: np.ndarray, seed: int = 0) -> np.ndarray:
        """Map stationary Poisson arrival times onto the modulated
        process: a_i = P⁻¹(s_i).  Monotone, so order is preserved;
        identity (same object) for a null model."""
        raise NotImplementedError

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items() if v is not None}
        return f"{type(self).__name__}({keys})"


@register_traffic
class StationaryTraffic(TrafficModel):
    """The null model: plain Poisson(λ), multiplier ≡ 1."""

    name = "stationary"

    @property
    def is_null(self) -> bool:
        return True

    def rate(self, t, seed: int = 0):
        return np.ones_like(np.asarray(t, np.float64))

    def cumulative(self, t, seed: int = 0):
        return np.asarray(t, np.float64)

    def warp(self, arrivals, seed: int = 0):
        return arrivals


@register_traffic
class SinusoidTraffic(TrafficModel):
    """Diurnal modulation m(t) = 1 + A·sin(2πt/period + φ), |A| ≤ 1.

    P(t) = t − A·(period/2π)·(cos(2πt/period + φ) − cos φ) is strictly
    increasing (for |A| < 1); the warp inverts it by bisection on the
    bracket |P(t) − t| ≤ A·period/π, vectorized over all arrivals."""

    name = "sinusoid"

    def __init__(self, amplitude: float = 0.5, period: float = 200.0,
                 phase: float = 0.0):
        assert 0.0 <= amplitude <= 1.0, "need |amplitude| <= 1 (rate >= 0)"
        assert period > 0.0
        self.amplitude = float(amplitude)
        self.period = float(period)
        self.phase = float(phase)

    @property
    def is_null(self) -> bool:
        return self.amplitude == 0.0

    def rate(self, t, seed: int = 0):
        t = np.asarray(t, np.float64)
        w = 2.0 * np.pi / self.period
        return 1.0 + self.amplitude * np.sin(w * t + self.phase)

    def cumulative(self, t, seed: int = 0):
        t = np.asarray(t, np.float64)
        w = 2.0 * np.pi / self.period
        return t - (self.amplitude / w) * (np.cos(w * t + self.phase)
                                           - np.cos(self.phase))

    def warp(self, arrivals, seed: int = 0):
        if self.is_null:
            return arrivals
        u = np.asarray(arrivals, np.float64)
        slack = self.amplitude * self.period / np.pi + 1.0
        lo = u - slack
        hi = u + slack
        for _ in range(64):          # bracket/2^64 << float64 resolution
            mid = 0.5 * (lo + hi)
            below = self.cumulative(mid) < u
            lo = np.where(below, mid, lo)
            hi = np.where(below, hi, mid)
        return 0.5 * (lo + hi)


@register_traffic
class MMPPTraffic(TrafficModel):
    """Markov-modulated Poisson process.

    State k holds for ~Exp(mean_dwell[k]) (drawn on the salted traffic
    stream), during which the multiplier is rates[k]; the embedded chain
    alternates for two states and moves to a uniformly-drawn OTHER state
    for more — symmetric, so its stationary time-weights are
    ∝ mean_dwell and the normalizing constant is the dwell-weighted mean
    rate ⟨m⟩ = Σ dwell·rates / Σ dwell.  Episodes are generated lazily
    until they cover the requested time/mass horizon; a prefix is always
    reproduced bit-exactly, so one (seed) names one environment shared
    by every replica of a fleet."""

    name = "mmpp"

    def __init__(self, rates: Sequence[float] = (0.5, 2.0),
                 mean_dwell: Sequence[float] = (100.0, 100.0)):
        rates = tuple(float(r) for r in rates)
        mean_dwell = tuple(float(d) for d in mean_dwell)
        assert len(rates) == len(mean_dwell) >= 1
        assert all(r > 0.0 for r in rates), "state rates must be positive"
        assert all(d > 0.0 for d in mean_dwell)
        self.rates = rates
        self.mean_dwell = mean_dwell

    @property
    def is_null(self) -> bool:
        return max(self.rates) == min(self.rates)

    def _mean_rate(self) -> float:
        d = np.asarray(self.mean_dwell)
        return float(np.dot(d, self.rates) / d.sum())

    def _profile(self, seed: int, t_max: float, mass_max: float):
        """(starts, multipliers) covering both horizons.  One rng, one
        draw order: dwell then (K>2) next-state, per episode."""
        rng = _traffic_rng(seed)
        norm = self._mean_rate()
        K = len(self.rates)
        starts, mults = [0.0], []
        state, t, mass = 0, 0.0, 0.0
        while t <= t_max or mass <= mass_max:
            dwell = rng.exponential(self.mean_dwell[state])
            m = self.rates[state] / norm
            mults.append(m)
            t += dwell
            mass += m * dwell
            starts.append(t)
            if K == 1:
                state = 0
            elif K == 2:
                state = 1 - state
            else:
                step = int(rng.integers(1, K))
                state = (state + step) % K
        return np.asarray(starts[:-1]), np.asarray(mults)

    def rate(self, t, seed: int = 0):
        t = np.asarray(t, np.float64)
        tm = float(t.max()) if t.size else 0.0
        starts, mults = self._profile(seed, tm, 0.0)
        k = np.clip(np.searchsorted(starts, t, side="right") - 1,
                    0, len(starts) - 1)
        return mults[k]

    def cumulative(self, t, seed: int = 0):
        t = np.asarray(t, np.float64)
        tm = float(t.max()) if t.size else 0.0
        starts, mults = self._profile(seed, tm, 0.0)
        return _piecewise_cumulative(t, starts, mults)

    def warp(self, arrivals, seed: int = 0):
        if self.is_null:
            return arrivals
        u = np.asarray(arrivals, np.float64)
        um = float(u.max()) if u.size else 0.0
        starts, mults = self._profile(seed, 0.0, um)
        return _piecewise_inverse(u, starts, mults)


@register_traffic
class TraceTraffic(TrafficModel):
    """Trace replay: piecewise-constant multipliers over explicit
    breakpoints, repeated cyclically.  ``times`` are segment starts in
    [0, period) with ``times[0] == 0``; segment k runs [times[k],
    times[k+1]) at rates[k], the last to ``period``.  Multipliers are
    normalized by their time-average over one period, so replaying a
    measured rate trace preserves the configured long-run λ."""

    name = "trace"

    def __init__(self,
                 times: Sequence[float] = (0.0, 100.0, 200.0, 300.0),
                 rates: Sequence[float] = (0.5, 1.5, 1.0, 2.0),
                 period: Optional[float] = None):
        times = tuple(float(t) for t in times)
        rates = tuple(float(r) for r in rates)
        assert len(times) == len(rates) >= 1
        assert times[0] == 0.0, "trace breakpoints start at 0"
        assert all(b > a for a, b in zip(times, times[1:]))
        assert all(r > 0.0 for r in rates), "trace rates must be positive"
        if period is None:
            # last segment gets the mean breakpoint gap
            gap = (times[-1] - times[0]) / max(len(times) - 1, 1) or 1.0
            period = times[-1] + gap
        assert period > times[-1]
        self.times = times
        self.rates = rates
        self.period = float(period)

    @property
    def is_null(self) -> bool:
        return max(self.rates) == min(self.rates)

    def _norm(self):
        starts = np.asarray(self.times)
        widths = np.diff(np.concatenate((starts, [self.period])))
        mean = float(np.dot(widths, self.rates)) / self.period
        return starts, np.asarray(self.rates) / mean

    def rate(self, t, seed: int = 0):
        starts, mults = self._norm()
        frac = np.mod(np.asarray(t, np.float64), self.period)
        k = np.clip(np.searchsorted(starts, frac, side="right") - 1,
                    0, len(starts) - 1)
        return mults[k]

    def cumulative(self, t, seed: int = 0):
        starts, mults = self._norm()
        t = np.asarray(t, np.float64)
        cycles = np.floor(t / self.period)
        frac = t - cycles * self.period
        # normalized -> exactly `period` mass per cycle
        return cycles * self.period + _piecewise_cumulative(
            frac, np.concatenate((starts, [self.period])),
            np.concatenate((mults, [mults[0]])))

    def warp(self, arrivals, seed: int = 0):
        if self.is_null:
            return arrivals
        starts, mults = self._norm()
        u = np.asarray(arrivals, np.float64)
        cycles = np.floor(u / self.period)
        rem = u - cycles * self.period
        x = _piecewise_inverse(
            rem, np.concatenate((starts, [self.period])),
            np.concatenate((mults, [mults[0]])))
        return cycles * self.period + np.minimum(x, self.period)


# ----------------------------------------------------------------------------
# Workload integration
# ----------------------------------------------------------------------------

def warp_workload(wl: Workload, traffic, seed: int) -> Workload:
    """Push a sampled workload's arrivals through the traffic warp.
    Tokens and predictions are untouched (they ride separate salted
    streams); ``inter`` is recomputed from the warped arrivals.  A null
    model (or ``traffic=None``) returns ``wl`` unchanged — the SAME
    object, so stationary trajectories stay bit-equal."""
    tm = traffic_from_spec(traffic)
    if tm.is_null:
        return wl
    arr = tm.warp(wl.arrivals, seed)
    return dataclasses.replace(wl, arrivals=arr,
                               inter=np.diff(arr, prepend=0.0))


__all__ = [
    "MMPPTraffic", "SinusoidTraffic", "StationaryTraffic", "TRAFFIC",
    "TraceTraffic", "TrafficModel", "default_traffic", "get_traffic",
    "null_traffic", "register_traffic", "traffic_from_spec",
    "warp_workload",
]
