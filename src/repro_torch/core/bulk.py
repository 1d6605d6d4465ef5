"""Bulk-service queueing models for batched LLM inference (paper §IV): a
copy of the part of ``repro.core.bulk`` the control plane reaches.

* Inoue's dynamic-batching M/G/1 bound (Eqs 14-16): service all waiting
  requests in one batch; batch time linear in batch size H[b] = alpha*b+beta;
  mean wait bounded by phi(lam, alpha, beta).
* LLM dynamic batching (Eqs 17-23): batch time additionally depends on the
  max output token length l in the batch, H[b,l] = k1 b + k2 + (k3 b + k4) l;
  linearized via order-statistic envelopes to reuse Eq (16).
* Fixed batching M/D^b/1 (Eqs 24-25): deterministic bulk service of exactly
  b requests; mean wait via the roots of z^b = exp(lam*H*(z-1)); the paper's
  truncated Lagrange series for the roots is provided alongside an exact
  fixed-point solve.
* Elastic batching (Eq 26): early-exit replies shrink the effective batch;
  completion time k1 b + k2 + k3*sum(n_i) + k4*max(n_i), again linearized.
* Multi-bin batching (Guldogan et al. 2024): the delay envelope and the
  load-dependent bin boundaries.
* WAIT threshold admission (Dai et al. 2025) and SRPT-like
  shortest-first batching: holding + clearing and size-interval
  envelopes.
* Server breakdowns (``breakdown_wait``): M/G/1 with interruptions, the
  analytic transfer for the crash fault model.

The tandem and session forms wait for the layers they model (ROADMAP.md
M7d, M7c).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import stats as st

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel
from repro_torch.core.mg1 import pollaczek_khinchine


# ----------------------------------------------------------------------------
# Inoue bound (Eq 16)
# ----------------------------------------------------------------------------

def inoue_bound(lam: float, alpha: float, beta: float) -> float:
    """min(phi_0, phi_1) upper bound on E[W] for dynamic batching with
    H[b] = alpha*b + beta (Inoue 2021, paper Eq 16). Stability: lam*alpha < 1."""
    if lam * alpha >= 1.0:
        return np.inf
    den = 2.0 * (1.0 - lam ** 2 * alpha ** 2)
    phi0 = lam * (alpha + beta) ** 2 / den
    phi1 = (lam * alpha * beta + lam * alpha ** 2 + beta) / den
    return float(min(phi0, phi1))


def dynamic_batching_bound(dist: TokenDistribution, lat: BatchLatencyModel,
                           lam: float, mode: str = "envelope",
                           quantile: float = 1.0,
                           b_range=None) -> dict:
    """Paper Eqs (19)-(20) generalized: linearize H^[b] then apply Eq (16)."""
    alpha, beta = lat.linear_envelope(dist, mode=mode, quantile=quantile,
                                      b_range=b_range)
    return {
        "alpha": alpha,
        "beta": beta,
        "wait_bound": inoue_bound(lam, alpha, beta),
        "stable": lam * alpha < 1.0,
    }


def elastic_batching_bound(dist: TokenDistribution, lat: BatchLatencyModel,
                           lam: float, quantile: float = 1.0) -> dict:
    """Paper Eq (26) + Eq (16): H_el[b] <= (k1 + k3*E[N])*b + k2 + k4*L_inf."""
    en = dist.mean()
    linf = dist.max_order_stat_limit(quantile)
    alpha = lat.k1 + lat.k3 * en
    beta = lat.k2 + lat.k4 * linf
    return {
        "alpha": alpha,
        "beta": beta,
        "wait_bound": inoue_bound(lam, alpha, beta),
        "stable": lam * alpha < 1.0,
    }


# ----------------------------------------------------------------------------
# Fixed batching: M/D^b/1 (Eq 25)
# ----------------------------------------------------------------------------

def _mdb1_roots_newton(lam_h: float, b: int, iters: int = 5000):
    """The b-1 roots (inside the unit disk, z != 1) of z^b = e^{lam_h (z-1)}.

    Fixed-point iteration on the branch form z = w_k * exp(lam_h (z-1)/b),
    w_k the k-th root of unity: a contraction for lam_h < b (|d/dz| =
    (lam_h/b)|z| < 1 on the closed unit disk), so it cannot escape to the
    spurious root z=1 the way Newton can."""
    ks = np.arange(1, b)
    w = np.exp(2j * np.pi * ks / b)
    z = w.copy()
    for _ in range(iters):
        z_new = w * np.exp(lam_h * (z - 1.0) / b)
        if np.max(np.abs(z_new - z)) < 1e-15:
            z = z_new
            break
        z = z_new
    return z


def _mdb1_roots_series(lam_h: float, b: int, terms: int = 20):
    """Paper Eq (25): truncated Lagrange series
    Z_k = sum_m exp(-lam_h m / b) (lam_h m / b)^{m-1} / m! * w_k^m."""
    ks = np.arange(1, b)
    w = np.exp(2j * np.pi * ks / b)
    ms = np.arange(1, terms + 1)
    x = lam_h / b
    log_c = (-x * ms + (ms - 1) * np.log(np.maximum(x * ms, 1e-300))
             - np.array([np.sum(np.log(np.arange(1, m + 1))) for m in ms]))
    c = np.exp(log_c)
    return (c[None, :] * (w[:, None] ** ms[None, :])).sum(axis=1)


def mdb1_wait_paper(lam: float, h_b: float, b: int,
                    method: str = "newton") -> float:
    """Paper Eq (25) EXACTLY as printed:

        E[W] = (1/lam) [ (b - (b - lam H)^2) / (2 (b - lam H))
                         + sum_{k=1}^{b-1} 1/(1 - Z_k) ]

    As the reference records: at b=1 this equals the M/D/1 *sojourn*
    (wait + service), and the simulator shows the same +H(b) offset for
    general b — i.e. Eq (25) measures delay-until-departure. Use
    ``mdb1_wait_exact`` for the queue-wait; both are exposed so the
    reproduction is faithful AND correct.
    """
    lam_h = lam * h_b
    if lam_h >= b:
        return np.inf
    d = b - lam_h
    first = (b - d ** 2) / (2.0 * d)
    s = 0.0
    if b > 1:
        z = (_mdb1_roots_newton(lam_h, b) if method == "newton"
             else _mdb1_roots_series(lam_h, b))
        s = float(np.sum(1.0 / (1.0 - z)).real)
    return float((first + s) / lam)


def mdb1_queue_stationary(lam: float, h_b: float, b: int,
                          n_trunc: int = None) -> np.ndarray:
    """Stationary distribution of the number waiting at batch completions
    for the wait-until-b M/D^b/1 queue (embedded chain; exact up to
    truncation). L' = L - b + A if L >= b else A, with A ~ Poisson(lam*H)."""
    lam_h = lam * h_b
    if lam_h >= b:
        raise ValueError("unstable")
    if n_trunc is None:
        n_trunc = int(max(20 * b, 40 * lam_h, 200))
    a_pmf = st.poisson(lam_h).pmf(np.arange(n_trunc + 1))
    P = np.zeros((n_trunc + 1, n_trunc + 1))
    for l in range(n_trunc + 1):
        base = max(l - b, 0) if l >= b else 0
        room = n_trunc - base
        P[l, base:] = a_pmf[: room + 1]
        P[l, n_trunc] += max(0.0, 1.0 - a_pmf[: room + 1].sum())
    # power iteration
    pi = np.ones(n_trunc + 1) / (n_trunc + 1)
    for _ in range(20000):
        new = pi @ P
        if np.abs(new - pi).sum() < 1e-13:
            pi = new
            break
        pi = new
    return pi / pi.sum()


def mdb1_wait_exact(lam: float, h_b: float, b: int) -> float:
    """Exact mean queue-wait for the wait-until-b M/D^b/1 the paper
    *describes* in §IV-C (beyond-paper: the printed Eq 25 does not track the
    simulated model away from the optimum).

    Renewal-reward over completion epochs with stationary leftover
    distribution pi_l (``mdb1_queue_stationary``):

      cycle(l)   = H                      if l >= b
                   (b-l)/lam + H          if l <  b   (wait for b-l arrivals)
      intQ(l)    = sum_{i=l}^{b-1} i/lam  (idle accumulation)   [l < b only]
                   + s0(l)*H + lam*H^2/2  (during service),  s0 = max(l-b, 0)

      E[W] = E[Q]/lam = (sum_l pi_l intQ(l)) / (lam * sum_l pi_l cycle(l)).
    """
    lam_h = lam * h_b
    if lam_h >= b:
        return np.inf
    pi = mdb1_queue_stationary(lam, h_b, b)
    ls = np.arange(len(pi))
    below = ls < b
    cycle = np.where(below, (b - ls) / lam + h_b, h_b)
    # idle-phase integral: sum_{i=l}^{b-1} i / lam = (b(b-1)/2 - l(l-1)/2)/lam
    idle_q = np.where(below, (b * (b - 1) / 2.0 - ls * (ls - 1) / 2.0) / lam, 0.0)
    s0 = np.maximum(ls - b, 0)
    svc_q = s0 * h_b + lam * h_b ** 2 / 2.0
    eq = float((pi * (idle_q + svc_q)).sum())
    et = float((pi * cycle).sum())
    return eq / (lam * et)


def optimal_fixed_batch(dist: TokenDistribution, lat: BatchLatencyModel,
                        lam: float, b_max: int = 64,
                        method: str = "paper") -> dict:
    """Paper §IV-C: b* = argmin_b E[W] for M/D^b/1 with
    H^[b] = k1 b + k2 + (k3 b + k4) E[L_b]  (paper uses Eq 25)."""
    waits = {}
    for b in range(1, b_max + 1):
        h = float(lat.mean_batch_time(dist, b))
        if lam * h >= b:
            waits[b] = np.inf
            continue
        waits[b] = (mdb1_wait_paper(lam, h, b) if method == "paper"
                    else mdb1_wait_exact(lam, h, b))
    finite = {b: w for b, w in waits.items() if np.isfinite(w)}
    if not finite:
        return {"b_star": None, "wait": np.inf, "waits": waits}
    b_star = min(finite, key=finite.get)
    return {"b_star": b_star, "wait": finite[b_star], "waits": waits}


def service_rate_curve(dist: TokenDistribution, lat: BatchLatencyModel,
                       bs) -> np.ndarray:
    """mu^[b] = b / H^[b] (paper Eq 24 / Fig 3b)."""
    return lat.service_rate(dist, np.asarray(bs))


# ----------------------------------------------------------------------------
# WAIT threshold admission (Dai et al. 2025): holding + clearing envelope
# ----------------------------------------------------------------------------

def _mean_capped_gamma(m: int, lam: float, cap: Optional[float]) -> float:
    """E[min(X, cap)] for X ~ Gamma(m, scale=1/lam) (the time until the
    m-th subsequent Poisson arrival); m=0 -> 0.  Uses the identity
    x·f_m(x) = (m/λ)·f_{m+1}(x):  E[X·1{X<=c}] = (m/λ)·F_{m+1}(c)."""
    if m == 0:
        return 0.0
    if cap is None:
        return m / lam
    below = float(st.gamma(a=m, scale=1.0 / lam).cdf(cap))
    mass = float(st.gamma(a=m + 1, scale=1.0 / lam).cdf(cap))
    return (m / lam) * mass + cap * (1.0 - below)


def wait_bound(dist: TokenDistribution, lat: BatchLatencyModel, lam: float,
               k: int, timeout: Optional[float] = None) -> dict:
    """Mean-delay envelope for WAIT threshold admission (hold batch
    formation until ``k`` requests are buffered or the head has waited
    ``timeout``; then serve everything arrived, no batch cap) — the
    M/D^k/1-like holding view with a timer cap:

    * **Holding arm.**  Couple each request to the group of ``k``
      consecutive arrivals it triggers with: the request in position j
      (from the group head) is held at most until the group's trigger —
      ``min(sum of its k-1-j subsequent interarrivals, timeout)`` — even
      when the server is busy (a busy server only replaces holding with
      queueing, which the second arm pays for).  Under Poisson arrivals
      the positional hold is E[min(Gamma(k-1-j, 1/λ), timeout)], averaged
      over j; without a timer it telescopes to (k-1)/(2λ), the mean
      residual of the deterministic-count trigger.

    * **Clearing arm.**  Once triggered, WAIT serves ALL arrived requests
      — the serve-all-waiting discipline whose backlog is dominated by
      Inoue's Eq-16 bound on the same (α, β) linear envelope dynamic
      batching uses (holding only *coalesces* work into larger, more
      amortized batches; it never adds work).

    The sum of the arms is an envelope (coupling) argument like
    ``multibin_bound``'s, not a closed form — Dai et al. prove throughput
    optimality, not a delay formula — and the reference's
    ``tests/test_policies.py`` validates it for dominance and
    non-vacuousness against the simulator (``WaitPolicy.analytic_kind ==
    'bound'``).  Stability is the dynamic-batching condition λ·α < 1
    (holding does not change the drift)."""
    assert k >= 1
    holds = [_mean_capped_gamma(k - 1 - j, lam, timeout) for j in range(k)]
    hold = float(np.mean(holds))
    clearing = dynamic_batching_bound(dist, lat, lam)
    return {
        "wait_bound": hold + clearing["wait_bound"],
        "hold_arm": hold,
        "clearing_arm": clearing["wait_bound"],
        "alpha": clearing["alpha"],
        "beta": clearing["beta"],
        "stable": clearing["stable"],
    }


# ----------------------------------------------------------------------------
# Multi-bin batching (Guldogan et al. 2024): per-bin envelopes, delay bound,
# load-dependent boundary optimization
# ----------------------------------------------------------------------------

def multibin_split(dist: TokenDistribution, edges):
    """Split ``dist`` at ``edges`` into per-bin pieces.

    Returns a list of ``(p_j, dist_j, pad_j)``: the bin probability, the
    conditional token distribution (None when the bin is empty) and the
    bin's padding level — its upper boundary (the last bin pads to the
    distribution's max support).  Bin membership matches
    ``MultiBinPolicy.bin_of``: bin j holds tokens n with
    ``edges[j-1] < n <= edges[j]`` (searchsorted side='left')."""
    edges = np.asarray(edges, np.float64)
    bin_of = np.searchsorted(edges, dist.support, side="left")
    out = []
    for j in range(len(edges) + 1):
        mask = bin_of == j
        p = float(dist.pmf[mask].sum())
        pad = float(edges[j]) if j < len(edges) else float(dist.max_tokens)
        if p <= 0.0:
            out.append((0.0, None, pad))
        else:
            out.append((p, TokenDistribution(np.where(mask, dist.pmf, 0.0)),
                        pad))
    return out


def multibin_bound(dist: TokenDistribution, lat: BatchLatencyModel,
                   lam: float, edges, quantile: float = 1.0) -> dict:
    """Inoue-style mean-delay upper bound for multi-bin batching
    (serve-all-waiting within the picked bin, no batch cap), as the
    minimum of two envelope arms:

    * **Arm A — singleton padding** (tight at low load).  Pad every
      request to its bin's upper boundary and serve it ALONE, FCFS:
      ``S_pad = (k1 + k2) + (k3 + k4) * pad(N)``.  A bin-j batch of m
      requests costs ``k1 m + k2 + (k3 m + k4) L <= m * S_pad`` (L <=
      pad_j), so multi-bin only coalesces this work; the work-conserving
      M/G/1 on S_pad dominates and Pollaczek-Khinchine (paper Eq 1) gives
      its delay.

    * **Arm B — clearing rounds** (tight at high load).  Whenever the
      server frees, every bin that is non-empty gets cleared within one
      round of at most B batches (the earliest-head rule never revisits a
      bin before the others' older heads are served), and the round is
      dominated by one bulk service with ``H~[m] = alpha~ m + beta~``,
      ``alpha~ = max_j (k1 + k3 pad_j)``, ``beta~ = sum_j (k2 + k4
      pad_j)`` — the aggregate-utilization coupling: all bins share the
      alpha~ per-request rate, and one round pays every bin's per-batch
      overhead once.  Inoue's Eq-16 bound applies to that envelope
      system.

    Both arms are envelope (coupling) arguments, not closed-form exact
    results; the reference's ``tests/test_policies.py`` validates
    dominance against the simulator across loads.  Returns the arms alongside the combined
    ``wait_bound``.

    ``quantile`` (like ``dynamic_batching_bound``'s) caps the *round
    arm's* per-bin padding levels at the distribution's ``quantile``-point
    instead of its max support.  The open last bin is what breaks the arm
    on heavy tails: lognormal(7, 0.7) has max support ~32768, so
    ``alpha~ = max_j (k1 + k3 pad_j)`` makes ``lam * alpha~ >= 1`` and the
    arm returns inf at loads where the simulator is perfectly stable.
    With ``quantile < 1`` the envelope ignores the top ``(1-q)`` tail of
    the padding support — no longer a strict bound (pair it with
    ``analytic_kind='approx'``), but finite and useful across the heavy-
    tail operating range.  The singleton arm keeps the exact pads: it
    integrates over the pmf, so the tail's mass — not its support —
    enters, and it stays finite regardless."""
    parts = multibin_split(dist, edges)
    k1, k2, k3, k4 = lat.k1, lat.k2, lat.k3, lat.k4
    # Arm A: P-K on the bin-padded singleton service
    pads = np.asarray([pad for _, _, pad in parts])
    edges = np.asarray(edges, np.float64)
    pad_of = pads[np.searchsorted(edges, dist.support, side="left")]
    s = (k1 + k2) + (k3 + k4) * pad_of
    es = float((dist.pmf * s).sum())
    es2 = float((dist.pmf * s ** 2).sum())
    wait_a = pollaczek_khinchine(lam, es, es2)
    # Arm B: one clearing round as a single bulk service (pads optionally
    # capped at the quantile envelope; quantile=1.0 keeps the strict arm)
    pad_cap = dist.max_order_stat_limit(quantile)
    occupied = [(p, min(pad, pad_cap)) for p, _, pad in parts if p > 0]
    alpha = max(k1 + k3 * pad for _, pad in occupied)
    beta = sum(k2 + k4 * pad for _, pad in occupied)
    wait_b = inoue_bound(lam, alpha, beta)
    return {
        "wait_bound": float(min(wait_a, wait_b)),
        "wait_singleton_arm": float(wait_a),
        "wait_round_arm": float(wait_b),
        "alpha": float(alpha),
        "beta": float(beta),
        "quantile": float(quantile),
        "stable": lam * alpha < 1.0,
    }


def multibin_saturated_service(dist: TokenDistribution,
                               lat: BatchLatencyModel, edges, b) -> float:
    """Mean per-request service time at saturation with per-bin batches of
    size ``b``:  sbar = k1 + k2/b + (k3 + k4/b) * sum_j p_j E[max of b
    draws | bin j].  Its reciprocal is the system's service capacity, so
    minimizing sbar over the boundaries maximizes throughput — the
    Guldogan et al. objective.  Binning exists exactly to shrink the
    E[max] term: members of one bin have similar lengths, so the batch max
    hugs the bin mean instead of the global tail."""
    el = sum(p * d.max_order_stat_mean(b)
             for p, d, _ in multibin_split(dist, edges) if p > 0)
    return float(lat.k1 + lat.k2 / b + (lat.k3 + lat.k4 / b) * el)


def optimize_bin_edges(dist: TokenDistribution, lat: BatchLatencyModel,
                       lam: float, num_bins: int = 4, b_cap: int = 64,
                       sweeps: int = 2, grid: int = 65) -> np.ndarray:
    """Load-dependent bin boundaries (Guldogan et al. 2024), replacing the
    equal-probability-mass quantiles ``MultiBinPolicy`` defaults to.

    The load enters through the **effective batch size** ``b(lam)``: the
    smallest per-bin batch size whose saturated per-request service time
    keeps the system stable (``lam * sbar_b < 1``, evaluated at the
    quantile boundaries; capped at ``b_cap``).  Light load => b(lam)=1 and
    every boundary choice is equivalent (sbar_1 telescopes to the global
    mean — the quantile start is returned unchanged); heavy load => large
    b(lam), the per-bin batch maxima dominate, and boundaries matter.

    Given b(lam), coordinate descent over a support-quantile candidate
    grid minimizes ``sbar(edges; b)``; starting from the equal-mass
    quantiles and only accepting improvements, so the result never loses
    to the quantile default on the objective.  Returns ascending float
    edges of length ``num_bins - 1``."""
    assert num_bins >= 2
    qs = np.arange(1, num_bins) / num_bins
    edges = np.asarray([float(np.searchsorted(dist.cdf, q)) for q in qs])
    b = 1
    while b < b_cap and lam * multibin_saturated_service(
            dist, lat, edges, b) >= 1.0:
        b += 1
    cand = np.unique(np.asarray(
        [float(np.searchsorted(dist.cdf, q))
         for q in np.linspace(0.005, 0.995, grid)]))
    best = multibin_saturated_service(dist, lat, edges, b)
    for _ in range(sweeps):
        improved = False
        for i in range(len(edges)):
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i + 1] if i + 1 < len(edges) else float(dist.max_tokens)
            for c in cand[(cand > lo) & (cand < hi)]:
                trial = edges.copy()
                trial[i] = c
                val = multibin_saturated_service(dist, lat, trial, b)
                if val < best - 1e-12:
                    best, edges, improved = val, trial, True
        if not improved:
            break
    return edges


# ----------------------------------------------------------------------------
# SRPT-like shortest-predicted-first batching: size-interval envelope
# ----------------------------------------------------------------------------

def srpt_bound(dist: TokenDistribution, lat: BatchLatencyModel, lam: float,
               b_max: Optional[int], num_classes: int = 8) -> dict:
    """Mean-delay envelope for capped shortest-predicted-first batching
    (:class:`~repro_torch.core.policies.SRPTPolicy` under oracle
    ordering), via the size-interval decomposition classic SRPT analysis uses
    (Harchol-Balter), adapted to batched non-preemptive service:

    * **Class arm.**  Split the token support into ``num_classes``
      equal-mass classes with upper edges ``e_1 < ... < e_J``.  While a
      class-j request waits, shortest-first formation only starts batches
      of shorter-or-equal requests, so its backlog is the system restricted
      to classes <= j: Poisson ``lam_j = lam * F(e_j)`` with every member
      padded to ``e_j``.  With the cap ``b``, clearing a backlogged room
      amortizes the per-batch overhead over at most ``b`` members, so the
      per-request envelope is ``alpha'_j = k1 + k3 e_j + (k2 + k4 e_j)/b``
      with per-batch overhead ``beta_j = k2 + k4 e_j``, and Inoue's Eq-16
      bound applies to that (alpha'_j, beta_j) system.  The arm is the
      class-probability mixture of the per-class bounds.

    * **Residual arm.**  Formation never preempts a running batch, so an
      arrival can additionally find a batch of LONGER requests in service
      — at most one, ever (every batch formed after it arrives is
      shorter-or-equal or includes it).  The stationary residual of that
      batch is bounded by ``rho * H(b, e_J) / 2`` with ``rho = min(1,
      lam * alpha'_J)`` the amortized-utilization envelope.

    Like :func:`wait_bound` and :func:`multibin_bound` this is an envelope
    (coupling) argument, not a closed form — no exact mean-delay result is
    known for batched SRPT — and the reference's ``tests/test_policies.py``
    validates dominance and non-vacuousness against the simulator across loads.
    With ``b_max=None`` membership degenerates to dynamic batching (the
    policy serves every waiting request; order inside a padded batch is
    irrelevant) and the exact dynamic envelope is returned instead.
    Stability is the top class's ``lam * alpha'_J < 1``."""
    if b_max is None:
        d = dynamic_batching_bound(dist, lat, lam)
        return {
            "wait_bound": d["wait_bound"],
            "class_arm": d["wait_bound"],
            "residual_arm": 0.0,
            "edges": [float(dist.max_tokens)],
            "stable": d["stable"],
        }
    assert b_max >= 1
    J = num_classes
    k1, k2, k3, k4 = lat.k1, lat.k2, lat.k3, lat.k4
    edges = sorted({int(np.searchsorted(dist.cdf, j / J))
                    for j in range(1, J)} | {int(dist.max_tokens)})
    class_arm, prev_f = 0.0, 0.0
    for e in edges:
        f = float(dist.cdf[e])
        p, prev_f = f - prev_f, f
        if p <= 0.0:
            continue
        beta = k2 + k4 * e
        alpha_p = k1 + k3 * e + beta / b_max
        class_arm += p * inoue_bound(lam * f, alpha_p, beta)
    e_top = edges[-1]
    beta_top = k2 + k4 * e_top
    alpha_top = k1 + k3 * e_top + beta_top / b_max
    rho = min(1.0, lam * alpha_top)
    residual = rho * float(lat.batch_time(b_max, e_top)) / 2.0
    return {
        "wait_bound": float(class_arm + residual),
        "class_arm": float(class_arm),
        "residual_arm": float(residual),
        "edges": [float(e) for e in edges],
        "stable": lam * alpha_top < 1.0,
    }


# ----------------------------------------------------------------------------
# Server breakdowns (beyond paper; M/G/1 with interruptions)
# ----------------------------------------------------------------------------

def breakdown_wait(dist: TokenDistribution, lat, lam: float,
                   mtbf: float, mttr: float, R: int = 1,
                   policy=None) -> dict:
    """Mean queueing delay on a breaking server — the analytic transfer
    for the ``crash`` fault model (:mod:`repro_torch.core.faults`) under
    preemptive-resume semantics (``lose_work=False``) on a random-split
    fleet of R replicas (each replica = the single-server model at λ/R,
    the superposition argument).

    ``policy=None`` (FCFS): the classic M/G/1-with-breakdowns
    completion-time decomposition (Gaver 1962).  With exponential
    up-times (rate ξ = 1/mtbf) and exponential repairs (mean r = mttr),
    a job of service S has completion time C = S + sum of repairs begun
    during it:

        E[C]  = (1 + ξ r) E[S] = E[S] / a,      a = mtbf / (mtbf + mttr)
        E[C²] = (1 + ξ r)² E[S²] + 2 ξ r² E[S]

    and the wait is Pollaczek–Khinchine on the C-moments plus the
    residual repair an arrival finds in progress (PASTA, memoryless):

        E[W] = λ E[C²] / (2 (1 − λ E[C])) + (1 − a) r

    ``policy`` set (a bulk/batched BatchPolicy): the **envelope arm** —
    the availability-discounted effective-λ transfer
    (:func:`repro_torch.core.faults.effective_lambda`): the policy's own
    ``analytic_delay`` at λ/(R·a), time-dilated back by 1/a, plus the
    same residual-repair term."""
    assert mtbf > 0 and mttr > 0 and R >= 1
    a = mtbf / (mtbf + mttr)
    xi, r = 1.0 / mtbf, mttr
    lam_r = lam / R
    out = {"availability": a, "lam_eff": lam_r / a, "R": R}
    if policy is None:
        from repro_torch.core.policies import single_from_batch
        single = lat if not isinstance(lat, BatchLatencyModel) \
            else single_from_batch(lat)
        es, es2 = single.moments(dist, None)
        ec = (1.0 + xi * r) * es
        ec2 = (1.0 + xi * r) ** 2 * es2 + 2.0 * xi * r * r * es
        out.update(kind="exact", stable=lam_r * ec < 1.0,
                   wait=float(pollaczek_khinchine(lam_r, ec, ec2)
                              + (1.0 - a) * r))
        return out
    base = policy.analytic_delay(lam_r / a, dist, lat)
    out.update(kind="envelope",
               stable=base is not None and np.isfinite(base),
               wait=None if base is None
               else float(base / a + (1.0 - a) * r))
    return out
