"""The port's copy of the control plane's analytics against
``repro.core`` on the same inputs.

The copies run the same float64 numpy arithmetic as the reference, so the
analytic results are held to 1e-12 relative and the controller's
recommendations must be EQUAL, field for field, on one recorded stream of
arrivals and completions."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import bulk as JB  # noqa: E402
from repro.core import control as JC  # noqa: E402
from repro.core import distributions as JD  # noqa: E402
from repro.core import latency_model as JLM  # noqa: E402
from repro.core import mg1 as JMG1  # noqa: E402
from repro.core import policy_opt as JPO  # noqa: E402
from repro_torch.core import bulk as TB  # noqa: E402
from repro_torch.core import control as TC  # noqa: E402
from repro_torch.core import distributions as TD  # noqa: E402
from repro_torch.core import latency_model as TLM  # noqa: E402
from repro_torch.core import mg1 as TMG1  # noqa: E402
from repro_torch.core import policy_opt as TPO  # noqa: E402

RTOL = 1e-12
# light and heavy lognormal output lengths (scv 0.09 and 1.72); the heavy
# one is cut at 1024 tokens to keep the solvers' grids small
DISTS = {"light": (3.0, 0.3, 256), "heavy": (5.0, 1.0, 1024)}
# the serving launcher's priors
SINGLE = dict(a=5e-3, c=0.05)
BATCH = dict(k1=5e-3, k2=5e-2, k3=1e-4, k4=5e-3)


def _pair(kind):
    mu, sigma, support = DISTS[kind]
    return (JD.LogNormalTokens(mu, sigma, support),
            TD.LogNormalTokens(mu, sigma, support))


def _close(a, b):
    """Equal structure, numbers within RTOL (inf/None/bools exactly)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=RTOL)
    elif isinstance(a, (float, np.floating)) and np.isfinite(a):
        assert b == pytest.approx(a, rel=RTOL, abs=0.0)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["light", "heavy"])
def test_distributions_and_mg1_match(kind):
    jd, td = _pair(kind)
    np.testing.assert_array_equal(td.pmf, jd.pmf)
    for n in (1, 17, 100, 10 ** 6):
        _close(jd.clipped_moments(n), td.clipped_moments(n))
        _close(jd.utility_after_clip(n), td.utility_after_clip(n))
        np.testing.assert_array_equal(td.clip(n).pmf, jd.clip(n).pmf)
    _close(jd.max_order_stat_mean([1, 4, 16]), td.max_order_stat_mean([1, 4, 16]))
    for lam in (0.5, 3.0):
        for n_max in (None, 40):
            _close(dataclasses.asdict(JMG1.mg1_wait(
                       jd, JLM.LatencyModel(**SINGLE), lam, n_max)),
                   dataclasses.asdict(TMG1.mg1_wait(
                       td, TLM.LatencyModel(**SINGLE), lam, n_max)))


@pytest.mark.parametrize("kind", ["light", "heavy"])
@pytest.mark.parametrize("lam", [0.5, 4.0])
def test_token_limit_v1_matches(kind, lam):
    jd, td = _pair(kind)
    j = JPO.optimize_token_limit_v1(jd, JLM.LatencyModel(**SINGLE), lam, 119 / 120)
    t = TPO.optimize_token_limit_v1(td, TLM.LatencyModel(**SINGLE), lam, 119 / 120)
    _close(dataclasses.asdict(j), dataclasses.asdict(t))


@pytest.mark.parametrize("kind", ["light", "heavy"])
@pytest.mark.parametrize("solver", ["dekok", "exact"])
def test_token_limit_v2_matches(kind, solver):
    jd, td = _pair(kind)
    grid = np.unique(np.linspace(1, jd.max_tokens, 6).astype(int))
    kw = dict(lam=2.0, theta=0.95, tau=1.5, loss_cost=4.0, grid=grid,
              solver=solver)
    j = JPO.optimize_token_limit_v2(jd, JLM.LatencyModel(**SINGLE), **kw)
    t = TPO.optimize_token_limit_v2(td, TLM.LatencyModel(**SINGLE), **kw)
    _close(dataclasses.asdict(j), dataclasses.asdict(t))


@pytest.mark.parametrize("kind", ["light", "heavy"])
@pytest.mark.parametrize("lam", [0.5, 4.0])
def test_bulk_bounds_match(kind, lam):
    jd, td = _pair(kind)
    jd, td = jd.clip(200), td.clip(200)
    jl, tl = JLM.BatchLatencyModel(**BATCH), TLM.BatchLatencyModel(**BATCH)
    for method in ("paper", "exact"):
        _close(JB.optimal_fixed_batch(jd, jl, lam, b_max=16, method=method),
               TB.optimal_fixed_batch(td, tl, lam, b_max=16, method=method))
    for mode in ("envelope", "lstsq"):
        _close(JB.dynamic_batching_bound(jd, jl, lam, mode=mode),
               TB.dynamic_batching_bound(td, tl, lam, mode=mode))
    _close(JB.mdb1_wait_paper(lam, 1.0, 8, method="series"),
           TB.mdb1_wait_paper(lam, 1.0, 8, method="series"))
    edges = JB.optimize_bin_edges(jd, jl, lam, num_bins=4)
    _close(edges, TB.optimize_bin_edges(td, tl, lam, num_bins=4))
    _close(JB.multibin_bound(jd, jl, lam, edges, quantile=0.99),
           TB.multibin_bound(td, tl, lam, edges, quantile=0.99))


def _recorded_stream(seed=0, n=96, lam=2.0):
    """Arrival times and completed lengths, interleaved as a serving loop
    reports them: (arrivals of one batch, then its completions)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, n))
    lengths = np.clip(np.rint(rng.lognormal(4.0, 1.0, n)), 1, 600).astype(int)
    sizes = rng.integers(1, 7, n)
    i, batches = 0, []
    while i < n:
        j = min(n, i + int(sizes[i]))
        batches.append((arrivals[i:j], lengths[i:j]))
        i = j
    return batches


@pytest.mark.parametrize("elastic", [True, False])
def test_controller_recommendations_equal_reference(elastic):
    """One recorded stream through both controllers: every recommendation,
    from warmup through heavy-tail b_max, multibin edges and hysteresis,
    is equal field for field."""
    kw = dict(theta=119 / 120, elastic_available=elastic, min_samples=8,
              window=64)
    jc = JC.AdaptiveController(JLM.LatencyModel(**SINGLE),
                               JLM.BatchLatencyModel(**BATCH), **kw)
    tc = TC.AdaptiveController(TLM.LatencyModel(**SINGLE),
                               TLM.BatchLatencyModel(**BATCH), **kw)
    seen = set()
    for arr, lens in _recorded_stream():
        jr, tr = jc.recommendation(), tc.recommendation()
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        seen.add((jr.policy, jr.b_max is not None))
        for a in arr:
            jc.observe_arrival(float(a))
            tc.observe_arrival(float(a))
        for n in lens:
            jc.observe_completion(int(n))
            tc.observe_completion(int(n))
    jr, tr = jc.recommendation(force=True), tc.recommendation(force=True)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    policy = "elastic" if elastic else "multibin"
    assert ("dynamic", False) in seen and (policy, True) in seen


def test_controller_parts_not_ported_raise():
    lat = (TLM.LatencyModel(**SINGLE), TLM.BatchLatencyModel(**BATCH))
    # the KV-memory axis is ported: a bad spec raises as the reference
    # does, a budget sizes the warmup recommendation as the reference's
    jlat = (JLM.LatencyModel(**SINGLE), JLM.BatchLatencyModel(**BATCH))
    for mod, law in ((JC, jlat), (TC, lat)):
        with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
            mod.AdaptiveController(*law, memory=object())
    jr = JC.AdaptiveController(*jlat, memory=4096.0).recommendation()
    tr = TC.AdaptiveController(*lat, memory=4096.0).recommendation()
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    with pytest.raises(ValueError, match="not in"):
        TC.AdaptiveController(*lat, length_predictor="psychic")
    # the fleet and predictor axes are ported (tests/test_torch_fleet.py)
    ctl = TC.AdaptiveController(*lat, max_replicas=2,
                                length_predictor="lognormal_noise")
    assert ctl.max_replicas == 2 and ctl.availability_hat() == 1.0
