"""The batch-event disciplines (multi-bin, WAIT, SRPT) of the port on the
CPU against the JAX package: the NumPy oracle, the fast path through the
plain versions of kernels S3-S5, the analytic envelopes, the schedulers
and the policies' workload and analytics.

Equal seeds must give equal trajectories: the port's oracle is held to
``repro.core.simulate`` and the port's fast path to the port's oracle
with ``np.array_equal``.  Against the reference's compiled loops
(``repro.core.fastsim``) the band is 1e-10 s (``SCAN_ATOL``) with the mean
batch equal: XLA on the CPU contracts their batch time into fused
multiply-adds, which moves a start by an ulp in some steps; the port
rounds each product and sum on its own, as the oracle does.  The envelopes
agree within 1e-12 relative (the same closed forms, evaluated by the same
NumPy and SciPy calls).

The reference's loops run under ``jax.experimental.enable_x64``, which
JAX 0.9 removed; the ``x64`` fixture puts back a shim that calls
``jax.enable_x64(True)``, only when the attribute is missing, with
``monkeypatch`` (the JAX package is not edited)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

from repro.core import bulk as j_bulk  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fastsim as j_fast  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import mg1 as j_mg1  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import predictors as j_pred  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402
from repro.data.pipeline import make_request_stream as j_stream  # noqa: E402
from repro.serving import metrics as j_metrics  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402

from repro_torch.core import bulk as t_bulk  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import mg1 as t_mg1  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import predictors as t_pred  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402
from repro_torch.data.pipeline import make_request_stream as t_stream  # noqa: E402
from repro_torch.kernels.multibin_scan import multibin_scan  # noqa: E402
from repro_torch.kernels.srpt_scan import srpt_scan  # noqa: E402
from repro_torch.kernels.wait_scan import wait_scan  # noqa: E402
from repro_torch.serving import metrics as t_metrics  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402

# the reference benchmark's heavy-tail law (Fig 6b constants)
LAT = dict(k1=0.05, k2=0.5, k3=2e-4, k4=0.002)
SCAN_ATOL = 1e-10
DISTS = {"uniform": ("UniformTokens", (1000,)),
         "lognormal": ("LogNormalTokens", (7.0, 0.7))}
LAMS = (0.05, 0.5, 3.0)          # idle, loaded, saturated
NS = (1, 2, 37, 3001)

# every case of the three disciplines: caps none, 1 and 16; timeouts none,
# 0 and finite; explicit and quantile edges; an n_max
CASES = [
    ("multibin", {}),
    ("multibin", {"b_max": 1}),
    ("multibin", {"num_bins": 3, "b_max": 16}),
    ("multibin", {"edges": (500.0, 1500.0)}),
    ("multibin", {"edges": (800.0,), "n_max": 1200, "b_max": 16}),
    ("wait", {}),
    ("wait", {"k": 4, "timeout": 0.0}),
    ("wait", {"k": 16, "timeout": 2.5, "b_max": 16}),
    ("wait", {"k": 3, "b_max": 1, "n_max": 1200}),
    ("srpt", {}),
    ("srpt", {"b_max": None}),
    ("srpt", {"b_max": 1}),
    ("srpt", {"b_max": 16, "n_max": 1200}),
]
CASE_IDS = [f"{name}-{'-'.join(f'{k}{v}' for k, v in kw.items()) or 'default'}"
            for name, kw in CASES]


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def dists(key):
    name, args = DISTS[key]
    return getattr(j_dist, name)(*args), getattr(t_dist, name)(*args)


def lats():
    return j_lat.BatchLatencyModel(**LAT), t_lat.BatchLatencyModel(**LAT)


def policies(name, **kw):
    return j_pol.REGISTRY[name](**kw), t_pol.REGISTRY[name](**kw)


def close(a, b, tol=1e-12):
    if a == b:                      # equal infinities too
        return
    assert abs(a - b) <= tol * max(1.0, abs(a), abs(b)), (a, b)


# ----------------------------------------------------------------------------
# The oracle and the fast path (plain versions of S3-S5)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dist", sorted(DISTS))
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_oracle_equals_reference(name, kw, dist):
    jd, td = dists(dist)
    jl, tl = lats()
    for lam in LAMS:
        for n in NS:
            jp, tp = policies(name, **kw)
            with j_sim.no_warmup(), t_sim.no_warmup():
                jr = j_sim.simulate_policy(jp, lam, jd, jl, num_requests=n,
                                           seed=4)
                tr = t_sim.simulate_policy(tp, lam, td, tl, num_requests=n,
                                           seed=4)
            assert tr.keys() == jr.keys()
            for k in tr:
                assert np.array_equal(tr[k], jr[k]), (k, lam, n)


@pytest.mark.parametrize("dist", sorted(DISTS))
@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_fast_path_equals_oracle_and_reference(x64, name, kw, dist):
    jd, td = dists(dist)
    jl, tl = lats()
    for lam in LAMS:
        for n in NS:
            jp, tp = policies(name, **kw)
            with j_sim.no_warmup(), t_sim.no_warmup():
                fast = t_fast.simulate_policy_fast(tp, lam, td, tl,
                                                   num_requests=n, seed=4,
                                                   device="cpu")
                ora = t_sim.simulate_policy(tp, lam, td, tl, num_requests=n,
                                            seed=4)
                ref = j_fast.simulate_policy_fast(jp, lam, jd, jl,
                                                  num_requests=n, seed=4)
            assert fast.keys() == ora.keys() == ref.keys()
            assert np.array_equal(fast["waits"], ora["waits"]), (lam, n)
            assert fast["mean_batch"] == ora["mean_batch"], (lam, n)
            np.testing.assert_allclose(fast["waits"], ref["waits"], rtol=0,
                                       atol=SCAN_ATOL)
            assert fast["mean_batch"] == ref["mean_batch"], (lam, n)


@pytest.mark.parametrize("name,kw", [("multibin", {}), ("wait", {"k": 4}),
                                     ("srpt", {})])
def test_zero_cap_is_no_cap(name, kw):
    """b_max=0 is no cap in the oracle (``if self.b_max:``) and so in the
    port's fast path.  The reference's compiled multi-bin and WAIT loops
    never end at b_max=0 and its SRPT loop serves every request alone, so
    the port is held to its own oracle here."""
    _, td = dists("lognormal")
    _, tl = lats()
    for lam in (0.5, 3.0):
        fast = t_fast.simulate_policy_fast(
            t_pol.get_policy(name, b_max=0, **kw), lam, td, tl,
            num_requests=2000, seed=1, device="cpu")
        none = t_sim.simulate_policy(t_pol.get_policy(name, b_max=None, **kw),
                                     lam, td, tl, num_requests=2000, seed=1)
        assert np.array_equal(fast["waits"], none["waits"]), lam
        assert fast["mean_batch"] == none["mean_batch"] > 1.0, lam


def test_plain_versions_take_lanes():
    """Lanes of one plain call equal one call per lane, and each lane is
    the oracle's run of its cell; ``first`` marks the oracle's batches."""
    _, td = dists("lognormal")
    _, tl = lats()
    k = tuple(LAT.values())
    n, lams = 2000, (0.2, 0.8, 2.0)
    wls = [t_pol.DynamicPolicy().sample_workload(lam, td, n, seed=i)
           for i, lam in enumerate(lams)]
    arr = torch.from_numpy(np.stack([w.arrivals for w in wls], axis=1))
    tok = torch.from_numpy(np.stack([w.tokens for w in wls], axis=1))
    caps = torch.tensor([0, 16, 1])
    pols = [t_pol.MultiBinPolicy(b_max=b or None) for b in (0, 16, 1)]
    bins = torch.from_numpy(np.stack([p.bin_of(w.tokens, td)
                                      for p, w in zip(pols, wls)], axis=1))
    runs = {
        "multibin": (pols, multibin_scan,
                     lambda c: (arr[:, c], tok[:, c], bins[:, c], 4,
                                caps[c])),
        "wait": ([t_pol.WaitPolicy(k=5, timeout=2.0, b_max=b or None)
                  for b in (0, 16, 1)], wait_scan,
                 lambda c: (arr[:, c], tok[:, c], torch.full_like(caps[c], 5),
                            torch.full(caps[c].shape, 2.0,
                                       dtype=torch.float64), caps[c])),
        "srpt": ([t_pol.SRPTPolicy(b_max=b or None) for b in (0, 16, 1)],
                 srpt_scan,
                 lambda c: (arr[:, c], tok[:, c],
                            torch.argsort(tok[:, c], dim=0, stable=True),
                            caps[c])),
    }
    for name, (pols_, fn, args) in runs.items():
        s_all, f_all = fn(*args(slice(None)), *k)
        assert s_all.shape == (n, 3) and f_all.dtype == torch.bool
        for c, pol in enumerate(pols_):
            s, f = fn(*args(slice(c, c + 1)), *k)
            assert torch.equal(s[:, 0], s_all[:, c])
            assert torch.equal(f[:, 0], f_all[:, c])
            with t_sim.no_warmup():
                ora = t_sim.simulate_policy(pol, None, td, tl,
                                            workload=wls[c])
            assert np.array_equal(s[:, 0].numpy() - wls[c].arrivals,
                                  ora["waits"]), (name, c)
            assert n / int(f.sum()) == ora["mean_batch"], (name, c)


def test_sweep_dispatches_event_policies_per_cell():
    """``sweep`` runs each (λ, policy) cell of the batch-event disciplines
    as its own launch, hands the launches back under ``cells``, and equals
    the oracle's sweep."""
    _, td = dists("lognormal")
    _, tl = lats()
    pols = {"dyn": t_pol.DynamicPolicy(b_max=16),
            "mb": t_pol.MultiBinPolicy(num_bins=4),
            "wait": t_pol.WaitPolicy(k=16), "srpt": t_pol.SRPTPolicy(b_max=16)}
    got = {}
    tf = t_fast.sweep(pols, [0.5, 1.0], td, tl, num_requests=3000, seed=15,
                      device="cpu", scan_out=got)
    to = t_sim.simulate_policy_sweep([0.5, 1.0], td, tl, pols,
                                     num_requests=3000, seed=15)
    for name in pols:
        assert np.array_equal(tf[name], to[name]), name
    assert sorted(got["cells"]) == [(p, li) for p in ("mb", "srpt", "wait")
                                    for li in (0, 1)]
    assert [name for name, *_ in got["lanes"]] == ["dyn", "dyn"]
    for (name, li), cell in got["cells"].items():
        assert cell["kernel"] == f"{pols[name].name}_scan"
        starts, first = cell["out"]
        wl = pols[name].sample_workload([0.5, 1.0][li], td, 3000, 15)
        assert torch.equal(cell["args"][0][:, 0],
                           torch.from_numpy(wl.arrivals))
        with t_sim.no_warmup():
            ora = t_sim.simulate_policy(pols[name], [0.5, 1.0][li], td, tl,
                                        num_requests=3000, seed=15)
        assert np.array_equal(starts[:, 0].numpy() - wl.arrivals,
                              ora["waits"])
        assert 3000 / int(first.sum()) == ora["mean_batch"]


# ----------------------------------------------------------------------------
# Analytics
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dist", sorted(DISTS))
def test_bounds_equal_reference(dist):
    jd, td = dists(dist)
    jl, tl = lats()
    for lam in (0.05, 0.3, 0.9, 3.0):
        for k, timeout in ((1, None), (8, None), (16, 2.5), (4, 0.0)):
            jb = j_bulk.wait_bound(jd, jl, lam, k, timeout)
            tb = t_bulk.wait_bound(td, tl, lam, k, timeout)
            assert jb.keys() == tb.keys()
            for key in jb:
                close(jb[key], tb[key])
        for b_max in (None, 1, 8, 16):
            jb = j_bulk.srpt_bound(jd, jl, lam, b_max)
            tb = t_bulk.srpt_bound(td, tl, lam, b_max)
            assert jb.keys() == tb.keys()
            for key in jb:
                if key == "edges":
                    assert jb[key] == tb[key]
                else:
                    close(jb[key], tb[key])
        for m, cap in ((0, None), (3, None), (5, 1.5), (12, 40.0)):
            close(j_bulk._mean_capped_gamma(m, lam, cap),
                  t_bulk._mean_capped_gamma(m, lam, cap))
    single = (j_lat.LatencyModel(0.021, 1.79), t_lat.LatencyModel(0.021, 1.79))
    grid = [200, 800, 1600, 3200]
    jw = j_mg1.wait_curve(jd, single[0], 1 / 40, grid)
    tw = t_mg1.wait_curve(td, single[1], 1 / 40, grid)
    assert jw.shape == tw.shape == (4,)
    for a, b in zip(jw, tw):
        close(a, b)


@pytest.mark.parametrize("name,kw", CASES, ids=CASE_IDS)
def test_policy_analytics_and_workload_equal_reference(name, kw):
    jd, td = dists("lognormal")
    jl, tl = lats()
    jp, tp = policies(name, **kw)
    assert repr(jp) == repr(tp)
    assert (jp.analytic_kind, jp.fast_kernel, jp.oracle_kind) == \
        (tp.analytic_kind, tp.fast_kernel, tp.oracle_kind)
    for lam in (0.2, 0.9):
        ja = jp.analytic_delay(lam, jd, jl)
        ta = tp.analytic_delay(lam, td, tl)
        assert (ja is None) == (ta is None)
        if ja is not None:
            close(ja, ta)
    jw = jp.sample_workload(0.4, jd, 500, 3)
    tw = tp.sample_workload(0.4, td, 500, 3)
    assert np.array_equal(jw.arrivals, tw.arrivals)
    assert np.array_equal(jw.tokens, tw.tokens)
    if name == "multibin":
        assert np.array_equal(jp.bin_edges(jd), tp.bin_edges(td))
        assert np.array_equal(jp.bin_of(jw.tokens, jd),
                              tp.bin_of(tw.tokens, td))
        # the scheduler layer's empirical quantiles of observed lengths
        assert np.array_equal(jp.bin_edges(None, jw.tokens),
                              tp.bin_edges(None, tw.tokens))


def test_optimized_multibin_equals_reference():
    jd, td = dists("lognormal")
    jl, tl = lats()
    jp = j_pol.MultiBinPolicy.optimized(1.0, jd, jl, num_bins=4)
    tp = t_pol.MultiBinPolicy.optimized(1.0, td, tl, num_bins=4)
    assert jp.edges == tp.edges and repr(jp) == repr(tp)
    assert tp.num_bins == 4 and tp.analytic_kind == "bound"


# ----------------------------------------------------------------------------
# Schedulers on a ModelClock, and the formations' rewind
# ----------------------------------------------------------------------------

def _streams(n=600, lam=0.6, seed=9):
    jd, td = dists("lognormal")
    return (j_stream(n, lam, jd, vocab=100, seed=seed),
            t_stream(n, lam, td, vocab=100, seed=seed))


def _clocks():
    jl, tl = lats()
    return (j_sched.ModelClock(j_lat.LatencyModel(0.021, 0.3), jl),
            t_sched.ModelClock(t_lat.LatencyModel(0.021, 0.3), tl))


def _same_result(jr, tr):
    for k in ("waits", "e2e", "lost"):
        assert np.array_equal(getattr(jr, k), getattr(tr, k)), k
    assert jr.batch_sizes == tr.batch_sizes
    assert jr.makespan == tr.makespan
    assert j_metrics.summarize(jr) == t_metrics.summarize(tr)


@pytest.mark.parametrize("cls,kw", [
    ("MultiBinBatchScheduler", {}),
    ("MultiBinBatchScheduler", {"edges": (300.0, 1200.0), "b_max": 8}),
    ("MultiBinBatchScheduler", {"num_bins": 2, "n_max": 1500}),
    ("WaitBatchScheduler", {}),
    ("WaitBatchScheduler", {"k": 4, "timeout": 1.0, "b_max": 6}),
    ("SRPTBatchScheduler", {}),
    ("SRPTBatchScheduler", {"b_max": 16, "n_max": 1500})])
def test_event_schedulers_equal_reference(cls, kw):
    for lam in (0.2, 0.6, 2.0):
        jreqs, treqs = _streams(lam=lam)
        jc, tc = _clocks()
        _same_result(getattr(j_sched, cls)(jc, **kw).run(jreqs),
                     getattr(t_sched, cls)(tc, **kw).run(treqs))
    if cls != "WaitBatchScheduler":
        # with a noisy predictor, membership follows the predictions
        spec = {"kind": "lognormal_noise", "sigma": 1.0}
        jreqs, treqs = _streams(lam=0.6)
        _same_result(getattr(j_sched, cls)(jc, predictor=spec, **kw).run(jreqs),
                     getattr(t_sched, cls)(tc, predictor=spec, **kw).run(treqs))


@pytest.mark.parametrize("name,kw", [("multibin", {"b_max": 4}),
                                     ("wait", {"k": 3, "b_max": 4}),
                                     ("srpt", {"b_max": 4})])
def test_formation_rewind_equals_reference(name, kw):
    """Deferring the tail of a formed batch (``rewind``) hands the same
    requests back at the next trigger in both packages."""
    jd, td = dists("lognormal")
    jp, tp = policies(name, **kw)
    wl = tp.sample_workload(1.5, td, 400, 6)
    jf = jp.formation(wl.arrivals, wl.tokens, jd)
    tf = tp.formation(wl.arrivals, wl.tokens, td)
    t_free, step = 0.0, 0
    while True:
        jb, tb = jf.next_batch(t_free), tf.next_batch(t_free)
        if jb is None or tb is None:
            assert jb is None and tb is None
            break
        assert jb[0] == tb[0] and np.array_equal(jb[1], tb[1])
        if len(tb[1]) > 1 and step % 3 == 0:
            jf.rewind(1)
            tf.rewind(1)
        t_free = tb[0] + 0.3 * len(tb[1])
        step += 1
    assert step > 50


# ----------------------------------------------------------------------------
# sweep_noise: WAIT cells as the lanes of one S4 launch
# ----------------------------------------------------------------------------

def _wait_noise_factory(pol_mod, pred_mod, kw):
    """WAIT at prediction noise sigma: ``kw`` for every sigma, or with
    ``"per_sigma"`` a k, timeout and cap of its own for each (the lanes of
    one launch need not share them)."""
    def make(s):
        own = kw if kw != "per_sigma" else {
            "k": 4 + int(8 * s), "timeout": None if s == 0 else 3.0 * s,
            "b_max": int(16 * s) or None}
        return pol_mod.get_policy(
            "wait", predictor=pred_mod.LogNormalNoisePredictor(s), **own)
    return make


@pytest.mark.parametrize("kw", [{"k": 16}, {"k": 4, "timeout": 2.5, "b_max": 8},
                                "per_sigma"], ids=["k16", "k4-t2.5-b8",
                                                   "per_sigma"])
def test_sweep_noise_wait_lanes_equal_cells_and_reference(x64, kw):
    """``sweep_noise`` with every cell WAIT runs the cells as the lanes of
    one ``wait_scan`` call (the plain version here: no launch counted);
    its means equal the per-cell ``simulate_policy_fast`` path bit for bit
    and the JAX package's ``sweep_noise`` (which runs WAIT a cell at a
    time) within the band."""
    lams, sigmas, n = [0.6, 1.0], [0.0, 0.5, 1.5], 2000
    jd, td = dists("lognormal")
    jl, tl = lats()
    factory = _wait_noise_factory(t_pol, t_pred, kw)
    got = {}
    before = K.LAUNCHES["wait_scan"]
    lanes = t_fast.sweep_noise(factory, lams, sigmas, td, tl, num_requests=n,
                               seed=15, device="cpu", launch_out=got)
    assert K.LAUNCHES["wait_scan"] == before
    assert got["kernel"] == "wait_scan"
    cells = [(li, si) for li in range(len(lams)) for si in range(len(sigmas))]
    assert got["cells"] == cells
    assert got["args"][0].shape == (n, len(cells))
    pols = [factory(sigmas[si]) for _, si in cells]
    assert got["args"][2].tolist() == [p.k for p in pols]
    assert got["args"][3].tolist() == [float("inf") if p.timeout is None
                                       else p.timeout for p in pols]
    assert got["args"][4].tolist() == [p.b_max or 0 for p in pols]
    for li, lam in enumerate(lams):
        for si, s in enumerate(sigmas):
            cell = t_fast.simulate_policy_fast(factory(s), lam, td, tl,
                                               num_requests=n, seed=15,
                                               device="cpu")
            assert lanes["mean_wait"][li, si] == cell["mean_wait"], (li, si)
    ref = j_fast.sweep_noise(_wait_noise_factory(j_pol, j_pred, kw), lams,
                             sigmas, jd, jl, num_requests=n, seed=15)
    np.testing.assert_allclose(lanes["mean_wait"], ref["mean_wait"], rtol=0,
                               atol=SCAN_ATOL)
