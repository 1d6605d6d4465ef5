"""The port's simulator side on the CPU against the JAX package: the token
distributions, the latency law and its fits, the elastic bound, the
policies' workload law and analytic delays, the NumPy oracle, the
virtual-timeline schedulers and ``summarize``.

Equal seeds must give equal trajectories: workloads, oracle waits and
schedules are compared with ``np.array_equal``; analytic delays within
1e-12 relative (the same closed forms, evaluated by the same NumPy and
SciPy calls)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bulk as j_bulk  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402
from repro.data.pipeline import make_request_stream as j_stream  # noqa: E402
from repro.serving import metrics as j_metrics  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402

from repro_torch.core import bulk as t_bulk  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402
from repro_torch.data.pipeline import make_request_stream as t_stream  # noqa: E402
from repro_torch.serving import metrics as t_metrics  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402

LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
DISTS = {"uniform": ("UniformTokens", (1000,)),
         "lognormal": ("LogNormalTokens", (7.0, 0.7))}


def both(module_pair, name, *args, **kw):
    """The same object built in both packages."""
    j, t = module_pair
    return getattr(j, name)(*args, **kw), getattr(t, name)(*args, **kw)


def dists(key):
    return both((j_dist, t_dist), DISTS[key][0], *DISTS[key][1])


def lats():
    return both((j_lat, t_lat), "BatchLatencyModel", **LAT)


def policies(name, **kw):
    return j_pol.REGISTRY[name](**kw), t_pol.REGISTRY[name](**kw)


def close(a, b, tol=1e-12):
    if a == b:                      # equal infinities too
        return
    assert abs(a - b) <= tol * max(1.0, abs(a), abs(b)), (a, b)


# ----------------------------------------------------------------------------
# Distributions, latency law, bulk
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("UniformTokens", (1000,)), ("UniformTokens", (300, 20)),
    ("TruncGaussianTokens", (800.0, 20.0)), ("DeterministicTokens", (64,)),
    ("GeometricTokens", (50.0,))])
def test_distribution_pmf_and_samples_equal(name, args):
    jd, td = both((j_dist, t_dist), name, *args)
    assert np.array_equal(jd.pmf, td.pmf)
    assert td.name == jd.name and td.max_tokens == jd.max_tokens
    for seed in (0, 7):
        assert np.array_equal(jd.sample(np.random.default_rng(seed), 5000),
                              td.sample(np.random.default_rng(seed), 5000))
    close(jd.max_order_stat_mean(8), td.max_order_stat_mean(8))


def test_latency_model_additions_equal():
    assert t_lat.PAPER_A100_LLAMA2_7B == t_lat.LatencyModel(
        **vars(j_lat.PAPER_A100_LLAMA2_7B))
    jl, tl = lats()
    ns = np.array([17.0, 3.0, 950.0, 3.0, 400.0])
    for fn, args in (("prefill_time", (5,)), ("decode_time", (5, 950.0)),
                     ("elastic_batch_time", (ns,)),
                     ("elastic_completion_times", (ns,))):
        assert np.array_equal(getattr(jl, fn)(*args), getattr(tl, fn)(*args))
    jd, td = dists("uniform")
    assert np.array_equal(jl.service_rate(jd, [1, 4, 16]),
                          tl.service_rate(td, [1, 4, 16]))
    assert np.array_equal(j_bulk.service_rate_curve(jd, jl, [2, 8]),
                          t_bulk.service_rate_curve(td, tl, [2, 8]))
    for lam in (0.1, 0.5):
        jb = j_bulk.elastic_batching_bound(jd, jl, lam)
        tb = t_bulk.elastic_batching_bound(td, tl, lam)
        assert jb == tb


def test_latency_fits_equal():
    rng = np.random.default_rng(3)
    b = rng.integers(1, 17, 40).astype(float)
    l = rng.integers(1, 500, 40).astype(float)
    secs = 0.01 * b + 0.2 + (1e-4 * b + 6e-3) * l + rng.normal(0, 1e-3, 40)
    assert vars(j_lat.fit_batch_latency_model(b, l, secs)) == \
        vars(t_lat.fit_batch_latency_model(b, l, secs))
    assert vars(j_lat.fit_latency_model(l, secs)) == \
        vars(t_lat.fit_latency_model(l, secs))
    assert j_lat.linear_fit_r2(b, secs) == t_lat.linear_fit_r2(b, secs)


# ----------------------------------------------------------------------------
# Workload law
# ----------------------------------------------------------------------------

WORKLOAD_CASES = [("fcfs", {}), ("fcfs", {"n_max": 600}),
                  ("dynamic", {}), ("dynamic", {"n_max": 500}),
                  ("elastic", {"b_max": 4}), ("elastic", {"n_max": 300}),
                  ("fixed", {"b": 4}), ("fixed", {"b": 16, "n_max": 800})]


@pytest.mark.parametrize("dist", sorted(DISTS))
@pytest.mark.parametrize("name,kw", WORKLOAD_CASES)
def test_sample_workload_bit_equal(name, kw, dist):
    jp, tp = policies(name, **kw)
    jd, td = dists(dist)
    jw = jp.sample_workload(0.3, jd, 9999, seed=5)
    tw = tp.sample_workload(0.3, td, 9999, seed=5)
    assert np.array_equal(jw.arrivals, tw.arrivals)
    assert np.array_equal(jw.tokens, tw.tokens)
    assert tw.tokens.dtype == jw.tokens.dtype
    if name == "fcfs":
        assert np.array_equal(jw.inter, tw.inter)
    else:
        assert tw.inter is None and jw.inter is None
    assert tp.schedule_length(9999) == jp.schedule_length(9999)


# ----------------------------------------------------------------------------
# The oracle
# ----------------------------------------------------------------------------

ORACLE_CASES = [
    ("fcfs", {}, "lognormal", 1 / 40, 20_000),
    ("fcfs", {"tau": 30.0}, "lognormal", 1 / 40, 20_000),
    ("fcfs", {"tau": 120.0, "n_max": 1600}, "lognormal", 1 / 40, 20_000),
    ("dynamic", {}, "uniform", 0.3, 20_000),
    ("dynamic", {"b_max": 8}, "uniform", 0.4, 20_000),
    ("dynamic", {"n_max": 500}, "uniform", 0.3, 20_000),
    ("elastic", {"b_max": 4}, "uniform", 0.3, 20_000),
    ("fixed", {"b": 4}, "uniform", 0.3, 20_000),
    ("fixed", {"b": 16}, "lognormal", 0.2, 20_000),
]


@pytest.mark.parametrize("name,kw,dist,lam,n", ORACLE_CASES)
def test_oracle_waits_bit_equal(name, kw, dist, lam, n):
    jp, tp = policies(name, **kw)
    jd, td = dists(dist)
    jl, tl = lats()
    if name == "fcfs":
        jl, tl = j_lat.PAPER_A100_LLAMA2_7B, t_lat.PAPER_A100_LLAMA2_7B
    jr = j_sim.simulate_policy(jp, lam, jd, jl, num_requests=n, seed=2)
    tr = t_sim.simulate_policy(tp, lam, td, tl, num_requests=n, seed=2)
    assert np.array_equal(jr["waits"], tr["waits"])
    assert jr.keys() == tr.keys()
    for k in jr:
        if k != "waits":
            assert jr[k] == tr[k], k


@pytest.mark.parametrize("slots,chunk", [(16, 1), (4, 8)])
def test_oracle_continuous_bit_equal(slots, chunk):
    jp, tp = policies("continuous", slots=slots, chunk=chunk)
    jd, td = both((j_dist, t_dist), "UniformTokens", 200)
    jl, tl = lats()
    jr = j_sim.simulate_policy(jp, 0.3, jd, jl, num_requests=4000, seed=4)
    tr = t_sim.simulate_policy(tp, 0.3, td, tl, num_requests=4000, seed=4)
    assert np.array_equal(jr["waits"], tr["waits"])
    assert jr["mean_batch"] == tr["mean_batch"]


def test_oracle_custom_batch_time_and_legacy_wrappers():
    jd, td = dists("uniform")
    jl, tl = lats()
    bt = lambda ns: 0.4 + 0.002 * float(np.max(ns))  # noqa: E731
    jr = j_sim.simulate_fixed_batching(0.3, 4, jd, batch_time=bt,
                                       num_requests=8000, seed=1)
    tr = t_sim.simulate_fixed_batching(0.3, 4, td, batch_time=bt,
                                       num_requests=8000, seed=1)
    assert np.array_equal(jr["waits"], tr["waits"])
    for fn, kw in (("simulate_dynamic_batching", dict(elastic=True, b_max=8)),
                   ("simulate_dynamic_batching", dict(n_max=500))):
        jr = getattr(j_sim, fn)(0.35, jd, jl, num_requests=6000, seed=3, **kw)
        tr = getattr(t_sim, fn)(0.35, td, tl, num_requests=6000, seed=3, **kw)
        assert np.array_equal(jr["waits"], tr["waits"])
    jr = j_sim.simulate_mg1(0.02, *dists("lognormal")[:1],
                            j_lat.PAPER_A100_LLAMA2_7B, tau=60.0,
                            num_requests=6000, seed=1)
    tr = t_sim.simulate_mg1(0.02, dists("lognormal")[1],
                            t_lat.PAPER_A100_LLAMA2_7B, tau=60.0,
                            num_requests=6000, seed=1)
    assert np.array_equal(jr["waits"], tr["waits"])


def test_oracle_sweep_and_no_warmup_equal():
    jd, td = dists("uniform")
    jl, tl = lats()
    spec = {"dyn": dict(kind="dynamic"), "ela8": dict(kind="elastic",
                                                      b_max=8),
            "fix4": dict(kind="fixed", b=4)}
    jr = j_sim.simulate_policy_sweep([0.1, 0.4], jd, jl, spec,
                                     num_requests=5000, seed=0)
    tr = t_sim.simulate_policy_sweep([0.1, 0.4], td, tl, spec,
                                     num_requests=5000, seed=0)
    assert jr.keys() == tr.keys()
    for k in jr:
        assert np.array_equal(jr[k], tr[k])
    with j_sim.no_warmup(), t_sim.no_warmup():
        jw = j_sim.simulate_policy(j_pol.DynamicPolicy(), 0.3, jd, jl,
                                   num_requests=4000, seed=1)["waits"]
        tw = t_sim.simulate_policy(t_pol.DynamicPolicy(), 0.3, td, tl,
                                   num_requests=4000, seed=1)["waits"]
    assert len(tw) == 4000 and np.array_equal(jw, tw)
    assert len(t_sim.simulate_policy(t_pol.DynamicPolicy(), 0.3, td, tl,
                                     num_requests=4000, seed=1)["waits"]) \
        == 3600


# ----------------------------------------------------------------------------
# Analytics
# ----------------------------------------------------------------------------

ANALYTIC_CASES = [
    ("fcfs", {}, "lognormal", 1 / 40),
    ("fcfs", {"n_max": 1600}, "lognormal", 1 / 40),
    ("fcfs", {"tau": 30.0}, "lognormal", 1 / 40),
    ("fcfs", {"tau": 120.0, "n_max": 1600}, "lognormal", 1 / 50),
    ("dynamic", {}, "uniform", 0.3),
    ("dynamic", {"n_max": 500}, "uniform", 0.3),
    ("dynamic", {"b_max": 8}, "uniform", 0.3),
    ("elastic", {}, "uniform", 0.5),
    ("elastic", {"n_max": 300}, "lognormal", 0.5),
    ("fixed", {"b": 4}, "uniform", 0.15),
    ("fixed", {"b": 4}, "uniform", 0.3),       # unstable: inf in both
    ("fixed", {"b": 8, "n_max": 800}, "lognormal", 0.2),
]


@pytest.mark.parametrize("name,kw,dist,lam", ANALYTIC_CASES)
def test_analytic_delay_matches_reference(name, kw, dist, lam):
    jp, tp = policies(name, **kw)
    jd, td = dists(dist)
    jl, tl = lats()
    if name == "fcfs":
        jl, tl = j_lat.PAPER_A100_LLAMA2_7B, t_lat.PAPER_A100_LLAMA2_7B
    ja, ta = jp.analytic_delay(lam, jd, jl), tp.analytic_delay(lam, td, tl)
    assert tp.analytic_kind == jp.analytic_kind
    if ja is None:
        assert ta is None
    else:
        close(ja, ta)


def test_fcfs_analytics_from_a_batch_law_and_optimal_limit():
    jp, tp = policies("fcfs")
    jd, td = dists("lognormal")
    jl, tl = lats()
    close(jp.analytic_delay(0.02, jd, jl), tp.analytic_delay(0.02, td, tl))
    assert t_pol.single_from_batch(tl) == t_lat.LatencyModel(
        **vars(j_pol.single_from_batch(jl)))
    assert jp.optimize_n_max(1 / 40, jd, j_lat.PAPER_A100_LLAMA2_7B, 0.95) \
        == tp.optimize_n_max(1 / 40, td, t_lat.PAPER_A100_LLAMA2_7B, 0.95)


# ----------------------------------------------------------------------------
# Virtual-timeline schedulers and summarize
# ----------------------------------------------------------------------------

def _streams(n=600, lam=0.35, seed=9):
    jd, td = dists("uniform")
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


@pytest.mark.parametrize("name,kw", [
    ("fcfs", {}), ("fcfs", {"tau": 5.0, "n_max": 400}), ("dynamic", {}),
    ("dynamic", {"b_max": 4}), ("elastic", {}), ("elastic", {"b_max": 8}),
    ("fixed", {"b": 4})])
def test_policy_scheduler_equals_reference(name, kw):
    jreqs, treqs = _streams()
    jc, tc = _clocks()
    jp, tp = policies(name, **kw)
    _same_result(j_sched.PolicyScheduler(jp, jc).run(jreqs),
                 t_sched.PolicyScheduler(tp, tc).run(treqs))
    # the policy's own scheduler binding is the same adapter
    _same_result(j_sched.PolicyScheduler(jp, jc).run(jreqs),
                 tp.scheduler(tc).run(treqs))


def test_named_schedulers_equal_reference():
    jreqs, treqs = _streams(n=400)
    jc, tc = _clocks()
    for cls, kw in (("FCFSScheduler", dict(tau=4.0)),
                    ("DynamicBatchScheduler", dict(b_max=6)),
                    ("FixedBatchScheduler", dict(b=3)),
                    ("ElasticBatchScheduler", dict(n_max=300))):
        jr = j_sched.run_schedule(getattr(j_sched, cls)(jc, **kw), jreqs)
        tr = t_sched.run_schedule(getattr(t_sched, cls)(tc, **kw), treqs)
        _same_result(jr, tr)


@pytest.mark.parametrize("slots,chunk,n_max", [(16, 1, None), (4, 8, None),
                                               (8, 4, 300)])
def test_continuous_virtual_equals_reference(slots, chunk, n_max):
    jreqs, treqs = _streams(n=500, lam=0.6)
    jc, tc = _clocks()
    jr = j_sched.ContinuousBatchScheduler(jc, slots, n_max=n_max,
                                          chunk=chunk).run(jreqs)
    tr = t_sched.ContinuousBatchScheduler(tc, slots, n_max=n_max,
                                          chunk=chunk).run(treqs)
    _same_result(jr, tr)
    arr = np.array([r.arrival for r in treqs])
    ns = np.array([r.target_output_tokens for r in treqs], np.int64)
    kw = dict(slots=slots, chunk=chunk, prefill_time=lambda b: 0.05 * b + 0.5,
              decode_step_time=lambda b: 0.0005 * b + 0.02)
    jv = j_sched.run_continuous_virtual(arr, ns, **kw)
    tv = t_sched.run_continuous_virtual(arr, ns, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(jv, tv))
    jp, tp = policies("continuous", slots=slots, chunk=chunk, n_max=n_max)
    _same_result(jp.scheduler(jc).run(jreqs), tp.scheduler(tc).run(treqs))


# ----------------------------------------------------------------------------
# What is not ported raises
# ----------------------------------------------------------------------------

def test_registry_and_unported_parts_raise():
    assert set(t_pol.default_policies()) == set(j_pol.default_policies())
    assert set(t_pol.REGISTRY) == set(j_pol.REGISTRY)
    for name in ("multibin", "wait", "srpt"):
        assert repr(t_pol.get_policy(name)) == repr(j_pol.get_policy(name))
        assert repr(t_pol.policy_from_spec({"kind": name, "b_max": 4})) == \
            repr(j_pol.policy_from_spec({"kind": name, "b_max": 4}))
        # a predictor is ported: the policy keeps it, as the reference does
        spec = {"kind": "lognormal_noise", "sigma": 0.5}
        jp, tp = (m.get_policy(name, predictor=spec) for m in (j_pol, t_pol))
        assert repr(tp.predictor) == repr(jp.predictor)
        assert tp.analytic_kind == jp.analytic_kind
    with pytest.raises(ValueError):
        t_pol.policy_from_spec({"kind": "nope"})
    assert repr(t_pol.policy_from_spec({"kind": "elastic", "b_max": 8})) == \
        repr(j_pol.policy_from_spec({"kind": "elastic", "b_max": 8}))
    assert repr(t_pol.DynamicPolicy(predictor="oracle").predictor) == \
        repr(j_pol.DynamicPolicy(predictor="oracle").predictor)
    # the tandem split and memory budgets are ported: the split equals the
    # reference's, a bad budget spec raises as the reference does, and a
    # real budget schedules as the reference's does
    ns = np.array([3.0, 1.0, 2.0])
    for name in ("elastic", "dynamic", "fixed"):
        jp, tp = policies(name)
        jpf, joff = jp.stage_split(ns, lats()[0])
        tpf, toff = tp.stage_split(ns, lats()[1])
        assert tpf == jpf and np.array_equal(toff, joff), name
    (jd, td), (jl, tl) = dists("uniform"), lats()
    with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
        j_sim.simulate_policy(j_pol.DynamicPolicy(), 0.3, jd, jl,
                              num_requests=100, memory=object())
    with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
        t_sim.simulate_policy(t_pol.DynamicPolicy(), 0.3, td, tl,
                              num_requests=100, memory=object())
    jreqs, treqs = _streams(n=300, lam=0.1)
    jc, tc = _clocks()
    jr = j_sched.PolicyScheduler(j_pol.DynamicPolicy(), jc,
                                 memory=1000).run(jreqs)
    tr = t_sched.PolicyScheduler(t_pol.DynamicPolicy(), tc,
                                 memory=1000).run(treqs)
    _same_result(jr, tr)
    assert tr.memory == jr.memory and tr.memory["capacity"] == 1000.0


def test_oracle_runs_on_the_host_without_a_gpu(monkeypatch):
    """The oracle is host NumPy: it takes no device and needs no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td, tl = dists("uniform")[1], lats()[1]
    r = t_pol.ElasticPolicy().simulate(0.3, td, tl, num_requests=2000)
    assert r["waits"].shape == (1800,) and np.isfinite(r["mean_wait"])
