"""The port's length predictors, modulated traffic, replica fleet and fleet
serving layer on the CPU, against the JAX package on equal seeds.

Predictions, warped arrivals, router assignments and the NumPy oracles'
waits must be EQUAL (``np.array_equal``): the port runs the reference's
NumPy arithmetic in the same order.  The fast path (``device="cpu"``: the
kernels' plain versions, S6 for the backlog routers) must equal the port's
own oracle bit for bit and the reference's compiled path within
``SCAN_ATOL`` = 1e-10 s with equal assignments and batch boundaries (XLA on
the CPU contracts the reference's batch time into fused multiply-adds; see
``tests/test_torch_simfast.py``).  The analytic forms agree within 1e-12
relative, the controller's recommendations field for field, and
``run_fleet_schedule``'s greedy tokens and ``produced`` with the reference
engine fleet on a shared fake clock.

The reference's compiled scans run under ``jax.experimental.enable_x64``,
which JAX 0.9 removed; the ``x64`` fixture puts back a shim with
``monkeypatch`` (the JAX package is not edited)."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

import repro.serving.engine as j_engine_mod  # noqa: E402
import repro_torch.serving.engine as t_engine_mod  # noqa: E402
from repro.core import control as j_ctl  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fastsim as j_fast  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import predictors as j_pred  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402
from repro.core import traffic as j_traf  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.serving import router as j_router  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import control as t_ctl  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import predictors as t_pred  # noqa: E402
from repro_torch.core import shardsweep as t_ss  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402
from repro_torch.core import traffic as t_traf  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.distributed import cells_mesh  # noqa: E402
from repro_torch.kernels.backlog_scan import (  # noqa: E402
    MAX_REPLICAS, backlog_scan, backlog_scan_reference)
from repro_torch.serving import router as t_router  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402

SCAN_ATOL = 1e-10
RTOL = 1e-12
LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)       # Fig 5 constants
HT = dict(k1=0.05, k2=0.5, k3=2e-4, k4=0.002)         # Fig 6b constants
DISTS = {"uniform": ("UniformTokens", (1000,)),
         "lognormal": ("LogNormalTokens", (7.0, 0.7))}
ROUTERS = ("random", "round_robin", "power_of_d", "jsq", "least_work",
           "session_affinity")
# every length-signal path behind the routers: padded, early exit, binned,
# ordered membership, single service
POLICIES = {"dynamic": ("dynamic", {"b_max": 8}), "elastic": ("elastic", {}),
            "multibin": ("multibin", {}), "srpt": ("srpt", {"b_max": 8}),
            "fcfs": ("fcfs", {})}


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def both(pair, name, *args, **kw):
    j, t = pair
    return getattr(j, name)(*args, **kw), getattr(t, name)(*args, **kw)


def dists(key):
    return both((j_dist, t_dist), DISTS[key][0], *DISTS[key][1])


def lats(law=LAT):
    return both((j_lat, t_lat), "BatchLatencyModel", **law)


def pols(name, **kw):
    kind, base = POLICIES.get(name, (name, {}))
    return both((j_pol, t_pol), "get_policy", kind, **{**base, **kw})


def close(a, b, tol=RTOL):
    if a == b:                      # equal infinities and Nones too
        return
    assert abs(a - b) <= tol * max(1.0, abs(a), abs(b)), (a, b)


def same_fast(jr, tr, to):
    """A port fast-path result against the reference's compiled one and the
    port's own oracle ``to``."""
    assert np.array_equal(tr["waits"], to["waits"])
    np.testing.assert_allclose(tr["waits"], jr["waits"], rtol=0,
                               atol=SCAN_ATOL)
    if "mean_batch" in jr:
        assert tr["mean_batch"] == jr["mean_batch"]


# ----------------------------------------------------------------------------
# Registries and predictors
# ----------------------------------------------------------------------------

def test_registries_equal_reference():
    assert set(t_pred.PREDICTORS) == set(j_pred.PREDICTORS)
    assert set(t_traf.TRAFFIC) == set(j_traf.TRAFFIC)
    assert set(t_fleet.ROUTERS) == set(j_fleet.ROUTERS)
    for a, b in ((t_traf.default_traffic(), j_traf.default_traffic()),
                 (t_traf.null_traffic(), j_traf.null_traffic()),
                 (t_fleet.default_routers(3), j_fleet.default_routers(3))):
        assert {k: repr(v) for k, v in a.items()} == \
            {k: repr(v) for k, v in b.items()}
    spec = {"kind": "lognormal_noise", "sigma": 0.7}
    assert repr(t_pred.predictor_from_spec(spec)) == \
        repr(j_pred.predictor_from_spec(spec))
    assert repr(t_traf.traffic_from_spec({"name": "sinusoid",
                                          "amplitude": 0.3})) == \
        repr(j_traf.traffic_from_spec({"name": "sinusoid", "amplitude": 0.3}))
    assert t_traf.traffic_from_spec(None).is_null
    r = t_fleet.router_from_spec({"kind": "least_work",
                                  "predictor": "bucket"})
    assert r.state_dependent and repr(r) == repr(j_fleet.router_from_spec(
        {"kind": "least_work", "predictor": "bucket"}))


def _fitted(mod, name):
    if name == "learned":
        return mod.LearnedPredictor.fitted(mod_dist(mod).LogNormalTokens(
            5.0, 0.8), num_train=3000, seed=2)
    train = (j_pipe if mod is j_pred else t_pipe).make_request_stream(
        400, 1.0, mod_dist(mod).LogNormalTokens(5.0, 0.8), vocab=300,
        seed=1, prompt_len_corr=1.0)
    return mod.PromptFeaturePredictor.fitted_on(train)


def mod_dist(mod):
    return j_dist if mod is j_pred else t_dist


PREDICTOR_SPECS = {
    "oracle": "oracle",
    "lognormal_noise": {"kind": "lognormal_noise", "sigma": 0.5,
                        "bias": 0.1},
    "additive_noise": {"kind": "additive_noise", "std": 120.0},
    "bucket": {"kind": "bucket", "num_buckets": 6, "accuracy": 0.7},
    "bucket_edges": {"kind": "bucket", "edges": [100.0, 800.0],
                     "accuracy": 0.5},
    "learned": None, "prompt_features": None}


@pytest.mark.parametrize("name", sorted(PREDICTOR_SPECS))
def test_predictions_equal_reference(name):
    spec = PREDICTOR_SPECS[name]
    if spec is None:
        jp, tp = _fitted(j_pred, name), _fitted(t_pred, name)
    else:
        jp, tp = (m.predictor_from_spec(spec) for m in (j_pred, t_pred))
    reqs = t_pipe.make_request_stream(
        300, 1.0, t_dist.LogNormalTokens(5.0, 0.8), vocab=300, seed=4,
        prompt_len_corr=1.0)
    true = np.array([r.target_output_tokens for r in reqs], np.float64)
    prompts = [r.prompt_tokens for r in reqs]
    for key in (0, 7, (3, 7919)):
        a = jp.predict(key, true, prompts)
        b = tp.predict(key, true, prompts)
        assert np.array_equal(a, b), (name, key)
        assert np.array_equal(jp.predict(key, true), tp.predict(key, true))
        assert j_pred.prediction_log_rmse(a, true) == \
            t_pred.prediction_log_rmse(b, true)
    jpol = j_pol.SRPTPolicy(predictor=jp)
    tpol = t_pol.SRPTPolicy(predictor=tp)
    assert np.array_equal(
        j_pred.resolve_predictions(jpol, None, 5, true, prompts),
        t_pred.resolve_predictions(tpol, None, 5, true, prompts))
    assert np.array_equal(
        j_pred.resolve_predictions(jpol, "additive_noise", 5, true),
        t_pred.resolve_predictions(tpol, "additive_noise", 5, true))


@pytest.mark.parametrize("pname", ["srpt", "multibin", "dynamic", "wait",
                                   "fcfs"])
def test_predicted_workloads_and_oracle_equal_reference(x64, pname):
    """The predicted column is drawn on a salted stream (arrivals and
    tokens untouched), threads through formation on the oracle and the
    fast path, and sigma = 0 is the oracle bit for bit."""
    (jd, td), (jl, tl) = dists("lognormal"), lats(HT)
    noisy = {"kind": "lognormal_noise", "sigma": 1.0}
    jp, tp = pols(pname, predictor=noisy)
    plain = pols(pname)[1]
    jw = jp.sample_workload(0.9, jd, 3000, 7)
    tw = tp.sample_workload(0.9, td, 3000, 7)
    tw0 = plain.sample_workload(0.9, td, 3000, 7)
    for k in ("arrivals", "tokens", "predicted"):
        assert np.array_equal(getattr(jw, k), getattr(tw, k)), k
    assert np.array_equal(tw.arrivals, tw0.arrivals) and tw0.predicted is None
    jo = j_sim.simulate_policy(jp, 0.9, jd, jl, num_requests=3000, seed=7)
    to = t_sim.simulate_policy(tp, 0.9, td, tl, num_requests=3000, seed=7)
    assert np.array_equal(jo["waits"], to["waits"])
    tf = t_fast.simulate_policy_fast(tp, 0.9, td, tl, num_requests=3000,
                                     seed=7, device="cpu")
    jf = j_fast.simulate_policy_fast(jp, 0.9, jd, jl, num_requests=3000,
                                     seed=7)
    same_fast(jf, tf, to)
    zero = pols(pname, predictor={"kind": "lognormal_noise",
                                  "sigma": 0.0})[1]
    assert np.array_equal(
        t_sim.simulate_policy(zero, 0.9, td, tl, num_requests=3000,
                              seed=7)["waits"],
        t_sim.simulate_policy(plain, 0.9, td, tl, num_requests=3000,
                              seed=7)["waits"])
    if pname == "srpt":
        assert tp.analytic_kind is None and tp.analytic_delay(
            0.9, td, tl) is None


@pytest.mark.parametrize("pname", ["srpt", "multibin", "wait"])
def test_sweep_noise_equals_reference(x64, pname):
    (jd, td), (jl, tl) = dists("lognormal"), lats(HT)
    kw = {"srpt": {"b_max": 16}, "multibin": {"num_bins": 4},
          "wait": {"k": 16}}[pname]
    lams, sigmas, n = [0.6, 1.0], [0.0, 0.5, 1.5], 2500

    def factory(mod, pred):
        return lambda s: mod.get_policy(
            pname, predictor=pred.LogNormalNoisePredictor(s), **kw)

    launch = {}
    t = t_fast.sweep_noise(factory(t_pol, t_pred), lams, sigmas, td, tl,
                           num_requests=n, seed=15, device="cpu",
                           launch_out=launch)
    j = j_fast.sweep_noise(factory(j_pol, j_pred), lams, sigmas, jd, jl,
                           num_requests=n, seed=15)
    np.testing.assert_allclose(t["mean_wait"], j["mean_wait"], rtol=0,
                               atol=SCAN_ATOL)
    # the sigma = 0 column is the predictor-free policy, bit for bit
    for li, lam in enumerate(lams):
        ref = t_fast.simulate_policy_fast(t_pol.get_policy(pname, **kw), lam,
                                          td, tl, num_requests=n, seed=15,
                                          device="cpu")
        assert t["mean_wait"][li, 0] == ref["mean_wait"]
    # every cell a lane of ONE launch, WAIT's too
    assert launch["kernel"] == pname + "_scan"
    assert launch["args"][0].shape == (n, len(lams) * len(sigmas))
    assert launch["cells"] == [(li, si) for li in range(2)
                               for si in range(3)]
    # the mesh executor in place of the S5 launch (multi-bin and WAIT keep
    # their one launch): the same plane, bit for bit
    mesh = t_ss.srpt_executor(cells_mesh(["cpu"] * 2))
    on_mesh = t_fast.sweep_noise(factory(t_pol, t_pred), lams, sigmas, td,
                                 tl, num_requests=n, seed=15, device="cpu",
                                 srpt_loop=mesh)
    assert np.array_equal(on_mesh["mean_wait"], t["mean_wait"])


# ----------------------------------------------------------------------------
# Traffic
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["default", "null"])
def test_traffic_profiles_and_warps_equal_reference(kind):
    jm = getattr(j_traf, f"{kind}_traffic")()
    tm = getattr(t_traf, f"{kind}_traffic")()
    base = np.cumsum(np.random.default_rng(0).exponential(1.0, 4000))
    t = np.linspace(0.0, 2500.0, 301)
    for name in jm:
        for seed in (0, 5):
            a, b = jm[name].warp(base, seed), tm[name].warp(base, seed)
            assert np.array_equal(a, b), (name, seed)
            if tm[name].is_null:
                assert b is base
            assert np.array_equal(jm[name].rate(t, seed),
                                  tm[name].rate(t, seed))
            assert np.array_equal(jm[name].cumulative(t, seed),
                                  tm[name].cumulative(t, seed))
    wl = t_pol.DynamicPolicy().sample_workload(0.5, None, 50, 1)
    assert t_traf.warp_workload(wl, None, 1) is wl
    ww = t_traf.warp_workload(wl, "mmpp", 1)
    assert np.array_equal(ww.tokens, wl.tokens) and np.array_equal(
        ww.inter, np.diff(ww.arrivals, prepend=0.0))


@pytest.mark.parametrize("name", sorted(j_traf.TRAFFIC))
def test_modulated_streams_equal_reference(x64, name):
    """make_request_stream, the oracle and the fast path under every
    registered traffic model (its default instance)."""
    jm, tm = j_traf.default_traffic()[name], t_traf.default_traffic()[name]
    (jd, td), (jl, tl) = dists("uniform"), lats()
    a = j_pipe.make_request_stream(200, 0.5, jd, vocab=100, seed=3,
                                   traffic=jm)
    b = t_pipe.make_request_stream(200, 0.5, td, vocab=100, seed=3,
                                   traffic=tm)
    assert [(r.arrival, r.target_output_tokens) for r in a] == \
        [(r.arrival, r.target_output_tokens) for r in b]
    assert all(np.array_equal(x.prompt_tokens, y.prompt_tokens)
               for x, y in zip(a, b))
    for pname in ("dynamic", "fcfs", "srpt"):
        jp, tp = pols(pname)
        kw = dict(num_requests=3000, seed=4)
        jo = j_sim.simulate_policy(jp, 0.1, jd, jl, traffic=jm, **kw)
        to = t_sim.simulate_policy(tp, 0.1, td, tl, traffic=tm, **kw)
        assert np.array_equal(jo["waits"], to["waits"]), pname
        tf = t_fast.simulate_policy_fast(tp, 0.1, td, tl, traffic=tm,
                                         device="cpu", **kw)
        jf = j_fast.simulate_policy_fast(jp, 0.1, jd, jl, traffic=jm, **kw)
        same_fast(jf, tf, to)


# ----------------------------------------------------------------------------
# The fleet: routers, oracle, fast path, analytics
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("rname", ROUTERS)
def test_router_assignments_equal_reference(rname):
    """Every router's split of one stream, host recursion and kernel S6's
    plain version alike, with the router's own predictor on its salted
    lane."""
    (jd, td), (jl, tl) = dists("lognormal"), lats(HT)
    for R in (1, 2, 3, 5):
        for pred in (None, {"kind": "lognormal_noise", "sigma": 0.5}):
            spec = {"kind": rname, "predictor": pred}
            jr, tr = (m.router_from_spec(dict(spec))
                      for m in (j_fleet, t_fleet))
            jp, tp = pols("srpt")
            jfw = jr.fleet_workload(jp, 1.6, jd, jl, 2000, 3, R,
                                    traffic="sinusoid")
            tfw = tr.fleet_workload(tp, 1.6, td, tl, 2000, 3, R,
                                    traffic="sinusoid")
            ffw = tr.fleet_workload(tp, 1.6, td, tl, 2000, 3, R, fast=True,
                                    traffic="sinusoid", device="cpu")
            assert np.array_equal(jfw.replica_of, tfw.replica_of), (R, pred)
            assert np.array_equal(tfw.replica_of, ffw.replica_of), (R, pred)
            assert np.array_equal(jfw.arrivals, tfw.arrivals)
            for a, b in zip(jfw.replicas, tfw.replicas):
                assert np.array_equal(a.arrivals, b.arrivals)
                assert np.array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("pname", sorted(POLICIES))
@pytest.mark.parametrize("rname", ROUTERS)
def test_fleet_oracle_and_fast_equal_reference(x64, rname, pname):
    (jd, td), (jl, tl) = dists("lognormal"), lats(HT)
    jp, tp = pols(pname)
    kw = dict(num_requests=1500, seed=3)
    jo = j_fleet.route_oracle(rname, jp, 1.2, 3, jd, jl, traffic="mmpp", **kw)
    to = t_fleet.route_oracle(rname, tp, 1.2, 3, td, tl, traffic="mmpp", **kw)
    assert np.array_equal(jo["replica_of"], to["replica_of"])
    assert np.array_equal(jo["replica_counts"], to["replica_counts"])
    for k in ("mean_wait", "p50_wait", "p95_wait", "p99_wait"):
        assert jo[k] == to[k], k
    assert jo.get("mean_batch") == to.get("mean_batch")
    launch = {}
    tf = t_fast.simulate_fleet_fast(rname, tp, 1.2, 3, td, tl, traffic="mmpp",
                                    device="cpu", launch_out=launch, **kw)
    jf = j_fast.simulate_fleet_fast(rname, jp, 1.2, 3, jd, jl, traffic="mmpp",
                                    **kw)
    assert np.array_equal(tf["replica_of"], jf["replica_of"])
    assert np.array_equal(tf["replica_of"], to["replica_of"])
    for a, b, c in zip(jf["per_replica"], tf["per_replica"],
                       to["per_replica"]):
        assert (a is None) == (b is None) == (c is None)
        if b is not None:
            same_fast(a, b, c)
    assert bool(launch) == t_fleet.router_from_spec(rname).state_dependent
    if launch:
        assert launch["kernel"] == "backlog_scan" and launch["args"][2] == 3


def test_fleet_sweep_equals_reference(x64):
    (jd, td), (jl, tl) = dists("uniform"), lats()
    launch = {}
    t = t_fleet.sweep([1, 2, 4], [0.4, 0.8], "jsq", t_pol.DynamicPolicy(8),
                      td, tl, num_requests=3000, seed=3, device="cpu",
                      launch_out=launch)
    j = j_fleet.sweep([1, 2, 4], [0.4, 0.8], "jsq", j_pol.DynamicPolicy(8),
                      jd, jl, num_requests=3000, seed=3)
    np.testing.assert_allclose(t["mean_wait"], j["mean_wait"], rtol=0,
                               atol=SCAN_ATOL)
    assert (np.diff(t["mean_wait"][:, 1]) < 0).all()
    assert sorted(launch) == [(R, li) for R in (2, 4) for li in (0, 1)]


def test_r1_fleet_is_the_single_server():
    td, tl = dists("uniform")[1], lats()[1]
    for name in ("dynamic", "srpt", "fcfs"):
        tp = pols(name)[1]
        single = t_sim.simulate_policy(tp, 0.3, td, tl, num_requests=2000,
                                       seed=2)
        for rname in ROUTERS:
            f = t_fleet.route_oracle(rname, tp, 0.3, 1, td, tl,
                                     num_requests=2000, seed=2)
            assert np.array_equal(f["per_replica"][0]["waits"],
                                  single["waits"]), (name, rname)


def test_fleet_analytics_equal_reference():
    (jd, td), (jl, tl) = dists("uniform"), lats()
    for R, a in ((1, 0.5), (3, 2.2), (8, 7.9), (4, 5.0)):
        close(j_fleet.erlang_c(R, a), t_fleet.erlang_c(R, a))
    for args in ((0.25, 3, 8.0, 90.0), (0.9, 4, 4.0, 20.0),
                 (2.0, 2, 1.5, 3.0)):
        close(j_fleet.mgr_whitt_wait(*args), t_fleet.mgr_whitt_wait(*args))
        close(j_fleet.split_qna_wait(*args), t_fleet.split_qna_wait(*args))
    for rname in ROUTERS:
        for pname in ("fcfs", "dynamic", "srpt"):
            jp, tp = pols(pname)
            assert j_fleet.fleet_analytic_kind(rname, jp) == \
                t_fleet.fleet_analytic_kind(rname, tp)
            for lam, R in ((0.25, 3), (0.6, 2)):
                close(j_fleet.fleet_analytic_delay(rname, jp, lam, R, jd, jl),
                      t_fleet.fleet_analytic_delay(rname, tp, lam, R, td, tl))
    for lam in (0.5, 3.0, 40.0):
        for mx in (1, 4, 64):
            assert j_fleet.recommend_replicas(lam, jd, jl, 0.7, mx) == \
                t_fleet.recommend_replicas(lam, td, tl, 0.7, mx)


# ----------------------------------------------------------------------------
# Kernel S6's plain version and wrapper (the card's tests: test_torch_gpu.py)
# ----------------------------------------------------------------------------

def _routing_lanes(n, R, lanes, seed):
    """[n, lanes] arrivals with ties (equal arrivals, zero work, a start at
    t = 0 where every backlog is 0) and an [n, R, lanes] mask with rows
    where every replica is down."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0, (n, lanes)), axis=0)
    arr[: n // 3] = np.floor(arr[: n // 3])          # runs of equal arrivals
    arr[0] = 0.0
    work = rng.exponential(2.0, (n, lanes))
    work[::5] = 0.0
    up = rng.random((n, R, lanes)) < 0.6
    up[::7] = False                                  # every replica down
    return arr, work, up


@pytest.mark.parametrize("R", [1, 2, 3, 8, MAX_REPLICAS])
def test_backlog_scan_plain_equals_numpy_recursion(R):
    for n in (1, 2, 37, 1500):
        arr, work, up = _routing_lanes(n, R, 3, seed=n + R)
        ta, tw = torch.from_numpy(arr), torch.from_numpy(work)
        ids = backlog_scan(ta, tw, R).numpy()
        mids = backlog_scan(ta, tw, R,
                            torch.from_numpy(up.astype(np.uint8))).numpy()
        for c in range(3):
            assert np.array_equal(ids[:, c], j_fleet._backlog_assign_np(
                arr[:, c], work[:, c], R))
            assert np.array_equal(mids[:, c], j_fleet._masked_backlog_assign_np(
                arr[:, c], work[:, c], R, up[:, :, c]))
            assert np.array_equal(ids[:, c], t_fleet._backlog_assign_np(
                arr[:, c], work[:, c], R))
        assert (mids[::7] == 0).all()        # all down: replica 0, as np
    # torch.argmin keeps the first of equal minima, as np.argmin does
    assert int(torch.argmin(torch.tensor([2.0, 1.0, 1.0, 1.0]))) == 1


def test_backlog_scan_wrapper_checks():
    a = torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(TypeError):
        backlog_scan(a.float(), a, 2)
    with pytest.raises(ValueError):
        backlog_scan(a, a, MAX_REPLICAS + 1)
    with pytest.raises(ValueError):
        backlog_scan(a, a, 0)
    with pytest.raises(ValueError):
        backlog_scan(a, a[:3], 2)
    with pytest.raises(ValueError):
        backlog_scan(a, a, 3, torch.ones(4, 2, 2, dtype=torch.uint8))
    with pytest.raises(TypeError):
        backlog_scan(a, a, 2, torch.ones(4, 2, 2, dtype=torch.bool))
    assert backlog_scan_reference(a, a, 1).eq(0).all()


# ----------------------------------------------------------------------------
# Serving: schedulers with predictions, the fleet scheduler, the engine fleet
# ----------------------------------------------------------------------------

def _clocks(law=HT):
    (jl, tl) = lats(law)
    return (j_sched.ModelClock(j_pol.single_from_batch(jl), jl),
            t_sched.ModelClock(t_pol.single_from_batch(tl), tl))


def _streams(n, lam, seed, **kw):
    jd, td = dists("lognormal")
    return (j_pipe.make_request_stream(n, lam, jd, vocab=100, seed=seed, **kw),
            t_pipe.make_request_stream(n, lam, td, vocab=100, seed=seed, **kw))


def _same_schedule(jr, tr):
    for k in ("waits", "e2e", "lost"):
        assert np.array_equal(getattr(jr, k), getattr(tr, k)), k
    assert jr.batch_sizes == tr.batch_sizes and jr.makespan == tr.makespan


@pytest.mark.parametrize("rname", ROUTERS)
def test_fleet_scheduler_equals_reference(rname):
    jreqs, treqs = _streams(1500, 1.6, 2, prompt_len_corr=1.0,
                            traffic="trace")
    jc, tc = _clocks()
    noisy = {"kind": "lognormal_noise", "sigma": 0.5}
    for pname, predictor in (("srpt", noisy), ("multibin", "bucket"),
                             ("dynamic", None)):
        jp, tp = pols(pname, b_max=16) if pname != "multibin" else \
            pols(pname)
        jr = j_router.FleetScheduler(rname, jp, jc, 3, predictor=predictor,
                                     predict_seed=4).run(jreqs)
        tr = t_router.FleetScheduler(rname, tp, tc, 3, predictor=predictor,
                                     predict_seed=4).run(treqs)
        _same_schedule(jr, tr)
        assert np.array_equal(jr.replica_of, tr.replica_of)
        js, ts = j_router.summarize_fleet(jr), t_router.summarize_fleet(tr)
        assert js == ts
    # a predictor on a single scheduler, and on the ContinuousPolicy fleet
    _same_schedule(j_sched.PolicyScheduler(jp, jc, predictor=noisy,
                                           predict_seed=1).run(jreqs),
                   t_sched.PolicyScheduler(tp, tc, predictor=noisy,
                                           predict_seed=1).run(treqs))
    jp, tp = pols("continuous", slots=4)
    _same_schedule(j_router.FleetScheduler(rname, jp, jc, 2).run(jreqs),
                   t_router.FleetScheduler(rname, tp, tc, 2).run(treqs))


def test_fleet_layers_refuse_what_is_not_ported(x64):
    td, tl = dists("uniform")[1], lats()[1]
    tc = _clocks()[1]
    pol = t_pol.DynamicPolicy(8)
    # per-replica KV budgets are ported: each layer raises the reference's
    # ValueError for a bad spec or for faults x memory
    jd, jl = dists("uniform")[0], lats()[0]
    jc = _clocks()[0]
    jpol = j_pol.DynamicPolicy(8)
    for router, fleet, fast, p, c, d, l, kw in (
            (j_router, j_fleet, j_fast, jpol, jc, jd, jl, {}),
            (t_router, t_fleet, t_fast, pol, tc, td, tl, {"device": "cpu"})):
        with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
            router.FleetScheduler("jsq", p, c, 2, memory=object())
        with pytest.raises(ValueError, match="resilience"):
            router.FleetScheduler("jsq", p, c, 2, memory=4000.0,
                                  faults="crash")
        with pytest.raises(ValueError, match="resilience"):
            router.run_fleet_schedule("jsq", p, object(), [], R=2,
                                      memory=4000.0, kill_at=1.0)
        with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
            fleet.route_oracle("jsq", p, 0.3, 2, d, l, num_requests=100,
                               memory=object())
        with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
            fast.simulate_fleet_fast("jsq", p, 0.3, 2, d, l,
                                     num_requests=100, memory=object(), **kw)


@pytest.fixture(scope="module")
def engines():
    from repro.configs import get_smoke_config as j_smoke
    from repro_torch.configs import get_smoke_config as t_smoke
    from repro_torch.models.params import params_from_numpy
    ecfg = dict(max_batch=4, max_seq=128, prompt_bucket=16)
    jc = dataclasses.replace(j_smoke("qwen2.5-3b"), num_layers=2)
    tc = dataclasses.replace(t_smoke("qwen2.5-3b"), num_layers=2)
    jeng = j_engine_mod.Engine(jc, j_engine_mod.EngineConfig(**ecfg))
    teng = t_engine_mod.Engine(
        tc, t_engine_mod.EngineConfig(**ecfg),
        params=params_from_numpy(jeng.params, device="cpu"), device="cpu")
    return jeng, teng


def _recording(engine, log):
    """Record every batch's greedy tokens and ``produced`` while the
    engine serves a schedule (the schedule itself reads only the times)."""
    generate = engine.generate

    def rec(prompts, targets, **kw):
        out = generate(prompts, targets, return_tokens=True, **kw)
        log.append((out["tokens"], list(out["produced"])))
        return out
    return rec


@pytest.mark.parametrize("rname,pname", [("least_work", "srpt"),
                                         ("jsq", "elastic")])
def test_run_fleet_schedule_equals_reference_engine(engines, monkeypatch,
                                                    rname, pname):
    jeng, teng = engines
    for mod in (j_engine_mod, t_engine_mod):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: float(next(t))))
    logs = {"j": [], "t": []}
    monkeypatch.setattr(jeng, "generate", _recording(jeng, logs["j"]))
    monkeypatch.setattr(teng, "generate", _recording(teng, logs["t"]))
    jd, td = (m.LogNormalTokens(log_mean=1.5, log_std=0.6, support=12)
              for m in (j_dist, t_dist))
    jreqs = j_pipe.make_request_stream(10, 4.0, jd, vocab=512,
                                       prompt_len_range=(3, 12), seed=5,
                                       traffic="mmpp")
    treqs = t_pipe.make_request_stream(10, 4.0, td, vocab=512,
                                       prompt_len_range=(3, 12), seed=5,
                                       traffic="mmpp")
    (jl, tl) = lats(HT)
    predictor = {"kind": "lognormal_noise", "sigma": 0.5}
    jp, tp = pols(pname, b_max=4)
    jr = j_router.run_fleet_schedule(rname, jp, jeng, jreqs, R=2, lat=jl,
                                     predictor=predictor)
    tr = t_router.run_fleet_schedule(rname, tp, teng, treqs, R=2, lat=tl,
                                     predictor=predictor)
    assert logs["t"] == logs["j"] and len(logs["t"]) >= 2
    assert np.array_equal(tr.replica_of, jr.replica_of)
    assert set(np.unique(tr.replica_of)) == {0, 1}
    _same_schedule(jr, tr)
    assert sum(tr.batch_sizes) == len(treqs) and not tr.lost.any()
    assert t_router.summarize_fleet(tr) == j_router.summarize_fleet(jr)
    # a list of engines, one a replica, gives the same fleet
    logs["t"].clear()
    tr2 = t_router.run_fleet_schedule(rname, tp, [teng, teng], treqs, lat=tl,
                                      predictor=predictor)
    assert np.array_equal(tr2.replica_of, tr.replica_of)
    assert tr2.batch_sizes == tr.batch_sizes


@pytest.mark.parametrize("rname,pname", [("jsq", "dynamic"),
                                         ("least_work", "elastic")])
def test_run_fleet_schedule_memory_equals_reference_engine(
        engines, monkeypatch, rname, pname):
    """Per-replica KV budgets on the engine layer: each replica admits
    against its own budget of 33.25 tokens (real footprints: prompt plus
    output), the split, schedule and memory roll-up equal to the
    reference's on the shared fake clock."""
    jeng, teng = engines
    for mod in (j_engine_mod, t_engine_mod):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: float(next(t))))
    jd, td = (m.LogNormalTokens(log_mean=1.5, log_std=0.6, support=12)
              for m in (j_dist, t_dist))
    jreqs = j_pipe.make_request_stream(12, 8.0, jd, vocab=512,
                                       prompt_len_range=(3, 12), seed=7)
    treqs = t_pipe.make_request_stream(12, 8.0, td, vocab=512,
                                       prompt_len_range=(3, 12), seed=7)
    jl, tl = lats(HT)
    jp, tp = pols(pname, b_max=4)
    jr = j_router.run_fleet_schedule(rname, jp, jeng, jreqs, R=2, lat=jl,
                                     memory=33.25)
    tr = t_router.run_fleet_schedule(rname, tp, teng, treqs, R=2, lat=tl,
                                     memory=33.25)
    assert np.array_equal(tr.replica_of, jr.replica_of)
    _same_schedule(jr, tr)
    assert tr.memory == jr.memory
    assert [p.memory for p in tr.per_replica] == \
        [p.memory for p in jr.per_replica]
    assert tr.memory["capacity"] == 33.25 and tr.memory["kv_peak"] <= 33.25
    assert t_router.summarize_fleet(tr) == j_router.summarize_fleet(jr)


# ----------------------------------------------------------------------------
# The controller's fleet, predictor and availability axes
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dist,lam", [("lognormal", 8.0), ("uniform", 0.01),
                                      ("uniform", 3.0)])
def test_controller_fleet_axis_equals_reference(dist, lam):
    jd, td = dists(dist)
    jl, tl = lats(HT)
    js, ts = (m.LatencyModel(0.0212, 1.79) for m in (j_lat, t_lat))
    kw = dict(max_replicas=16, min_samples=32, length_predictor="bucket",
              elastic_available=False)
    jc = j_ctl.AdaptiveController(js, jl, **kw)
    tc = t_ctl.AdaptiveController(ts, tl, **kw)
    rng = np.random.default_rng(0)
    t = 0.0
    for i, x in enumerate(td.sample(rng, 512)):
        t += rng.exponential(1.0 / lam)
        for c in (jc, tc):
            c.observe_arrival(t)
            c.observe_completion(int(max(x, 1)))
            if i % 100 == 99:
                c.observe_episode(150.0 + i, 10.0)
        if i in (255, 511):
            assert dataclasses.asdict(tc.recommendation()) == \
                dataclasses.asdict(jc.recommendation())
    assert tc.availability_hat() == jc.availability_hat() < 1.0
    for l in (0.5, 5.0, 50.0):
        assert tc.shed_probability(l, td) == jc.shed_probability(l, jd)


# ----------------------------------------------------------------------------
# Entry points need the card unless the CPU is asked for
# ----------------------------------------------------------------------------

def test_fleet_entry_points_need_a_gpu(monkeypatch):
    from repro_torch.core import faults as t_faults
    td, tl = dists("uniform")[1], lats()[1]
    pol = t_pol.DynamicPolicy(8)
    a, w = np.arange(5.0), np.ones(5)
    calls = {
        "backlog_route": lambda **k: t_fast.backlog_route(a, w, 2, **k),
        "masked_backlog_route": lambda **k: t_fast.masked_backlog_route(
            a, w, np.ones((5, 2), bool), 2, **k),
        "simulate_fleet_fast": lambda **k: t_fast.simulate_fleet_fast(
            "jsq", pol, 0.3, 2, td, tl, num_requests=200, **k),
        "fleet.sweep": lambda **k: t_fleet.sweep(
            [2], [0.3], "jsq", pol, td, tl, num_requests=200, **k),
        "sweep_noise": lambda **k: t_fast.sweep_noise(
            lambda s: t_pol.SRPTPolicy(predictor=t_pred.LogNormalNoisePredictor(
                s)), [0.3], [0.0], td, tl, num_requests=200, **k),
        "simulate_fleet_faulty": lambda **k: t_faults.simulate_fleet_faulty(
            "jsq", pol, 0.3, 2, td, tl, "crash", num_requests=200,
            fast=True, **k),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K.reset_launches()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu") is not None, name
    # the host oracles take no device
    assert t_fleet.route_oracle("jsq", pol, 0.3, 2, td, tl,
                                num_requests=200)["mean_wait"] >= 0
    assert t_faults.simulate_fleet_faulty("jsq", pol, 0.3, 2, td, tl, "crash",
                                          num_requests=200)["n_arrived"] == 200
    assert K.LAUNCHES["backlog_scan"] == 0       # the plain version ran
