"""The port's closed-loop autoscaler (``repro_torch.core.control.
simulate_controlled``, ``fastsim.run_controlled``) against
``repro.core.control`` on the CPU.

The reference's fast path needs ``jax.experimental.enable_x64``, which JAX
0.9 removed, so the port is held to the reference's oracle twin
(``fast=False``): the port's oracle bit for bit (actions, waits with NaN
where shed, served, shed, replica-time and objective), and the port's
fast path (the kernels' plain versions on the CPU) within 1e-9 s with the
same actions.  The cell is ``tests/test_autoscale.py``'s: sinusoid
amplitude 0.8, period 250, 2,000 requests, seed 1, window 50, four
replicas at most, replica cost 1."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import control as JC  # noqa: E402
from repro.core import distributions as JD  # noqa: E402
from repro.core import latency_model as JLM  # noqa: E402
from repro.core import policies as JP  # noqa: E402
from repro.core import traffic as JT  # noqa: E402
from repro.core.simulate import no_warmup as jax_no_warmup  # noqa: E402
from repro.core.simulate import simulate_policy as jax_simulate_policy  # noqa: E402
from repro_torch.core import control as TC  # noqa: E402
from repro_torch.core import distributions as TD  # noqa: E402
from repro_torch.core import latency_model as TLM  # noqa: E402
from repro_torch.core import policies as TP  # noqa: E402
from repro_torch.core import traffic as TT  # noqa: E402
from repro_torch.core.fastsim import run_controlled  # noqa: E402
from repro_torch.core.simulate import no_warmup, simulate_policy  # noqa: E402

LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
CELL = dict(num_requests=2_000, seed=1, window=50.0, max_replicas=4,
            replica_cost=1.0)

# the five carry-safe policies, built alike in both packages
POLICIES = {
    "fcfs": ("FCFSPolicy", {}),
    "dynamic": ("DynamicPolicy", {"b_max": 8}),
    "elastic": ("ElasticPolicy", {}),
    "multibin": ("MultiBinPolicy", {"num_bins": 3}),
    "srpt": ("SRPTPolicy", {"b_max": 8}),
}
MODES = {"adaptive": {}, "fixed": {"fixed": (2, "least_work")},
         "clairvoyant": {"clairvoyant": True}}


def _args(pkg, name):
    """(policy, dist, lat, traffic) of the cell, from package ``pkg``."""
    P, D, LM, T = (JP, JD, JLM, JT) if pkg == "jax" else (TP, TD, TLM, TT)
    cls, kw = POLICIES[name]
    return (getattr(P, cls)(**kw), D.LogNormalTokens(5.0, 0.6),
            LM.BatchLatencyModel(**LAT),
            T.SinusoidTraffic(amplitude=0.8, period=250.0))


def _run(pkg, name, mode, lam=4.0, fast=False, **over):
    pol, dist, lat, tm = _args(pkg, name)
    kw = dict(CELL, traffic=tm, **MODES[mode])
    kw.update(over)
    if pkg == "jax":
        return JC.simulate_controlled(pol, lam, dist, lat, fast=False, **kw)
    if fast:
        kw["device"] = "cpu"
    return TC.simulate_controlled(pol, lam, dist, lat, fast=fast, **kw)


def _actions(res):
    return [dataclasses.astuple(a) for a in res.actions]


@pytest.fixture(scope="module")
def reference():
    """The reference oracle's run of every (policy, mode) cell."""
    return {(p, m): _run("jax", p, m) for p in POLICIES for m in MODES}


def test_pow2_replicas():
    for r, mx, want in ((1, 8, 1), (3, 8, 4), (5, 8, 8), (9, 8, 8),
                        (5, 6, 4), (0, 4, 1), (2, 1, 1)):
        assert TC.pow2_replicas(r, mx) == JC.pow2_replicas(r, mx) == want


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_oracle_equals_reference_oracle(reference, name, mode):
    ref = reference[(name, mode)]
    got = _run("torch", name, mode)
    assert _actions(got) == _actions(ref)
    assert np.array_equal(got.waits, ref.waits, equal_nan=True)
    assert np.array_equal(got.lost, ref.lost)
    assert (got.served, got.shed) == (ref.served, ref.shed)
    assert got.avg_replicas == ref.avg_replicas
    assert got.objective == ref.objective and got.mean_wait == ref.mean_wait
    assert got.windows == ref.windows
    if mode == "adaptive" and name == "elastic":
        rs = [a.replicas for a in got.actions]
        assert min(rs) < max(rs) and set(rs) <= {1, 2, 4}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_fast_path_on_cpu_equals_reference_oracle(reference, name, mode):
    """The kernels' plain versions, one per replica a window: the same
    actions, waits within 1e-9 s."""
    ref = reference[(name, mode)]
    got = _run("torch", name, mode, fast=True)
    assert _actions(got) == _actions(ref)
    assert np.array_equal(got.lost, ref.lost)
    np.testing.assert_allclose(got.waits, ref.waits, rtol=0, atol=1e-9)
    assert abs(got.objective - ref.objective) <= 1e-9


def test_run_controlled_is_the_fast_driver_and_deterministic():
    pol, dist, lat, tm = _args("torch", "elastic")
    a = run_controlled(pol, 4.0, dist, lat, traffic=tm, device="cpu", **CELL)
    b = run_controlled(pol, 4.0, dist, lat, traffic=tm, device="cpu", **CELL)
    assert a.actions == b.actions
    assert np.array_equal(a.waits, b.waits)
    assert a.objective == b.objective
    f = TC.simulate_controlled(pol, 4.0, dist, lat, traffic=tm, fast=True,
                               device="cpu", **CELL)
    assert f.actions == a.actions and np.array_equal(f.waits, a.waits)


def test_single_window_fixed_r1_pins_plain_simulator():
    """One window, one replica, no shedding: the driver is the plain
    simulator (full-length waits, no warmup trim), in both packages."""
    kw = dict(num_requests=400, seed=9, window=1e9, fixed=(1, "round_robin"),
              fast=False)
    res = TC.simulate_controlled(
        TP.DynamicPolicy(8), 2.0, TD.LogNormalTokens(5.0, 0.6),
        TLM.BatchLatencyModel(**LAT),
        traffic=TT.SinusoidTraffic(amplitude=0.5, period=100.0), **kw)
    assert len(res.windows) == 1
    with no_warmup():
        base = simulate_policy(
            TP.DynamicPolicy(8), 2.0, TD.LogNormalTokens(5.0, 0.6),
            TLM.BatchLatencyModel(**LAT), num_requests=400, seed=9,
            traffic=TT.SinusoidTraffic(amplitude=0.5, period=100.0))
    np.testing.assert_array_equal(res.waits, base["waits"])
    with jax_no_warmup():
        jbase = jax_simulate_policy(
            JP.DynamicPolicy(8), 2.0, JD.LogNormalTokens(5.0, 0.6),
            JLM.BatchLatencyModel(**LAT), num_requests=400, seed=9,
            traffic=JT.SinusoidTraffic(amplitude=0.5, period=100.0))
    np.testing.assert_array_equal(res.waits, jbase["waits"])


def test_objective_accounting():
    res = _run("torch", "elastic", "adaptive", fast=True, shed_cost=2.0)
    n = res.served + res.shed
    expect = (res.mean_wait + res.replica_cost * res.avg_replicas
              + res.shed_cost * res.shed / n)
    assert abs(res.objective - expect) < 1e-9
    assert res.served + res.shed == len(res.waits)
    assert np.isnan(res.waits[res.lost]).all()


def test_overload_sheds_on_the_shed_lane():
    """At a rate past four replicas' capacity the controller sheds in
    several windows: the shed requests are the reference's, drawn from the
    traffic PRNG's shed lane, their waits NaN; the fast path sheds the
    same."""
    ref = _run("jax", "elastic", "adaptive", lam=16.0, num_requests=6_000)
    got = _run("torch", "elastic", "adaptive", lam=16.0, num_requests=6_000)
    assert got.shed > 0 and sum(a.shed_prob > 0 for a in got.actions) >= 2
    fast = _run("torch", "elastic", "adaptive", lam=16.0, num_requests=6_000,
                fast=True)
    assert _actions(fast) == _actions(ref)
    assert np.array_equal(fast.lost, ref.lost)
    assert _actions(got) == _actions(ref)
    assert np.array_equal(got.lost, ref.lost)
    assert np.array_equal(got.waits, ref.waits, equal_nan=True)


@pytest.mark.parametrize("bad", [
    dict(policy=("WaitPolicy", {"k": 4})),
    dict(policy=("FixedPolicy", {"b": 4})),
    dict(policy=("FCFSPolicy", {"tau": 5.0})),
    dict(fixed=(2, "round_robin"), clairvoyant=True),
    dict(window=0.0),
])
def test_refusals_raise_as_the_reference(bad):
    bad = dict(bad)
    cls, kw = bad.pop("policy", ("ElasticPolicy", {}))
    for P, D, LM, sim in ((TP, TD, TLM, TC.simulate_controlled),
                          (JP, JD, JLM, JC.simulate_controlled)):
        with pytest.raises(AssertionError):
            sim(getattr(P, cls)(**kw), 4.0, D.LogNormalTokens(5.0, 0.6),
                LM.BatchLatencyModel(**LAT), num_requests=200, fast=False,
                **bad)


def test_fast_driver_needs_a_gpu_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pol, dist, lat, tm = _args("torch", "elastic")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_controlled(pol, 4.0, dist, lat, traffic=tm, **CELL)
    # the oracle twin takes no device
    TC.simulate_controlled(pol, 4.0, dist, lat, traffic=tm, fast=False,
                           **CELL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_beats_best_static_multi_seed(seed):
    """``bench_autoscale.py``'s operating point over seeds (the reference's
    regret test), on the port's oracle: the adaptive objective is below
    every static power-of-two (R, router), equal to the reference's, and
    the regret against the clairvoyant run is finite and smaller than the
    best static objective."""
    kw = dict(traffic=TT.SinusoidTraffic(amplitude=0.9, period=2000.0),
              num_requests=32_000, seed=seed, window=200.0, max_replicas=8,
              replica_cost=5.0, fast=False)
    dist, lat = TD.LogNormalTokens(5.0, 0.8), TLM.BatchLatencyModel(**LAT)
    adaptive = TC.simulate_controlled(
        TP.ElasticPolicy(), 8.0, dist, lat,
        controller_kwargs={"replica_target_util": 0.4}, **kw)
    statics = [TC.simulate_controlled(TP.ElasticPolicy(), 8.0, dist, lat,
                                      fixed=(R, rt), **kw).objective
               for R in (1, 2, 4, 8) for rt in ("round_robin", "least_work")]
    assert adaptive.objective < min(statics), (seed, adaptive.objective,
                                               min(statics))
    clair = TC.simulate_controlled(TP.ElasticPolicy(), 8.0, dist, lat,
                                   clairvoyant=True, **kw)
    regret = adaptive.objective - clair.objective
    assert np.isfinite(regret) and abs(regret) < min(statics)
    jkw = dict(kw, traffic=JT.SinusoidTraffic(amplitude=0.9, period=2000.0))
    ref = JC.simulate_controlled(
        JP.ElasticPolicy(), 8.0, JD.LogNormalTokens(5.0, 0.8),
        JLM.BatchLatencyModel(**LAT),
        controller_kwargs={"replica_target_util": 0.4}, **jkw)
    assert _actions(adaptive) == _actions(ref)
    assert adaptive.objective == ref.objective
