"""The port's re-entrant sessions (``repro_torch.core.sessions``) on the
CPU, against the JAX package on equal seeds: the registry and spec forms,
the session plan and its salted PRNG lanes, the multi-turn expansion of
``make_request_stream``, the null models pinned to the session-free paths,
the feedback fixed point on the oracle and the fast path (single server and
fleet), shedding and fault-trace accounting, both schedulers'
``run_sessions``, and the analytic transfer (``mg1_feedback_wait``,
``feedback_policy_delay``).

The oracle and the serving layers are host NumPy on both sides: waits,
replicas and session rows must be EQUAL (``np.array_equal``).  The fast
path (``device="cpu"``: the kernels' plain versions, one launch a pass)
must equal the port's own oracle bit for bit, and the reference's compiled
path within 1e-9 s, the reference's own oracle-vs-fast tolerance
(``tests/test_sessions.py``), with equal replicas.

The reference's compiled scans run under ``jax.experimental.enable_x64``,
which JAX 0.9 removed; the ``x64`` fixture puts back a shim with
``monkeypatch`` (the JAX package is not edited)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

from repro.core import bulk as j_bulk  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fastsim as j_fast  # noqa: E402
from repro.core import faults as j_faults  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import mg1 as j_mg1  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import sessions as j_ses  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.serving import router as j_router  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import bulk as t_bulk  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import faults as t_faults  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import mg1 as t_mg1  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import sessions as t_ses  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.serving import metrics as t_metrics  # noqa: E402
from repro_torch.serving import router as t_router  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402

FAST_ATOL = 1e-9
LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
SINGLE = dict(a=0.0205, c=0.55)
GEO = {"name": "geometric", "p": 0.5, "think_mean": 2.0}
# tests/test_sessions.py's policies and routers, and a policy for each of
# the other batch kernels (S3, S4) and the backlog routers (S6)
POLICIES = {"dynamic": ("dynamic", {"b_max": 8}), "elastic": ("elastic", {}),
            "srpt": ("srpt", {"b_max": 8}), "multibin": ("multibin", {}),
            "wait": ("wait", {"k": 4, "timeout": 2.0})}
ROUTERS = ["session_affinity", "round_robin", "random", "least_work", "jsq"]
NONNULL = sorted(k for k, m in j_ses.default_sessions().items()
                 if not m.is_null)


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def ln():
    return j_dist.LogNormalTokens(5.0, 0.6), t_dist.LogNormalTokens(5.0, 0.6)


def lats(single=False):
    if single:
        return j_lat.LatencyModel(**SINGLE), t_lat.LatencyModel(**SINGLE)
    return j_lat.BatchLatencyModel(**LAT), t_lat.BatchLatencyModel(**LAT)


def pols(name):
    kind, kw = POLICIES.get(name, (name, {}))
    return j_pol.get_policy(kind, **kw), t_pol.get_policy(kind, **kw)


def clocks():
    return tuple(s.ModelClock(p.single_from_batch(l), l)
                 for s, p, l in zip((j_sched, t_sched), (j_pol, t_pol),
                                    lats()))


def models(name):
    return j_ses.default_sessions()[name], t_ses.default_sessions()[name]


def same_rows(js, ts):
    """Two session summaries: the counts equal and every row equal."""
    assert {k: v for k, v in ts.items() if k != "rows"} == \
        {k: v for k, v in js.items() if k != "rows"}
    assert set(ts["rows"]) == set(js["rows"])
    for k, v in js["rows"].items():
        assert np.array_equal(ts["rows"][k], v, equal_nan=True), k


def same_result(jr, tr, fast_vs_ref=False):
    """Two simulator results: scalars and waits equal (within FAST_ATOL
    against the reference's compiled path), replicas equal."""
    assert set(tr) == set(jr)
    if fast_vs_ref:
        np.testing.assert_allclose(tr["waits"], jr["waits"], rtol=0,
                                   atol=FAST_ATOL)
    else:
        assert np.array_equal(tr["waits"], jr["waits"])
        same_rows(jr["sessions"], tr["sessions"])
        for k in ("mean_wait", "p95_wait", "loss_frac", "mean_batch"):
            if k in jr:
                assert tr[k] == jr[k], k
    for k in ("replica_of", "replica_counts"):
        if k in jr:
            assert np.array_equal(tr[k], jr[k]), k
    assert tr["converged"] == jr["converged"]


# ----------------------------------------------------------------------------
# Registry, spec forms, plans, salted lanes, expansion
# ----------------------------------------------------------------------------

def test_registry_and_spec_forms_equal_reference():
    assert set(t_ses.SESSIONS) == set(j_ses.SESSIONS)
    for a, b in ((t_ses.default_sessions(), j_ses.default_sessions()),
                 (t_ses.null_sessions(), j_ses.null_sessions())):
        assert {k: repr(v) for k, v in a.items()} == \
            {k: repr(v) for k, v in b.items()}
        assert {k: (v.is_null, v.mean_turns()) for k, v in a.items()} == \
            {k: (v.is_null, v.mean_turns()) for k, v in b.items()}
    for spec in (None, "chain", GEO, {"name": "toolcall", "p": 0.3,
                                      "max_turns": 4}):
        t, j = t_ses.session_from_spec(spec), j_ses.session_from_spec(spec)
        assert repr(t) == repr(j) and t.is_null == j.is_null
    inst = t_ses.ChainSession(k=2)
    assert t_ses.session_from_spec(inst) is inst
    assert (t_ses._SESSION_SALT, t_ses._TURNS_LANE, t_ses._THINK_LANE,
            t_ses._TOKENS_LANE, t_ses._PROMPT_LANE, t_ses._SESSION_PRED_LANE,
            t_ses._MAX_PASSES, t_ses._TOL) == \
        (j_ses._SESSION_SALT, j_ses._TURNS_LANE, j_ses._THINK_LANE,
         j_ses._TOKENS_LANE, j_ses._PROMPT_LANE, j_ses._SESSION_PRED_LANE,
         j_ses._MAX_PASSES, j_ses._TOL)


@pytest.mark.parametrize("name", sorted(j_ses.SESSIONS))
@pytest.mark.parametrize("seed", [0, 7])
def test_plan_and_salted_lanes_equal_reference(name, seed):
    jm, tm = models(name)
    jp, tp = j_ses.plan_sessions(jm, 300, seed), t_ses.plan_sessions(
        tm, 300, seed)
    for f in ("session", "turn", "parent", "think", "turns", "offsets"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
    assert (tp.total, tp.n_sessions) == (jp.total, jp.n_sessions)
    for lane in (11, 13, 17):
        assert np.array_equal(t_ses._session_rng(seed, lane).random(5),
                              j_ses._session_rng(seed, lane).random(5))
    # the expansion of a sampled workload, with a predictor on the policy
    jd, td = ln()
    jpol, tpol = (m.DynamicPolicy(b_max=8, predictor="lognormal_noise")
                  for m in (j_pol, t_pol))
    jw, jpl = j_ses.expand_workload(
        jpol.sample_workload(1.0, jd, 300, seed), jm, jd, jpol, seed)
    tw, tpl = t_ses.expand_workload(
        tpol.sample_workload(1.0, td, 300, seed), tm, td, tpol, seed)
    for f in ("arrivals", "tokens", "predicted", "session", "turn"):
        assert np.array_equal(getattr(tw, f), getattr(jw, f)), f


@pytest.mark.parametrize("spec", [GEO, "chain", "toolcall",
                                  {"name": "geometric", "p": 0.0},
                                  {"name": "chain", "k": 1}])
@pytest.mark.parametrize("kw", [{}, {"prompt_len_corr": 0.5,
                                     "traffic": "mmpp"}])
def test_make_request_stream_sessions_row_for_row(spec, kw):
    jd, td = ln()
    js = j_pipe.make_request_stream(150, 1.0, jd, vocab=256, seed=8,
                                    sessions=spec, **kw)
    ts = t_pipe.make_request_stream(150, 1.0, td, vocab=256, seed=8,
                                    sessions=spec, **kw)
    assert len(ts) == len(js)
    for a, b in zip(js, ts):
        assert (b.rid, b.arrival, b.target_output_tokens, b.session, b.turn,
                b.think) == (a.rid, a.arrival, a.target_output_tokens,
                             a.session, a.turn, a.think)
        assert np.array_equal(b.prompt_tokens, a.prompt_tokens)
    null = t_ses.session_from_spec(spec).is_null
    assert (len(ts) == 150) == null
    assert all(r.session == -1 for r in ts) == null


# ----------------------------------------------------------------------------
# Null models: bit-equal to the session-free paths, on every layer
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(j_ses.SESSIONS))
def test_null_models_pin_every_layer(name):
    sm = t_ses.null_sessions()[name]
    _, td = ln()
    _, tl = lats()
    pol = t_pol.DynamicPolicy(8)
    kw = dict(num_requests=300, seed=2)
    base = t_sim.simulate_policy(pol, 0.4, td, tl, **kw)
    assert np.array_equal(
        base["waits"],
        t_sim.simulate_policy(pol, 0.4, td, tl, sessions=sm, **kw)["waits"])
    fast = t_fast.simulate_policy_fast(pol, 0.4, td, tl, device="cpu", **kw)
    assert np.array_equal(fast["waits"], t_fast.simulate_policy_fast(
        pol, 0.4, td, tl, device="cpu", sessions=sm, **kw)["waits"])
    for router in ("least_work", "random"):
        for run, extra in ((t_fleet.route_oracle, {}),
                           (t_fast.simulate_fleet_fast, {"device": "cpu"})):
            a = run(router, pol, 3.0, 2, td, tl, **kw, **extra)
            b = run(router, pol, 3.0, 2, td, tl, sessions=sm, **kw, **extra)
            assert np.array_equal(a["replica_of"], b["replica_of"])
            assert a["mean_wait"] == b["mean_wait"]


def test_null_models_pin_schedulers():
    _, td = ln()
    _, tc = clocks()
    base = t_pipe.make_request_stream(120, 1.0, td, vocab=256, seed=4)
    null = t_pipe.make_request_stream(120, 1.0, td, vocab=256, seed=4,
                                      sessions={"name": "chain", "k": 1})
    sch = t_sched.PolicyScheduler(t_pol.DynamicPolicy(8), tc)
    rn = sch.run_sessions(null)
    assert rn.sessions is None
    assert np.array_equal(sch.run(base).waits, rn.waits)
    fl = t_router.FleetScheduler("session_affinity", t_pol.DynamicPolicy(8),
                                 tc, R=3)
    f0, fn = fl.run(base), fl.run_sessions(null)
    assert fn.sessions is None
    assert np.array_equal(f0.waits, fn.waits)
    assert np.array_equal(f0.replica_of, fn.replica_of)


# ----------------------------------------------------------------------------
# The feedback fixed point: oracle and fast, single server and fleet
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("model", NONNULL)
@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_policy_sessions_equal_reference(x64, model, pol):
    jm, tm = models(model)
    jd, td = ln()
    jl, tl = lats()
    jp, tp = pols(pol)
    jo = j_ses.simulate_policy_sessions(jp, 1.2, jd, jl, 250, 11, jm)
    to = t_ses.simulate_policy_sessions(tp, 1.2, td, tl, 250, 11, tm)
    same_result(jo, to)
    assert to["converged"]
    jf = j_ses.simulate_policy_sessions(jp, 1.2, jd, jl, 250, 11, jm,
                                        fast=True)
    K.reset_launches()
    tf = t_ses.simulate_policy_sessions(tp, 1.2, td, tl, 250, 11, tm,
                                        fast=True, device="cpu")
    assert sum(K.LAUNCHES.values()) == 0        # the plain versions ran
    assert np.array_equal(tf["waits"], to["waits"])
    assert tf["passes"] == to["passes"]
    same_rows(to["sessions"], tf["sessions"])
    same_result(jf, tf, fast_vs_ref=True)


@pytest.mark.parametrize("model", NONNULL)
@pytest.mark.parametrize("router", ROUTERS)
def test_fleet_sessions_equal_reference(x64, model, router):
    jm, tm = models(model)
    jd, td = ln()
    jl, tl = lats()
    jp, tp = pols("dynamic")
    kw = dict(prefix_discount=0.5)
    jo = j_ses.simulate_fleet_sessions(router, jp, 1.5, 3, jd, jl, 250, 13,
                                       jm, **kw)
    to = t_ses.simulate_fleet_sessions(router, tp, 1.5, 3, td, tl, 250, 13,
                                       tm, **kw)
    same_result(jo, to)
    jf = j_ses.simulate_fleet_sessions(router, jp, 1.5, 3, jd, jl, 250, 13,
                                       jm, fast=True, **kw)
    tf = t_ses.simulate_fleet_sessions(router, tp, 1.5, 3, td, tl, 250, 13,
                                       tm, fast=True, device="cpu", **kw)
    assert np.array_equal(tf["waits"], to["waits"])
    assert np.array_equal(tf["replica_of"], to["replica_of"])
    same_result(jf, tf, fast_vs_ref=True)


@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_public_entry_points_dispatch_to_the_fixed_point(x64, gamma):
    """``simulate_policy``/``simulate_policy_fast`` and ``route_oracle``/
    ``simulate_fleet_fast`` with ``sessions=`` equal the reference's."""
    jd, td = ln()
    jl, tl = lats()
    jp, tp = pols("dynamic")
    kw = dict(num_requests=250, seed=13, sessions=GEO, prefix_discount=gamma)
    same_result(j_sim.simulate_policy(jp, 0.8, jd, jl, **kw),
                t_sim.simulate_policy(tp, 0.8, td, tl, **kw))
    same_result(j_fast.simulate_policy_fast(jp, 0.8, jd, jl, **kw),
                t_fast.simulate_policy_fast(tp, 0.8, td, tl, device="cpu",
                                            **kw), fast_vs_ref=True)
    for router in ("session_affinity", "least_work"):
        jo = j_fleet.route_oracle(router, jp, 1.5, 3, jd, jl, **kw)
        to = t_fleet.route_oracle(router, tp, 1.5, 3, td, tl, **kw)
        same_result(jo, to)
        tf = t_fast.simulate_fleet_fast(router, tp, 1.5, 3, td, tl,
                                        device="cpu", **kw)
        assert np.array_equal(tf["waits"], to["waits"])
        same_result(j_fast.simulate_fleet_fast(router, jp, 1.5, 3, jd, jl,
                                               **kw), tf, fast_vs_ref=True)


# ----------------------------------------------------------------------------
# Shedding and fault-trace accounting
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_shedding_equals_reference(fast):
    jd, td = ln()
    jl, tl = lats(single=True)
    jp, tp = (m.FCFSPolicy(tau=5.0) for m in (j_pol, t_pol))
    dev = {"device": "cpu"} if fast else {}
    jr = j_ses.simulate_policy_sessions(jp, 0.3, jd, jl, 400, 3,
                                        j_ses.session_from_spec(GEO),
                                        fast=fast)
    tr = t_ses.simulate_policy_sessions(tp, 0.3, td, tl, 400, 3,
                                        t_ses.session_from_spec(GEO),
                                        fast=fast, **dev)
    same_result(jr, tr)
    s = tr["sessions"]
    assert s["turns_arrived"] == s["turns_served"] + s["turns_lost"]
    assert 0.0 < tr["loss_frac"] < 1.0
    # the fleet's shedding runs the per-replica pass (S2 on the fast path)
    jf = j_ses.simulate_fleet_sessions("round_robin", jp, 0.9, 3, jd, jl,
                                       250, 7, j_ses.session_from_spec(GEO))
    tf = t_ses.simulate_fleet_sessions("round_robin", tp, 0.9, 3, td, tl,
                                       250, 7, t_ses.session_from_spec(GEO),
                                       fast=fast, **dev)
    assert np.array_equal(tf["waits"], jf["waits"])
    same_rows(jf["sessions"], tf["sessions"])
    assert tf["loss_frac"] == jf["loss_frac"]


def test_fault_trace_composes_equal_reference(x64):
    jd, td = ln()
    jl, tl = lats()
    jp, tp = pols("dynamic")
    jt, tt = (m.Slowdown(mtbf=40.0, duration=10.0, factor=4.0).trace(
        11, 0, 5000.0) for m in (j_faults, t_faults))
    jo = j_ses.simulate_policy_sessions(jp, 1.0, jd, jl, 250, 5,
                                        j_ses.session_from_spec(GEO),
                                        fault_trace=jt)
    to = t_ses.simulate_policy_sessions(tp, 1.0, td, tl, 250, 5,
                                        t_ses.session_from_spec(GEO),
                                        fault_trace=tt)
    same_result(jo, to)
    tf = t_ses.simulate_policy_sessions(tp, 1.0, td, tl, 250, 5,
                                        t_ses.session_from_spec(GEO),
                                        fault_trace=tt, fast=True,
                                        device="cpu")
    assert np.array_equal(tf["waits"], to["waits"])


def test_unsupported_compositions_raise():
    _, td = ln()
    _, tl = lats()
    _, tc = clocks()
    for pol in (t_pol.ContinuousPolicy(), t_pol.FixedPolicy(b=4)):
        with pytest.raises(ValueError):
            t_ses.check_policy_supports_sessions(pol)
    pol = t_pol.DynamicPolicy(8)
    wl = pol.sample_workload(1.0, td, 50, seed=0)
    for run in (t_sim.simulate_policy,
                lambda *a, **k: t_fast.simulate_policy_fast(*a, device="cpu",
                                                            **k)):
        with pytest.raises(ValueError):
            run(pol, 1.0, td, tl, workload=wl, sessions=GEO)
    reqs = t_pipe.make_request_stream(40, 1.0, td, vocab=64, seed=1,
                                      sessions=GEO)
    with pytest.raises(ValueError):
        t_router.FleetScheduler("random", pol, tc, R=2,
                                faults="crash").run_sessions(reqs)


# ----------------------------------------------------------------------------
# The serving layer: both schedulers' run_sessions
# ----------------------------------------------------------------------------

def _same_schedule(jr, tr):
    for f in ("waits", "e2e", "lost"):
        assert np.array_equal(getattr(tr, f), getattr(jr, f)), f
    assert tr.batch_sizes == jr.batch_sizes and tr.makespan == jr.makespan
    same_rows(jr.sessions, tr.sessions)


@pytest.mark.parametrize("pol", ["dynamic", "srpt", "fcfs_tau"])
@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_policy_scheduler_run_sessions_equals_reference(pol, gamma):
    jd, td = ln()
    jc, tc = clocks()
    jreqs, treqs = (p.make_request_stream(100, 1.0, d, vocab=256, seed=4,
                                          sessions=GEO)
                    for p, d in ((j_pipe, jd), (t_pipe, td)))
    if pol == "fcfs_tau":
        js, ts = (s.FCFSScheduler(c, tau=5.0)
                  for s, c in ((j_sched, jc), (t_sched, tc)))
    else:
        jp, tp = pols(pol)
        js, ts = j_sched.PolicyScheduler(jp, jc), t_sched.PolicyScheduler(
            tp, tc)
    jr = js.run_sessions(jreqs, prefix_discount=gamma)
    tr = ts.run_sessions(treqs, prefix_discount=gamma)
    _same_schedule(jr, tr)
    s = tr.sessions
    assert s["turns_arrived"] == s["turns_served"] + s["turns_lost"]
    m = t_metrics.summarize(tr)
    assert m["n_sessions"] == 100 and "mean_session_e2e" in m


@pytest.mark.parametrize("router", ["session_affinity", "round_robin",
                                    "random", "least_work"])
@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_fleet_scheduler_run_sessions_equals_reference(router, gamma):
    jd, td = ln()
    jc, tc = clocks()
    jreqs, treqs = (p.make_request_stream(100, 1.0, d, vocab=256, seed=4,
                                          sessions=GEO)
                    for p, d in ((j_pipe, jd), (t_pipe, td)))
    jr = j_router.FleetScheduler(router, j_pol.DynamicPolicy(8), jc,
                                 R=3).run_sessions(jreqs,
                                                   prefix_discount=gamma)
    tr = t_router.FleetScheduler(router, t_pol.DynamicPolicy(8), tc,
                                 R=3).run_sessions(treqs,
                                                   prefix_discount=gamma)
    _same_schedule(jr, tr)
    assert np.array_equal(tr.replica_of, jr.replica_of)
    assert t_router.summarize_fleet(tr) == j_router.summarize_fleet(jr)
    assert len(tr.waits) == len(treqs)


# ----------------------------------------------------------------------------
# Analytics: the λ_eff = λ·E[turns] transfer
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [GEO, "chain", "toolcall", "single",
                                  {"name": "geometric", "p": 0.0}])
@pytest.mark.parametrize("lam", [0.05, 0.15])
def test_feedback_analytics_equal_reference(spec, lam):
    jd, td = ln()
    js, ts = lats(single=True)
    jb, tb = lats()
    for n_max in (None, 400):
        assert dataclasses.asdict(t_mg1.mg1_feedback_wait(
            td, ts, lam, spec, n_max)) == dataclasses.asdict(
            j_mg1.mg1_feedback_wait(jd, js, lam, spec, n_max))
    for name, law in (("fcfs", (js, ts)), ("dynamic", (jb, tb)),
                      ("srpt", (jb, tb))):
        jp, tp = pols(name)
        assert t_bulk.feedback_policy_delay(tp, lam, td, law[1], spec) == \
            j_bulk.feedback_policy_delay(jp, lam, jd, law[0], spec)
    noisy = [m.SRPTPolicy(b_max=8, predictor="lognormal_noise")
             for m in (j_pol, t_pol)]
    out = t_bulk.feedback_policy_delay(noisy[1], lam, td, tb, spec)
    assert out == j_bulk.feedback_policy_delay(noisy[0], lam, jd, jb, spec)
    assert out["wait"] is None and not out["stable"]


def test_fast_session_entry_points_need_a_gpu(monkeypatch):
    """The fast path runs on the card unless the CPU is asked for; the
    oracle is host NumPy and takes no device."""
    _, td = ln()
    _, tl = lats()
    pol = t_pol.DynamicPolicy(8)
    sm = t_ses.session_from_spec(GEO)
    calls = {
        "simulate_policy_sessions": lambda **k: t_ses.simulate_policy_sessions(
            pol, 0.5, td, tl, 60, 1, sm, fast=True, **k),
        "simulate_fleet_sessions": lambda **k: t_ses.simulate_fleet_sessions(
            "least_work", pol, 0.5, 2, td, tl, 60, 1, sm, fast=True, **k),
        "simulate_policy_fast": lambda **k: t_fast.simulate_policy_fast(
            pol, 0.5, td, tl, num_requests=60, seed=1, sessions=sm, **k),
        "simulate_fleet_fast": lambda **k: t_fast.simulate_fleet_fast(
            "least_work", pol, 0.5, 2, td, tl, num_requests=60, seed=1,
            sessions=sm, **k),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert call(device="cpu")["converged"], name
    assert t_ses.simulate_policy_sessions(pol, 0.5, td, tl, 60, 1,
                                          sm)["converged"]
    assert t_fleet.route_oracle("least_work", pol, 0.5, 2, td, tl,
                                num_requests=60, seed=1,
                                sessions=sm)["converged"]
