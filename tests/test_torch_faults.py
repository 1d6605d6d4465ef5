"""The port's fault models on the CPU against the JAX package on equal
seeds: the registry, replica traces and their operational-time transform,
availability masks, masked routing (kernel S6's masked plain version
included), single-server fault injection, the fault-injected fleet simulation
on the oracle and the fast path, and ``bulk.breakdown_wait``.

Fault epochs, masks, assignments and the oracle's waits must be EQUAL
(``np.array_equal``).  The fast path (``device="cpu"``) equals the port's
own oracle and the reference's compiled path within ``SCAN_ATOL`` = 1e-10
s, with equal assignments, retries and served sets; the analytic forms
agree within 1e-12 relative.  The serving layer's resilience path
(``repro_torch.serving.resilience``) is tested in
``tests/test_torch_resilience.py``.

The reference's compiled scans run under ``jax.experimental.enable_x64``,
which JAX 0.9 removed; the ``x64`` fixture puts back a shim with
``monkeypatch`` (the JAX package is not edited)."""

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
from repro.core import policies as j_pol  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402

from repro_torch.core import bulk as t_bulk  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import faults as t_faults  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402

SCAN_ATOL = 1e-10
RTOL = 1e-12
LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
FAULTS = {"none": {"kind": "none"},
          "crash": {"kind": "crash", "mtbf": 100.0, "mttr": 15.0},
          "crash_resume": {"kind": "crash", "mtbf": 60.0, "mttr": 20.0,
                           "lose_work": False},
          "slowdown": {"kind": "slowdown", "mtbf": 40.0, "duration": 15.0,
                       "factor": 4.0},
          "drop": {"kind": "drop", "p": 0.1}}
ROUTERS = ("random", "round_robin", "power_of_d", "jsq", "least_work",
           "session_affinity")


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def faults(key):
    return (j_faults.fault_from_spec(dict(FAULTS[key])),
            t_faults.fault_from_spec(dict(FAULTS[key])))


def ln():
    return j_dist.LogNormalTokens(7.0, 0.7), t_dist.LogNormalTokens(7.0, 0.7)


def lats():
    return j_lat.BatchLatencyModel(**LAT), t_lat.BatchLatencyModel(**LAT)


def close(a, b, tol=RTOL):
    if a == b:
        return
    assert abs(a - b) <= tol * max(1.0, abs(a), abs(b)), (a, b)


def test_registry_and_spec_forms_equal_reference():
    assert set(t_faults.FAULTS) == set(j_faults.FAULTS)
    assert {k: repr(v) for k, v in t_faults.default_faults().items()} == \
        {k: repr(v) for k, v in j_faults.default_faults().items()}
    assert t_faults.fault_from_spec(None).is_null
    for key in FAULTS:
        jf, tf = faults(key)
        assert repr(tf) == repr(jf) and tf.is_null == jf.is_null
        assert tf.capacity() == jf.capacity()
        assert t_faults.effective_lambda(2.0, tf) == \
            j_faults.effective_lambda(2.0, jf)


@pytest.mark.parametrize("key", sorted(FAULTS))
def test_traces_and_transforms_equal_reference(key):
    """Episodes on the salted fault stream, the drop mask, and every
    transform of the trace, on the same times."""
    jf, tf = faults(key)
    t = np.sort(np.random.default_rng(1).uniform(0.0, 3000.0, 2000))
    t[::50] = 0.0
    t.sort()
    for seed in (0, (3, 1)):
        for r in range(3):
            jt, tt = jf.trace(seed, r, 2500.0), tf.trace(seed, r, 2500.0)
            assert np.array_equal(jt.starts, tt.starts)
            assert np.array_equal(jt.ends, tt.ends)
            assert jt.speed == tt.speed and jt.empty == tt.empty
            if tt.empty:
                continue
            pts = np.concatenate([t, tt.starts, tt.ends])
            for fn in ("op_time", "up_at", "next_up"):
                assert np.array_equal(getattr(jt, fn)(pts),
                                      getattr(tt, fn)(pts)), fn
            u = tt.op_time(pts)
            assert np.array_equal(jt.wall_time(u), tt.wall_time(u))
            assert np.array_equal(jt.crash_starts(), tt.crash_starts())
            assert jt.availability(2500.0) == tt.availability(2500.0)
        assert np.array_equal(jf.drop_mask(seed, 700), tf.drop_mask(seed, 700))
    # the renewal draw itself, blocks and horizon cut included
    for up, down, h in ((5.0, 1.0, 400.0), (50.0, np.inf, 300.0),
                        (np.inf, 3.0, 10.0)):
        a = j_faults._renewal_episodes(np.random.default_rng(2), up, down, h)
        b = t_faults._renewal_episodes(np.random.default_rng(2), up, down, h)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _masked_case(seed, n=600, R=3):
    jf, tf = faults("crash")
    arr = np.cumsum(np.random.default_rng(seed).exponential(0.3, n))
    jtr = [jf.trace(seed, r, 2 * arr[-1]) for r in range(R)]
    ttr = [tf.trace(seed, r, 2 * arr[-1]) for r in range(R)]
    dead = t_faults.ReplicaTrace(np.array([0.0]), np.array([80.0]), 0.0)
    jdead = j_faults.ReplicaTrace(np.array([0.0]), np.array([80.0]), 0.0)
    return arr, jtr + [jdead], ttr + [dead]


@pytest.mark.parametrize("rname", ROUTERS)
def test_up_matrix_and_masked_assign_equal_reference(rname):
    arr, jtr, ttr = _masked_case(4)
    R = len(ttr)
    up = t_faults.up_matrix(ttr, arr)
    assert np.array_equal(up, j_faults.up_matrix(jtr, arr))
    assert up.any(axis=1).all() and not up[arr < 80.0, -1].any()
    work = np.random.default_rng(5).exponential(2.0, len(arr))
    jr = j_faults.masked_assign(rname, arr, work, R, 3, up)
    tr = t_faults.masked_assign(rname, arr, work, R, 3, up)
    launch = {}
    fr = t_faults.masked_assign(rname, arr, work, R, 3, up, fast=True,
                                device="cpu", launch_out=launch)
    assert np.array_equal(jr, tr) and np.array_equal(tr, fr)
    assert up[np.arange(len(arr)), tr].all()
    if t_fleet.router_from_spec(rname).state_dependent:
        assert launch["kernel"] == "backlog_scan"
        assert launch["args"][3].shape == (len(arr), R, 1)
    rep = t_fleet.router_from_spec(rname).assign(arr, work, R, 3)
    assert np.array_equal(t_faults.replay_backlog(arr, work, rep, R, t=500.0),
                          j_faults.replay_backlog(arr, work, rep, R, t=500.0))


def test_masked_route_on_kernel_plain_version_equals_numpy():
    """Masked S6 (plain version, one lane) against the reference's NumPy
    recursion, a row with every replica down included."""
    rng = np.random.default_rng(0)
    for n, R in ((1, 2), (37, 3), (2000, 4)):
        arr = np.cumsum(rng.exponential(0.3, n))
        work = rng.exponential(1.0, n)
        up = rng.random((n, R)) > 0.4
        up[n // 2] = False
        assert np.array_equal(
            t_fast.masked_backlog_route(arr, work, up, R, device="cpu"),
            j_fleet._masked_backlog_assign_np(arr, work, R, up))
        assert np.array_equal(
            t_fast.masked_backlog_route(arr, work, np.ones((n, R), bool), R,
                                        device="cpu"),
            t_fast.backlog_route(arr, work, R, device="cpu"))


@pytest.mark.parametrize("pname", ["dynamic", "srpt", "fcfs"])
def test_single_server_fault_trace_equals_reference(x64, pname):
    jd, td = ln()
    jl, tl = lats()
    jp, tp = (m.get_policy(pname, **({} if pname == "fcfs" else
                                     {"b_max": 16})) for m in (j_pol, t_pol))
    jf, tf = faults("crash")
    jtr, ttr = jf.trace(11, 0, 10_000.0), tf.trace(11, 0, 10_000.0)
    kw = dict(num_requests=1500, seed=6)
    jo = j_sim.simulate_policy(jp, 2.0, jd, jl, fault_trace=jtr, **kw)
    to = t_sim.simulate_policy(tp, 2.0, td, tl, fault_trace=ttr, **kw)
    assert np.array_equal(jo["waits"], to["waits"])
    assert jo["mean_wait"] == to["mean_wait"]
    tfast = t_fast.simulate_policy_fast(tp, 2.0, td, tl, fault_trace=ttr,
                                        device="cpu", **kw)
    jfast = j_fast.simulate_policy_fast(jp, 2.0, jd, jl, fault_trace=jtr,
                                        **kw)
    assert np.array_equal(tfast["waits"], to["waits"])
    np.testing.assert_allclose(tfast["waits"], jfast["waits"], rtol=0,
                               atol=SCAN_ATOL)
    base = t_sim.simulate_policy(tp, 2.0, td, tl, **kw)
    assert to["mean_wait"] >= base["mean_wait"]


def _same_faulty(a, b, exact):
    for k in ("shed", "retries", "failed", "unserved", "n_arrived",
              "n_served"):
        assert a[k] == b[k], k
    assert a["availability"] == b["availability"]
    assert np.array_equal(a["replica_of"], b["replica_of"])
    if "served_mask" not in a:      # a null model: the fault-free fleet's
        for x, y in zip(a["per_replica"], b["per_replica"]):   # result
            np.testing.assert_allclose(x["waits"], y["waits"], rtol=0,
                                       atol=0 if exact else SCAN_ATOL)
        return
    assert np.array_equal(a["served_mask"], b["served_mask"])
    m = a["served_mask"]
    if exact:
        assert np.array_equal(a["waits_by_request"][m],
                              b["waits_by_request"][m])
        assert a["mean_wait"] == b["mean_wait"]
    else:
        np.testing.assert_allclose(a["waits_by_request"][m],
                                   b["waits_by_request"][m], rtol=0,
                                   atol=SCAN_ATOL)


@pytest.mark.parametrize("key", sorted(FAULTS))
@pytest.mark.parametrize("rname", ROUTERS)
def test_faulty_fleet_equals_reference(x64, rname, key):
    """The fault-injected fleet on the oracle (bit for bit) and the fast
    path (S6 masked routing, then the kernels per replica), conservation
    included."""
    jd, td = ln()
    jl, tl = lats()
    jf, tf = faults(key)
    pol = ("fixed", {"b": 8}) if rname == "round_robin" else \
        ("dynamic", {"b_max": 16})
    jp, tp = (m.get_policy(pol[0], **pol[1]) for m in (j_pol, t_pol))
    kw = dict(num_requests=600, seed=2, traffic="mmpp")
    jo = j_faults.simulate_fleet_faulty(rname, jp, 4.0, 3, jd, jl, jf, **kw)
    to = t_faults.simulate_fleet_faulty(rname, tp, 4.0, 3, td, tl, tf, **kw)
    _same_faulty(jo, to, exact=True)
    assert (to["n_served"] + to["shed"] + to["failed"] + to["unserved"]
            == to["n_arrived"])
    launch = {}
    tfast = t_faults.simulate_fleet_faulty(rname, tp, 4.0, 3, td, tl, tf,
                                           fast=True, device="cpu",
                                           launch_out=launch, **kw)
    jfast = j_faults.simulate_fleet_faulty(rname, jp, 4.0, 3, jd, jl, jf,
                                           fast=True, **kw)
    _same_faulty(jfast, tfast, exact=False)
    _same_faulty(to, tfast, exact=False)
    assert bool(launch) == t_fleet.router_from_spec(rname).state_dependent
    if key == "none":       # the null model is the fault-free fleet
        ref = t_fleet.route_oracle(rname, tp, 4.0, 3, td, tl, **kw)
        assert np.array_equal(to["replica_of"], ref["replica_of"])
        assert to["mean_wait"] == ref["mean_wait"]
    if key == "crash":
        assert to["retries"] > 0


def test_crash_tie_cell_parts_where_the_reference_parts(x64):
    """chip_smoke's phase 8b(e) crash cell (least_work + dynamic b16, λ = 4,
    R = 3, mtbf 60, mttr 20, 5,000 requests, seed 3).  A repair maps its
    queued arrivals to one instant; the batching scan lets a request that
    arrives at its batch's start join it, the oracle's idle server starts
    the head alone (ROADMAP queue 3).  So each package's fast path parts
    from its oracle here, and it must part at the same requests by the same
    amounts in both: the port's oracle equals the reference's and the
    port's fast path the reference's, bit for bit, over the whole lane."""
    jd, td = ln()
    jl, tl = lats()
    cell = {"kind": "crash", "mtbf": 60.0, "mttr": 20.0}
    jf, tf = j_faults.fault_from_spec(dict(cell)), \
        t_faults.fault_from_spec(dict(cell))
    jp, tp = j_pol.DynamicPolicy(16), t_pol.DynamicPolicy(16)
    kw = dict(num_requests=5000, seed=3)
    jo, jfast = (j_faults.simulate_fleet_faulty(
        "least_work", jp, 4.0, 3, jd, jl, jf, fast=fast, **kw)
        for fast in (False, True))
    to = t_faults.simulate_fleet_faulty("least_work", tp, 4.0, 3, td, tl, tf,
                                        **kw)
    tfast = t_faults.simulate_fleet_faulty("least_work", tp, 4.0, 3, td, tl,
                                           tf, fast=True, device="cpu", **kw)
    _same_faulty(jo, to, exact=True)
    _same_faulty(jfast, tfast, exact=True)
    assert to["retries"] > 0

    def parted(oracle, fast):
        assert np.array_equal(oracle["served_mask"], fast["served_mask"])
        w, f = oracle["waits_by_request"], fast["waits_by_request"]
        at = np.flatnonzero(w != f)
        return at, f[at] - w[at]

    (j_at, j_by), (t_at, t_by) = parted(jo, jfast), parted(to, tfast)
    assert np.array_equal(t_at, j_at) and np.array_equal(t_by, j_by)
    assert len(t_at) == 3 and (t_by < 0).all()       # joined a batch early
    assert np.max(np.abs(t_by)) == pytest.approx(0.878, abs=5e-4)


def test_breakdown_wait_equals_reference():
    jd, td = ln()
    jl, tl = lats()
    js, ts = j_pol.single_from_batch(jl), t_pol.single_from_batch(tl)
    for mtbf, mttr, lam, R in ((300.0, 12.0, 0.02, 1), (400.0, 5.0, 4.0, 3),
                               (60.0, 20.0, 4.0, 3), (1e12, 1e-6, 0.02, 1)):
        a = j_bulk.breakdown_wait(jd, js, lam, mtbf, mttr, R=R)
        b = t_bulk.breakdown_wait(td, ts, lam, mtbf, mttr, R=R)
        assert a.keys() == b.keys() and a["kind"] == b["kind"] == "exact"
        for k in a:
            close(a[k], b[k]) if isinstance(a[k], float) else \
                (a[k] == b[k]) or pytest.fail(k)
        for pname, kw in (("dynamic", {"b_max": 16}), ("elastic", {}),
                          ("srpt", {"b_max": 16})):
            a = j_bulk.breakdown_wait(jd, jl, lam, mtbf, mttr, R=R,
                                      policy=j_pol.get_policy(pname, **kw))
            b = t_bulk.breakdown_wait(td, tl, lam, mtbf, mttr, R=R,
                                      policy=t_pol.get_policy(pname, **kw))
            assert a["kind"] == b["kind"] == "envelope"
            assert a["stable"] == b["stable"]
            close(a["wait"], b["wait"])
            close(a["lam_eff"], b["lam_eff"])
