"""The port's KV-memory layer on the CPU (``repro_torch.core.memory``, the
tandem's ``stage_split``, ``simulate_policy(memory=)``, kernel S7's plain
version behind ``simulate_policy_fast(memory=)``, the fleet,
``bulk.tandem_bound``, the controller's memory axis and the schedulers under
a budget) against the JAX package on equal seeds.  Every case of the
reference's ``tests/test_memory.py`` has a counterpart here, the hypothesis
properties included; the engine layer under a budget
(``run_engine_schedule(memory=)``, ``run_fleet_schedule(memory=)``) is held
to the reference in ``tests/test_torch_engine.py`` and
``tests/test_torch_fleet.py``, beside the engines those files build.

The oracle's waits, completions, batch sizes and occupancy blocks must be
EQUAL (``np.array_equal``, ``==``).  S7's plain version (``device="cpu"``)
equals the port's oracle bit for bit; the reference's compiled tandem loop
(``_tandem_loop``) contracts its batch time into fused multiply-adds under
XLA, so the port is held to it within ``SCAN_ATOL`` = 1e-10 s with its
integers (blocked batches, deferred requests) equal.  At ``b_max = 0`` the
oracle reads no cap and the reference's loop caps every batch at one
(ROADMAP.md queue 3): the port follows its oracle there.  Analytic forms
agree within 1e-12 relative.

The reference's compiled loops run under ``jax.experimental.enable_x64``,
which JAX 0.9 removed; the ``x64`` fixture puts back a shim with
``monkeypatch`` (the JAX package is not edited)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import bulk as j_bulk  # noqa: E402
from repro.core import control as j_ctl  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fastsim as j_fast  # noqa: E402
from repro.core import faults as j_faults  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import memory as j_mem  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import sessions as j_sess  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.serving import metrics as j_metrics  # noqa: E402
from repro.serving import router as j_router  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import bulk as t_bulk  # noqa: E402
from repro_torch.core import control as t_ctl  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import faults as t_faults  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import memory as t_mem  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import sessions as t_sess  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels.batch_scan import NO_CAP  # noqa: E402
from repro_torch.kernels.tandem_scan import tandem_scan  # noqa: E402
from repro_torch.serving import metrics as t_metrics  # noqa: E402
from repro_torch.serving import router as t_router  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402

SCAN_ATOL = 1e-10
RTOL = 1e-12
LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
LAT1 = dict(a=0.0212, c=1.79)
# non-integer budgets dodge searchsorted ties in the release ledger
M_TIGHT = 1777.25
M_MID = 4000.25
NULL_SPECS = [None, "budget", "inf-budget", np.inf]
# the batch-formation policies the tandem gates (oracle_kind "batches")
BATCH_POLICIES = ["dynamic", "dynamic_b8", "elastic", "fixed_b4",
                  "multibin_4", "wait_k8", "srpt_b8"]


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def uni():
    return j_dist.UniformTokens(1000), t_dist.UniformTokens(1000)


def lats():
    return j_lat.BatchLatencyModel(**LAT), t_lat.BatchLatencyModel(**LAT)


def clocks():
    jl, tl = lats()
    return (j_sched.ModelClock(j_lat.LatencyModel(**LAT1), jl),
            t_sched.ModelClock(t_lat.LatencyModel(**LAT1), tl))


def pols(name):
    return j_pol.default_policies()[name], t_pol.default_policies()[name]


def null_spec(spec, mem):
    """A null budget spec, built in ``mem``'s package where it is one."""
    return {"budget": lambda: mem.MemoryBudget(),
            "inf-budget": lambda: mem.MemoryBudget(capacity=np.inf)}.get(
        spec, lambda: spec)()


def close(a, b, tol=RTOL):
    if a == b:                      # equal infinities too
        return
    assert abs(a - b) <= tol * max(1.0, abs(a), abs(b)), (a, b)


def same_oracle(jr, tr):
    """Two tandem-oracle results, equal field for field."""
    for k in ("waits", "waits_all", "completions"):
        assert np.array_equal(jr[k], tr[k]), k
    assert jr["batch_sizes"] == tr["batch_sizes"]
    assert jr["memory"] == tr["memory"]
    for k in ("mean_wait", "p95_wait", "mean_batch"):
        assert jr[k] == tr[k], k


def same_fast(jr, tr):
    """The port's fast tandem against the reference's compiled loop."""
    np.testing.assert_allclose(tr["waits"], jr["waits"], rtol=0,
                               atol=SCAN_ATOL)
    for k in ("blocked_batches", "deferred_requests"):
        assert tr["memory"][k] == jr["memory"][k], k
    close(tr["memory"]["kv_peak"], jr["memory"]["kv_peak"])
    assert tr["mean_batch"] == jr["mean_batch"]


def same_schedule(jr, tr):
    for k in ("waits", "e2e", "lost"):
        assert np.array_equal(getattr(jr, k), getattr(tr, k)), k
    assert jr.batch_sizes == tr.batch_sizes
    assert jr.makespan == tr.makespan
    assert tr.memory == jr.memory
    assert t_metrics.summarize(tr) == j_metrics.summarize(jr)


def streams(n, lam, seed, **kw):
    jd, td = uni()
    return (j_pipe.make_request_stream(n, lam=lam, dist=jd, vocab=100,
                                       seed=seed, **kw),
            t_pipe.make_request_stream(n, lam=lam, dist=td, vocab=100,
                                       seed=seed, **kw))


# ----------------------------------------------------------------------------
# Units: budget model, spec parsing, policy gate, tandem clock, stage split
# ----------------------------------------------------------------------------

def test_budget_null_and_footprint():
    for mem in (j_mem, t_mem):
        assert mem.MemoryBudget().is_null
        assert mem.MemoryBudget(capacity=np.inf).is_null
        assert not mem.MemoryBudget(capacity=100.0).is_null
    jb = j_mem.MemoryBudget(capacity=1000.0, prompt_tokens=32.0)
    tb = t_mem.MemoryBudget(capacity=1000.0, prompt_tokens=32.0)
    assert np.array_equal(tb.footprint([10, 20]), jb.footprint([10, 20]))
    assert np.array_equal(tb.footprint([10, 20]), [42.0, 52.0])


def test_budget_max_batch():
    jd, td = uni()
    for cap, q in [(4000.0, 1.0), (4000.0, 0.5), (10.0, 1.0), (7777.0, 0.9)]:
        jb, tb = j_mem.MemoryBudget(capacity=cap), t_mem.MemoryBudget(cap)
        assert tb.max_batch(td, quantile=q) == jb.max_batch(jd, quantile=q)
    assert t_mem.MemoryBudget(4000.0).max_batch(td) == 4000 // 999
    assert t_mem.MemoryBudget(4000.0).max_batch(td, quantile=0.5) > \
        t_mem.MemoryBudget(4000.0).max_batch(td)
    assert t_mem.MemoryBudget(10.0).max_batch(td) == 1     # floor at 1
    for mem, d in ((j_mem, jd), (t_mem, td)):
        with pytest.raises(ValueError, match="undefined for a null budget"):
            mem.MemoryBudget().max_batch(d)


def test_memory_from_spec():
    for mem in (j_mem, t_mem):
        assert mem.memory_from_spec(None).is_null
        assert mem.memory_from_spec(2000).capacity == 2000.0
        b = mem.memory_from_spec({"capacity": 100.0, "prompt_tokens": 8.0})
        assert b.prompt_tokens == 8.0
        assert mem.memory_from_spec(b) is b
    msgs = []
    for mem in (j_mem, t_mem):
        with pytest.raises(ValueError) as e:
            mem.memory_from_spec("not-a-budget")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert dataclasses.asdict(t_mem.memory_from_spec(
        {"capacity": 5.0, "prompt_tokens": 2.0})) == dataclasses.asdict(
        j_mem.memory_from_spec({"capacity": 5.0, "prompt_tokens": 2.0}))


@pytest.mark.parametrize("name", sorted(j_pol.default_policies()))
def test_policy_gate(name):
    jp, tp = pols(name)
    out = []
    for mem, p in ((j_mem, jp), (t_mem, tp)):
        try:
            mem.check_policy_supports_memory(p)
            out.append(None)
        except ValueError as e:
            assert "admission point" in str(e)
            out.append(str(e))
    assert out[0] == out[1]
    assert (out[1] is None) == (tp.oracle_kind == "batches")


def test_tandem_clock_recovers_serial_law():
    jl, tl = lats()
    jc, tc = j_mem.TandemClock(jl), t_mem.TandemClock(tl)
    for b, l in [(1, 10), (4, 100), (8, 999)]:
        assert tc.prefill_time(b) == jc.prefill_time(b)
        assert tc.decode_time(b, l) == jc.decode_time(b, l)
        assert tc.serial_time(b, l) == jc.serial_time(b, l)
        np.testing.assert_allclose(tc.prefill_time(b) + tc.decode_time(b, l),
                                   tc.serial_time(b, l), rtol=1e-12)
    ns = np.array([10.0, 400.0, 999.0])
    jp, tp = pols("elastic")
    jpf, joff = jc.stage_split(jp, ns)
    tpf, toff = tc.stage_split(tp, ns)
    assert tpf == jpf and np.array_equal(toff, joff)


@pytest.mark.parametrize("name", BATCH_POLICIES)
def test_stage_split_every_policy(name):
    """Every batch policy's tandem split equals the reference's; padded
    policies complete everyone at the batch max, elastic exits early."""
    jl, tl = lats()
    jp, tp = pols(name)
    for ns in (np.array([10.0, 400.0, 999.0]), np.array([7.0]),
               np.array([5.0, 5.0, 3.0, 900.0])):
        jpf, joff = jp.stage_split(ns, jl)
        tpf, toff = tp.stage_split(ns, tl)
        assert tpf == jpf and np.array_equal(toff, joff)
        assert tpf == pytest.approx(float(tl.prefill_time(len(ns))))
        if name == "elastic":
            assert tpf + toff.max() == pytest.approx(
                float(tp.batch_time(ns, tl)))
            assert tpf + toff.max() <= float(
                t_pol.DynamicPolicy(None).batch_time(ns, tl))
        else:
            np.testing.assert_allclose(tpf + toff, tp.batch_time(ns, tl))
    ns = np.array([10.0, 400.0, 999.0])
    if name == "elastic":
        _, off = tp.stage_split(ns, tl)
        assert off[0] < off[1] < off[2]


@pytest.mark.parametrize("name", ["dynamic", "fixed_b4", "multibin_4",
                                  "wait_k8", "srpt_b8"])
def test_formation_rewind_reoffers_members(name):
    """The same rewind pattern gives the same batch sequence in both
    packages, and the dynamic case re-offers exactly the deferred tail."""
    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.exponential(0.5, 40))
    tok = rng.integers(1, 1000, 40).astype(np.float64)
    jd, td = uni()
    seqs = []
    for p, d in zip(pols(name), (jd, td)):
        fs = p.formation(arr, tok, d)
        seq, t = [], 0.0
        while (nb := fs.next_batch(t)) is not None:
            start, idx = nb
            if len(idx) > 1 and len(seq) % 2 == 0:
                fs.rewind(len(idx) // 2)
                idx = idx[:len(idx) - len(idx) // 2]
            seq.append((float(start), [int(i) for i in idx]))
            t = float(start) + 5.0
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    served = sorted(i for _, idx in seqs[1] for i in idx)
    assert served == sorted(set(served))           # nobody served twice
    fs = t_pol.DynamicPolicy(None).formation(
        np.array([0.0, 0.1, 0.2, 0.3]), np.array([5.0, 6.0, 7.0, 8.0]), td)
    _, idx = fs.next_batch(10.0)
    assert len(idx) == 4
    fs.rewind(2)
    _, idx2 = fs.next_batch(20.0)
    np.testing.assert_array_equal(idx2, idx[2:])
    assert fs.next_batch(30.0) is None


def test_single_request_overflow_raises():
    jd, td = uni()
    jl, tl = lats()
    msgs = []
    for mem, pol, d, l in ((j_mem, j_pol, jd, jl), (t_mem, t_pol, td, tl)):
        wl = pol.DynamicPolicy(None).sample_workload(0.1, d, 200, seed=0)
        with pytest.raises(ValueError, match="largest single request") as e:
            mem.tandem_oracle(pol.DynamicPolicy(None), wl, l, d,
                              mem.MemoryBudget(capacity=500.0))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="largest single request") as e:
        t_fast.simulate_policy_fast(t_pol.DynamicPolicy(None), 0.1, td, tl,
                                    num_requests=200, seed=0, memory=500.0,
                                    device="cpu")
    assert str(e.value) == msgs[1]


# ----------------------------------------------------------------------------
# A null budget takes the budget-free path, bit for bit, on every layer
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dynamic", "elastic", "srpt_b8"])
def test_null_budget_bit_equal_oracle_and_fast(name):
    (jd, td), (jl, tl) = uni(), lats()
    jp, tp = pols(name)
    kw = dict(num_requests=5_000, seed=3)
    base_o = t_sim.simulate_policy(tp, 0.1, td, tl, **kw)
    assert np.array_equal(
        base_o["waits"], j_sim.simulate_policy(jp, 0.1, jd, jl, **kw)["waits"])
    base_f = t_fast.simulate_policy_fast(tp, 0.1, td, tl, device="cpu", **kw)
    for spec in NULL_SPECS:
        r = t_sim.simulate_policy(tp, 0.1, td, tl, memory=null_spec(
            spec, t_mem), **kw)
        assert np.array_equal(r["waits"], base_o["waits"]) and \
            "memory" not in r
        r = t_fast.simulate_policy_fast(tp, 0.1, td, tl, device="cpu",
                                        memory=null_spec(spec, t_mem), **kw)
        assert np.array_equal(r["waits"], base_f["waits"]) and \
            "memory" not in r


def test_null_budget_bit_equal_fleet():
    (jd, td), (jl, tl) = uni(), lats()
    pol = t_pol.DynamicPolicy(8)
    kw = dict(num_requests=4_000, seed=5)
    base = t_fleet.route_oracle("round_robin", pol, 0.3, 2, td, tl, **kw)
    jbase = j_fleet.route_oracle("round_robin", j_pol.DynamicPolicy(8), 0.3,
                                 2, jd, jl, **kw)
    r = t_fleet.route_oracle("round_robin", pol, 0.3, 2, td, tl,
                             memory=np.inf, **kw)
    for p0, p1, pj in zip(base["per_replica"], r["per_replica"],
                          jbase["per_replica"]):
        assert np.array_equal(p0["waits"], p1["waits"])
        assert np.array_equal(p0["waits"], pj["waits"])
    assert "memory" not in r
    base_f = t_fast.simulate_fleet_fast("round_robin", pol, 0.3, 2, td, tl,
                                        device="cpu", **kw)
    r_f = t_fast.simulate_fleet_fast("round_robin", pol, 0.3, 2, td, tl,
                                     memory=np.inf, device="cpu", **kw)
    for p0, p1 in zip(base_f["per_replica"], r_f["per_replica"]):
        assert np.array_equal(p0["waits"], p1["waits"])


def test_null_budget_bit_equal_scheduler():
    jreqs, treqs = streams(3_000, 0.1, 11)
    jc, tc = clocks()
    base = t_sched.PolicyScheduler(t_pol.DynamicPolicy(8), tc).run(treqs)
    same_schedule(j_sched.PolicyScheduler(j_pol.DynamicPolicy(8), jc)
                  .run(jreqs), base)
    for spec in NULL_SPECS:
        r = t_sched.PolicyScheduler(t_pol.DynamicPolicy(8), tc,
                                    memory=null_spec(spec, t_mem)).run(treqs)
        np.testing.assert_array_equal(r.waits, base.waits)
        np.testing.assert_array_equal(r.e2e, base.e2e)
        assert r.memory is None
    fr = t_router.FleetScheduler("jsq", t_pol.DynamicPolicy(8), tc, 2,
                                 memory=np.inf).run(treqs)
    fb = t_router.FleetScheduler("jsq", t_pol.DynamicPolicy(8), tc,
                                 2).run(treqs)
    assert np.array_equal(fr.waits, fb.waits) and fr.memory is None


# ----------------------------------------------------------------------------
# The tandem oracle against the reference's, and S7 against both
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", BATCH_POLICIES)
@pytest.mark.parametrize("M", [M_TIGHT, M_MID])
def test_tandem_oracle_equals_reference(name, M):
    (jd, td), (jl, tl) = uni(), lats()
    jp, tp = pols(name)
    kw = dict(num_requests=4_000, seed=7, memory=M)
    jr = j_sim.simulate_policy(jp, 0.1, jd, jl, **kw)
    tr = t_sim.simulate_policy(tp, 0.1, td, tl, **kw)
    same_oracle(jr, tr)
    assert tr["memory"]["capacity"] == M


@pytest.mark.parametrize("name", ["dynamic", "elastic", "srpt_b8",
                                  "fixed_b4"])
@pytest.mark.parametrize("M", [M_TIGHT, M_MID])
def test_tandem_oracle_matches_fast(x64, name, M):
    """The fast path: S7's plain version for dynamic batching (bit-equal to
    the oracle), the oracle itself for the others, as the reference
    dispatches them; within SCAN_ATOL of the reference's fast path."""
    (jd, td), (jl, tl) = uni(), lats()
    jp, tp = pols(name)
    kw = dict(num_requests=8_000, seed=7, memory=M)
    ro = t_sim.simulate_policy(tp, 0.1, td, tl, **kw)
    K.reset_launches()
    rf = t_fast.simulate_policy_fast(tp, 0.1, td, tl, device="cpu", **kw)
    assert K.LAUNCHES["tandem_scan"] == 0           # the plain version ran
    assert np.array_equal(rf["waits"], ro["waits"])
    assert rf["memory"] == ro["memory"]
    same_fast(j_fast.simulate_policy_fast(jp, 0.1, jd, jl, **kw), rf)


@pytest.mark.parametrize("case", ["cap", "cap0", "n1", "largest", "faults",
                                  "prompt"])
def test_tandem_fast_edge_lanes(x64, case):
    """S7's plain version on the lanes at its edges, against the port's
    oracle (bit for bit) and the reference (oracle bit for bit, compiled
    loop within SCAN_ATOL), except where the reference's loop reads
    b_max = 0 as a cap of one."""
    (jd, td), (jl, tl) = uni(), lats()
    b_max = {"cap": 4, "cap0": 0}.get(case)
    jp, tp = j_pol.DynamicPolicy(b_max), t_pol.DynamicPolicy(b_max)
    kw = dict(num_requests=1 if case == "n1" else 3_000, seed=4)
    memory = M_TIGHT
    if case == "largest":
        # the budget is the largest footprint: that request runs alone
        wl = tp.sample_workload(0.2, td, kw["num_requests"], kw["seed"])
        memory = float(wl.tokens.max())
    if case == "prompt":
        memory = {"capacity": 4000.0, "prompt_tokens": 250.0}
    trace = {}
    if case == "faults":
        spec = {"kind": "crash", "mtbf": 100.0, "mttr": 15.0}
        trace = dict(j=j_faults.fault_from_spec(dict(spec)).trace(
            11, 0, 50_000.0), t=t_faults.fault_from_spec(dict(spec)).trace(
            11, 0, 50_000.0))
    ro = t_sim.simulate_policy(tp, 0.2, td, tl, memory=memory,
                               fault_trace=trace.get("t"), **kw)
    rf = t_fast.simulate_policy_fast(tp, 0.2, td, tl, memory=memory,
                                     fault_trace=trace.get("t"),
                                     device="cpu", **kw)
    assert np.array_equal(rf["waits"], ro["waits"])
    assert rf["memory"] == ro["memory"]
    jo = j_sim.simulate_policy(jp, 0.2, jd, jl, memory=memory,
                               fault_trace=trace.get("j"), **kw)
    assert np.array_equal(jo["waits"], ro["waits"])
    if case != "cap0":
        same_fast(j_fast.simulate_policy_fast(
            jp, 0.2, jd, jl, memory=memory, fault_trace=trace.get("j"),
            **kw), rf)
    if case == "largest":
        assert rf["memory"]["kv_peak"] <= memory
        assert rf["memory"]["blocked_batches"] > 0
    if case == "cap":
        assert rf["mean_batch"] <= 4


def test_tandem_lanes_equal_their_single_runs():
    """One S7 launch of lanes with different lengths, budgets and caps
    (shorter lanes padded with +inf arrivals) equals each lane run alone,
    and the oracle."""
    (_, td), (_, tl) = uni(), lats()
    cells = []
    for n, seed, cap, b_max in [(2_000, 1, M_TIGHT, None),
                                (700, 2, M_MID, 8), (1, 3, 999.0, None),
                                (1_500, 4, 2000.25, 0)]:
        pol = t_pol.DynamicPolicy(b_max)
        cells.append((pol, pol.sample_workload(0.3, td, n, seed),
                      t_mem.MemoryBudget(cap)))
    launch = {}
    multi = t_fast.tandem_lanes([(wl, b, p.b_max) for p, wl, b in cells], tl,
                                device="cpu", launch_out=launch)
    assert launch["kernel"] == "tandem_scan"
    assert launch["args"][0].shape == (2_000, 4)
    assert bool(torch.isinf(launch["args"][0][700:, 1]).all())
    for (pol, wl, budget), got in zip(cells, multi):
        one = t_fast.tandem_lanes([(wl, budget, pol.b_max)], tl,
                                  device="cpu")[0]
        ro = t_sim.simulate_policy(pol, 0.3, td, tl, workload=wl,
                                   memory=budget)
        for r in (one, ro):
            assert np.array_equal(got["waits"], r["waits"])
            assert got["memory"] == r["memory"]


def test_tandem_scan_plain_version_by_hand():
    """The plain version on two lanes worked by hand, k1 = k2 = k4 = 1 and
    k3 = 0 (prefill 2 s for one request, decode as long as its tokens):
    lane 0, three requests of footprint 6 under a budget of 10, so each
    batch after the first waits for the last one's release and defers the
    request that does not fit; lane 1, one request and two padding rows."""
    inf = np.inf
    f64 = dict(dtype=torch.float64)
    arr = torch.tensor([[0.0, 0.0], [0.5, inf], [0.6, inf]], **f64)
    tok = torch.tensor([[6.0, 3.0], [6.0, 0.0], [6.0, 0.0]], **f64)
    fp_cum = torch.tensor([[0.0, 0.0], [6.0, 3.0], [12.0, inf],
                           [18.0, inf]], **f64)
    out = tandem_scan(arr, tok, fp_cum, torch.tensor([10.0, 10.0], **f64),
                      torch.tensor([NO_CAP, NO_CAP], **f64),
                      1.0, 1.0, 0.0, 1.0)
    starts, ends, dends, nb, blocked, blocked_t, deferred = out
    # lane 0: batch 0 starts request 0 at 0 and frees 6 at 8; at t_pf = 2
    # requests 1 and 2 wait, but 6 + 6 > 10 until 8, so batch 1 starts at
    # 8 with request 1 alone (request 2 deferred) and frees at 16; batch 2
    # waits for that release too
    assert nb.tolist() == [3, 1]
    assert starts[:3, 0].tolist() == [0.0, 8.0, 16.0]
    assert ends[:3, 0].tolist() == [1, 2, 3]
    assert dends[:3, 0].tolist() == [8.0, 16.0, 24.0]
    assert blocked.tolist() == [2, 0] and blocked_t.tolist() == [12.0, 0.0]
    assert deferred.tolist() == [1, 0]
    # lane 1 stops at its padding
    assert (starts[0, 1].item(), ends[0, 1].item(), dends[0, 1].item()) == \
        (0.0, 1, 5.0)


@pytest.mark.parametrize("router", ["round_robin", "least_work"])
def test_tandem_fleet_oracle_matches_fast(x64, router):
    """The reference test's fleet cells: per-replica waits of the port's
    route_oracle equal the reference's, and the fast path (routing on S6's
    plain version for least_work, S7's a replica) equals the port's
    oracle, within SCAN_ATOL of the reference's fast path."""
    (jd, td), (jl, tl) = uni(), lats()
    jp, tp = j_pol.DynamicPolicy(None), t_pol.DynamicPolicy(None)
    kw = dict(num_requests=6_000, seed=9, memory=M_TIGHT)
    jo = j_fleet.route_oracle(router, jp, 0.3, 2, jd, jl, **kw)
    to = t_fleet.route_oracle(router, tp, 0.3, 2, td, tl, **kw)
    tf = t_fast.simulate_fleet_fast(router, tp, 0.3, 2, td, tl,
                                    device="cpu", **kw)
    jf = j_fast.simulate_fleet_fast(router, jp, 0.3, 2, jd, jl, **kw)
    for pj, pt, pf, pjf in zip(jo["per_replica"], to["per_replica"],
                               tf["per_replica"], jf["per_replica"]):
        same_oracle(pj, pt)
        assert np.array_equal(pf["waits"], pt["waits"])
        assert pf["memory"] == pt["memory"]
        same_fast(pjf, pf)
    assert to["memory"] == jo["memory"]
    assert tf["memory"] == to["memory"]
    assert to["memory"]["capacity"] == M_TIGHT     # per-replica budgets


def _fleet_a_replica(router, pol, lam, R, dist, lat, n, seed, M):
    """The fast fleet with S7 launched a replica at a time: the same
    routing, each non-empty replica through ``simulate_policy_fast``."""
    fw = t_fleet.router_from_spec(router).fleet_workload(
        pol, lam, dist, lat, n, seed, R, fast=True, device="cpu")
    return t_fleet.run_fleet(fw, pol, lat, dist, lambda wls: [
        t_fast.simulate_policy_fast(pol, lam, dist, lat, workload=wl,
                                    memory=M, device="cpu") for wl in wls])


FLEET_STACKED = {
    **{f"{r}-R{R}": (r, R, 0.3, 1_500, 9)
       for r in ("round_robin", "least_work", "jsq") for R in (2, 3)},
    # least_work at a trickle: every request finds replica 0 idle, so the
    # other two replicas stay empty
    "empty-replicas": ("least_work", 3, 0.002, 6, 4),
    # jsq at low load: replica 0 takes most of the stream
    "uneven-lengths": ("jsq", 3, 0.06, 1_500, 2),
}


@pytest.mark.parametrize("case", sorted(FLEET_STACKED))
def test_tandem_fleet_stacked_launch(monkeypatch, case):
    """``simulate_fleet_fast(memory=)`` for dynamic batching runs every
    non-empty replica as a lane of one S7 launch; the fleet equals the
    path that launches S7 a replica and the port's route_oracle, field for
    field, empty replicas None."""
    router, R, lam, n, seed = FLEET_STACKED[case]
    (_, td), (_, tl) = uni(), lats()
    pol = t_pol.DynamicPolicy(None)
    calls = []

    def counted(arr, *rest):
        calls.append(arr.shape)
        return tandem_scan(arr, *rest)
    monkeypatch.setattr(t_fast, "tandem_scan", counted)
    kw = dict(num_requests=n, seed=seed, memory=M_TIGHT)
    got = t_fast.simulate_fleet_fast(router, pol, lam, R, td, tl,
                                     device="cpu", **kw)
    live = [c for c in got["replica_counts"] if c]
    assert calls == [(max(live), len(live))]
    one = _fleet_a_replica(router, pol, lam, R, td, tl, n, seed, M_TIGHT)
    assert len(calls) == 1 + len(live)            # a launch a replica
    ora = t_fleet.route_oracle(router, pol, lam, R, td, tl, **kw)
    if case == "empty-replicas":
        assert list(got["replica_counts"]) == [n, 0, 0]
    if case == "uneven-lengths":
        counts = sorted(got["replica_counts"])
        assert counts[-1] > 5 * counts[0] > 0
    for r in (one, ora):
        assert np.array_equal(got["replica_counts"], r["replica_counts"])
        assert np.array_equal(got["replica_of"], r["replica_of"])
        for k in ("mean_wait", "p50_wait", "p95_wait", "p99_wait",
                  "memory"):
            assert got[k] == r[k], k
        for p, q in zip(got["per_replica"], r["per_replica"]):
            assert (p is None) == (q is None)
            if p is None:
                continue
            assert np.array_equal(p["waits"], q["waits"])
            assert p["memory"] == q["memory"]
            assert p["mean_wait"] == q["mean_wait"]
            assert p["p95_wait"] == q["p95_wait"]
    for p, q in zip(got["per_replica"], one["per_replica"]):
        assert p is None and q is None or p.keys() == q.keys() and all(
            np.array_equal(p[k], q[k]) for k in p)
    assert got["mean_batch"] == one["mean_batch"]


def _routed(fleet, pol_mod, counts, seed):
    """A routed stream of ``counts[r]`` requests on replica r, built from
    one seeded draw so both packages get the same arrays."""
    rng = np.random.default_rng(seed)
    R, n = len(counts), int(sum(counts))
    arr = np.cumsum(rng.exponential(1.0, n))
    tok = rng.integers(1, 200, n).astype(np.float64)
    of = rng.permutation(np.repeat(np.arange(R), counts))
    reps = [pol_mod.Workload(arrivals=arr[of == r], tokens=tok[of == r],
                             inter=np.diff(arr[of == r], prepend=0.0))
            for r in range(R)]
    return fleet.FleetWorkload(replicas=reps, replica_of=of, arrivals=arr,
                               R=R)


@pytest.mark.parametrize("counts,b", [((5, 0, 3), None), ((0, 0, 4), None),
                                      ((6, 7, 9), 4), ((0, 0), None)])
def test_run_fleet_runs_live_replicas_in_one_call(counts, b):
    """``run_fleet`` hands every non-empty served slice, in replica order,
    to one call of its runner, and rolls the results up as the
    reference's ``run_fleet`` does a replica at a time: empty replicas
    are None, a fixed policy's slices are cut to a multiple of b, and a
    fleet with no request makes no call."""
    def result(wl):
        return {"waits": wl.arrivals.copy(), "mean_batch": 1.5}
    calls = []

    def run(wls):
        calls.append([len(wl.arrivals) for wl in wls])
        return [result(wl) for wl in wls]
    t_p = t_pol.DynamicPolicy(b_max=8) if b is None else t_pol.FixedPolicy(b)
    j_p = j_pol.DynamicPolicy(b_max=8) if b is None else j_pol.FixedPolicy(b)
    got = t_fleet.run_fleet(_routed(t_fleet, t_pol, counts, 5), t_p, None,
                            None, run)
    want = j_fleet.run_fleet(_routed(j_fleet, j_pol, counts, 5), j_p, None,
                             None, lambda p, wl: result(wl))
    served = [c if b is None else c // b * b for c in counts]
    assert calls == ([[c for c in served if c]] if any(served) else [])
    assert [p is None for p in got["per_replica"]] == \
        [p is None for p in want["per_replica"]] == [c == 0 for c in served]
    for p, q in zip(got["per_replica"], want["per_replica"]):
        assert p is None or np.array_equal(p["waits"], q["waits"])
    for k in ("mean_wait", "p50_wait", "p95_wait", "p99_wait"):
        assert got[k] == want[k]
    assert got.get("mean_batch") == want.get("mean_batch")
    assert np.array_equal(got["replica_counts"], want["replica_counts"])


@pytest.mark.parametrize("n,lanes", [(1, 1), (2, 3), (7, 2), (1_000, 4)])
def test_tandem_scan_layout(n, lanes):
    """S7's wrapper lays each input out lanes major, [lanes, ld] with ld
    the even number at or above n + 1: every row 16-byte aligned, the
    lane's values first, and the kernel's bulk copies of whole 16-byte
    chunks stay inside the row."""
    from repro_torch.kernels.tandem_scan.ops import layout
    rng = np.random.default_rng(n + lanes)
    arr = torch.from_numpy(np.sort(rng.random((n, lanes)), axis=0))
    tok = torch.from_numpy(rng.integers(1, 1001, (n, lanes)).astype(float))
    fp_cum = torch.zeros(n + 1, lanes, dtype=torch.float64)
    fp_cum[1:] = torch.cumsum(tok, 0)
    laid = layout(arr, tok, fp_cum)
    ld = n + 1 + (n + 1) % 2
    for x, src in zip(laid, (arr, tok, fp_cum)):
        assert x.shape == (lanes, ld) and x.dtype == torch.float64
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
        assert torch.equal(x[:, :src.shape[0]], src.t())
    assert (ld * 8) % 16 == 0


# ----------------------------------------------------------------------------
# Conservation: occupancy <= budget, allocated == freed at drain
# ----------------------------------------------------------------------------

def _occupancy_trace(mem):
    assert mem["kv_peak"] <= mem["capacity"] + 1e-9
    assert mem["kv_mean"] <= mem["kv_peak"] + 1e-9
    np.testing.assert_allclose(mem["allocated"], mem["freed"], rtol=1e-12)
    assert 0.0 <= mem["utilization"] <= 1.0 + 1e-12


@pytest.mark.parametrize("name", ["dynamic", "elastic", "srpt_b8",
                                  "fixed_b4"])
def test_occupancy_within_budget(name):
    (jd, td), (jl, tl) = uni(), lats()
    jp, tp = pols(name)
    for M in (M_TIGHT, M_MID):
        kw = dict(num_requests=6_000, seed=2, memory=M)
        tr = t_sim.simulate_policy(tp, 0.1, td, tl, **kw)
        _occupancy_trace(tr["memory"])
        assert tr["memory"] == j_sim.simulate_policy(
            jp, 0.1, jd, jl, **kw)["memory"]


def test_occupancy_stats_tie_break():
    # a release and an allocation at the same instant: the freed slot is
    # reusable, so the peak never double-counts the handoff
    args = (np.array([0.0, 5.0]), np.array([5.0, 9.0]),
            np.array([800.0, 900.0]), 1000.0)
    mem = t_mem.occupancy_stats(*args)
    assert mem == j_mem.occupancy_stats(*args)
    assert mem["kv_peak"] == 900.0
    assert mem["allocated"] == mem["freed"] == 1700.0
    # the served= cut drops the unserved tail (fixed batching's remnant)
    args = (np.array([0.0, 1.0, 0.0]), np.array([4.0, 6.0, 0.0]),
            np.array([3.0, 2.0, 9.0]), 10.0)
    assert t_mem.occupancy_stats(*args, served=2) == \
        j_mem.occupancy_stats(*args, served=2)
    assert t_mem.occupancy_stats([], [], [], 10.0) == \
        j_mem.occupancy_stats([], [], [], 10.0)


# ----------------------------------------------------------------------------
# Analytics: the tandem decomposition bound
# ----------------------------------------------------------------------------

def _same_bound(jb, tb):
    assert jb.keys() == tb.keys()
    for k, v in jb.items():
        if isinstance(v, float):
            close(v, tb[k])
        else:
            assert v == tb[k], k


def test_tandem_bound_null_is_slack_arm():
    (jd, td), (jl, tl) = uni(), lats()
    tb = t_bulk.tandem_bound(td, tl, 0.1, memory=None)
    _same_bound(j_bulk.tandem_bound(jd, jl, 0.1, memory=None), tb)
    slack = t_bulk.dynamic_batching_bound(td, tl, 0.1)
    assert tb["wait_bound"] == pytest.approx(slack["wait_bound"])
    assert tb["memory_arm"] is None and tb["b_mem"] is None


@pytest.mark.parametrize("lam,M", [(0.05, 2000.25), (0.05, 4000.25),
                                   (0.1, 4000.25)])
def test_tandem_bound_dominates_simulation(lam, M):
    """The bound equals the reference's and dominates the port's oracle,
    per seed (the reference checks 30,000 requests; here 8,000)."""
    (jd, td), (jl, tl) = uni(), lats()
    tb = t_bulk.tandem_bound(td, tl, lam, memory=M)
    _same_bound(j_bulk.tandem_bound(jd, jl, lam, memory=M), tb)
    assert tb["stable"]
    for seed in (1, 2, 3):
        r = t_sim.simulate_policy(t_pol.DynamicPolicy(None), lam, td, tl,
                                  num_requests=8_000, seed=seed, memory=M)
        assert tb["wait_bound"] >= r["mean_wait"], (seed, tb, r["mean_wait"])


def test_tandem_bound_tight_at_heavy_cell():
    (jd, td), (jl, tl) = uni(), lats()
    tb = t_bulk.tandem_bound(td, tl, 0.1, memory=4000.25)
    _same_bound(j_bulk.tandem_bound(jd, jl, 0.1, memory=4000.25), tb)
    r = t_sim.simulate_policy(t_pol.DynamicPolicy(None), 0.1, td, tl,
                              num_requests=30_000, seed=1, memory=4000.25)
    assert tb["wait_bound"] <= 2.0 * r["mean_wait"]


def test_tandem_bound_instability_flag():
    (jd, td), (jl, tl) = uni(), lats()
    tb = t_bulk.tandem_bound(td, tl, 0.2, memory=4000.25)
    _same_bound(j_bulk.tandem_bound(jd, jl, 0.2, memory=4000.25), tb)
    assert not tb["stable"]
    assert tb["wait_bound"] == np.inf


def test_tandem_bound_monotone_in_budget():
    (jd, td), (jl, tl) = uni(), lats()
    bounds = []
    for M in (2000.25, 4000.25, None, {"capacity": 4000.25,
                                       "prompt_tokens": 200.0}):
        tb = t_bulk.tandem_bound(td, tl, 0.05, memory=M, quantile=0.9)
        _same_bound(j_bulk.tandem_bound(jd, jl, 0.05, memory=M,
                                        quantile=0.9), tb)
        bounds.append(tb["wait_bound"])
    assert bounds[0] > bounds[1] > bounds[2]    # looser budget, smaller
    assert bounds[3] > bounds[1]                # a prompt shrinks b(M)


# ----------------------------------------------------------------------------
# The controller: batch size against KV headroom
# ----------------------------------------------------------------------------

def _fed_controllers(**kw):
    """The reference test's observation stream fed to both packages'
    controllers; both forced recommendations."""
    recs = []
    for ctl, lat in ((j_ctl, j_lat), (t_ctl, t_lat)):
        c = ctl.AdaptiveController(lat.LatencyModel(**LAT1),
                                   lat.BatchLatencyModel(**LAT),
                                   max_replicas=1, **kw)
        rng = np.random.default_rng(0)
        t = 0.0
        for _ in range(1_500):
            t += float(rng.exponential(10.0))
            c.observe_arrival(t)
            c.observe_completion(int(rng.integers(1, 1000)))
        recs.append(c.recommendation(force=True))
    assert dataclasses.asdict(recs[1]) == dataclasses.asdict(recs[0])
    return recs[1]


def test_controller_memory_caps_batch():
    blind = _fed_controllers()
    aware = _fed_controllers(memory=600.0)
    assert blind.memory_budget is None
    assert blind.details.get("b_mem") is None
    assert aware.memory_budget == 600.0
    b_mem = aware.details["b_mem"]
    assert b_mem is not None
    assert aware.details["memory_binding"]
    assert aware.policy == "fixed"
    assert 1 <= aware.b_max <= max(1, b_mem // 2)


def test_controller_loose_budget_only_caps():
    rec = _fed_controllers(memory=60_000.0)
    assert not rec.details["memory_binding"]
    assert rec.policy == _fed_controllers().policy
    assert rec.b_max == rec.details["b_mem"]
    # a quantile-capped worst case sizes b(M) as the reference's does
    assert _fed_controllers(memory=60_000.0, memory_quantile=0.5).details[
        "b_mem"] >= rec.details["b_mem"]


def test_controller_prefix_discount_grows_b_of_m():
    plain = _fed_controllers(memory={"capacity": 4000.0,
                                     "prompt_tokens": 500.0})
    reuse = _fed_controllers(memory={"capacity": 4000.0,
                                     "prompt_tokens": 500.0},
                             prefix_discount=0.5)
    assert reuse.details["b_mem"] > plain.details["b_mem"]
    for bad in (dict(memory_quantile=0.0), dict(prefix_discount=1.0)):
        with pytest.raises(ValueError):
            t_ctl.AdaptiveController(t_lat.LatencyModel(**LAT1),
                                     t_lat.BatchLatencyModel(**LAT), **bad)


def test_controller_warmup_has_no_memory_budget():
    for ctl, lat in ((j_ctl, j_lat), (t_ctl, t_lat)):
        c = ctl.AdaptiveController(lat.LatencyModel(**LAT1),
                                   lat.BatchLatencyModel(**LAT),
                                   memory=4000.0)
        rec = c.recommendation()
        assert rec.details.get("reason") == "warmup"
        assert rec.memory_budget is None
    assert c.memory.capacity == 4000.0


# ----------------------------------------------------------------------------
# Serving layer: scheduler admission, fleet roll-up, composition guards
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dynamic", "elastic", "srpt_b8",
                                  "fixed_b4"])
def test_scheduler_tandem_reports_memory(name):
    jreqs, treqs = streams(4_000, 0.1, 11)
    jc, tc = clocks()
    jp, tp = pols(name)
    jr = j_sched.PolicyScheduler(jp, jc, memory=M_MID).run(jreqs)
    tr = t_sched.PolicyScheduler(tp, tc, memory=M_MID).run(treqs)
    same_schedule(jr, tr)
    out = t_metrics.summarize(tr)
    mem = out["memory"]
    assert mem["capacity"] == M_MID
    assert 0.0 < mem["kv_peak"] <= M_MID
    assert mem["allocated"] == pytest.approx(mem["freed"])
    if name == "dynamic":
        base = t_metrics.summarize(t_sched.PolicyScheduler(tp, tc).run(treqs))
        assert out["mean_wait"] >= base["mean_wait"]


@pytest.mark.parametrize("router", ["round_robin", "least_work"])
def test_fleet_scheduler_memory_rollup(router):
    jreqs, treqs = streams(4_000, 0.2, 4)
    jc, tc = clocks()
    jr = j_router.FleetScheduler(router, j_pol.DynamicPolicy(None), jc, R=2,
                                 memory=M_MID).run(jreqs)
    tr = t_router.FleetScheduler(router, t_pol.DynamicPolicy(None), tc, R=2,
                                 memory=M_MID).run(treqs)
    same_schedule(jr, tr)
    assert np.array_equal(tr.replica_of, jr.replica_of)
    assert t_router.summarize_fleet(tr) == j_router.summarize_fleet(jr)
    mem = t_metrics.summarize(tr)["memory"]
    assert mem["capacity"] == M_MID          # per-replica, not pooled
    assert mem["kv_peak"] <= M_MID
    assert mem["deferred_requests"] >= 0 and "blocked_batches" in mem


def test_sessions_x_memory_raises():
    (jd, td), (jl, tl) = uni(), lats()
    jc, tc = clocks()
    jreqs, treqs = streams(200, 0.1, 0)
    msgs = {}
    for key, sim, fast, pol, sess, sched, router, d, l, c, kw in (
            ("j", j_sim, j_fast, j_pol, j_sess, j_sched, j_router, jd, jl,
             jc, {}),
            ("t", t_sim, t_fast, t_pol, t_sess, t_sched, t_router, td, tl,
             tc, {"device": "cpu"})):
        reqs = (j_pipe if key == "j" else t_pipe).make_request_stream(
            200, lam=0.1, dist=d, vocab=100, seed=0,
            sessions=sess.GeometricSession(p=0.5))
        out = []
        for call in (
                lambda: sim.simulate_policy(
                    pol.DynamicPolicy(8), 0.1, d, l, num_requests=500,
                    seed=0, sessions=sess.GeometricSession(p=0.5),
                    memory=M_MID),
                lambda: fast.simulate_policy_fast(
                    pol.DynamicPolicy(8), 0.1, d, l, num_requests=500,
                    seed=0, sessions=sess.GeometricSession(p=0.5),
                    memory=M_MID, **kw),
                lambda: sched.PolicyScheduler(pol.DynamicPolicy(8), c,
                                              memory=M_MID).run_sessions(reqs),
                lambda: router.FleetScheduler(
                    "jsq", pol.DynamicPolicy(8), c, 2,
                    memory=M_MID).run_sessions(reqs)):
            with pytest.raises(ValueError, match="sessions") as e:
                call()
            out.append(str(e.value))
        msgs[key] = out
    assert msgs["j"] == msgs["t"]
    # a session-free stream runs under the budget as the plain run does
    single = t_sched.PolicyScheduler(t_pol.DynamicPolicy(8), tc, memory=M_MID)
    assert np.array_equal(single.run_sessions(treqs).waits,
                          single.run(treqs).waits)


def test_memory_rejects_unsupported_policies():
    (jd, td), (jl, tl) = uni(), lats()
    jc, tc = clocks()
    for sim, fast, pol, sched, router, d, l, c, kw in (
            (j_sim, j_fast, j_pol, j_sched, j_router, jd, jl, jc, {}),
            (t_sim, t_fast, t_pol, t_sched, t_router, td, tl, tc,
             {"device": "cpu"})):
        single = (j_lat if sim is j_sim else t_lat).LatencyModel(**LAT1)
        for call in (
                lambda: sim.simulate_policy(pol.FCFSPolicy(), 0.1, d, single,
                                            num_requests=500, seed=0,
                                            memory=M_MID),
                lambda: fast.simulate_policy_fast(
                    pol.ContinuousPolicy(slots=8), 0.1, d, l,
                    num_requests=500, seed=0, memory=M_MID, **kw),
                lambda: sched.PolicyScheduler(pol.ContinuousPolicy(slots=8),
                                              c, memory=M_MID),
                lambda: router.FleetScheduler("jsq", pol.FCFSPolicy(), c, 2,
                                              memory=M_MID),
                lambda: sched.run_engine_schedule(pol.FCFSPolicy(), object(),
                                                  [], memory=M_MID)):
            with pytest.raises(ValueError, match="admission point"):
                call()


# ----------------------------------------------------------------------------
# Properties
# ----------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), cap=st.floats(1100.0, 9000.0),
       lam=st.floats(0.02, 0.12))
def test_property_occupancy_never_exceeds_budget(seed, cap, lam):
    (jd, td), (jl, tl) = uni(), lats()
    kw = dict(num_requests=1_500, seed=seed, memory=cap)
    res = t_sim.simulate_policy(t_pol.DynamicPolicy(None), lam, td, tl, **kw)
    mem = res["memory"]
    assert mem["kv_peak"] <= cap + 1e-9
    np.testing.assert_allclose(mem["allocated"], mem["freed"], rtol=1e-12)
    same_oracle(j_sim.simulate_policy(j_pol.DynamicPolicy(None), lam, jd, jl,
                                      **kw), res)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), cap=st.floats(1100.0, 9000.0))
def test_property_allocated_equals_served_footprint(seed, cap):
    # every served request allocates exactly footprint(n) and frees it at
    # drain: allocated == freed == sum of served footprints
    (jd, td), (jl, tl) = uni(), lats()
    pol = t_pol.FixedPolicy(4)
    res = t_sim.simulate_policy(pol, 0.05, td, tl, num_requests=1_000,
                                seed=seed, memory=cap)
    wl = pol.sample_workload(0.05, td, 1_000, seed)
    served = pol.schedule_length(len(wl.tokens))
    expect = float(wl.tokens[:served].sum())     # footprint == tokens here
    mem = res["memory"]
    np.testing.assert_allclose(mem["allocated"], mem["freed"], rtol=1e-12)
    np.testing.assert_allclose(mem["allocated"], expect, rtol=1e-12)
    assert mem == j_sim.simulate_policy(j_pol.FixedPolicy(4), 0.05, jd, jl,
                                        num_requests=1_000, seed=seed,
                                        memory=cap)["memory"]


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_property_null_budget_bit_equal(seed):
    (jd, td), (jl, tl) = uni(), lats()
    base = t_sim.simulate_policy(t_pol.DynamicPolicy(8), 0.1, td, tl,
                                 num_requests=1_200, seed=seed)
    r = t_sim.simulate_policy(t_pol.DynamicPolicy(8), 0.1, td, tl,
                              num_requests=1_200, seed=seed, memory=np.inf)
    np.testing.assert_array_equal(r["waits"], base["waits"])
    np.testing.assert_array_equal(
        j_sim.simulate_policy(j_pol.DynamicPolicy(8), 0.1, jd, jl,
                              num_requests=1_200, seed=seed,
                              memory=np.inf)["waits"], base["waits"])


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), cap=st.floats(999.0, 6000.0),
       lam=st.floats(0.05, 2.0), b_max=st.sampled_from([None, 0, 1, 3, 16]),
       prompt=st.sampled_from([0.0, 0.5, 7.0]))
def test_property_s7_plain_version_equals_oracle(seed, cap, lam, b_max,
                                                 prompt):
    """S7's plain version equals the port's oracle bit for bit over
    budgets (the largest footprint included), loads, caps and prompts."""
    (_, td), (_, tl) = uni(), lats()
    pol = t_pol.DynamicPolicy(b_max)
    wl = pol.sample_workload(lam, td, 400, seed)
    budget = t_mem.MemoryBudget(max(cap, float(wl.tokens.max()) + prompt),
                                prompt)
    ro = t_sim.simulate_policy(pol, lam, td, tl, workload=wl, memory=budget)
    rf = t_fast.simulate_policy_fast(pol, lam, td, tl, workload=wl,
                                     memory=budget, device="cpu")
    assert np.array_equal(rf["waits"], ro["waits"])
    assert rf["memory"] == ro["memory"]
