"""The port's serving resilience path (``repro_torch.serving.resilience``)
on the CPU, against the JAX package on equal inputs: the resilient fleet on
the virtual clock (``FleetScheduler`` with ``faults=`` or a knob) and on
the engine (``run_fleet_schedule(..., kill_at=...)``), and the controller's
availability axis that reads the same fault episodes.

The resilience path is host NumPy on both sides, so ``waits``, ``e2e``,
``replica_of``, ``lost``, the batch sizes and every ``ResilienceReport``
field must be EQUAL (``np.array_equal``, ``==``), and ``summarize_fleet``
must give the same keys and values.  The cells are the reference's own
serving-resilience tests (``tests/test_faults.py``) and the
``straggler_hedging`` and ``shed_sweep`` cells of
``benchmarks/bench_faults.py``, plus the planned-unavailability knobs
(``scale_schedule``, ``down_spans``, ``max_retries``, ``retry_backoff``)
and continuous batching, whose victims the FCFS progress proxy picks."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving.engine as j_engine_mod  # noqa: E402
import repro_torch.serving.engine as t_engine_mod  # noqa: E402
from repro.core import control as j_ctl  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import faults as j_faults  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.serving import resilience as j_res  # noqa: E402
from repro.serving import router as j_router  # noqa: E402
from repro.serving import scheduler as j_sched  # noqa: E402

from repro_torch.core import control as t_ctl  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import faults as t_faults  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.serving import resilience as t_res  # noqa: E402
from repro_torch.serving import router as t_router  # noqa: E402
from repro_torch.serving import scheduler as t_sched  # noqa: E402

LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
PAIRS = ((j_dist, j_lat, j_pol, j_faults, j_pipe, j_sched, j_router),
         (t_dist, t_lat, t_pol, t_faults, t_pipe, t_sched, t_router))

# name -> (router, policy (kind, kwargs), requests, λ, stream seed, fault
# model (kind, kwargs) or None, knobs).  "median" as kill_at's time is the
# stream's median arrival, as the reference test kills.  The reference's
# cells run ``DynamicPolicy(16)``, whose first argument is n_max.
CELLS = {
    # tests/test_faults.py:300-372
    "zero_fault_knob": ("least_work", ("dynamic", {"n_max": 16}), 200, 3.0,
                        0, None, {"kill_at": None}),
    "null_fault_model": ("least_work", ("dynamic", {"n_max": 16}), 200, 3.0,
                         0, ("none", {}), {}),
    "midrun_kill": ("jsq", ("dynamic", {"n_max": 16}), 250, 3.0, 0, None,
                    {"kill_at": {0: "median"}, "seed": 1}),
    "shed_determinism": ("least_work", ("dynamic", {"n_max": 16}), 150, 3.0,
                         0, ("crash", {"mtbf": 80.0, "mttr": 6.0}),
                         {"seed": 2, "shed_prob": 0.05}),
    "hedging_dedup": ("random", ("dynamic", {"n_max": 16}), 300, 8.0, 0,
                      None, {"hedge_slo": 0.05, "seed": 3}),
    # planned unavailability, retry knobs, and the other victim pickers
    "scale_and_down_spans": ("least_work", ("srpt", {"b_max": 8}), 200, 3.0,
                             4, ("crash", {"mtbf": 60.0, "mttr": 8.0}),
                             {"scale_schedule": [(20.0, 2), (45.0, 3)],
                              "down_spans": [[], [(5.0, 12.0)], []],
                              "max_retries": 1, "retry_backoff": 0.5,
                              "seed": 5}),
    "continuous_kill": ("round_robin", ("continuous", {"slots": 4}), 120,
                        2.0, 6, ("drop", {"p": 0.1}),
                        {"kill_at": {1: "median"}, "hedge_slo": 1.0,
                         "seed": 7}),
    "fcfs_tau_kill": ("session_affinity", ("fcfs", {"tau": 4.0}), 150, 1.0,
                      8, None, {"kill_at": {2: "median"}, "seed": 9}),
}


def _fault(mod, spec):
    return None if spec is None else mod.get_fault(spec[0], **spec[1])


def _knobs(kw, reqs):
    out = dict(kw)
    if out.get("kill_at"):
        med = float(np.median([r.arrival for r in reqs]))
        out["kill_at"] = {r: (med if t == "median" else t)
                          for r, t in out["kill_at"].items()}
    return out


def _fleets(cell, dist=("LogNormalTokens", (7.0, 0.7))):
    """Build one cell's fleet in each package and run it."""
    router, (kind, pkw), n, lam, seed, fault, kw = cell
    out = []
    for dm, lm, pm, fm, pipe, sm, rm in PAIRS:
        d = getattr(dm, dist[0])(*dist[1])
        lat = lm.BatchLatencyModel(**LAT)
        clock = sm.ModelClock(pm.single_from_batch(lat), lat)
        reqs = pipe.make_request_stream(n, lam=lam, dist=d, vocab=512,
                                        seed=seed)
        fleet = rm.FleetScheduler(router, pm.get_policy(kind, **pkw), clock,
                                  3, faults=_fault(fm, fault),
                                  **_knobs(kw, reqs))
        out.append((fleet.run(reqs), reqs))
    return out


def same_resilient(jr, tr):
    """Two resilient fleet results, field for field."""
    for f in ("waits", "e2e", "lost", "replica_of"):
        assert np.array_equal(getattr(tr, f), getattr(jr, f)), f
    assert tr.batch_sizes == jr.batch_sizes
    assert tr.makespan == jr.makespan
    assert dataclasses.asdict(tr.resilience) == \
        dataclasses.asdict(jr.resilience)
    for jp, tp in zip(jr.per_replica, tr.per_replica):
        assert (jp is None) == (tp is None)
        if jp is not None:
            assert np.array_equal(tp.waits, jp.waits)
            assert np.array_equal(tp.e2e, jp.e2e)
    assert t_router.summarize_fleet(tr) == j_router.summarize_fleet(jr)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_resilient_fleet_equals_reference(name):
    (jr, jreqs), (tr, _) = _fleets(CELLS[name])
    assert isinstance(tr, t_res.ResilientFleetResult)
    same_resilient(jr, tr)
    rep = tr.resilience
    assert rep.served + rep.shed + rep.failed == rep.arrived == len(jreqs)
    if name == "midrun_kill":
        assert rep.retries > 0 and rep.kill_events
        starts = np.array([r.arrival for r in jreqs]) + tr.waits
        kill_t = float(np.median([r.arrival for r in jreqs]))
        assert (starts[tr.replica_of == 0] <= kill_t + 1e-9).all()
    if name == "hedging_dedup":
        assert rep.hedged > 0 and rep.served == rep.arrived


def test_zero_faults_keep_the_fault_free_path():
    """No fault model and no knob: ``FleetScheduler.run`` stays the
    fault-free body (a ``FleetScheduleResult``), equal to the resilient
    path's zero-fault cells as the reference's test holds them."""
    (_, _), (tr, treqs) = _fleets(CELLS["zero_fault_knob"])
    lat = t_lat.BatchLatencyModel(**LAT)
    clock = t_sched.ModelClock(t_pol.single_from_batch(lat), lat)
    base = t_router.FleetScheduler("least_work", t_pol.DynamicPolicy(16),
                                   clock, 3).run(treqs)
    assert isinstance(base, t_router.FleetScheduleResult)
    assert np.array_equal(base.waits, tr.waits)
    assert np.array_equal(base.replica_of, tr.replica_of)
    (_, _), (tn, _) = _fleets(CELLS["null_fault_model"])
    assert np.array_equal(base.replica_of, tn.replica_of)
    np.testing.assert_allclose(base.waits, tn.waits, rtol=1e-9, atol=1e-12)


def test_scale_spans_equals_reference():
    for sched, R, horizon in (([(10.0, 2), (20.0, 4), (30.0, 1)], 4, 50.0),
                              ([(0.0, 0), (5.0, 3)], 3, 8.0),
                              ([], 2, 1.0)):
        assert t_res.scale_spans(sched, R, horizon) == \
            j_res.scale_spans(sched, R, horizon)


# ----------------------------------------------------------------------------
# benchmarks/bench_faults.py:83-115 (lognormal(7, 0.7), λ = 8, R = 3, 800
# requests, seed 3): the serving layer's straggler hedging and shed sweep
# ----------------------------------------------------------------------------

BENCH = [("random", ("dynamic", {"n_max": 16}), 800, 8.0, 3,
          ("slowdown", {"mtbf": 40.0, "duration": 15.0, "factor": 4.0}),
          {"seed": 3}),
         ("random", ("dynamic", {"n_max": 16}), 800, 8.0, 3,
          ("slowdown", {"mtbf": 40.0, "duration": 15.0, "factor": 4.0}),
          {"seed": 3, "hedge_slo": 0.05})] + [
    ("jsq", ("dynamic", {"n_max": 16}), 800, 8.0, 3,
     ("crash", {"mtbf": 80.0, "mttr": 10.0}), {"seed": 3, "shed_prob": p})
    for p in (0.0, 0.1, 0.25, 0.5)]


@pytest.mark.parametrize("cell", range(len(BENCH)),
                         ids=["straggler_plain", "straggler_hedged",
                              "shed_0", "shed_0.1", "shed_0.25", "shed_0.5"])
def test_bench_faults_serving_cells_equal_reference(cell):
    (jr, _), (tr, _) = _fleets(BENCH[cell])
    same_resilient(jr, tr)
    if cell == 1:
        assert tr.resilience.hedged > 0
        assert tr.resilience.served == len(tr.waits)


# ----------------------------------------------------------------------------
# The learned availability (tests/test_faults.py:374-392)
# ----------------------------------------------------------------------------

def test_controller_learns_availability_equals_reference():
    ctls = []
    for dm, lm, pm, cm in ((j_dist, j_lat, j_pol, j_ctl),
                           (t_dist, t_lat, t_pol, t_ctl)):
        lat = lm.BatchLatencyModel(**LAT)
        ln = dm.LogNormalTokens(7.0, 0.7)
        ctl = cm.AdaptiveController(pm.single_from_batch(lat), lat,
                                    max_replicas=4, elastic_available=False)
        assert ctl.availability_hat() == 1.0
        for _ in range(10):
            ctl.observe_episode(90.0, 10.0)
        rng = np.random.default_rng(0)
        t = 0.0
        shed = [ctl.shed_probability(x, ln) for x in (100.0, 1e-6)]
        for _ in range(200):
            t += rng.exponential(1 / 50.0)
            ctl.observe_arrival(t)
            ctl.observe_completion(int(ln.sample(rng, 1)[0]))
        ctls.append((ctl.availability_hat(), shed,
                     dataclasses.asdict(ctl.recommendation())))
    assert ctls[1] == ctls[0]
    avail, (p_hi, p_lo), rec = ctls[1]
    assert avail == pytest.approx(0.9) and 0.0 < p_hi < 1.0 and p_lo == 0.0
    assert rec["availability"] == pytest.approx(0.9)


# ----------------------------------------------------------------------------
# The engine fleet with a kill (smoke qwen2.5-3b, two layers)
# ----------------------------------------------------------------------------

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
    generate = engine.generate

    def rec(prompts, targets, **kw):
        out = generate(prompts, targets, return_tokens=True, **kw)
        log.append((out["tokens"], list(out["produced"])))
        return out
    return rec


def test_engine_fleet_kill_equals_reference(engines, monkeypatch):
    """``run_fleet_schedule(..., kill_at=...)``: the port's engine fleet
    against the reference's ``run_resilient_engine_fleet`` on a shared
    fake clock: greedy tokens and ``produced`` batch for batch, the final
    replica of every request and the report."""
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
    jreqs, treqs = (p.make_request_stream(12, 4.0, d, vocab=512,
                                          prompt_len_range=(3, 12), seed=5)
                    for p, d in ((j_pipe, jd), (t_pipe, td)))
    kill = {0: float(np.median([r.arrival for r in jreqs]))}
    jl, tl = (m.BatchLatencyModel(**LAT) for m in (j_lat, t_lat))
    jr = j_res.run_resilient_engine_fleet(
        "jsq", j_pol.DynamicPolicy(b_max=4), jeng, jreqs, R=3, lat=jl,
        kill_at=kill, seed=1)
    tr = t_router.run_fleet_schedule(
        "jsq", t_pol.DynamicPolicy(b_max=4), teng, treqs, R=3, lat=tl,
        kill_at=kill, seed=1)
    assert logs["t"] == logs["j"] and len(logs["t"]) >= 2
    same_resilient(jr, tr)
    rep = tr.resilience
    assert rep.kill_events and rep.retries > 0
    assert rep.served == rep.arrived == len(treqs)
    assert (tr.replica_of >= 0).all() and np.isfinite(tr.waits).all()
    # victims are picked on the batch law's virtual clock, so in both
    # packages the engine fleet's final replicas and report equal the
    # virtual-clock resilient fleet's on a ModelClock of the same law
    # (chip_smoke's resilient engine fleet asserts this on the card)
    for res, sm, pm, rm, reqs, law in (
            (jr, j_sched, j_pol, j_res, jreqs, jl),
            (tr, t_sched, t_pol, t_res, treqs, tl)):
        virt = rm.ResilientFleetScheduler(
            "jsq", pm.DynamicPolicy(b_max=4),
            sm.ModelClock(pm.single_from_batch(law), law), 3,
            kill_at=kill, seed=1).run(reqs)
        assert np.array_equal(virt.replica_of, res.replica_of)
        assert dataclasses.asdict(virt.resilience) == \
            dataclasses.asdict(res.resilience)
