"""The port's engine and engine-layer scheduler against ``repro.serving``
on the CPU, in fp32 and greedy decoding: token streams, ``produced``,
host-sync ledgers, compaction events and schedules must be EQUAL to the
reference's.  Schedules depend on wall-clock batch times, so the schedule
tests give both engines the same fake clock (one tick per
``time.perf_counter`` call)."""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.serving.engine as jax_engine_mod  # noqa: E402
import repro_torch.serving.engine as torch_engine_mod  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.core.distributions import LogNormalTokens  # noqa: E402
from repro.core.policies import get_policy as jax_get_policy  # noqa: E402
from repro.data.pipeline import make_request_stream as jax_stream  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.scheduler import run_engine_schedule as jax_schedule  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.policies import get_policy  # noqa: E402
from repro_torch.data.pipeline import make_request_stream  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, EngineConfig, run_engine_schedule)

ECFG = dict(max_batch=4, max_seq=128, prompt_bucket=16)
PROMPTS = [np.arange(4, dtype=np.int32) + i for i in range(3)]
TARGETS = [17, 3, 9]


@pytest.fixture(scope="module")
def cfgs():
    jc = dataclasses.replace(jax_get_smoke("qwen2.5-3b"), num_layers=2)
    tc = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2)
    return jc, tc


@pytest.fixture(scope="module")
def jax_engines(cfgs):
    jc, _ = cfgs
    eng = JaxEngine(jc, JaxEngineConfig(**ECFG))
    host = JaxEngine(jc, JaxEngineConfig(**ECFG, compact_impl="host"),
                     params=eng.params)
    return {"fused": eng, "host": host}


def _port_engine(cfgs, jax_engines, **kw):
    params = params_from_numpy(jax_engines["fused"].params, device="cpu")
    return Engine(cfgs[1], EngineConfig(**ECFG, **kw), params=params,
                  device="cpu")


def _events(eng, n0=0):
    return [(e["impl"], e["batch"], e["syncs"]) for e in eng.step_log[n0:]
            if e["kind"] == "compact"]


@pytest.mark.parametrize("mode,impl", [("padded", "fused"),
                                       ("elastic", "fused"),
                                       ("elastic", "host")])
def test_generate_equals_reference(cfgs, jax_engines, mode, impl):
    elastic = mode == "elastic"
    jeng = jax_engines[impl]
    teng = _port_engine(cfgs, jax_engines, compact_impl=impl)
    n0 = len(jeng.step_log)
    # chunk=4: slots finish at chunk boundaries, so elastic runs compact
    jr = jeng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=4,
                       return_tokens=True)
    tr = teng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=4,
                       return_tokens=True)
    assert tr["tokens"] == jr["tokens"]
    assert list(tr["produced"]) == list(jr["produced"]) == TARGETS
    assert tr["host_syncs"] == jr["host_syncs"]
    assert _events(teng) == _events(jeng, n0)
    assert len(_events(teng)) == (2 if elastic else 0)
    assert [e["steps"] for e in teng.step_log if e["kind"] == "decode_chunk"] \
        == [e["steps"] for e in jeng.step_log[n0:] if e["kind"] == "decode_chunk"]
    c = tr["completion_seconds"]
    if elastic:
        assert c[1] < c[2] < c[0]          # short replies exit earlier
    else:
        assert np.all(c == tr["batch_seconds"])


def test_chunk_one_gives_the_chunked_tokens(cfgs, jax_engines):
    teng = _port_engine(cfgs, jax_engines)
    for elastic in (False, True):
        r1 = teng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=1,
                           return_tokens=True)
        r32 = teng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=32,
                            return_tokens=True)
        assert r1["tokens"] == r32["tokens"]
        assert list(r1["produced"]) == list(r32["produced"]) == TARGETS
        assert r1["host_syncs"] > r32["host_syncs"]
    assert r1["host_syncs"] == 1 + (max(TARGETS) - 1)     # per-step loop


def test_fused_compaction_saves_one_sync_per_event(cfgs, jax_engines):
    runs = {}
    for impl in ("fused", "host"):
        eng = _port_engine(cfgs, jax_engines, compact_impl=impl)
        runs[impl] = (eng.generate(PROMPTS, TARGETS, elastic=True, chunk=4,
                                   return_tokens=True), _events(eng))
    (rf, evf), (rh, evh) = runs["fused"], runs["host"]
    assert rf["tokens"] == rh["tokens"]
    assert len(evf) == len(evh) >= 1
    assert all(e[0] == "fused" and e[2] == 0 for e in evf)
    assert all(e[0] == "host" and e[2] == 1 for e in evh)
    assert rf["host_syncs"] == rh["host_syncs"] - len(evh)


def test_ragged_impl_gives_the_dense_tokens(cfgs, jax_engines):
    dense = _port_engine(cfgs, jax_engines)
    ragged = Engine(dataclasses.replace(cfgs[1], decode_attention_impl="ragged"),
                    EngineConfig(**ECFG), params=dense.params, device="cpu")
    assert ragged.generate(PROMPTS, TARGETS, elastic=True,
                           return_tokens=True)["tokens"] == \
        dense.generate(PROMPTS, TARGETS, elastic=True,
                       return_tokens=True)["tokens"]


def test_engine_refusals(cfgs, jax_engines):
    eng = _port_engine(cfgs, jax_engines, kv_budget=40)
    with pytest.raises(ValueError, match="kv_budget"):
        eng.generate(PROMPTS, TARGETS)
    r = eng.generate(PROMPTS[:1], [8])
    assert 0 < eng.kv_report()["kv_peak"] <= 40 and r["produced"][0] == 8
    cal = eng.calibration_log()
    assert len(cal["prefill"]) == 1 and len(cal["decode"]) >= 1


# ----------------------------------------------------------------------------
# run_engine_schedule on a shared fake clock
# ----------------------------------------------------------------------------

def _stream(mod_stream, **kw):
    return mod_stream(8, 4.0, LogNormalTokens(log_mean=1.5, log_std=0.6,
                                              support=12),
                      vocab=512, prompt_len_range=(3, 12), seed=5, **kw)


@pytest.mark.parametrize("corr", [0.0, 0.5])
def test_request_stream_equals_reference(corr):
    a = _stream(make_request_stream, prompt_len_corr=corr)
    b = _stream(jax_stream, prompt_len_corr=corr)
    assert [(r.rid, r.arrival, r.target_output_tokens) for r in a] == \
        [(r.rid, r.arrival, r.target_output_tokens) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt_tokens, y.prompt_tokens)


# b_max caps batches at the engine's max_batch bucket
@pytest.mark.parametrize("name,kw", [("dynamic", {"b_max": 4}),
                                     ("elastic", {"b_max": 4}),
                                     ("fixed", {"b": 2}),
                                     ("dynamic", {"b_max": 2}),
                                     ("multibin", {"num_bins": 2,
                                                   "b_max": 4}),
                                     ("wait", {"k": 3, "b_max": 4}),
                                     ("srpt", {"b_max": 4})])
def test_run_engine_schedule_equals_reference(cfgs, jax_engines, monkeypatch,
                                              name, kw):
    for mod in (jax_engine_mod, torch_engine_mod):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: float(next(t))))
    teng = _port_engine(cfgs, jax_engines)
    tr = run_engine_schedule(get_policy(name, **kw), teng,
                             _stream(make_request_stream))
    jr = jax_schedule(jax_get_policy(name, **kw), jax_engines["fused"],
                      _stream(jax_stream))
    assert tr.batch_sizes == jr.batch_sizes
    assert len(tr.batch_sizes) > 1
    np.testing.assert_array_equal(tr.waits, jr.waits)
    np.testing.assert_array_equal(tr.e2e, jr.e2e)
    assert tr.makespan == jr.makespan


# a KV budget of 40 tokens cuts batches of this stream (footprints: prompt
# of 3-11 tokens plus up to 12 output tokens)
@pytest.mark.parametrize("name,kw,memory", [
    ("dynamic", {"b_max": 4}, 40.0), ("elastic", {"b_max": 4}, 40.0),
    ("srpt", {"b_max": 4}, 40.0), ("wait", {"k": 3, "b_max": 4}, 33.25),
    ("dynamic", {"b_max": 4}, np.inf)])
def test_run_engine_schedule_memory_equals_reference(cfgs, jax_engines,
                                                     monkeypatch, name, kw,
                                                     memory):
    for mod in (jax_engine_mod, torch_engine_mod):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: float(next(t))))
    teng = _port_engine(cfgs, jax_engines)
    treqs = _stream(make_request_stream)
    tr = run_engine_schedule(get_policy(name, **kw), teng, treqs,
                             memory=memory)
    jr = jax_schedule(jax_get_policy(name, **kw), jax_engines["fused"],
                      _stream(jax_stream), memory=memory)
    assert tr.batch_sizes == jr.batch_sizes
    np.testing.assert_array_equal(tr.waits, jr.waits)
    np.testing.assert_array_equal(tr.e2e, jr.e2e)
    assert tr.makespan == jr.makespan
    assert tr.memory == jr.memory
    if np.isinf(memory):
        assert tr.memory is None
        return
    # every admitted batch's real footprint fits the budget
    fp = [len(r.prompt_tokens) + r.target_output_tokens for r in treqs]
    start = np.round(tr.waits + [r.arrival for r in treqs], 9)
    for t in np.unique(start):
        assert sum(f for f, s in zip(fp, start) if s == t) <= memory
    assert tr.memory["kv_peak"] <= memory
    assert tr.memory["allocated"] == tr.memory["freed"] == sum(fp)
    if name == "dynamic":
        assert tr.memory["deferred_requests"] > 0


def test_schedule_refuses_unported_options(cfgs, jax_engines):
    eng = _port_engine(cfgs, jax_engines)
    # memory budgets are ported: a bad spec raises as the reference does,
    # and an empty stream schedules nothing under a budget
    for schedule, policy, engine in (
            (jax_schedule, jax_get_policy("dynamic"), jax_engines["fused"]),
            (run_engine_schedule, get_policy("dynamic"), eng)):
        with pytest.raises(ValueError, match="cannot build a MemoryBudget"):
            schedule(policy, engine, [], memory=object())
    res = run_engine_schedule(get_policy("dynamic"), eng, [], memory=100)
    jres = jax_schedule(jax_get_policy("dynamic"), jax_engines["fused"], [],
                        memory=100)
    assert res.batch_sizes == [] and res.memory == jres.memory
    # predictions are ported: an empty stream schedules nothing
    res = run_engine_schedule(get_policy("srpt", predictor="oracle"), eng, [],
                              predictor="lognormal_noise")
    assert res.batch_sizes == [] and res.makespan == 0.0
