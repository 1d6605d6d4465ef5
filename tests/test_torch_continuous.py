"""The port's continuous batching (``repro_torch.serving.continuous``)
against ``repro.serving.continuous`` on the CPU, greedy, on the same
converted weights: ``produced``, decode steps, host syncs and every
emitted greedy token must be EQUAL to the reference's; plus the reference's own checks of
``tests/test_continuous.py``, ported."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.serving.continuous import serve_continuous as jax_serve  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, EngineConfig, serve_continuous, splice_cache)

ECFG = dict(max_batch=4, max_seq=128, prompt_bucket=16)
PROMPTS = [np.arange(5, dtype=np.int32) + 3 * i for i in range(5)]
TARGETS = [6, 2, 9, 4, 3]


@pytest.fixture(scope="module")
def jax_engine():
    cfg = dataclasses.replace(jax_get_smoke("qwen2.5-3b"), num_layers=2,
                              decode_cache_update="scatter")
    return JaxEngine(cfg, JaxEngineConfig(**ECFG))


@pytest.fixture(scope="module")
def engine(jax_engine):
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2,
                              decode_cache_update="scatter")
    return Engine(cfg, EngineConfig(**ECFG),
                  params=params_from_numpy(jax_engine.params, device="cpu"),
                  device="cpu")


def _record_tokens(monkeypatch, eng):
    """Wrap ``eng.decode_chunk`` to keep each chunk's tokens of the active
    slots, in (step, slot) order; both engines return them as outputs 5
    (step tokens) and 6 (active mask)."""
    seen, chunk_fn = [], eng.decode_chunk

    def recording(*a, **kw):
        out = chunk_fn(*a, **kw)
        seen.append(np.asarray(out[5])[np.asarray(out[6])].tolist())
        return out

    monkeypatch.setattr(eng, "decode_chunk", recording)
    return seen


@pytest.mark.parametrize("slots,chunk", [(2, 1), (2, 8), (1, 8)])
def test_serve_continuous_equals_reference(engine, jax_engine, monkeypatch,
                                           slots, chunk):
    """The same chunks and the same greedy tokens of the active slots as
    the reference, so a splice into the wrong slot, a stale ``kv_lens`` or
    a wrong admitted token would show.  At slots=1 the pool is the
    engine's bucket-1 cache, the bucket of every admission prefill: the
    staging cache keeps the two apart."""
    t_toks = _record_tokens(monkeypatch, engine)
    j_toks = _record_tokens(monkeypatch, jax_engine)
    tr = serve_continuous(engine, PROMPTS, TARGETS, slots=slots, chunk=chunk)
    jr = jax_serve(jax_engine, PROMPTS, TARGETS, slots=slots, chunk=chunk)
    assert list(tr.produced) == list(jr.produced) == TARGETS
    assert tr.decode_steps == jr.decode_steps
    assert tr.host_syncs == jr.host_syncs
    assert t_toks == j_toks
    assert sum(map(len, t_toks)) == sum(TARGETS) - len(TARGETS)
    assert np.isfinite(tr.completion).all() and np.isfinite(tr.ttft).all()


def test_continuous_chunked_same_produced(engine):
    r1 = serve_continuous(engine, PROMPTS, TARGETS, slots=2, chunk=1)
    r8 = serve_continuous(engine, PROMPTS, TARGETS, slots=2, chunk=8)
    assert list(r1.produced) == list(r8.produced) == TARGETS
    # chunk cut at the earliest completion while queued: no extra decode
    assert r8.decode_steps == r1.decode_steps
    assert r8.host_syncs < r1.host_syncs


def test_continuous_matches_batch_tokens(engine):
    res = serve_continuous(engine, PROMPTS, TARGETS, slots=2)
    assert list(res.produced) == TARGETS
    assert np.isfinite(res.completion).all()
    assert res.completion[1] < res.completion[2]   # short ones finish first


def test_continuous_greedy_consistency(engine):
    res = serve_continuous(engine, [np.arange(4, dtype=np.int32)], [5],
                           slots=2)
    assert list(res.produced) == [5]
    assert res.decode_steps >= 4


def test_splice_preserves_other_slots(engine):
    """Splicing a request into slot 0 leaves slot 1 bit-equal and writes
    the request's cache into slot 0."""
    pool = engine.new_cache(2)
    for leaf in tree_leaves(pool):
        leaf[:, 1] = 1.5
    single, _, _, _, _ = engine.prefill_batch([np.arange(4, dtype=np.int32)])
    out = splice_cache(engine.cfg, pool, single, 0, 2, engine.ecfg.max_seq)
    assert out is pool
    for leaf, one in zip(tree_leaves(pool), tree_leaves(single)):
        assert torch.equal(leaf[:, 1], torch.full_like(leaf[:, 1], 1.5))
        assert torch.equal(leaf[:, 0], one[:, 0])


def test_continuous_interleaves_admissions(engine):
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(4)]
    res = serve_continuous(engine, prompts, [12, 2, 2, 2], slots=2)
    assert list(res.produced) == [12, 2, 2, 2]
    assert res.ttft[3] < res.completion[0]     # refilled before it ends


def test_continuous_refuses_uniform_cache_updates(engine):
    eng = Engine(dataclasses.replace(engine.cfg,
                                     decode_cache_update="uniform"),
                 engine.ecfg, params=engine.params, device="cpu")
    with pytest.raises(ValueError, match="per-slot"):
        serve_continuous(eng, PROMPTS, TARGETS)
