"""Sampled decoding in the port's engine on the CPU.  JAX's threefry bits
cannot be matched, so these hold the reference's invariants
(``tests/test_chunked_decode.py``, ``tests/test_compaction.py``): streams
that do not change with the chunk size, elastic compaction, the
compaction implementation or the batch a request is served in; the
sampler's frequencies against softmax(logits / T) over the top k; and the
greedy fallback of a slot with non-finite logits."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

import repro_torch.serving.engine as engine_mod  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    _sample_tokens, _split_slot_keys, sample_noise_bits, slot_keys_for)

ECFG = EngineConfig(max_batch=4, max_seq=128, prompt_bucket=16)
PROMPTS = [np.arange(4, dtype=np.int32) + i for i in range(3)]
TARGETS = [17, 3, 9]
HOT = dict(temperature=0.8, seed=123, return_tokens=True)


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2)


@pytest.fixture(scope="module")
def engine(cfg):
    return Engine(cfg, ECFG, device="cpu")


def test_sampling_chunk_invariant(engine):
    r1 = engine.generate(PROMPTS, TARGETS, chunk=1, **HOT)
    r8 = engine.generate(PROMPTS, TARGETS, chunk=8, **HOT)
    assert list(r1["produced"]) == list(r8["produced"]) == TARGETS
    assert r1["tokens"] == r8["tokens"]


def test_sampling_padded_elastic_solo_equal(engine):
    """Compaction fires here (3 -> 2 live at bucket 4) and gathers the
    keys; a request alone gets the stream it has inside the batch."""
    rp = engine.generate(PROMPTS, TARGETS, chunk=4, **HOT)
    n0 = len(engine.step_log)
    re_ = engine.generate(PROMPTS, TARGETS, elastic=True, chunk=4, **HOT)
    assert any(e["kind"] == "compact" for e in engine.step_log[n0:])
    assert rp["tokens"] == re_["tokens"]
    r1 = engine.generate(PROMPTS, TARGETS, elastic=True, chunk=1, **HOT)
    assert r1["tokens"] == re_["tokens"]
    solo = engine.generate([PROMPTS[0]], [TARGETS[0]], **HOT)
    assert solo["tokens"][0] == rp["tokens"][0]


def test_sampling_fused_equals_host_compaction(cfg, engine):
    runs = {}
    for impl in ("fused", "host"):
        eng = Engine(cfg, dataclasses.replace(ECFG, compact_impl=impl),
                     params=engine.params, device="cpu")
        r = eng.generate(PROMPTS, TARGETS, elastic=True, chunk=4, **HOT)
        runs[impl] = (r, [e for e in eng.step_log if e["kind"] == "compact"])
    (rf, evf), (rh, evh) = runs["fused"], runs["host"]
    assert rf["tokens"] == rh["tokens"]
    assert list(rf["produced"]) == list(rh["produced"]) == TARGETS
    assert len(evf) == len(evh) >= 1
    assert rf["host_syncs"] == rh["host_syncs"] - len(evh)


def test_sampling_reseeds_and_differs_from_greedy(engine):
    g = engine.generate(PROMPTS, TARGETS, chunk=8, return_tokens=True)
    kw = dict(chunk=8, temperature=1.5, seed=7, return_tokens=True)
    s1 = engine.generate(PROMPTS, TARGETS, **kw)
    s2 = engine.generate(PROMPTS, TARGETS, **kw)
    s3 = engine.generate(PROMPTS, TARGETS, **dict(kw, seed=8))
    assert s1["tokens"] == s2["tokens"]          # same seed, same stream
    assert s1["tokens"] != g["tokens"]           # hot sampling != greedy
    assert s1["tokens"] != s3["tokens"]
    assert list(s1["produced"]) == TARGETS
    # without a seed the engine's stream moves on: a new draw each call
    s4 = engine.generate(PROMPTS, TARGETS, chunk=8, temperature=1.5,
                         return_tokens=True)
    assert s4["tokens"] != s2["tokens"]


def test_top_k_one_equals_greedy(engine):
    g = engine.generate(PROMPTS, TARGETS, chunk=8, return_tokens=True)
    s = engine.generate(PROMPTS, TARGETS, chunk=8, temperature=0.7,
                        top_k=1, seed=3, return_tokens=True)
    assert s["tokens"] == g["tokens"]


def test_sampler_frequencies_match_softmax_over_top_k():
    """20,000 draws (4,000 slot streams x 5 steps) on fixed logits: no draw
    outside the top k, and a chi-square test of the counts against
    softmax(l / T) over the top k at the 0.001 level."""
    logits = torch.tensor([1.0, -0.5, 2.0, 0.3, 0.0, 1.7, -2.0, 0.9])
    t, k, slots, steps = 0.7, 5, 4000, 5
    keys = slot_keys_for(0x5EED, slots, "cpu")
    counts = np.zeros(len(logits), np.int64)
    for _ in range(steps):
        keys, subs = _split_slot_keys(keys)
        tok, bad = _sample_tokens(subs, logits.expand(slots, -1), t, k)
        assert not bad.any()
        counts += np.bincount(tok.numpy(), minlength=len(logits))
    top = torch.topk(logits, k).indices.numpy()
    outside = np.setdiff1d(np.arange(len(logits)), top)
    assert counts[outside].sum() == 0
    p = torch.softmax(logits[top] / t, 0).double().numpy()
    stat, pval = stats.chisquare(counts[top], p * counts.sum())
    assert pval > 1e-3, (counts, p, stat)


def test_noise_bits_are_32_bit_and_vary_by_slot_step_and_token():
    keys = slot_keys_for(1, 4, "cpu")
    bits = sample_noise_bits(keys, 1000)
    assert bits.dtype == torch.int64 and bits.shape == (4, 1000)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    nxt = sample_noise_bits(_split_slot_keys(keys)[0], 1000)
    assert len(torch.unique(torch.cat([bits.flatten(), nxt.flatten()]))) \
        == 8000
    # the top bits are uniform enough for 24-bit uniforms: each of 16
    # leading-nibble bins holds 1/16 of the words
    hist = np.bincount((bits >> 28).flatten().numpy(), minlength=16)
    assert stats.chisquare(hist).pvalue > 1e-3


def test_non_finite_slot_falls_back_to_greedy_and_is_counted(cfg,
                                                             monkeypatch):
    """One NaN logit in slot 1 at every prefill and decode step: slot 1
    decodes greedily over its finite logits in the sampled run (the same
    tokens as a greedy run), once per emitted token in
    ``sample_fallbacks``; the other slots still sample."""
    def poison(fn):
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            logits[1, 5] = float("nan")
            return logits, cache
        return wrapped

    monkeypatch.setattr(engine_mod, "prefill", poison(engine_mod.prefill))
    monkeypatch.setattr(engine_mod, "decode_step",
                        poison(engine_mod.decode_step))
    eng = Engine(cfg, ECFG, device="cpu")
    g = eng.generate(PROMPTS, TARGETS, chunk=4, return_tokens=True)
    f0 = eng.sample_fallbacks
    assert f0 == TARGETS[1]
    s = eng.generate(PROMPTS, TARGETS, chunk=4, temperature=1.5, seed=1,
                     return_tokens=True)
    assert eng.sample_fallbacks - f0 == TARGETS[1]
    assert s["tokens"][1] == g["tokens"][1]
    assert 5 not in g["tokens"][1]
    assert s["tokens"][0] != g["tokens"][0]
