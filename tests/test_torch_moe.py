"""The MoE family mixtral-8x7b and moonshot-v1-16b-a3b: the port's configs,
specs, MoE block, model and engine against ``repro`` on the CPU.

Configs compare field for field and capacities for every group size up to
5,000.  The dispatch (``buf``, ``e_flat``, ``p_flat``, ``keep``) is
bit-equal on the same top-k indices, dropped assignments included.
Reference params (``jax.random`` init) go through ``params_from_numpy``;
inputs come from a numpy seed.  The MoE block's output and load-balance
loss are held to 2e-5 in fp32 and bf16 logits to 2e-2 (the bands of
``tests/test_kernels.py``); fp32 logits and caches to 2e-5 of their largest
magnitude (see ``_prefill_decode``); greedy engine streams, ``produced``,
host syncs, compaction events and schedules are equal, with tokens dropped
at capacity in decode steps."""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serving.engine as jax_engine_mod  # noqa: E402
import repro_torch.serving.engine as torch_engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.core.distributions import LogNormalTokens  # noqa: E402
from repro.core.policies import get_policy as jax_get_policy  # noqa: E402
from repro.data.pipeline import make_request_stream as jax_stream  # noqa: E402
from repro.distributed.sharding import NULL_CTX  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.scheduler import run_engine_schedule as jax_schedule  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, get_config, get_smoke_config)
from repro_torch.core.policies import get_policy  # noqa: E402
from repro_torch.data.pipeline import make_request_stream  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    map_tree, params_from_numpy, tree_leaves)
from repro_torch.serving import (  # noqa: E402
    Engine, EngineConfig, run_engine_schedule)

MOE = ("mixtral-8x7b", "moonshot-v1-16b-a3b")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jax_get_smoke(arch), num_layers=2, **kw)
    tc = dataclasses.replace(get_smoke_config(arch), num_layers=2, **kw)
    return jc, tc


def _cpu(tree, dtype=None):
    return params_from_numpy(tree, device="cpu", dtype=dtype)


def _decode_drops(log):
    """Assignments dropped at capacity in decode steps (seq 1), from a
    ``count_drops`` log."""
    return sum(int(n) for s, n in log if s == 1)


# ----------------------------------------------------------------------------
# Configs, specs and capacity
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_configs_equal_reference_field_for_field(arch):
    full, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_get_smoke(arch))
    assert full.param_count() == ref.param_count() == full.expected_params
    assert full.active_param_count() == ref.active_param_count()
    for n in (1, 16):          # phase 4e's reduced mixtral: 16 of 32 layers
        assert dataclasses.replace(full, num_layers=n).param_count() == \
            dataclasses.replace(ref, num_layers=n).param_count()
    assert get_smoke_config(arch).param_count() == \
        jax_get_smoke(arch).param_count()
    assert arch in ARCH_IDS


@pytest.mark.parametrize("arch", MOE)
def test_specs_equal_reference(arch):
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    for jc, tc in (_cfgs(arch), (jax_get_config(arch), get_config(arch))):
        for jt, tt in ((JM.param_specs(jc), TM.param_specs(tc)),
                       (JM.cache_specs(jc, 4, 64), TM.cache_specs(tc, 4, 64)),
                       (JMoE.moe_specs(jc), TMoE.moe_specs(tc))):
            jl = jax.tree.leaves(jt, is_leaf=is_spec)
            assert [(s.shape, s.axes, s.init, s.scale) for s in jl] == \
                [(s.shape, s.axes, s.init, s.scale) for s in tree_leaves(tt)]
            assert jax.tree.structure(jt, is_leaf=is_spec) == \
                jax.tree.structure(map_tree(lambda s: 0, tt))
    # moonshot's two shared experts: one gated FFN of 2 x moe_d_ff
    shared = TMoE.moe_specs(get_config(arch)).get("shared_up")
    assert (shared.shape[1] if shared else 0) == \
        get_config(arch).num_shared_experts * get_config(arch).moe_d_ff


@pytest.mark.parametrize("cf", [None, 0.3, 4.0])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_equals_reference(arch, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    for tc, jc in ((dataclasses.replace(get_config(arch), **kw),
                    dataclasses.replace(jax_get_config(arch), **kw)),
                   (dataclasses.replace(get_smoke_config(arch), **kw),
                    dataclasses.replace(jax_get_smoke(arch), **kw))):
        got = [TMoE._capacity(tc, t) for t in range(1, 5001)]
        assert got == [JMoE._capacity(jc, t) for t in range(1, 5001)]
    if cf is None:      # the serving buckets' capacities
        c = get_config(arch)
        assert [TMoE._capacity(c, t) for t in (4, 8, 16, 4096)] == \
            ([4, 4, 8, 1280] if arch == "mixtral-8x7b" else [4, 4, 4, 480])


# ----------------------------------------------------------------------------
# The MoE block against repro.models.moe
# ----------------------------------------------------------------------------

def _top_idx(rng, t, k, e):
    """[t, k] distinct experts per token, as top-k gives them."""
    return np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)


@pytest.mark.parametrize("t,e,k,cap", [(16, 4, 2, 8), (16, 4, 2, 4),
                                       (37, 8, 2, 4), (64, 8, 6, 12),
                                       (5, 8, 2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_group_bit_equal_to_reference(t, e, k, cap, dtype):
    rng = np.random.default_rng(t * 31 + cap)
    x = rng.standard_normal((t, 24), np.float32)
    idx = _top_idx(rng, t, k, e)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx = jnp.asarray(x).astype(jd)
    ref = JMoE._dispatch_group(jx, None, jnp.asarray(idx), e, cap)
    got = TMoE._dispatch_group(_cpu(jx), torch.from_numpy(idx), e, cap)
    assert got[0].dtype == td and tuple(got[0].shape) == (e, cap, 24)
    np.testing.assert_array_equal(got[0].float().numpy(),
                                  np.asarray(ref[0].astype(jnp.float32)))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dropped = int((~got[3]).sum())
    if cap * e < t * k:         # more assignments than slots: some drop
        assert dropped >= t * k - cap * e
    if cap >= t:                # an expert takes at most t: dropless
        assert dropped == 0


@pytest.mark.parametrize("groups,b", [(1, 3), (2, 4), (2, 3)])
@pytest.mark.parametrize("arch,shared,cf", [
    ("mixtral-8x7b", 0, None), ("mixtral-8x7b", 2, None),
    ("mixtral-8x7b", 0, 0.3), ("moonshot-v1-16b-a3b", 1, None),
    ("moonshot-v1-16b-a3b", 0, None), ("moonshot-v1-16b-a3b", 1, 0.3)])
def test_moe_block_matches_reference(arch, shared, cf, groups, b):
    """Output and Switch aux loss in fp32, with and without shared experts,
    with capacity forced low (drops), and the group rule: ``moe_groups``
    groups when it divides the tokens (b = 4), else one (b = 3)."""
    kw = dict(num_shared_experts=shared, moe_groups=groups)
    if cf is not None:
        kw["capacity_factor"] = cf
    jc = dataclasses.replace(jax_get_smoke(arch), **kw)
    tc = dataclasses.replace(get_smoke_config(arch), **kw)
    jp = jax_init_params(JMoE.moe_specs(jc), jax.random.PRNGKey(1),
                         jnp.float32)
    x = np.random.default_rng(2).standard_normal((b, 15, jc.d_model),
                                                 np.float32)
    jo, ja = JMoE.moe_block(jp, jnp.asarray(x), jc, NULL_CTX,
                            return_aux=True)
    with TMoE.count_drops() as log:
        to, ta = TMoE.moe_block(_cpu(jp), torch.from_numpy(x), tc,
                                return_aux=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL["float32"])
    np.testing.assert_allclose(float(ta), float(ja), **TOL["float32"])
    assert TMoE.moe_block(_cpu(jp), torch.from_numpy(x), tc)[1] == 0.0
    assert [s for s, _ in log] == [15]
    assert (int(log[0][1]) > 0) == (cf is not None)


# ----------------------------------------------------------------------------
# Prefill + decode against repro.models.model
# ----------------------------------------------------------------------------

def _cache_close(tcache, jcache):
    for a, b in zip(tree_leaves(tcache), tree_leaves(_cpu(jcache))):
        scale = float(b.float().abs().max())
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0, atol=2e-5 * max(scale, 1.0))


def _logits_close(tl, jl, dtype):
    ref = np.asarray(jl, np.float32)
    tol = TOL[dtype] if dtype == "bfloat16" else dict(
        rtol=0, atol=2e-5 * max(float(np.abs(ref).max()), 1.0))
    np.testing.assert_allclose(tl.float().numpy(), ref, **tol)


def _prefill_decode(jc, tc, dtype, steps=8, seed=0, lens=(16, 5, 9),
                    max_seq=64):
    """Prefill three ragged prompts, then ``steps`` greedy decode steps in
    both packages from the same params; asserts logits at every step (and
    caches in fp32) and returns the last logits.

    fp32 logits are held to 2e-5 of their largest magnitude, as caches are,
    not element by element: over 24 decode steps a few logits near zero
    differ by up to 3.7e-5 (seed 0).  The MoE block itself agrees to 2e-7
    of its output's scale on the same inputs; the gap is the two
    frameworks' fp32 summation order in the attention branch, amplified by
    the smoke init's residual stream of ~900 (the dense configs' logits
    drift the same way, to 1.8e-5 over 24 steps)."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(seed), jd)
    tp = _cpu(jp)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (3, max(lens))).astype(np.int32)
    lens = np.array(lens, np.int32)
    jcache = JM.init_cache(jc, 3, max_seq, jd)
    jl, jcache = jax.jit(lambda p, c, t, l: JM.prefill(
        jc, p, t, cache=c, prompt_lens=l))(jp, jcache, jnp.asarray(toks),
                                            jnp.asarray(lens))
    tcache = TM.init_cache(tc, 3, max_seq, td, device="cpu")
    tl, tcache = TM.prefill(tc, tp, torch.from_numpy(toks), cache=tcache,
                            prompt_lens=torch.from_numpy(lens))
    _logits_close(tl, jl, dtype)
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    kv = lens.copy()
    for _ in range(steps):
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(kv))
        _logits_close(tl, jl, dtype)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        kv = kv + 1
    if dtype == "float32":
        _cache_close(tcache, jcache)
    return tl, jl


@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference_fp32(arch, impl):
    """Two layers, 24 decode steps from prompts of 16, 5 and 9 tokens at
    max_seq 64: mixtral's window of 32 makes its cache a 32-slot ring,
    which the longest prompt passes after 16 steps."""
    jc, tc = _cfgs(arch, decode_attention_impl=impl,
                   decode_cache_update="scatter")
    assert TM.cache_specs(tc, 3, 64)["pos0"]["k"].shape[2] == \
        (32 if arch == "mixtral-8x7b" else 64)
    _prefill_decode(jc, tc, "float32", steps=24)


def test_window_ring_with_a_prompt_longer_than_the_span():
    """A 48-token prompt into mixtral's 32-slot ring: prefill keeps its last
    32 keys at slots 0-31 and decode then writes at ``kv_lens % 32``, which
    is not where that ring would hold them (ROADMAP.md, queue 3, reference
    caveats); the port does what the reference does, logits and caches."""
    jc, tc = _cfgs("mixtral-8x7b", decode_cache_update="scatter",
                   decode_attention_impl="ragged")
    _prefill_decode(jc, tc, "float32", steps=6, lens=(48, 40, 7))


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference_bf16(arch):
    """bf16 on the smoke configs as the reference defines them (one
    layer); two layers are held to the reference's fp32 logits in
    ``tests/test_torch_bf16_depth.py``."""
    jc = dataclasses.replace(jax_get_smoke(arch), dtype="bfloat16",
                             decode_cache_update="scatter")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                             decode_cache_update="scatter")
    _prefill_decode(jc, tc, "bfloat16", steps=4)


# ----------------------------------------------------------------------------
# The engine: greedy token streams with decode drops
# ----------------------------------------------------------------------------

# bucket 8 with capacity_factor 0.5: an expert takes at most 4 of a decode
# step's 8 tokens, so decode steps drop assignments
ECFG = dict(max_batch=8, max_seq=64, prompt_bucket=16)
CF = 0.5
PROMPTS = [np.arange(4 + i % 3, dtype=np.int32) * 7 + i for i in range(6)]
TARGETS = [30, 3, 9, 17, 5, 12]


@pytest.fixture(scope="module", params=MOE)
def engines(request):
    arch = request.param
    jc, tc = _cfgs(arch, capacity_factor=CF)
    jeng = JaxEngine(jc, JaxEngineConfig(**ECFG))
    host = JaxEngine(jc, JaxEngineConfig(**ECFG, compact_impl="host"),
                     params=jeng.params)
    return arch, tc, {"fused": jeng, "host": host}


def _port(engines, **kw):
    _, tc, jengs = engines
    return Engine(tc, EngineConfig(**ECFG, **kw),
                  params=_cpu(jengs["fused"].params), device="cpu")


def _events(eng, n0=0):
    return [(e["impl"], e["batch"], e["syncs"]) for e in eng.step_log[n0:]
            if e["kind"] == "compact"]


@pytest.mark.parametrize("mode,impl", [("padded", "fused"),
                                       ("elastic", "fused"),
                                       ("elastic", "host")])
def test_engine_greedy_streams_equal_reference(engines, mode, impl):
    elastic = mode == "elastic"
    jeng = engines[2][impl]
    teng = _port(engines, compact_impl=impl)
    n0 = len(jeng.step_log)
    jr = jeng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=4,
                       return_tokens=True)
    with TMoE.count_drops() as log:
        tr = teng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=4,
                           return_tokens=True)
    assert tr["tokens"] == jr["tokens"]
    assert list(tr["produced"]) == list(jr["produced"]) == TARGETS
    assert tr["host_syncs"] == jr["host_syncs"]
    assert _events(teng) == _events(jeng, n0)
    assert (len(_events(teng)) > 0) == elastic
    assert [e["steps"] for e in teng.step_log if e["kind"] == "decode_chunk"] \
        == [e["steps"] for e in jeng.step_log[n0:] if e["kind"] == "decode_chunk"]
    assert _decode_drops(log) > 0, "no decode step dropped an assignment"


def _stream(mod_stream, vocab=512):
    return mod_stream(10, 4.0, LogNormalTokens(log_mean=1.8, log_std=0.6,
                                               support=20),
                      vocab=vocab, prompt_len_range=(3, 12), seed=5)


@pytest.mark.parametrize("name,kw", [("elastic", {"b_max": 8}),
                                     ("dynamic", {"b_max": 8})])
def test_run_engine_schedule_equals_reference(engines, monkeypatch, name, kw):
    for mod in (jax_engine_mod, torch_engine_mod):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: float(next(t))))
    teng = _port(engines)
    tr = run_engine_schedule(get_policy(name, **kw), teng,
                             _stream(make_request_stream))
    jr = jax_schedule(jax_get_policy(name, **kw), engines[2]["fused"],
                      _stream(jax_stream))
    assert tr.batch_sizes == jr.batch_sizes
    assert len(tr.batch_sizes) > 1
    np.testing.assert_array_equal(tr.waits, jr.waits)
    np.testing.assert_array_equal(tr.e2e, jr.e2e)
    assert tr.makespan == jr.makespan


@pytest.mark.parametrize("arch", MOE)
def test_launcher_runs_each_moe_arch_on_the_cpu(capsys, arch):
    """``python -m repro_torch.launch.serve --arch <id> --smoke --device
    cpu``."""
    S.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "served=3/3" in out[-2]
    assert out[-1].startswith("[serve] mean queue wait")
