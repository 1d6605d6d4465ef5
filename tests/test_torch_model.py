"""The port's dense decoder against ``repro.models`` on the CPU.

Reference params (``jax.random`` init) are converted with
``params_from_numpy``; inputs come from a numpy seed.  Logits are held to
2e-5 in fp32 (absolute and relative, the band of ``tests/test_kernels.py``).
Cache entries are held to 2e-5 of the cache's largest magnitude: the
layer-1 K/V rows sit after a whole layer whose random weights make them
O(20), and the two frameworks round their matrix products in different
orders."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, get_config, get_smoke_config)
from repro_torch.kernels.rmsnorm import fused_rmsnorm  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    map_tree, params_from_numpy, tree_leaves)

TOL = dict(atol=2e-5, rtol=2e-5)


def _cfgs(**kw):
    jc = dataclasses.replace(jax_get_smoke("qwen2.5-3b"), num_layers=2, **kw)
    tc = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2, **kw)
    return jc, tc


@pytest.fixture(scope="module")
def jax_params():
    jc, _ = _cfgs()
    return jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(0),
                           jnp.float32)


def _cpu(tree):
    return params_from_numpy(tree, device="cpu")


def _assert_cache_close(tcache, jcache):
    for a, b in zip(tree_leaves(tcache), tree_leaves(_cpu(jcache))):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2e-5 * max(scale, 1.0))


# ----------------------------------------------------------------------------
# Config, specs and the weight bridge
# ----------------------------------------------------------------------------

def test_configs_equal_reference_field_for_field():
    """The registries serve the same ten ids in the same order, and every
    config and smoke config compares field for field."""
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch)), arch
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_get_smoke(arch)), arch
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count(), arch
    with pytest.raises(KeyError):
        get_config("no-such-model")


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_specs_equal_reference(layout):
    jc, tc = _cfgs(cache_layout=layout)
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    for jt, tt in ((JM.param_specs(jc), TM.param_specs(tc)),
                   (JM.cache_specs(jc, 4, 64), TM.cache_specs(tc, 4, 64))):
        jl = jax.tree.leaves(jt, is_leaf=is_spec)
        tl = tree_leaves(tt)
        assert [(s.shape, s.axes, s.init) for s in jl] == \
            [(s.shape, s.axes, s.init) for s in tl]
        assert jax.tree.structure(jt, is_leaf=is_spec) == \
            jax.tree.structure(map_tree(lambda s: 0, tt))


def test_params_round_trip_bit_exact(jax_params):
    tp = _cpu(jax_params)
    assert jax.tree.structure(jax_params) == \
        jax.tree.structure(map_tree(lambda t: 0, tp))
    for j, t in zip(jax.tree.leaves(jax_params), tree_leaves(tp)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # bf16 leaves keep their bits
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jax_params)
    for j, t in zip(jax.tree.leaves(jb), tree_leaves(_cpu(jb))):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                      t.view(torch.uint16).numpy())


def test_unported_model_parts_raise():
    """Only ``decode_unroll_layers`` stays refused (the port updates caches
    in place instead); cross-attention positions, the bhsd layout and
    sinusoidal positions, refused before, now build."""
    _, tc = _cfgs()
    with pytest.raises(NotImplementedError, match="decode_unroll_layers"):
        TM.param_specs(dataclasses.replace(tc, decode_unroll_layers=True))
    for ported in (dict(group_pattern=(("cross_attn", "dense"),),
                        vision_seq=8),
                   dict(cache_layout="bhsd"),
                   dict(pos_embedding="sinusoidal")):
        cfg = dataclasses.replace(tc, **ported)
        TM.param_specs(cfg)
        TM.cache_specs(cfg, 2, 16)


def test_auto_decode_attention_resolves_from_device():
    _, tc = _cfgs()
    assert tc.decode_attention_impl == "auto"
    assert tc.resolve_decode_attention_impl(torch.device("cpu")) == "dense"
    assert tc.resolve_decode_attention_impl(torch.device("cuda")) == "ragged"
    for forced in ("dense", "ragged"):
        c = dataclasses.replace(tc, decode_attention_impl=forced)
        assert c.resolve_decode_attention_impl(torch.device("cpu")) == forced


# ----------------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16), np.float32) * 3
    w = rng.standard_normal((16,), np.float32) * 0.1
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    # the port's norm is the fused residual-add + RMSNorm; with a zero
    # residual it is the reference's plain layer norm
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        fused_rmsnorm(tx, torch.zeros_like(tx), torch.from_numpy(w),
                      eps=1e-6)[1].numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-4, rtol=1e-4)   # angles up to 4000 rad: cos/sin round apart


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None),
    dict(causal=True, window=5, softcap=30.0),
    dict(causal=False, window=None, kv_len_mask=True),
])
def test_dense_attention_matches_reference(kw):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 12, 4, 16), np.float32)
    k = rng.standard_normal((2, 12, 2, 16), np.float32)
    v = rng.standard_normal((2, 12, 2, 16), np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_len_mask"):
        m = np.arange(12)[None, :] < np.array([[7], [12]])
        jkw["kv_len_mask"], tkw["kv_len_mask"] = jnp.asarray(m), torch.from_numpy(m)
    out = TL.dense_attention(*map(torch.from_numpy, (q, k, v)), **tkw)
    ref = JL.dense_attention(*map(jnp.asarray, (q, k, v)), **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------------------------
# Prefill + 32 decode steps
# ----------------------------------------------------------------------------

def _prefill_both(jc, tc, jp, tp, toks, lens, max_seq):
    jcache = JM.init_cache(jc, toks.shape[0], max_seq, jnp.float32)
    jl, jcache = jax.jit(lambda p, c, t, l: JM.prefill(
        jc, p, t, cache=c, prompt_lens=l))(jp, jcache, jnp.asarray(toks),
                                            jnp.asarray(lens))
    tcache = TM.init_cache(tc, toks.shape[0], max_seq, torch.float32,
                           device="cpu")
    tl, tcache = TM.prefill(tc, tp, torch.from_numpy(toks), cache=tcache,
                            prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_cache_close(tcache, jcache)
    return jl, jcache, tl, tcache


@pytest.mark.parametrize("mode", ["onehot", "scatter", "uniform"])
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_prefill_and_decode_match_reference(jax_params, impl, mode):
    jc, tc = _cfgs(decode_attention_impl=impl, decode_cache_update=mode)
    tp = _cpu(jax_params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (3, 16)).astype(np.int32)
    # 'uniform' writes every slot at slot 0's position: lock-step lengths
    lens = np.full(3, 16, np.int32) if mode == "uniform" else \
        np.array([16, 5, 9], np.int32)
    jl, jcache, tl, tcache = _prefill_both(jc, tc, jax_params, tp, toks,
                                           lens, 64)
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    kv = lens.copy()
    for _ in range(32):
        jl, jcache = step(jax_params, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(kv))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        kv = kv + 1
    _assert_cache_close(tcache, jcache)


def test_long_prefill_takes_blockwise_attention(jax_params):
    """A prompt above ``attn_dense_max_seq`` (128 at smoke size) runs
    ``blockwise_attention`` in both packages."""
    jc, tc = _cfgs()
    assert 160 > tc.attn_dense_max_seq
    toks = np.random.default_rng(3).integers(0, 512, (2, 160)).astype(np.int32)
    _prefill_both(jc, tc, jax_params, _cpu(jax_params), toks,
                  np.array([160, 131], np.int32), 192)


def test_blockwise_attention_matches_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 64, 4, 16), np.float32)
    k = rng.standard_normal((1, 64, 2, 16), np.float32)
    v = rng.standard_normal((1, 64, 2, 16), np.float32)
    kw = dict(causal=True, window=24, block_q=16, block_kv=16)
    out = TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    ref = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------------------------
# The head-major (bhsd) cache layout
# ----------------------------------------------------------------------------

def test_decode_attention_bhsd_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 1, 4, 16), np.float32)
    k, v = (rng.standard_normal((3, 2, 20, 16), np.float32) for _ in range(2))
    lens = np.array([20, 1, 7], np.int32)
    out = TL.decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                              layout="bhsd")
    ref = JL.decode_attention(*map(jnp.asarray, (q, k, v, lens)), window=None,
                              layout="bhsd")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the same cache in bshd gives the same attention
    bshd = TL.decode_attention(*map(torch.from_numpy, (
        q, k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy(),
        lens)))
    np.testing.assert_allclose(out.numpy(), bshd.numpy(), **TOL)


@pytest.mark.parametrize("mode", ["onehot", "scatter", "uniform"])
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_bhsd_prefill_and_decode_match_reference(jax_params, impl, mode):
    """Head-major caches [g, B, Hkv, S, D]: prefill writes its K/V
    transposed, every decode mode writes its row transposed, and decode
    reads them with the plain ``decode_attention(layout="bhsd")`` whatever
    ``decode_attention_impl`` says (the ragged kernel is bshd-only), as
    the reference routes them."""
    jc, tc = _cfgs(decode_attention_impl=impl, decode_cache_update=mode,
                   cache_layout="bhsd")
    tp = _cpu(jax_params)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 512, (3, 16)).astype(np.int32)
    lens = np.full(3, 16, np.int32) if mode == "uniform" else \
        np.array([16, 5, 9], np.int32)
    jl, jcache, tl, tcache = _prefill_both(jc, tc, jax_params, tp, toks,
                                           lens, 64)
    assert tcache["pos0"]["k"].shape == (2, 3, 2, 64, 16)
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    kv = lens.copy()
    for _ in range(8):
        jl, jcache = step(jax_params, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(kv))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        kv = kv + 1
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("elastic", [False, True])
def test_bhsd_engine_greedy_streams_equal_reference(jax_params, elastic):
    """A bhsd qwen smoke model served by both engines: the same greedy
    tokens, through elastic compaction of the head-major caches."""
    from repro.serving.engine import Engine as JaxEngine
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro_torch.serving import Engine, EngineConfig
    jc, tc = _cfgs(cache_layout="bhsd")
    ecfg = dict(max_batch=4, max_seq=128, prompt_bucket=16)
    jeng = JaxEngine(jc, JaxEngineConfig(**ecfg), params=jax_params)
    teng = Engine(tc, EngineConfig(**ecfg), params=_cpu(jax_params),
                  device="cpu")
    prompts = [np.arange(4, dtype=np.int32) * 7 + i for i in range(3)]
    targets = [17, 3, 9]
    jr = jeng.generate(prompts, targets, elastic=elastic, chunk=4,
                       return_tokens=True)
    tr = teng.generate(prompts, targets, elastic=elastic, chunk=4,
                       return_tokens=True)
    assert tr["tokens"] == [list(map(int, t)) for t in jr["tokens"]]
    assert list(tr["produced"]) == list(jr["produced"]) == targets
