"""musicgen-large (the audio family): the port's config, specs, sinusoidal
positions, model (through token ids and through ``embeds=``) and engine
against ``repro`` on the CPU.

musicgen is MHA with heads of 64 ((G, D) = (1, 64) for the attention
kernels), a non-gated tanh-GELU FFN, and a sinusoid table added to the
inputs.  The table's frequencies are an exp of float32 arguments, and
``torch.exp`` and XLA's float32 exp differ by one ulp in about one
argument in ten: at d_model 2,048 and position 4,095 that moves the table
by 2.4e-4.  The port computes XLA's exp step for step
(``layers._exp_f32_xla``), so its frequencies are the reference's bit for
bit; the table then differs only by the two libraries' sin and cos, at
most 1.2e-7 over positions 0-4,095.  Logits are held to 2e-5 in fp32 and
2e-2 in bf16 (the smoke config has one layer), caches to 2e-5 of their
largest magnitude."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, get_config, get_smoke_config)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    map_tree, params_from_numpy, tree_leaves)
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

ARCH = "musicgen-large"
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**kw):
    kw.setdefault("decode_cache_update", "scatter")
    return (dataclasses.replace(jax_get_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _cpu(tree, dtype=None):
    return params_from_numpy(tree, device="cpu", dtype=dtype)


# ----------------------------------------------------------------------------
# Config and specs
# ----------------------------------------------------------------------------

def test_config_equals_reference_field_for_field():
    full, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_get_smoke(ARCH))
    assert full.param_count() == ref.param_count()
    assert (full.num_heads // full.num_kv_heads, full.head_dim) == (1, 64)
    assert ARCH in ARCH_IDS


def test_specs_equal_reference():
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    for jc, tc in (_cfgs(), (jax_get_config(ARCH), get_config(ARCH))):
        for jt, tt in ((JM.param_specs(jc), TM.param_specs(tc)),
                       (JM.cache_specs(jc, 4, 64), TM.cache_specs(tc, 4, 64))):
            jl = jax.tree.leaves(jt, is_leaf=is_spec)
            assert [(s.shape, s.axes, s.init) for s in jl] == \
                [(s.shape, s.axes, s.init) for s in tree_leaves(tt)]
            assert jax.tree.structure(jt, is_leaf=is_spec) == \
                jax.tree.structure(map_tree(lambda s: 0, tt))


# ----------------------------------------------------------------------------
# Sinusoidal positions
# ----------------------------------------------------------------------------

def test_exp_is_xlas_bit_for_bit():
    """``_exp_f32_xla`` equals ``jnp.exp`` on float32 bit for bit over
    [-87, 88] (2,000,001 points) and on the sinusoid's own arguments;
    ``torch.exp`` does not on the latter."""
    x = np.linspace(-87.0, 88.0, 2_000_001).astype(np.float32)
    ref = np.asarray(jnp.exp(jnp.asarray(x)))
    np.testing.assert_array_equal(
        TL._exp_f32_xla(torch.from_numpy(x)).numpy().view(np.int32),
        ref.view(np.int32))
    half = 1024
    arg = -np.log(10000.0) * torch.arange(half, dtype=torch.float32) / half
    ref = np.asarray(jnp.exp(jnp.asarray(arg.numpy())))
    assert np.array_equal(TL._exp_f32_xla(arg).numpy(), ref)
    assert not np.array_equal(torch.exp(arg).numpy(), ref)


@pytest.mark.parametrize("d_model", [64, 2048])
def test_sinusoid_table_matches_reference(d_model):
    """The table at positions 0-4,095: within 1.2e-7 of the reference's
    (the libraries' sin and cos), where torch.exp's frequencies would put
    it 2.4e-4 off at d_model 2,048."""
    pos = np.arange(4096, dtype=np.int32)
    ref = np.asarray(JL.sinusoidal_embedding(jnp.asarray(pos), d_model))
    got = TL.sinusoidal_embedding(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == (4096, d_model)
    err = float(np.abs(got.numpy() - ref).max())
    assert err <= 1.2e-7, err
    # the same positions as [B, S] (prefill) and [B, 1] (decode)
    np.testing.assert_array_equal(
        TL.sinusoidal_embedding(torch.from_numpy(pos).view(64, 64),
                                d_model).reshape(4096, d_model).numpy(),
        got.numpy())


# ----------------------------------------------------------------------------
# Prefill + decode against repro.models.model
# ----------------------------------------------------------------------------

def _prefill_decode(jc, tc, dtype, *, embeds_dtype=None, steps=4, seed=0):
    """Prefill three ragged prompts (token ids, or their embeddings when
    ``embeds_dtype`` is given), then ``steps`` greedy decode steps; logits
    held at every step and caches in fp32."""
    jd, td = DTYPES[dtype]
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(seed), jd)
    tp = _cpu(jp)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (3, 16)).astype(np.int32)
    lens = np.array([16, 5, 9], np.int32)
    if embeds_dtype is None:
        jin, tin = dict(tokens=jnp.asarray(toks)), dict(
            tokens=torch.from_numpy(toks))
    else:
        ed, etd = DTYPES[embeds_dtype]
        emb = rng.standard_normal((3, 16, jc.d_model), np.float32)
        jin = dict(embeds=jnp.asarray(emb, ed))
        tin = dict(embeds=torch.from_numpy(emb).to(etd))
    jcache = JM.init_cache(jc, 3, 64, jd)
    jl, jcache = jax.jit(lambda p, c, l, kw: JM.prefill(
        jc, p, cache=c, prompt_lens=l, **kw))(jp, jcache, jnp.asarray(lens),
                                              jin)
    tcache = TM.init_cache(tc, 3, 64, td, device="cpu")
    tl, tcache = TM.prefill(tc, tp, cache=tcache,
                            prompt_lens=torch.from_numpy(lens), **tin)
    tol = TOL["float32" if (embeds_dtype or dtype) == "float32" and
              dtype == "float32" else "bfloat16"]
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               **tol)
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    tok, kv = np.array(jnp.argmax(jl, -1), np.int32), lens.copy()
    for _ in range(steps):
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(kv))
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), **TOL[dtype])
        tok, kv = np.array(jnp.argmax(jl, -1), np.int32), kv + 1
    if dtype == "float32":
        for a, b in zip(tree_leaves(tcache), tree_leaves(_cpu(jcache))):
            scale = float(b.abs().max())
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=2e-5 * max(scale, 1.0))


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_prefill_and_decode_through_tokens_fp32(impl, layout):
    _prefill_decode(*_cfgs(decode_attention_impl=impl, cache_layout=layout),
                    "float32")


def test_prefill_and_decode_through_tokens_bf16():
    _prefill_decode(*_cfgs(dtype="bfloat16"), "bfloat16")


@pytest.mark.parametrize("dtype,embeds_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_prefill_through_embeds(dtype, embeds_dtype):
    """``embeds=`` enter in their own dtype, uncast: fp32 embeddings in a
    bf16 model run the prompt in fp32 (bf16 weights cast up), as the
    reference does, and decode then runs on the bf16 caches."""
    _prefill_decode(*_cfgs(dtype=dtype), dtype, embeds_dtype=embeds_dtype)


def test_embeds_equal_token_path_on_the_table_rows():
    """Embeddings equal to the table rows of the tokens give the token
    path's logits bit for bit (the sinusoid is added the same way)."""
    _, tc = _cfgs()
    jc, _ = _cfgs()
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(1),
                         jnp.float32)
    tp = _cpu(jp)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 16)
                                             ).astype(np.int32)
    outs = []
    for kw in (dict(tokens=torch.from_numpy(toks)),
               dict(embeds=tp["embed"][torch.from_numpy(toks).long()])):
        cache = TM.init_cache(tc, 2, 32, torch.float32, device="cpu")
        outs.append(TM.prefill(tc, tp, cache=cache, **kw)[0])
    assert torch.equal(*outs)


# ----------------------------------------------------------------------------
# The engine: greedy token streams
# ----------------------------------------------------------------------------

ECFG = dict(max_batch=4, max_seq=128, prompt_bucket=16)


@pytest.mark.parametrize("elastic", [False, True])
def test_engine_greedy_streams_equal_reference(elastic):
    jc, tc = _cfgs(num_layers=2)
    jeng = JaxEngine(jc, JaxEngineConfig(**ECFG))
    teng = Engine(tc, EngineConfig(**ECFG), params=_cpu(jeng.params),
                  device="cpu")
    prompts = [np.arange(4, dtype=np.int32) * 7 + i for i in range(3)]
    targets = [17, 3, 9]
    jr = jeng.generate(prompts, targets, elastic=elastic, chunk=4,
                       return_tokens=True)
    tr = teng.generate(prompts, targets, elastic=elastic, chunk=4,
                       return_tokens=True)
    assert np.array_equal(np.array(tr["tokens"], dtype=object),
                          np.array(jr["tokens"], dtype=object))
    assert list(tr["produced"]) == list(jr["produced"]) == targets
    assert tr["host_syncs"] == jr["host_syncs"]


def test_launcher_runs_musicgen_on_the_cpu(capsys):
    from repro_torch.launch import serve as S
    S.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "served=3/3" in out[-2]
    assert out[-1].startswith("[serve] mean queue wait")
