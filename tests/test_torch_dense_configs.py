"""The dense families internlm2-1.8b, yi-9b and gemma-7b: the port's
configs, specs, model and engine against ``repro`` on the CPU.

Configs compare field for field.  Reference params (``jax.random`` init)
go through ``params_from_numpy``; inputs come from a numpy seed.  Logits
are held to 2e-5 in fp32 and 2e-2 in bf16 (the bands of
``tests/test_kernels.py``), caches to 2e-5 of the cache's largest
magnitude in fp32 (as ``tests/test_torch_model.py`` does); greedy engine
streams are equal.  K1's and K3's plain versions at the new (G, D) pairs
(2, 128) and (1, 256) are held to the Pallas kernels in
``tests/test_torch_kernels.py``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.distributed.sharding import NULL_CTX  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import scaled_down as jax_scaled_down  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, get_config, get_smoke_config)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.config import scaled_down  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    map_tree, params_from_numpy, tree_leaves)
from repro_torch.serving import Engine, EngineConfig  # noqa: E402

DENSE = ("internlm2-1.8b", "yi-9b", "gemma-7b")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jax_get_smoke(arch), num_layers=2, **kw)
    tc = dataclasses.replace(get_smoke_config(arch), num_layers=2, **kw)
    return jc, tc


def _cpu(tree, dtype=None):
    return params_from_numpy(tree, device="cpu", dtype=dtype)


# ----------------------------------------------------------------------------
# Configs and specs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_reference_field_for_field(arch):
    full, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_get_smoke(arch))
    assert full.param_count() == ref.param_count() == full.expected_params
    assert get_smoke_config(arch).param_count() == \
        jax_get_smoke(arch).param_count()
    assert arch in ARCH_IDS


@pytest.mark.parametrize("arch", DENSE)
def test_specs_equal_reference(arch):
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    for jc, tc in (_cfgs(arch), (jax_get_config(arch), get_config(arch))):
        for jt, tt in ((JM.param_specs(jc), TM.param_specs(tc)),
                       (JM.cache_specs(jc, 4, 64), TM.cache_specs(tc, 4, 64))):
            jl = jax.tree.leaves(jt, is_leaf=is_spec)
            assert [(s.shape, s.axes, s.init) for s in jl] == \
                [(s.shape, s.axes, s.init) for s in tree_leaves(tt)]
            assert jax.tree.structure(jt, is_leaf=is_spec) == \
                jax.tree.structure(map_tree(lambda s: 0, tt))
    # internlm2 and yi untie their heads: the port's spec tree has lm_head
    assert ("lm_head" in TM.param_specs(get_config(arch))) == \
        (arch != "gemma-7b")


# ----------------------------------------------------------------------------
# Prefill + decode against repro.models.model
# ----------------------------------------------------------------------------

def _cache_close(tcache, jcache):
    for a, b in zip(tree_leaves(tcache), tree_leaves(_cpu(jcache))):
        scale = float(b.float().abs().max())
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=0, atol=2e-5 * max(scale, 1.0))


def _prefill_decode(jc, tc, dtype, steps=8, seed=0):
    """Prefill three ragged prompts, then ``steps`` greedy decode steps in
    both packages from the same params; asserts logits at every step (and
    caches in fp32) and returns the last logits."""
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(seed), jd)
    tp = _cpu(jp)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (3, 16)).astype(np.int32)
    lens = np.array([16, 5, 9], np.int32)
    jcache = JM.init_cache(jc, 3, 64, jd)
    jl, jcache = jax.jit(lambda p, c, t, l: JM.prefill(
        jc, p, t, cache=c, prompt_lens=l))(jp, jcache, jnp.asarray(toks),
                                            jnp.asarray(lens))
    tcache = TM.init_cache(tc, 3, 64, td, device="cpu")
    tl, tcache = TM.prefill(tc, tp, torch.from_numpy(toks), cache=tcache,
                            prompt_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               **TOL[dtype])
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    kv = lens.copy()
    for _ in range(steps):
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(kv))
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), **TOL[dtype])
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        kv = kv + 1
    if dtype == "float32":
        _cache_close(tcache, jcache)
    return tl, jl


@pytest.mark.parametrize("impl", ["dense", "ragged"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference_fp32(arch, impl):
    jc, tc = _cfgs(arch, decode_attention_impl=impl,
                   decode_cache_update="scatter")
    _prefill_decode(jc, tc, "float32")


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference_bf16(arch):
    """bf16 on the smoke configs as the reference defines them (one layer).
    At a second layer some elements leave the 2e-2 band, and that is no
    port fault: where bf16 is rounded is XLA's choice, and the reference
    parts from itself by as much when that choice changes (neither fp32
    scores nor the reference's rounding of the norm's sum close the gap).
    Two layers are held instead to the reference's fp32 logits from the
    same bf16-valued params, against the reference's own bf16 gap to them,
    in ``tests/test_torch_bf16_depth.py``."""
    jc = dataclasses.replace(jax_get_smoke(arch), dtype="bfloat16",
                             decode_cache_update="scatter")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                             decode_cache_update="scatter")
    _prefill_decode(jc, tc, "bfloat16", steps=4)


def test_gemma_bf16_embedding_scale_is_rounded_first():
    """gemma's sqrt(d_model) is rounded to bf16 before the multiply, as the
    reference does: at d_model 3072 the constant is 55.5, not 55.43, and
    the port's bf16 embeddings equal the reference's bit for bit (an fp32
    constant would give other bf16 values)."""
    jc = dataclasses.replace(jax_get_smoke("gemma-7b"), d_model=3072,
                             dtype="bfloat16")
    tc = dataclasses.replace(get_smoke_config("gemma-7b"), d_model=3072,
                             dtype="bfloat16")
    rng = np.random.default_rng(7)
    embed = rng.standard_normal((tc.padded_vocab, 3072), np.float32)
    toks = rng.integers(0, tc.vocab_size, (2, 9)).astype(np.int32)
    ref = np.asarray(JM._embed_inputs(jc, {"embed": jnp.asarray(embed)},
                                      tokens=jnp.asarray(toks)))
    got = TM._embed_inputs(tc, {"embed": torch.from_numpy(embed)},
                           torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert torch.tensor(3072 ** 0.5, dtype=torch.bfloat16).item() == 55.5
    np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                  ref.view(np.uint16))
    fp32_const = (torch.from_numpy(embed).bfloat16()[torch.from_numpy(toks)
                                                      .long()].float()
                  * 3072 ** 0.5).bfloat16()
    assert not torch.equal(fp32_const, got)


def test_gemma_geglu_at_its_widths():
    """GeGLU (tanh GELU, as ``jax.nn.gelu``) at gemma's d_ff = 24,576, and a
    two-layer gemma-family model at head dim 256 (G = 1, the kernels' new
    pair) against the reference in fp32."""
    rng = np.random.default_rng(3)
    d, f = 256, 24_576
    x = rng.standard_normal((2, 3, d), np.float32)
    p = {k: rng.standard_normal(s, np.float32) * 0.02
         for k, s in (("w_up", (d, f)), ("w_gate", (d, f)),
                      ("w_down", (f, d)))}
    tc = scaled_down(get_config("gemma-7b"), d_model=d, d_ff=f)
    jc = jax_scaled_down(jax_get_config("gemma-7b"), d_model=d, d_ff=f)
    out = TL.ffn_block({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), tc)
    ref = JL.ffn_block({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), jc, NULL_CTX)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])
    kw = dict(num_heads=4, num_kv_heads=4, head_dim=256, d_ff=f)
    jc, tc = _cfgs("gemma-7b", decode_cache_update="scatter", **kw)
    _prefill_decode(jc, tc, "float32", steps=4)


# ----------------------------------------------------------------------------
# The engine: greedy token streams
# ----------------------------------------------------------------------------

ECFG = dict(max_batch=4, max_seq=128, prompt_bucket=16)


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma-7b"])
def test_engine_greedy_streams_equal_reference(arch, elastic):
    jc, tc = _cfgs(arch)
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
