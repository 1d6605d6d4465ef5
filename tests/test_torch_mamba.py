"""The state-space families mamba2-2.7b and jamba-1.5-large-398b: the
port's configs, specs, Mamba2 mixer (``repro_torch.models.mamba``), the
plain version of kernel S8, the model and the engine against ``repro`` on
the CPU.

Reference params (``jax.random`` init) go through ``params_from_numpy``;
inputs come from a numpy seed.  The chunked SSD, the mixer and mamba2's
logits and caches are held to 2e-5 of their largest magnitude in fp32.
The mixer sums its within-chunk cumsum in the reference's CPU order
(``models.mamba._cumsum``), which is bit-equal to ``jnp.cumsum`` there.
S8's plain version is held to the reference's ``lax.scan`` step to 1e-6
relative: XLA on the CPU may contract the step's multiply-add into one
FMA, which the port's two rounded ops do not.  Greedy engine streams,
``produced``, host syncs, compaction events, schedules and continuous
batching are equal.

jamba's smoke logits and caches are held to ``JAMBA_TOL`` of their scale,
not 2e-5: its attention layer comes first, and on the same inputs its
output differs from the reference's by 1.5e-6 of its scale (fp32
summation order over scores of the smoke init's large q and k; the Mamba
mixer itself agrees to under 1e-6), which the seven Mamba layers carry
into every later state.  Over seeds 0-5 and 8 decode steps the largest
gap measured 2.4e-5 of the logits' scale and 4.3e-5 of a cache leaf's
(CPU)."""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

import repro.serving.engine as jax_engine_mod  # noqa: E402
import repro_torch.serving.engine as torch_engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.core.distributions import LogNormalTokens  # noqa: E402
from repro.core.policies import get_policy as jax_get_policy  # noqa: E402
from repro.data.pipeline import make_request_stream as jax_stream  # noqa: E402
from repro.distributed.sharding import NULL_CTX  # noqa: E402
from repro.models import mamba as JMa  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serving.continuous import serve_continuous as jax_serve  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.scheduler import run_engine_schedule as jax_schedule  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, get_config, get_smoke_config)
from repro_torch.core.policies import get_policy  # noqa: E402
from repro_torch.data.pipeline import make_request_stream  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_state_scan, ssd_state_scan_reference)
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.models import mamba as TMa  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    map_tree, params_from_numpy, tree_leaves)
from repro_torch.serving import (  # noqa: E402
    Engine, EngineConfig, run_engine_schedule, serve_continuous)

SSM = ("mamba2-2.7b", "jamba-1.5-large-398b")
JAMBA_TOL = 6e-5


def _tol(arch):
    return JAMBA_TOL if arch.startswith("jamba") else 2e-5


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jax_get_smoke(arch), **kw)
    tc = dataclasses.replace(get_smoke_config(arch), **kw)
    return jc, tc


def _cpu(tree, dtype=None):
    return params_from_numpy(tree, device="cpu", dtype=dtype)


def _close(got, ref, rel=2e-5):
    """``got`` within ``rel`` of ``ref``'s largest magnitude."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1.0))


# ----------------------------------------------------------------------------
# Configs, specs and the weight bridge
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM)
def test_configs_equal_reference_field_for_field(arch):
    assert arch in ARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_get_smoke(arch))
    assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    assert get_config(arch).active_param_count() == \
        jax_get_config(arch).active_param_count()


def test_one_jamba_group_does_not_fit_one_card_and_mamba2_does():
    """jamba's smallest stack is one group of its 8-layer pattern: 45.25 B
    parameters, 90.5 GB in bf16, more than an 80 GB card; mamba2-2.7b is
    2.70 B (5.4 GB)."""
    one = dataclasses.replace(get_config("jamba-1.5-large-398b"), num_layers=8)
    ref = dataclasses.replace(jax_get_config("jamba-1.5-large-398b"),
                              num_layers=8)
    assert one.param_count() == ref.param_count()
    assert 2 * one.param_count() > 80e9
    assert round(one.param_count() / 1e9, 2) == 45.25
    whole = get_config("mamba2-2.7b").param_count()
    assert whole == jax_get_config("mamba2-2.7b").param_count() == 2_702_296_576


@pytest.mark.parametrize("arch", SSM)
def test_specs_equal_reference(arch):
    jc, tc = _cfgs(arch)
    is_spec = lambda s: hasattr(s, "axes")  # noqa: E731
    for jt, tt in ((JM.param_specs(jc), TM.param_specs(tc)),
                   (JM.cache_specs(jc, 4, 64), TM.cache_specs(tc, 4, 64))):
        jl = jax.tree.leaves(jt, is_leaf=is_spec)
        tl = tree_leaves(tt)
        assert [(s.shape, s.axes, s.init, s.scale) for s in jl] == \
            [(s.shape, s.axes, s.init, s.scale) for s in tl]
        assert jax.tree.structure(jt, is_leaf=is_spec) == \
            jax.tree.structure(map_tree(lambda s: 0, tt))
    kinds = {tuple(sorted(v)) for v in TM.cache_specs(tc, 4, 64).values()}
    assert ("conv", "ssm") in kinds


@pytest.mark.parametrize("arch", SSM)
def test_params_round_trip_bit_exact(arch):
    jc, _ = _cfgs(arch)
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(2),
                         jnp.float32)
    for j, t in zip(jax.tree.leaves(jp), tree_leaves(_cpu(jp))):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    for j, t in zip(jax.tree.leaves(jb), tree_leaves(_cpu(jb))):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(j).view(np.uint16),
                                      t.view(torch.uint16).numpy())
    # the caches' conv and ssm leaves too
    jcache = JM.init_cache(jc, 2, 32, jnp.bfloat16)
    for j, t in zip(jax.tree.leaves(jcache), tree_leaves(_cpu(jcache))):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape


def test_chunked_init_of_jamba_stacked_experts(monkeypatch):
    """A leaf past ``INIT_CHUNK`` elements (jamba's stacked experts) is
    drawn in chunks: every chunk fresh numbers at the leaf's std, the
    small Mamba leaves (ones, zeros) exact, in the asked dtype."""
    monkeypatch.setattr(TP, "INIT_CHUNK", 1000)
    _, tc = _cfgs("jamba-1.5-large-398b")
    gen = torch.Generator().manual_seed(0)
    params = TP.init_params(TM.param_specs(tc), gen, torch.bfloat16, "cpu")
    up = params["groups"]["pos0"]["ffn"]["w_up"]            # [1, E, d, f]
    assert up.numel() > 10 * TP.INIT_CHUNK and up.dtype == torch.bfloat16
    flat = up.float().flatten()
    chunks = flat[:flat.numel() // 1000 * 1000].view(-1, 1000)
    std = 1.0 / np.sqrt(up.shape[0])
    assert torch.all((chunks.std(dim=1) - std).abs() < 0.15 * std)
    assert not torch.equal(chunks[0], chunks[1])
    mixer = params["groups"]["pos1"]["mixer"]
    assert torch.equal(mixer["A_log"], torch.ones_like(mixer["A_log"]))
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))
    assert not mixer["dt_bias"].any() and not mixer["norm_w"].any()
    # the reference's rule: a stacked leaf's fan-in is its group dim
    conv_std = 0.5 / np.sqrt(mixer["conv_w"].shape[0])
    assert abs(float(mixer["conv_w"].float().std()) - conv_std) < 0.15 * conv_std


def test_unported_parts_still_raise():
    """The one part of the model the port still refuses,
    ``decode_unroll_layers``, raises on a state-space config too;
    cross-attention positions and the two families once refused
    (llama-3.2-vision-90b, musicgen-large) now build."""
    _, tc = _cfgs("mamba2-2.7b")
    with pytest.raises(NotImplementedError, match="decode_unroll_layers"):
        TM.param_specs(dataclasses.replace(tc, decode_unroll_layers=True))
    TM.param_specs(dataclasses.replace(
        tc, group_pattern=(("cross_attn", "dense"),), vision_seq=8))
    for arch in ("llama-3.2-vision-90b", "musicgen-large"):
        assert get_config(arch).name == arch


# ----------------------------------------------------------------------------
# The chunked SSD and kernel S8's plain version
# ----------------------------------------------------------------------------

def _ssd_inputs(b, s, seed, h=4, p=32, g=2, n=16):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * 3).astype(np.float32)
    return xh, dt, a, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [40, 32, 5])
def test_ssd_chunked_matches_reference(s, with_h0):
    """Chunk 8: S = 40 pads nothing but runs 5 chunks, S = 32 runs 4, S =
    5 is one short chunk; with chunk 16, S = 40 pads 8 dt = 0 tokens."""
    for chunk in (8, 16):
        jc, tc = _cfgs("jamba-1.5-large-398b", ssm_chunk=chunk)
        xh, dt, a, bm, cm, h0 = _ssd_inputs(2, s, seed=s + chunk)
        init = h0 if with_h0 else None
        jy, jh = JMa._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)), jc,
                                  NULL_CTX, init_state=None if init is None
                                  else jnp.asarray(init))
        ty, th = TMa._ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)),
                                  tc, init_state=None if init is None
                                  else torch.from_numpy(init))
        assert ty.dtype == th.dtype == torch.float32
        _close(ty, jy)
        _close(th, jh)


def _reference_scan(chunk_decay, states, h0):
    """The reference's inter-chunk recurrence (``repro.models.mamba``,
    ``_ssd_chunked``'s ``step``) run by ``lax.scan`` under jit."""

    def step(h_prev, inp):
        dec, st = inp
        h_new = h_prev * dec[:, :, None, None] + st
        return h_new, h_prev

    @jax.jit
    def run(cd, st, h):
        hT, hb = lax.scan(step, h, (jnp.moveaxis(cd, 1, 0),
                                    jnp.moveaxis(st, 1, 0)))
        return jnp.moveaxis(hb, 0, 1), hT

    return run(jnp.asarray(chunk_decay), jnp.asarray(states), jnp.asarray(h0))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_ssd_scan_plain_version_matches_reference_step(c, with_h0):
    rng = np.random.default_rng(c)
    b, h, p, n = 2, 3, 4, 5
    decay = np.exp(-rng.random((b, c, h)) * 4).astype(np.float32)
    states = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jb, jt = _reference_scan(decay, states,
                             h0 if with_h0 else np.zeros_like(h0))
    tb, tt = ssd_state_scan_reference(
        torch.from_numpy(decay), torch.from_numpy(states),
        torch.from_numpy(h0) if with_h0 else None)
    for got, ref in ((tb, jb), (tt, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(ref).max()))
    # the wrapper runs the plain version on CPU tensors
    wb, wt = ssd_state_scan(torch.from_numpy(decay), torch.from_numpy(states),
                            torch.from_numpy(h0) if with_h0 else None)
    assert torch.equal(wb, tb) and torch.equal(wt, tt)


def test_ssd_scan_refuses_what_the_kernel_does_not_take():
    d = torch.ones(2, 3, 4)
    s = torch.ones(2, 3, 4, 5, 6)
    with pytest.raises(TypeError, match="fp32"):
        ssd_state_scan(d.double(), s.double())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_state_scan(d, s.transpose(3, 4))
    with pytest.raises(ValueError, match="chunk_decay"):
        ssd_state_scan(torch.ones(2, 2, 4), s)
    with pytest.raises(ValueError, match="h0"):
        ssd_state_scan(d, s, torch.ones(2, 4, 5, 5))


@pytest.mark.parametrize("n", [1, 5, 16, 17, 32, 40, 200, 256])
def test_within_chunk_cumsum_is_bit_equal_to_the_reference(n):
    """``jnp.cumsum`` as XLA sums it on the CPU: in order up to 16
    elements, then in blocks of 16 plus the blocks before."""
    x = -(np.random.default_rng(n).random((3, 2, n, 4)) * 30).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(jnp.asarray(x)))
    np.testing.assert_array_equal(TMa._cumsum(torch.from_numpy(x), 2).numpy(),
                                  ref)


# ----------------------------------------------------------------------------
# The mixer
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM)
def test_mamba_block_matches_reference(arch):
    """Prefill without a state, prefill into zero caches (the engine's),
    then two decode steps from the reference's states: outputs and new
    conv and SSM states."""
    jc, tc = _cfgs(arch)
    jp = jax_init_params(JMa.mamba_specs(jc), jax.random.PRNGKey(1),
                         jnp.float32)
    tp = _cpu(jp)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, jc.d_model)).astype(np.float32)
    jo, _ = JMa.mamba_block(jp, jnp.asarray(x), jc, NULL_CTX)
    to, none = TMa.mamba_block(tp, torch.from_numpy(x), tc)
    assert none is None
    _close(to, jo)
    zero = {"conv": np.zeros((3, jc.ssm_conv_kernel - 1, jc.ssm_conv_dim),
                             np.float32),
            "ssm": np.zeros((3, jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state),
                            np.float32)}
    jst = jax.tree.map(jnp.asarray, zero)
    tst = {k: torch.from_numpy(v.copy()) for k, v in zero.items()}
    for s in (40, 1, 1):
        xs = x if s > 1 else rng.standard_normal(
            (3, 1, jc.d_model)).astype(np.float32)
        jo, jst = JMa.mamba_block(jp, jnp.asarray(xs), jc, NULL_CTX, state=jst)
        to, tst = TMa.mamba_block(tp, torch.from_numpy(xs), tc, state=tst)
        _close(to, jo)
        for k in ("conv", "ssm"):
            _close(tst[k], jst[k])
        # the states go on from the reference's, so each step is held alone
        tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}


def test_mamba_block_writes_caches_in_their_dtype_in_place():
    _, tc = _cfgs("mamba2-2.7b")
    gen = torch.Generator().manual_seed(0)
    p = TP.init_params(TMa.mamba_specs(tc), gen, torch.float32, "cpu")
    st = {"conv": torch.zeros(2, 3, tc.ssm_conv_dim, dtype=torch.bfloat16),
          "ssm": torch.zeros(2, tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state,
                             dtype=torch.bfloat16)}
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    x = torch.randn(2, 7, tc.d_model, generator=gen)
    out, new = TMa.mamba_block(p, x, tc, state=st)
    assert new is st and {k: v.data_ptr() for k, v in st.items()} == ptrs
    assert all(v.dtype == torch.bfloat16 for v in st.values())
    assert st["ssm"].abs().max() > 0
    # the conv window holds the last three inputs of the prompt
    conv_in = torch.matmul(x, p["in_proj"])[..., tc.ssm_d_inner:
                                            tc.ssm_d_inner + tc.ssm_conv_dim]
    assert torch.equal(st["conv"], conv_in[:, -3:].to(torch.bfloat16))


# ----------------------------------------------------------------------------
# The model: prefill and decode
# ----------------------------------------------------------------------------

def _prefill_decode(arch, steps=8, seed=0, lens=(16, 5, 9), max_seq=64):
    """Prefill three ragged prompts, then ``steps`` greedy decode steps in
    both packages from the same fp32 params; logits at every step and the
    caches at the end within ``_tol(arch)`` of their scale."""
    jc, tc = _cfgs(arch, decode_cache_update="scatter")
    rel = _tol(arch)
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(seed),
                         jnp.float32)
    tp = _cpu(jp)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab_size, (3, max(lens))).astype(np.int32)
    lens = np.array(lens, np.int32)
    jcache = JM.init_cache(jc, 3, max_seq, jnp.float32)
    jl, jcache = jax.jit(lambda p, c, t, l: JM.prefill(
        jc, p, t, cache=c, prompt_lens=l))(jp, jcache, jnp.asarray(toks),
                                            jnp.asarray(lens))
    tcache = TM.init_cache(tc, 3, max_seq, torch.float32, device="cpu")
    tl, tcache = TM.prefill(tc, tp, torch.from_numpy(toks), cache=tcache,
                            prompt_lens=torch.from_numpy(lens))
    _close(tl, jl, rel)
    step = jax.jit(lambda p, c, t, l: JM.decode_step(jc, p, c, t, l))
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    kv = lens.copy()
    for _ in range(steps):
        jl, jcache = step(jp, jcache, jnp.asarray(tok), jnp.asarray(kv))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(kv))
        _close(tl, jl, rel)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        kv = kv + 1
    for a, b in zip(tree_leaves(tcache), tree_leaves(_cpu(jcache))):
        _close(a, b, rel)


@pytest.mark.parametrize("arch", SSM)
def test_prefill_and_decode_match_reference_fp32(arch):
    _prefill_decode(arch)


def test_mamba2_long_prompt_runs_several_chunks():
    """A 100-token prompt at the smoke chunk of 32: four chunks, the last
    padded, through S8's plain version."""
    _prefill_decode("mamba2-2.7b", steps=3, lens=(100, 33, 64), max_seq=128)


# ----------------------------------------------------------------------------
# The reference's padding semantic
# ----------------------------------------------------------------------------

def test_prompt_bucket_padding_enters_the_ssm_state_as_in_the_reference():
    """The engine right-pads a prompt with token 0 to its bucket and the
    Mamba mixer runs the SSD over the whole bucket (it takes no prompt
    lengths), so the state decode starts from has absorbed the pad tokens
    (ROADMAP.md, queue 3, reference caveats).  A 5-token prompt in buckets
    8 and 16: the same last logits, different SSM states; the port's
    states equal the reference's in each bucket, and so does their
    difference."""
    jc, tc = _cfgs("mamba2-2.7b")
    jp = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(0),
                         jnp.float32)
    tp = _cpu(jp)
    prompt = [np.array([7, 100, 3, 42, 9], np.int32)]
    out = {}
    for bucket in (8, 16):
        ecfg = dict(max_batch=1, max_seq=64, prompt_bucket=bucket)
        jeng = JaxEngine(jc, JaxEngineConfig(**ecfg), params=jp)
        teng = Engine(tc, EngineConfig(**ecfg), params=tp, device="cpu")
        jcache, _, jl, _, _ = jeng.prefill_batch(prompt)
        tcache, _, tl, _, _ = teng.prefill_batch(prompt)
        assert jeng.step_log[-1]["seq"] == teng.step_log[-1]["seq"] == bucket
        out[bucket] = {"j": (np.asarray(jl), np.asarray(jcache["pos0"]["ssm"]),
                             np.asarray(jcache["pos0"]["conv"])),
                       "t": (tl.numpy(), tcache["pos0"]["ssm"].numpy().copy(),
                             tcache["pos0"]["conv"].numpy().copy())}
    for side in ("j", "t"):
        l8, s8, c8 = out[8][side]
        l16, s16, c16 = out[16][side]
        _close(l16, l8)
        assert np.abs(s16 - s8).max() > 0.05 * np.abs(s8).max(), side
        # both conv windows hold the last three pad positions (token 0)
        np.testing.assert_array_equal(c16, c8)
    for bucket in (8, 16):
        for t, j in zip(out[bucket]["t"], out[bucket]["j"]):
            _close(t, j)
    _close(out[16]["t"][1] - out[8]["t"][1], out[16]["j"][1] - out[8]["j"][1])


# ----------------------------------------------------------------------------
# The engine
# ----------------------------------------------------------------------------

ECFG = dict(max_batch=8, max_seq=64, prompt_bucket=16)
PROMPTS = [np.arange(4 + i % 3, dtype=np.int32) * 7 + i for i in range(6)]
TARGETS = [30, 3, 9, 17, 5, 12]


@pytest.fixture(scope="module", params=SSM)
def engines(request):
    arch = request.param
    jc, tc = _cfgs(arch, decode_cache_update="scatter")
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
    """Elastic runs compact the conv and SSM leaves (and jamba's K/V)
    from bucket 8 to 4, 2 and 1."""
    elastic = mode == "elastic"
    jeng = engines[2][impl]
    teng = _port(engines, compact_impl=impl)
    n0 = len(jeng.step_log)
    jeng.kv_peak = 0            # the module's engines served earlier tests
    jr = jeng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=4,
                       return_tokens=True)
    tr = teng.generate(PROMPTS, TARGETS, elastic=elastic, chunk=4,
                       return_tokens=True)
    assert tr["tokens"] == jr["tokens"]
    assert list(tr["produced"]) == list(jr["produced"]) == TARGETS
    assert tr["host_syncs"] == jr["host_syncs"]
    assert _events(teng) == _events(jeng, n0)
    assert (len(_events(teng)) > 0) == elastic
    assert [e["steps"] for e in teng.step_log if e["kind"] == "decode_chunk"] \
        == [e["steps"] for e in jeng.step_log[n0:] if e["kind"] == "decode_chunk"]
    assert teng.kv_report() == jeng.kv_report()


def _stream(mod_stream, vocab=512):
    return mod_stream(10, 4.0, LogNormalTokens(log_mean=1.8, log_std=0.6,
                                               support=20),
                      vocab=vocab, prompt_len_range=(3, 12), seed=5)


@pytest.mark.parametrize("name", ["elastic", "dynamic"])
def test_run_engine_schedule_equals_reference(engines, monkeypatch, name):
    for mod in (jax_engine_mod, torch_engine_mod):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda t=ticks: float(next(t))))
    teng = _port(engines)
    tr = run_engine_schedule(get_policy(name, b_max=8), teng,
                             _stream(make_request_stream))
    jr = jax_schedule(jax_get_policy(name, b_max=8), engines[2]["fused"],
                      _stream(jax_stream))
    assert tr.batch_sizes == jr.batch_sizes
    assert len(tr.batch_sizes) > 1
    np.testing.assert_array_equal(tr.waits, jr.waits)
    np.testing.assert_array_equal(tr.e2e, jr.e2e)
    assert tr.makespan == jr.makespan


def _record_tokens(monkeypatch, eng):
    seen, chunk_fn = [], eng.decode_chunk

    def recording(*a, **kw):
        out = chunk_fn(*a, **kw)
        seen.append(np.asarray(out[5])[np.asarray(out[6])].tolist())
        return out

    monkeypatch.setattr(eng, "decode_chunk", recording)
    return seen


@pytest.mark.parametrize("slots,chunk", [(2, 4), (1, 8)])
def test_serve_continuous_equals_reference(monkeypatch, slots, chunk):
    """mamba2 smoke: each admission's conv and SSM states are spliced into
    the pool at its slot (``splice_cache`` finds the batch axis of the
    conv and ssm leaves from their specs)."""
    jc, tc = _cfgs("mamba2-2.7b", decode_cache_update="scatter")
    ecfg = dict(max_batch=4, max_seq=64, prompt_bucket=16)
    jeng = JaxEngine(jc, JaxEngineConfig(**ecfg))
    teng = Engine(tc, EngineConfig(**ecfg), params=_cpu(jeng.params),
                  device="cpu")
    prompts, targets = PROMPTS[:5], [6, 2, 9, 4, 3]
    t_toks = _record_tokens(monkeypatch, teng)
    j_toks = _record_tokens(monkeypatch, jeng)
    tr = serve_continuous(teng, prompts, targets, slots=slots, chunk=chunk)
    jr = jax_serve(jeng, prompts, targets, slots=slots, chunk=chunk)
    assert list(tr.produced) == list(jr.produced) == targets
    assert tr.decode_steps == jr.decode_steps
    assert tr.host_syncs == jr.host_syncs
    assert t_toks == j_toks
    assert sum(map(len, t_toks)) == sum(targets) - len(targets)


@pytest.mark.parametrize("arch", SSM)
def test_launcher_runs_each_ssm_arch_on_the_cpu(capsys, arch):
    """``python -m repro_torch.launch.serve --arch <id> --smoke --device
    cpu``."""
    S.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "served=3/3" in out[-2]
    assert out[-1].startswith("[serve] mean queue wait")
