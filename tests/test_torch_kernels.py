"""The port's kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them) and the reference oracles on the same numpy inputs.  Tolerances
are the bands of ``tests/test_kernels.py``: 2e-5 in fp32, 2e-2 in bf16;
the gathers, and the fused norm's residual sum, are bit-equal.
``tests/test_torch_gpu.py`` holds the CUDA kernels against the same plain
versions on the card."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.kernels.compaction import fused_compact as jax_fused_compact  # noqa: E402
from repro.kernels.compaction import gather_rows as jax_gather_rows  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    attention_reference as jax_attention_reference)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention)
from repro.kernels.ragged_decode_attention import (  # noqa: E402
    decode_attention_reference as jax_decode_reference)
from repro.kernels.ragged_decode_attention import (  # noqa: E402
    ragged_decode_attention as jax_ragged)
from repro.kernels.rmsnorm import fused_rmsnorm as jax_fused_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_reference as jax_rmsnorm_reference  # noqa: E402
from repro.models.layers import _ragged_block_kv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.compaction import (  # noqa: E402
    compact_reference, fused_compact, gather_rows)
from repro_torch.kernels.compaction.ops import keep_indices  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.kernels.ragged_decode_attention import (  # noqa: E402
    decode_attention_reference, ragged_decode_attention, split_count,
    split_decode_attention_reference)
from repro_torch.kernels.ragged_decode_attention.ops import SMS  # noqa: E402
from repro_torch.kernels.ragged_decode_attention.ref import (  # noqa: E402
    split_partials)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    fused_rmsnorm, rmsnorm_reference)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402


def _cpu(tree):
    return params_from_numpy(tree, device="cpu")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(arr, name):
    """One numpy fp32 array as a (jax, torch) pair of dtype ``name``; both
    round fp32 -> bf16 to nearest even, so the inputs are bit-equal."""
    jd, td = DTYPES[name]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _ragged_inputs(b, s, hq, hkv, d, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d), np.float32)
    kc = rng.standard_normal((b, s, hkv, d), np.float32)
    vc = rng.standard_normal((b, s, hkv, d), np.float32)
    return q, kc, vc, np.asarray(lens, np.int32)


# ----------------------------------------------------------------------------
# K1: ragged decode attention
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,lens", [
    (4, 512, 8, 2, 64, [1, 100, 511, 512]),      # GQA, lengths 1 and S
    (2, 256, 4, 4, 128, [17, 256]),              # MHA
    (2, 128, 8, 1, 64, [128, 3]),                # MQA
    (3, 200, 16, 2, 128, [1, 77, 200]),          # span not a power of two
])
def test_ragged_plain_matches_pallas_and_oracle(b, s, hq, hkv, d, lens, dtype):
    q, kc, vc, ln = _ragged_inputs(b, s, hq, hkv, d, lens)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kc, dtype)
    jv, tv = _pair(vc, dtype)
    out = ragged_decode_attention(tq, tk, tv, torch.from_numpy(ln))
    assert out.dtype == tq.dtype and out.shape == (b, hq, d)
    pallas = jax_ragged(jq, jk, jv, jnp.asarray(ln),
                        block_kv=_ragged_block_kv(s, 128))
    oracle = jax_decode_reference(jq, jk, jv, jnp.asarray(ln))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(oracle), **_tol(dtype))


def test_ragged_plain_ignores_stale_cache():
    """Entries at or past lengths must not affect the output (a freed slot
    can hold garbage)."""
    q, kc, vc, ln = _ragged_inputs(2, 256, 4, 4, 64, [64, 192])
    q, kc, vc, ln = map(torch.from_numpy, (q, kc, vc, ln))
    out1 = ragged_decode_attention(q, kc, vc, ln)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[0, 64:] = 1e4
    vc2[0, 64:] = -1e4
    out2 = ragged_decode_attention(q, kc2, vc2, ln)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_split_algorithm_matches_pallas_and_oracle(splits, dtype):
    """The CUDA kernel's split-KV algorithm, written plainly: per-split
    partials merged in split order.  Lengths 1, S, fewer positions than
    splits, and a span that is no multiple of any split count."""
    b, s, hq, hkv, d = 5, 256, 16, 2, 128
    q, kc, vc, ln = _ragged_inputs(b, s, hq, hkv, d, [1, s, 3, 100, 77],
                                   seed=splits)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kc, dtype)
    jv, tv = _pair(vc, dtype)
    out = split_decode_attention_reference(tq, tk, tv, torch.from_numpy(ln),
                                           splits)
    assert out.dtype == tq.dtype and out.shape == (b, hq, d)
    pallas = jax_ragged(jq, jk, jv, jnp.asarray(ln),
                        block_kv=_ragged_block_kv(s, 128))
    oracle = jax_decode_reference(jq, jk, jv, jnp.asarray(ln))
    plain = decode_attention_reference(tq, tk, tv, torch.from_numpy(ln))
    for want in (pallas, oracle, plain):
        np.testing.assert_allclose(_f32(out), _f32(want), **_tol(dtype))


def test_ragged_split_partials_cover_each_position_once():
    """Share i of request b is [i c, min((i + 1) c, len)) with c = ceil(len
    / splits): the shares tile [0, len), and a share past len is empty (m
    = -inf, l = 0, acc = 0)."""
    q, kc, vc, ln = map(torch.from_numpy,
                        _ragged_inputs(3, 40, 8, 1, 64, [1, 40, 5]))
    m, l, acc = split_partials(q, kc, vc, ln, 8)
    live = torch.isfinite(m[:, :, 0])
    # c = 1, 5, 1: request 0 fills share 0, request 1 all 8, request 2 five
    assert live.sum(0).tolist() == [1, 8, 5]
    assert torch.all(l[~live] == 0) and torch.all(acc[~live] == 0)
    assert torch.all(l[live] >= 1)        # each share holds its own max


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("s", [128, 2048])
@pytest.mark.parametrize("hkv", [1, 2, 8])
def test_ragged_split_count_fills_the_card(b, s, hkv):
    """Enough splits for two blocks per SM where B * Hkv * S allows, never
    more splits than positions, and one split once B * Hkv alone fills the
    card."""
    n = split_count(b, hkv, s)
    assert 1 <= n <= s
    assert b * hkv * n >= min(2 * SMS, b * hkv * s)
    assert n == 1 or b * hkv * (n - 1) < 2 * SMS     # no more than needed
    assert split_count(2 * SMS, hkv, s) == 1


def test_ragged_split_count_rejects_empty_shapes():
    with pytest.raises(ValueError):
        split_count(0, 2, 128)


def test_ragged_wrapper_runs_plain_version_on_cpu():
    q, kc, vc, ln = map(torch.from_numpy,
                        _ragged_inputs(2, 64, 4, 2, 64, [5, 64]))
    before = K.LAUNCHES["ragged_decode_attention"]
    out = ragged_decode_attention(q, kc, vc, ln)
    assert torch.equal(out, decode_attention_reference(q, kc, vc, ln))
    assert K.LAUNCHES["ragged_decode_attention"] == before


# ----------------------------------------------------------------------------
# K2: row gather and fused compaction
# ----------------------------------------------------------------------------

def _gather_src(g, b, f, dtype, seed=1):
    src = np.random.default_rng(seed).standard_normal((g, b, f), np.float32)
    if dtype == "int32":
        a = (src * 100).astype(np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    return _pair(src, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("g,b,f", [(2, 8, 256), (1, 4, 64), (3, 8, 65),
                                   (2, 16, 1024)])
def test_gather_rows_bit_equal_to_pallas(g, b, f, dtype):
    jsrc, tsrc = _gather_src(g, b, f, dtype)
    idx = np.array([0, b - 1, 2 % b, 0, b - 1], np.int32)    # repeats
    out = gather_rows(tsrc, torch.from_numpy(idx))
    ref = jax_gather_rows(jsrc, jnp.asarray(idx))
    assert out.dtype == tsrc.dtype
    np.testing.assert_array_equal(_f32(out), _f32(ref))


def test_gather_rows_multidim_trailing():
    src = np.random.default_rng(2).standard_normal((2, 8, 4, 3, 5), np.float32)
    idx = np.array([5, 1, 1], np.int32)
    out = gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), src[:, idx])


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_keep_indices_match_padded_nonzero(nb):
    rng = np.random.default_rng(nb)
    for _ in range(20):
        targets = rng.integers(0, 6, 8)
        produced = rng.integers(0, 6, 8)
        live = np.nonzero(targets - produced > 0)[0]
        want = np.zeros(nb, np.int32)
        want[:min(nb, len(live))] = live[:nb]
        got = keep_indices(torch.from_numpy(produced),
                           torch.from_numpy(targets), nb)
        np.testing.assert_array_equal(got.numpy(), want)


ECFG = JaxEngineConfig(max_batch=4, max_seq=128, prompt_bucket=16)


@pytest.fixture(scope="module")
def qwen_cache():
    """A real qwen2.5-3b smoke cache from the reference engine's prefill."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2)
    eng = JaxEngine(cfg, ECFG)
    prompts = [np.arange(4, dtype=np.int32) + i for i in range(3)]
    cache, kv_lens, last, b, _ = eng.prefill_batch(prompts)
    tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
    return eng, cache, kv_lens, tok


def test_fused_compact_bit_equal_to_pallas_and_engine_compact(qwen_cache):
    eng, cache, kv_lens, tok = qwen_cache
    # slots 0 and 2 still owe tokens; slot 1 finished; slot 3 is padding
    produced = np.array([2, 5, 1, 0], np.int32)
    targets = np.array([5, 5, 3, 0], np.int32)
    nb = 2
    tc, tl, tt, tk, keep = fused_compact(
        _cpu(cache), _cpu(kv_lens),
        _cpu(tok), None, torch.from_numpy(produced),
        torch.from_numpy(targets), nb=nb)
    assert tk is None and keep.tolist() == [0, 2]
    jc, jl, jt, _, jkeep = jax_fused_compact(
        cache, kv_lens, tok, None, jnp.asarray(produced),
        jnp.asarray(targets), nb=nb)
    hc, hl, ht, hb, _, _ = eng.compact(cache, kv_lens, tok,
                                       np.array([0, 2], np.int32))
    assert hb == nb
    for ref_cache, ref_l, ref_t in ((jc, jl, jt), (hc, hl, ht)):
        for a, b in zip(tree_leaves(tc), tree_leaves(_cpu(ref_cache))):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(ref_l))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(ref_t))
    # the plain host-path gathers agree too
    rc, rl, rt, _ = compact_reference(_cpu(cache), _cpu(kv_lens), _cpu(tok),
                                      keep)
    for a, b in zip(tree_leaves(tc), tree_leaves(rc)):
        assert torch.equal(a, b)


def test_fused_compact_pads_with_slot_zero(qwen_cache):
    """Past the live count the rows repeat slot 0 (not zeros), as the host
    path's zero-filled keep array selects."""
    _, cache, kv_lens, tok = qwen_cache
    tcache = _cpu(cache)
    produced = torch.tensor([3, 0, 3, 3], dtype=torch.int32)
    targets = torch.tensor([3, 4, 3, 3], dtype=torch.int32)
    c, lens, toks, _, keep = fused_compact(
        tcache, _cpu(kv_lens), _cpu(tok), None,
        produced, targets, nb=2)
    assert keep.tolist() == [1, 0]
    assert torch.equal(c["pos0"]["k"][:, 1], tcache["pos0"]["k"][:, 0])


# ----------------------------------------------------------------------------
# K3: prefill flash attention
# ----------------------------------------------------------------------------

def _attn_inputs(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d), np.float32),
            rng.standard_normal((b, s, hkv, d), np.float32),
            rng.standard_normal((b, s, hkv, d), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,win", [
    (2, 256, 4, 4, 64, None),
    (1, 512, 8, 2, 128, None),
    (2, 256, 4, 2, 128, 128),
    (1, 128, 2, 1, 256, None),
    (1, 384, 6, 3, 64, 96),
])
def test_flash_plain_matches_pallas(b, s, hq, hkv, d, win, dtype):
    """The ``test_flash_attention_sweep`` shapes of ``tests/test_kernels.py``
    (the Pallas kernel in interpret mode, 64-blocks)."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype)
                                    for a in _attn_inputs(b, s, hq, hkv, d))
    out = flash_attention(tq, tk, tv, window=win)
    assert out.dtype == tq.dtype and out.shape == (b, s, hq, d)
    pallas = jax_flash_attention(jq, jk, jv, window=win, block_q=64,
                                 block_kv=64)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,win", [(80, None), (200, None), (200, 48)])
def test_flash_plain_matches_oracle_off_block_multiples(s, win, dtype):
    """Prompt buckets that are no multiple of the Pallas kernel's blocks
    (the port's kernel masks the tail itself): held to the reference's
    oracle, since the Pallas op cannot run them."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype)
                                    for a in _attn_inputs(2, s, 16, 2, 128))
    out = flash_attention(tq, tk, tv, window=win)
    ref = jax_attention_reference(jq, jk, jv, window=win)
    np.testing.assert_allclose(_f32(out), _f32(ref), **_tol(dtype))


def test_flash_plain_equals_model_dense_path_in_fp32():
    """In fp32 the kernel's function is the model's causal dense prefill
    attention (the model's path rounds probabilities to v's dtype before
    P.V, a no-op in fp32)."""
    q, k, v = map(torch.from_numpy, _attn_inputs(2, 48, 16, 2, 128, seed=5))
    for win in (None, 7):
        np.testing.assert_allclose(
            flash_attention(q, k, v, window=win).numpy(),
            TL.dense_attention(q, k, v, causal=True, window=win).numpy(),
            atol=2e-5, rtol=2e-5)


def test_flash_wrapper_runs_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _attn_inputs(1, 40, 16, 2, 128))
    before = K.LAUNCHES["flash_attention"]
    assert torch.equal(flash_attention(q, k, v),
                       attention_reference(q, k, v, causal=True))
    assert K.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


# ----------------------------------------------------------------------------
# K4: fused residual-add + RMSNorm
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 128, 512), (4, 32, 128)])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    """The ``test_fused_rmsnorm_sweep`` shapes of ``tests/test_kernels.py``,
    with an fp32 weight as there."""
    rng = np.random.default_rng(6)
    (jx, tx), (jr, tr) = (_pair(rng.standard_normal(shape, np.float32), dtype)
                          for _ in range(2))
    w = rng.standard_normal(shape[-1:], np.float32) * 0.1
    s, n = fused_rmsnorm(tx, tr, torch.from_numpy(w), eps=1e-6)
    assert s.dtype == n.dtype == tx.dtype and s.shape == n.shape == shape
    js, jn = jax_fused_rmsnorm(jx, jr, jnp.asarray(w), eps=1e-6, block_rows=32)
    os_, on = jax_rmsnorm_reference(jx, jr, jnp.asarray(w), 1e-6)
    for got, want in ((s, js), (n, jn), (s, os_), (n, on)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_sum_is_the_add(dtype):
    """s is bit-equal to ``x + residual``, at any row count and eps."""
    rng = np.random.default_rng(7)
    td = DTYPES[dtype][1]
    x, r = (torch.from_numpy(rng.standard_normal((3, 5, 2048), np.float32))
            .to(td) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal(2048, np.float32) * 0.1).to(td)
    before = K.LAUNCHES["fused_rmsnorm"]
    s, n = fused_rmsnorm(x, r, w, eps=1e-5)
    assert K.LAUNCHES["fused_rmsnorm"] == before
    assert torch.equal(s, x + r)
    assert torch.equal(n, rmsnorm_reference(x, r, w, 1e-5)[1])
