"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in fp32; in bf16 4e-3 plus 8e-3 relative, one bf16 ulp
of the output (both sides compute in fp32 and differ only in the final
rounding); the gather, the fused norm's residual sum, the simulators'
float64 scans and batch-event loops (S1-S5), the fleet's routing scan
(S6), the memory-gated tandem loop (S7) and the SSD's chunk-state scan
(S8) are bit-equal, as are its backward's (S8b) state gradients; S8b's
chunk-decay gradient, a sum over P*N terms, is held to the error bound of
fp32 summation."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels.compaction import fused_compact, gather_rows  # noqa: E402
from repro_torch.kernels.compaction.ref import (  # noqa: E402
    compact_reference, gather_rows_reference)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.kernels.ragged_decode_attention import (  # noqa: E402
    decode_attention_reference, ragged_decode_attention, split_count)
from repro_torch.kernels.ragged_decode_attention import ops as ragged_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import fused_rmsnorm, rmsnorm_reference  # noqa: E402

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=4e-3, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.from_numpy(g).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(4, 1000, 16, 2, 128),
                                          (2, 256, 8, 1, 128),
                                          (3, 130, 32, 4, 128),
                                          (16, 2048, 16, 2, 128)] + [
    # the (G, D) pairs of internlm2-1.8b (2, 128) and gemma-7b (1, 256)
    (b, s, hq, hkv, d) for hq, hkv, d in ((16, 8, 128), (16, 16, 256))
    for b, s in ((4, 1000), (2, 256), (3, 130), (16, 2048))])
def test_ragged_kernel_matches_plain(cuda, b, s, hq, hkv, d, dtype):
    q = _randn((b, hq, d), dtype, cuda, 0)
    kc = _randn((b, s, hkv, d), dtype, cuda, 1)
    vc = _randn((b, s, hkv, d), dtype, cuda, 2)
    ln = torch.from_numpy(np.linspace(1, s, b).astype(np.int32)).to(cuda)
    before = K.LAUNCHES["ragged_decode_attention"]
    out = ragged_decode_attention(q, kc, vc, ln)
    assert K.LAUNCHES["ragged_decode_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               decode_attention_reference(q, kc, vc, ln).float(),
                               **TOL[dtype])


@pytest.mark.gpu
def test_ragged_kernel_rejects_what_it_does_not_take(cuda):
    q = _randn((2, 6, 128), torch.float32, cuda, 0)
    kc = _randn((2, 64, 2, 128), torch.float32, cuda, 1)
    ln = torch.tensor([3, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="built for"):    # G = 3
        ragged_decode_attention(q, kc, kc, ln)
    q64 = _randn((2, 16, 64), torch.float32, cuda, 0)
    k64 = _randn((2, 64, 2, 64), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # (8, 64)
        ragged_decode_attention(q64, k64, k64, ln)
    with pytest.raises(TypeError):                        # mixed dtypes
        ragged_decode_attention(q[:, :4].contiguous().half(), kc, kc, ln)
    with pytest.raises(ValueError):                       # CPU + CUDA
        ragged_decode_attention(q[:, :4].contiguous(), kc, kc, ln.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_every_split_count(cuda, dtype):
    """Every split count from 1 to the one the wrapper picks, with lengths
    of 1, of S, and fewer positions than splits."""
    b, s = 4, 300
    chosen = split_count(b, 2, s)
    q = _randn((b, 16, 128), dtype, cuda, 0)
    kc = _randn((b, s, 2, 128), dtype, cuda, 1)
    vc = _randn((b, s, 2, 128), dtype, cuda, 2)
    ln = torch.tensor([1, s, 3, 150], dtype=torch.int32, device=cuda)
    ref = decode_attention_reference(q, kc, vc, ln).float()
    for splits in range(1, chosen + 1):
        out = ragged_ops._launch(q, kc, vc, ln, splits)
        torch.testing.assert_close(out.float(), ref, **TOL[dtype],
                                   msg=lambda m: f"splits={splits}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_bit_equal_across_calls_and_stale_rows(cuda, dtype):
    """The splits merge in a fixed order with no atomics: two calls give the
    same bits, and rows at or past lengths (never read) change nothing."""
    b, s = 16, 2048
    q = _randn((b, 16, 128), dtype, cuda, 0)
    kc = _randn((b, s, 2, 128), dtype, cuda, 1)
    vc = _randn((b, s, 2, 128), dtype, cuda, 2)
    lens = np.random.default_rng(5).integers(1, s + 1, b).astype(np.int32)
    lens[:3] = (1, s, 7)
    ln = torch.from_numpy(lens).to(cuda)
    out = ragged_decode_attention(q, kc, vc, ln)
    assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out)
    for i, n in enumerate(lens.tolist()):
        kc[i, n:], vc[i, n:] = float("nan"), 1e4
    assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint8])
@pytest.mark.parametrize("shape", [(3, 8, 65), (2, 16, 4, 3, 5), (36, 16, 2048)])
def test_gather_kernel_bit_equal(cuda, dtype, shape):
    src = (_randn(shape, torch.float32, cuda, 3) * 100).to(dtype)
    idx = torch.tensor([7, 0, 0, 3], dtype=torch.int32, device=cuda)
    before = K.LAUNCHES["gather_rows"]
    out = gather_rows(src, idx)
    assert K.LAUNCHES["gather_rows"] == before + 1
    assert torch.equal(out, gather_rows_reference(src, idx))


@pytest.mark.gpu
def test_fused_compact_bit_equal_to_host_gathers(cuda):
    cache = {"pos0": {k: _randn((2, 8, 32, 2, 64), torch.bfloat16, cuda, i)
                      for i, k in enumerate("kv")}}
    kv_lens = torch.arange(8, dtype=torch.int32, device=cuda) + 5
    tok = torch.arange(8, dtype=torch.int32, device=cuda) * 7
    produced = torch.tensor([4, 1, 4, 0, 2, 4, 4, 4], dtype=torch.int32,
                            device=cuda)
    targets = torch.full((8,), 4, dtype=torch.int32, device=cuda)
    c, l, t, _, keep = fused_compact(cache, kv_lens, tok, None, produced,
                                     targets, nb=4)
    assert keep.tolist() == [1, 3, 4, 0]
    rc, rl, rt, _ = compact_reference(cache, kv_lens, tok, keep)
    for a, b in ((c["pos0"]["k"], rc["pos0"]["k"]),
                 (c["pos0"]["v"], rc["pos0"]["v"]), (l, rl), (t, rt)):
        assert torch.equal(a, b)


# prompt lengths that are no block multiple among them; B = 16 with S = 4096
# is left out only because the plain version's [B, H, S, S] scores would
# take 17 GB
FLASH_SHAPES = [(b, s, None) for s in (16, 80, 192, 256, 1000) for b in (1, 16)] \
    + [(1, 4096, None), (2, 1000, 256), (16, 192, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,win", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, s, win, dtype):
    q = _randn((b, s, 16, 128), dtype, cuda, 0)
    k = _randn((b, s, 2, 128), dtype, cuda, 1)
    v = _randn((b, s, 2, 128), dtype, cuda, 2)
    before = K.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=win)
    assert K.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), attention_reference(q, k, v, window=win).float(),
        **TOL[dtype])


# the bf16 kernel's K/V tiles are 64 keys and its blocks 8 positions:
# first, partial and last tiles of the ring, and windows across tile edges
RING_SHAPES = [(b, s, None) for s in (1, 63, 64, 65, 127, 129) for b in (1, 16)] \
    + [(2, 300, 100), (1, 200, 64), (3, 129, 65), (1, 1000, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,win", RING_SHAPES)
def test_flash_bf16_kernel_ring_edges(cuda, b, s, win):
    q = _randn((b, s, 16, 128), torch.bfloat16, cuda, 4)
    k = _randn((b, s, 2, 128), torch.bfloat16, cuda, 5)
    v = _randn((b, s, 2, 128), torch.bfloat16, cuda, 6)
    torch.testing.assert_close(
        flash_attention(q, k, v, window=win).float(),
        attention_reference(q, k, v, window=win).float(), **TOL[torch.bfloat16])


@pytest.mark.gpu
def test_flash_kernel_reads_strided_bshd_views(cuda):
    """q, k and v as views of one fused projection: read through their
    strides, no copy."""
    for s in (80, 1000):
        qkv = _randn((2, s, 20, 128), torch.bfloat16, cuda, 3)
        q, k, v = qkv[:, :, :16], qkv[:, :, 16:18], qkv[:, :, 18:]
        torch.testing.assert_close(flash_attention(q, k, v).float(),
                                   attention_reference(q, k, v).float(),
                                   **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "simt")])
def test_flash_kernel_dispatch_by_dtype(cuda, dtype, kernel):
    """bf16 runs the tensor-core kernel, fp32 the fp32-core one (the
    tensor cores would take fp32 only as TF32)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q = _randn((1, 100, 16, 128), dtype, cuda, 0)
    k = _randn((1, 100, 2, 128), dtype, cuda, 1)
    flash_attention(q, k, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            flash_attention(q, k, k)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    ours = {n for n in names if "flash_attention" in n}
    assert ours and all(f"flash_attention_{kernel}" in n for n in ours), names


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = _randn((1, 32, 6, 128), torch.float32, cuda, 0)
    k = _randn((1, 32, 2, 128), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # G = 3
        flash_attention(q, k, k)
    q64 = _randn((1, 32, 16, 64), torch.float32, cuda, 0)
    k64 = _randn((1, 32, 2, 64), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # (8, 64)
        flash_attention(q64, k64, k64)
    q16 = _randn((1, 32, 16, 128), torch.float32, cuda, 0)
    with pytest.raises(TypeError):                        # mixed dtypes
        flash_attention(q16.bfloat16(), k, k)
    with pytest.raises(ValueError):                       # CPU + CUDA
        flash_attention(q16, k, k.cpu())


# ----------------------------------------------------------------------------
# K1 and K3 at the (G, D) pairs of internlm2-1.8b (16 / 8 heads of 128),
# gemma-7b (16 / 16 heads of 256), mixtral-8x7b (32 / 8 heads of 128),
# moonshot-v1-16b-a3b (16 / 16 heads of 128) and musicgen-large (32 / 32
# heads of 64), over the edge cases of (8, 128) above
# ----------------------------------------------------------------------------

NEW_PAIRS = {"g2d128": (16, 8, 128), "g1d256": (16, 16, 256),
             "g4d128": (32, 8, 128), "g1d128": (16, 16, 128),
             "g1d64": (32, 32, 64)}     # musicgen-large's 32 / 32 heads of 64


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", sorted(NEW_PAIRS))
def test_ragged_kernel_new_pairs_every_split_count(cuda, pair, dtype):
    """Every split count from 1 to the one the wrapper picks (2 at gemma's
    16 KV heads and B = 16), lengths of 1, of S, and fewer positions than
    splits."""
    hq, hkv, d = NEW_PAIRS[pair]
    for b, s in ((4, 300), (16, 2048)):
        chosen = split_count(b, hkv, s)
        q = _randn((b, hq, d), dtype, cuda, 0)
        kc = _randn((b, s, hkv, d), dtype, cuda, 1)
        vc = _randn((b, s, hkv, d), dtype, cuda, 2)
        lens = np.random.default_rng(b).integers(1, s + 1, b).astype(np.int32)
        lens[:4] = (1, s, 3, s // 2)
        ln = torch.from_numpy(lens).to(cuda)
        ref = decode_attention_reference(q, kc, vc, ln).float()
        for splits in range(1, max(chosen, 3) + 1):
            out = ragged_ops._launch(q, kc, vc, ln, splits)
            torch.testing.assert_close(out.float(), ref, **TOL[dtype],
                                       msg=lambda m: f"splits={splits}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pair", sorted(NEW_PAIRS))
def test_ragged_kernel_new_pairs_bit_equal_and_stale_rows(cuda, pair, dtype):
    hq, hkv, d = NEW_PAIRS[pair]
    b, s = 16, 2048
    q = _randn((b, hq, d), dtype, cuda, 0)
    kc = _randn((b, s, hkv, d), dtype, cuda, 1)
    vc = _randn((b, s, hkv, d), dtype, cuda, 2)
    lens = np.random.default_rng(5).integers(1, s + 1, b).astype(np.int32)
    lens[:3] = (1, s, 7)
    ln = torch.from_numpy(lens).to(cuda)
    out = ragged_decode_attention(q, kc, vc, ln)
    assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out)
    for i, n in enumerate(lens.tolist()):
        kc[i, n:], vc[i, n:] = float("nan"), 1e4
    assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,win", FLASH_SHAPES + RING_SHAPES)
@pytest.mark.parametrize("pair", sorted(NEW_PAIRS))
def test_flash_kernel_new_pairs_match_plain(cuda, pair, b, s, win, dtype):
    """A block holds 64 / G positions (32 at G = 2, 16 at G = 4, 64 at G = 1) over 64-key
    tiles: the cases cross a block's and a tile's edges, partial and last
    tiles, and windows across them."""
    hq, hkv, d = NEW_PAIRS[pair]
    q = _randn((b, s, hq, d), dtype, cuda, 4)
    k = _randn((b, s, hkv, d), dtype, cuda, 5)
    v = _randn((b, s, hkv, d), dtype, cuda, 6)
    before = K.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, window=win)
    assert K.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), attention_reference(q, k, v, window=win).float(),
        **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("pair", sorted(NEW_PAIRS))
def test_flash_kernel_new_pairs_read_strided_views(cuda, pair):
    """q, k and v as views of one fused projection at the new pairs."""
    hq, hkv, d = NEW_PAIRS[pair]
    for s in (80, 1000):
        qkv = _randn((2, s, hq + 2 * hkv, d), torch.bfloat16, cuda, 3)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
        torch.testing.assert_close(flash_attention(q, k, v).float(),
                                   attention_reference(q, k, v).float(),
                                   **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", [(16, 1, 128), (16, 4, 256),
                                      (16, 8, 256), (16, 2, 256)])
def test_attention_kernels_refuse_pairs_outside_their_shapes(cuda, hq, hkv, d):
    """(G, D) = (16, 128), (4, 256), (2, 256), (8, 256): no instance, a
    ValueError from each wrapper before any launch."""
    before = dict(K.LAUNCHES)
    q = _randn((2, hq, d), torch.bfloat16, cuda, 0)
    kc = _randn((2, 64, hkv, d), torch.bfloat16, cuda, 1)
    ln = torch.tensor([3, 64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="built for"):
        ragged_decode_attention(q, kc, kc, ln)
    qp = _randn((1, 32, hq, d), torch.bfloat16, cuda, 0)
    kp = _randn((1, 32, hkv, d), torch.bfloat16, cuda, 1)
    with pytest.raises(ValueError, match="built for"):
        flash_attention(qp, kp, kp)
    assert dict(K.LAUNCHES) == before


def _check_rmsnorm(x, r, w):
    before = K.LAUNCHES["fused_rmsnorm"]
    s, n = fused_rmsnorm(x, r, w, eps=1e-6)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_rmsnorm"] == before + 1
    assert s.dtype == n.dtype == x.dtype and s.shape == n.shape == x.shape
    assert torch.equal(s, x + r)
    torch.testing.assert_close(n.float(),
                               rmsnorm_reference(x, r, w, 1e-6)[1].float(),
                               **TOL[x.dtype])


# rows: one decode token to a prefill bucket; D: the smallest bf16 row (one
# 16-byte vector), qwen2.5-3b's width, a width no multiple of the thread
# block, and the widest rows (12000 fit the earlier kernel's 48 KB of
# shared memory; 12288 is the wrapper's limit)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 2048, 2056, 12000, 12288])
@pytest.mark.parametrize("rows", [1, 2, 16, 64, 4096, (4, 37)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype):
    shape = (rows if isinstance(rows, tuple) else (rows,)) + (d,)
    x = _randn(shape, dtype, cuda, 0) * 3
    r = _randn(shape, dtype, cuda, 1)
    w = _randn((d,), dtype, cuda, 2) * 0.1
    _check_rmsnorm(x, r, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_strided_and_3d_inputs(cuda, dtype):
    wide = _randn((16, 2 * 2048), dtype, cuda, 0)
    x = wide[:, ::2]                                     # non-contiguous rows
    assert not x.is_contiguous()
    _check_rmsnorm(x, _randn((16, 2048), dtype, cuda, 1),
                   _randn((2048,), dtype, cuda, 2) * 0.1)
    _check_rmsnorm(_randn((2, 9, 2048), dtype, cuda, 3),
                   _randn((2, 9, 2048), dtype, cuda, 4),
                   _randn((2048,), dtype, cuda, 5) * 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 16, 4096])
def test_rmsnorm_kernel_round_sum_matches_plain(cuda, rows, dtype):
    """``round_sum`` (the norm after a layer group) normalises the sum as
    written in x's dtype: bf16 within its band of the plain version, fp32
    bit-equal to the unrounded norm."""
    x = _randn((rows, 2560), dtype, cuda, 0) * 3
    r = _randn((rows, 2560), dtype, cuda, 1)
    w = _randn((2560,), dtype, cuda, 2) * 0.1
    s, n = fused_rmsnorm(x, r, w, eps=1e-5, round_sum=True)
    assert torch.equal(s, x + r)
    torch.testing.assert_close(
        n.float(), rmsnorm_reference(x, r, w, 1e-5, True)[1].float(),
        **TOL[dtype])
    if dtype == torch.float32:
        assert torch.equal(n, fused_rmsnorm(x, r, w, eps=1e-5)[1])


@pytest.mark.gpu
def test_rmsnorm_kernel_rejects_what_it_does_not_take(cuda):
    x = _randn((4, 2048), torch.float32, cuda, 0)
    with pytest.raises(TypeError):                # bf16 weight, fp32 rows
        fused_rmsnorm(x, x, torch.zeros(2048, device=cuda,
                                        dtype=torch.bfloat16))
    x3 = _randn((4, 2044), torch.bfloat16, cuda, 0)
    with pytest.raises(ValueError, match="16-byte"):      # D * 2 % 16 != 0
        fused_rmsnorm(x3, x3, x3[0])


# ----------------------------------------------------------------------------
# The compiled decode chunk (one CUDA graph per bucket, steps and sampling
# setting) against the engine's eager loop, and the serving paths on it.
# Small fp32 model: qwen's 16/2 heads of 128 keep the ragged kernel on its
# one shape.
# ----------------------------------------------------------------------------

def _small_engines(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    cfg = scaled_down(get_config("qwen2.5-3b"), num_groups=2, d_model=128,
                      num_heads=16, num_kv_heads=2, head_dim=128, d_ff=256,
                      decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=16, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    gpu = Engine(cfg, ecfg, seed=3, device=cuda)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    return gpu, cpu


def _prompts(n, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(m)).astype(np.int32)
            for m in rng.integers(3, 40, n)]


def _launch_delta(fn):
    before = dict(K.LAUNCHES)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in K.LAUNCHES.items()
                 if v != before.get(k, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("temperature,top_k", [(0.0, None), (0.8, None),
                                               (0.8, 5)])
def test_graph_replay_equals_eager_loop(cuda, temperature, top_k):
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import slot_keys_for
    eng, _ = _small_engines(cuda)
    cache, kv, last, b, _ = eng.prefill_batch(_prompts(16, 0))
    tok = last.argmax(-1).to(torch.int32)
    prod = torch.ones(b, dtype=torch.int32, device=cuda)
    targ = torch.from_numpy(np.arange(b, dtype=np.int32) % 12 + 2).to(cuda)
    keys = slot_keys_for(7, b, cuda)
    steps = 8
    out = eng.decode_chunk(cache, kv, tok, prod, targ, steps, temperature,
                           top_k, keys)
    cap = eng.step_log[-1]
    assert cap["graph"] == "capture"
    # the capture is part of the call's time, and M4's fit leaves it out
    assert 0 < cap["capture_seconds"] < cap["seconds"] == out[-1]
    _, tok, kv, prod, keys = out[:5]
    cache_e = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    state = [t.clone() for t in (tok, kv, prod, keys)]
    out, d_graph = _launch_delta(lambda: eng.decode_chunk(
        cache, kv, tok, prod, targ, steps, temperature, top_k, keys))
    assert eng.step_log[-1]["graph"] == "replay"
    assert eng.calibration_log()["decode"] == [(b, out[-1] / steps)]
    (t_e, kv_e, prod_e, keys_e, packed), d_eager = _launch_delta(
        lambda: eng._chunk_eager(cache_e, *state[:3], targ, state[3], steps,
                                 temperature, top_k))
    host = packed.cpu().numpy()
    n = steps * b
    np.testing.assert_array_equal(out[5], host[:n].reshape(steps, b))
    np.testing.assert_array_equal(out[6], host[n:2 * n].reshape(steps, b) > 0)
    np.testing.assert_array_equal(out[7], host[2 * n + 1:])
    for a, e in zip(out[1:5], (t_e, kv_e, prod_e, keys_e)):
        assert torch.equal(a, e)
    for a, e in zip(tree_leaves(cache), tree_leaves(cache_e)):
        assert torch.equal(a, e)
    # a replay counts what the eager loop launches
    assert d_graph == d_eager
    assert d_graph["ragged_decode_attention"] == steps * 2
    assert d_graph["fused_rmsnorm"] == steps * (2 * 2 + 1)


@pytest.mark.gpu
def test_graph_second_batch_and_compaction_equal_cpu(cuda):
    """Other prompts through graphs captured by an earlier batch (stale
    static buffers would show), and a 16 -> 8 compaction followed by
    replays at bucket 8: the card's greedy tokens equal the CPU's."""
    gpu, cpu = _small_engines(cuda)
    targets = [20] * 8 + [3] * 8           # half finish in the first chunk
    for seed in (1, 2):
        prompts = _prompts(16, seed)
        n0 = len(gpu.step_log)
        rg = gpu.generate(prompts, targets, elastic=True, return_tokens=True)
        rc = cpu.generate(prompts, targets, elastic=True, return_tokens=True)
        assert rg["tokens"] == rc["tokens"]
        assert list(rg["produced"]) == targets
        log = gpu.step_log[n0:]
        assert [(e["impl"], e["batch"]) for e in log
                if e["kind"] == "compact"] == [("fused", 8)]
        chunks = [(e["batch"], e["graph"]) for e in log
                  if e["kind"] == "decode_chunk"]
        if seed == 2:
            assert chunks and all(g == "replay" for _, g in chunks)
            assert (8, "replay") in chunks


@pytest.mark.gpu
def test_graph_sampled_generate_equals_cpu(cuda):
    gpu, cpu = _small_engines(cuda)
    prompts, targets = _prompts(5, 3), [9, 4, 12, 2, 7]
    for _ in range(2):                      # capture, then replay
        kw = dict(elastic=True, temperature=0.9, top_k=50, seed=11,
                  return_tokens=True)
        rg = gpu.generate(prompts, targets, **kw)
        rc = cpu.generate(prompts, targets, **kw)
        assert rg["tokens"] == rc["tokens"]


@pytest.mark.gpu
def test_graph_refuses_a_cache_it_does_not_own(cuda):
    eng, _ = _small_engines(cuda)
    cache, kv, last, b, _ = eng.prefill_batch(_prompts(4, 0))
    foreign = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    tok = last.argmax(-1).to(torch.int32)
    ones = torch.ones(b, dtype=torch.int32, device=cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="own cache"):
        eng.decode_chunk(foreign, kv, tok, ones, ones * 5, 4)
    assert dict(K.LAUNCHES) == before and not eng._graphs


@pytest.mark.gpu
def test_serve_continuous_card_equals_cpu(cuda):
    """The same admissions, chunks and active-slot tokens on the card (K1,
    K3, K4, graphs) as on the CPU (plain paths), and the pool's live rows
    (each slot's rows below its final ``kv_lens``) within the cache band
    of ``tests/test_torch_model.py``: 2e-5 of the leaf's largest magnitude.
    The random weights make the K/V rows O(30); layer 0's rows agree to
    2e-5 absolute, and fp32 rounding carried through layer 0's attention
    and MLP moves layer 1's rows by more than that.  The rows from
    ``kv_lens`` on are dead (a
    slot without a request keeps decoding and rewrites the row at its
    ``kv_lens`` every step) and are not compared.  Where card and CPU
    differ is printed by leaf and layer."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import serve_continuous
    gpu, cpu = _small_engines(cuda)
    prompts, targets = _prompts(7, 4), [6, 2, 9, 4, 3, 11, 1]
    emitted = {}
    for name, eng in (("gpu", gpu), ("cpu", cpu)):
        chunk_fn, seen = eng.decode_chunk, []

        def recording(*a, chunk_fn=chunk_fn, seen=seen, **kw):
            out = chunk_fn(*a, **kw)
            seen.append((out[5][out[6]].tolist(), out[7].copy()))
            return out

        eng.decode_chunk = recording
        emitted[name] = (serve_continuous(eng, prompts, targets, slots=4,
                                          chunk=8), seen)
        # no admission after the last chunk, so its kv_lens are the pool's
        assert eng.step_log[-1]["kind"] == "decode_chunk"
    (rg, tg), (rc, tc) = emitted["gpu"], emitted["cpu"]
    assert list(rg.produced) == list(rc.produced) == targets
    assert rg.decode_steps == rc.decode_steps
    assert rg.host_syncs == rc.host_syncs
    toks = [t for t, _ in tg]
    assert toks == [t for t, _ in tc]
    assert sum(map(len, toks)) == sum(targets) - len(targets)
    assert any(e.get("graph") == "replay" for e in gpu.step_log)

    kv = tc[-1][1].astype(np.int64)
    np.testing.assert_array_equal(tg[-1][1], kv)
    pos = torch.arange(gpu.ecfg.max_seq)[None, None, :, None, None]
    live = pos < torch.from_numpy(kv)[None, :, None, None, None]
    leaves, report = [], []
    for leaf, (a, e) in enumerate(zip(tree_leaves(gpu._caches[4]),
                                      tree_leaves(cpu._caches[4]))):
        a, mask = a.cpu(), live.expand_as(e)
        atol = 2e-5 * max(float(e[mask].abs().max()), 1.0)
        leaves.append((a[mask], e[mask], atol))
        diff = (a - e).abs()
        for g in range(e.shape[0]):
            on, off = diff[g][mask[g]], diff[g][~mask[g]]
            report.append(
                f"leaf {leaf} layer {g}: band {atol:.1e}; live rows max "
                f"{on.max():.1e}, {int((on > 1e-4).sum())} of {on.numel()} "
                f"above 1e-4; dead rows max {off.max():.1e}, "
                f"{int((off > 1e-4).sum())} of {off.numel()} above 1e-4")
    print("continuous pool, card vs CPU: " + "; ".join(report))
    for a, e, atol in leaves:
        torch.testing.assert_close(a, e, rtol=0, atol=atol)


@pytest.mark.gpu
def test_sampling_bits_equal_on_cpu_and_cuda(cuda):
    from repro_torch.serving.engine import (
        _sample_tokens, _split_slot_keys, sample_noise_bits, slot_keys_for)
    keys = {d: slot_keys_for(0xDEADBEEF, 16, d) for d in ("cpu", cuda)}
    for _ in range(3):
        bits = {d: sample_noise_bits(k, 151936) for d, k in keys.items()}
        assert torch.equal(bits["cpu"], bits[cuda].cpu())
        keys = {d: _split_slot_keys(k)[0] for d, k in keys.items()}
    logits = _randn((16, 1000), torch.float32, "cpu", 5) * 3
    toks = {d: _sample_tokens(keys[d], logits.to(d), 1.0, None)[0].cpu()
            for d in keys}
    assert torch.equal(toks["cpu"], toks[cuda])


# ----------------------------------------------------------------------------
# The simulators' scans (S1 batch_scan, S2 impatience_scan): float64, equal
# bit for bit to their plain versions (no tolerance: every product and sum
# is rounded on its own in both)
# ----------------------------------------------------------------------------

def _scan_inputs(lanes, n, seed):
    """Arrivals [n, lanes] with the first at t=0 and runs of equal arrival
    times (ties decide ``a <= t_cur``), and integer token counts."""
    rng = np.random.default_rng(seed)
    lam = np.geomspace(0.05, 2.0, lanes)
    gaps = rng.exponential(1.0, (n, lanes)) / lam
    gaps[0] = 0.0
    gaps[rng.random(n) < 0.05] = 0.0
    arr = np.cumsum(gaps, axis=0)
    tok = rng.integers(1, 1001, (n, lanes)).astype(np.float64)
    return arr, tok


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3, 64])
@pytest.mark.parametrize("capped", [False, True])
def test_batch_scan_kernel_bit_equal_to_plain(cuda, lanes, capped):
    from repro_torch.kernels.batch_scan import (
        NO_CAP, batch_scan, batch_scan_reference)
    n = 5003                                    # no multiple of 32 or 8
    arr, tok = _scan_inputs(lanes, n, seed=lanes)
    elastic = np.arange(lanes) % 2 == 1
    b_max = np.where(np.arange(lanes) % 3 == 0, NO_CAP, 8.0) if capped \
        else np.full(lanes, NO_CAP)
    args = [torch.from_numpy(x).to(cuda) for x in (arr, tok, elastic, b_max)]
    lat = (0.05, 0.5, 0.0005, 0.02)
    before = K.LAUNCHES["batch_scan"]
    starts, closed = batch_scan(*args, *lat)
    torch.cuda.synchronize()
    assert K.LAUNCHES["batch_scan"] == before + 1
    assert starts.shape == (n, lanes) and starts.dtype == torch.float64
    ref_s, ref_c = batch_scan_reference(*args, *lat)
    assert torch.equal(starts, ref_s) and torch.equal(closed, ref_c)
    assert bool(closed[0].all())                # the bogus first close
    cpu_s, cpu_c = batch_scan(*(a.cpu() for a in args), *lat)
    assert torch.equal(starts.cpu(), cpu_s) and torch.equal(closed.cpu(), cpu_c)


# S1's shared-memory ring at its edges: n of 1, one short of the ring's
# depth D, D, one past it and three rings and a bit; lanes of one block, a
# few, one past a warp and the sweeps' 64; capped and not; every lane
# padded, every lane elastic, or the two alternating in one launch (each
# lane's block runs the loop of its own law)
# (multiple of D, offset): n = multiple * D + offset
S1_RING_NS = {"1": (0, 1), "D-1": (1, -1), "D": (1, 0), "D+1": (1, 1),
              "3D+5": (3, 5)}


@pytest.mark.gpu
@pytest.mark.parametrize("law", ["padded", "elastic", "mixed"])
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("lanes", [1, 3, 33, 64])
@pytest.mark.parametrize("n_case", sorted(S1_RING_NS))
def test_batch_scan_ring_edges_bit_equal_to_plain(cuda, n_case, lanes, capped,
                                                  law):
    from repro_torch.kernels.batch_scan import (
        NO_CAP, batch_scan, batch_scan_reference)
    from repro_torch.kernels.batch_scan.ops import ring_depth
    depth = ring_depth()
    assert depth >= 64
    times, plus = S1_RING_NS[n_case]
    n = times * depth + plus
    arr, tok = _scan_inputs(lanes, n, seed=n + lanes)
    elastic = {"padded": np.zeros(lanes, bool), "elastic": np.ones(lanes, bool),
               "mixed": np.arange(lanes) % 2 == 1}[law]
    b_max = np.where(np.arange(lanes) % 3 == 0, NO_CAP, 4.0) if capped \
        else np.full(lanes, NO_CAP)
    args = [torch.from_numpy(x).to(cuda) for x in (arr, tok, elastic, b_max)]
    lat = (0.05, 0.5, 0.0005, 0.02)
    before = K.LAUNCHES["batch_scan"]
    starts, closed = batch_scan(*args, *lat)
    torch.cuda.synchronize()
    assert K.LAUNCHES["batch_scan"] == before + 1
    ref_s, ref_c = batch_scan_reference(*(a.cpu() for a in args), *lat)
    assert torch.equal(starts.cpu(), ref_s) and torch.equal(closed.cpu(), ref_c)


@pytest.mark.gpu
def test_batch_scan_saturated_and_light_lanes_in_one_launch(cuda):
    """One launch whose lane 0 arrives far above the padded capacity (its
    batches fill to the cap, or without one grow to hundreds) beside lanes
    so light that nearly every request closes a batch."""
    from repro_torch.kernels.batch_scan import (
        NO_CAP, batch_scan, batch_scan_reference)
    n, lanes = 20_011, 8
    rng = np.random.default_rng(20)
    lam = np.array([50.0, 50.0] + list(np.geomspace(5e-4, 5e-3, lanes - 2)))
    gaps = rng.exponential(1.0, (n, lanes)) / lam
    gaps[0] = 0.0
    arr = np.cumsum(gaps, axis=0)
    tok = rng.integers(1, 1001, (n, lanes)).astype(np.float64)
    elastic = np.arange(lanes) % 2 == 1
    b_max = np.array([8.0, NO_CAP] + [8.0, NO_CAP] * ((lanes - 2) // 2))
    args = [torch.from_numpy(x).to(cuda) for x in (arr, tok, elastic, b_max)]
    lat = (0.05, 0.5, 0.0005, 0.02)
    starts, closed = batch_scan(*args, *lat)
    torch.cuda.synchronize()
    ref_s, ref_c = batch_scan_reference(*(a.cpu() for a in args), *lat)
    assert torch.equal(starts.cpu(), ref_s) and torch.equal(closed.cpu(), ref_c)
    batches = closed.sum(dim=0).cpu().numpy()
    assert batches[0] <= n // 8 + 3                  # full batches of 8
    assert batches[1] < n // 100                     # batches of hundreds
    assert (batches[2:] > 0.9 * n).all()             # nearly all alone


# S2's shared-memory ring at its edges: n of 1, a tile T less one, T, T
# plus one, past the ring's depth D, and a length that is no multiple of
# anything; lanes of one block, a few, the sweeps' 64 and past 128; tau 30,
# 1e12 (none lost) and 0 (all lost) side by side; inputs contiguous, every
# other column of a wider tensor, lanes-major storage, and contiguous 8
# bytes off 16-byte alignment.  (multiple of T, offset): n = mult * T + off
S2_RING_NS = {"1": (0, 1), "T-1": (1, -1), "T": (1, 0), "T+1": (1, 1),
              "D+T+3": (None, 3), "5003": (0, 5003)}


def _impatience_inputs(n, lanes, seed):
    """[n, lanes] inter-arrival times (the first 0, runs of zero gaps) and
    service times of the paper's A100 law on integer token counts."""
    rng = np.random.default_rng(seed)
    inter = rng.exponential(40.0, (n, lanes))
    inter[0] = 0.0
    inter[rng.random((n, lanes)) < 0.05] = 0.0
    service = 1.79 + 0.021 * rng.integers(1, 3000, (n, lanes))
    return inter, service


def _s2_view(x, layout, dev):
    """The [n, lanes] array x on the card, stored as ``layout`` says."""
    t = torch.from_numpy(x).to(dev)
    if layout == "strided":                  # every other column of [n, 2L]
        wide = torch.zeros(x.shape[0], 2 * x.shape[1], dtype=t.dtype,
                           device=dev)
        wide[:, ::2] = t
        return wide[:, ::2]
    if layout == "lanes_major":              # strides (1, n)
        return t.t().contiguous().t()
    if layout == "offset":                   # 8 bytes past an aligned start
        flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "strided", "lanes_major",
                                    "offset"])
@pytest.mark.parametrize("lanes", [1, 3, 64, 130])
@pytest.mark.parametrize("n_case", sorted(S2_RING_NS))
def test_impatience_scan_kernel_bit_equal_to_plain(cuda, n_case, lanes,
                                                   layout):
    from repro_torch.kernels.impatience_scan import (
        impatience_scan, impatience_scan_reference)
    from repro_torch.kernels.impatience_scan.ops import ring_depth, tile
    T, D = tile(), ring_depth()
    assert D >= 2 * T >= 512
    mult, plus = S2_RING_NS[n_case]
    n = (D + T if mult is None else mult * T) + plus
    inter, service = _impatience_inputs(n, lanes, seed=n + lanes)
    tau = np.array([30.0, 1e12, 0.0])[np.arange(lanes) % 3]
    args = [_s2_view(inter, layout, cuda), _s2_view(service, layout, cuda),
            torch.from_numpy(tau).to(cuda)]
    before = K.LAUNCHES["impatience_scan"]
    waits, lost = impatience_scan(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["impatience_scan"] == before + 1
    assert waits.shape == (n, lanes) and waits.dtype == torch.float64
    ref_w, ref_l = impatience_scan_reference(*(a.cpu() for a in args))
    assert torch.equal(waits.cpu(), ref_w) and torch.equal(lost.cpu(), ref_l)
    assert not bool(lost[:, 1::3].any())                 # tau 1e12
    assert bool(lost[:, 2::3].all()) and not bool(waits[:, 2::3].any())
    if n > 4000:
        assert bool(lost[:, 0].any())                    # tau 30


@pytest.mark.gpu
def test_scan_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.batch_scan import batch_scan
    from repro_torch.kernels.impatience_scan import impatience_scan
    a = torch.zeros(40, 2, dtype=torch.float64, device=cuda)  # [n, lanes]
    cap = torch.full((2,), 8.0, dtype=torch.float64, device=cuda)
    flags = torch.zeros(2, dtype=torch.bool, device=cuda)
    lat = (0.05, 0.5, 0.0005, 0.02)
    with pytest.raises(TypeError):                        # float32
        batch_scan(a.float(), a.float(), flags, cap, *lat)
    with pytest.raises(TypeError):
        impatience_scan(a, a.float(), cap)
    with pytest.raises(ValueError):                       # shapes
        batch_scan(a, a[:39], flags, cap, *lat)
    with pytest.raises(ValueError):
        impatience_scan(a, a, cap[:1])
    with pytest.raises(ValueError):                       # CPU + CUDA
        batch_scan(a, a.cpu(), flags, cap, *lat)
    with pytest.raises(ValueError):
        impatience_scan(a, a, cap.cpu())


@pytest.mark.gpu
def test_fast_simulators_on_the_card_equal_the_oracle(cuda):
    """``core.fastsim`` through S1 and S2 on the card against the NumPy
    oracle and the CPU run of the same entry point."""
    from repro_torch.core import fastsim, simulate
    from repro_torch.core.distributions import LogNormalTokens, UniformTokens
    from repro_torch.core.latency_model import (
        PAPER_A100_LLAMA2_7B, BatchLatencyModel)
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, FCFSPolicy)
    uni, ln = UniformTokens(1000), LogNormalTokens(7.0, 0.7)
    lat = BatchLatencyModel(0.05, 0.5, 0.0005, 0.02)
    for pol, lam, dist, law in (
            (DynamicPolicy(), 0.4, uni, lat),
            (ElasticPolicy(b_max=8), 0.6, uni, lat),
            (FCFSPolicy(tau=30.0), 1 / 40, ln, PAPER_A100_LLAMA2_7B),
            (FCFSPolicy(tau=120.0, n_max=1600), 1 / 40, ln,
             PAPER_A100_LLAMA2_7B)):
        before = dict(K.LAUNCHES)
        gpu = fastsim.simulate_policy_fast(pol, lam, dist, law,
                                           num_requests=6000, seed=1)
        name = "impatience_scan" if pol.name == "fcfs" else "batch_scan"
        assert K.LAUNCHES[name] == before.get(name, 0) + 1
        ora = simulate.simulate_policy(pol, lam, dist, law, num_requests=6000,
                                       seed=1)
        assert np.array_equal(gpu["waits"], ora["waits"]), pol
    pols = {"dyn": DynamicPolicy(), "ela8": ElasticPolicy(b_max=8)}
    before = K.LAUNCHES["batch_scan"]
    gpu = fastsim.sweep(pols, [0.1, 0.5, 0.9], uni, lat, num_requests=6000)
    assert K.LAUNCHES["batch_scan"] == before + 1      # six lanes, one launch
    ora = simulate.simulate_policy_sweep([0.1, 0.5, 0.9], uni, lat, pols,
                                         num_requests=6000)
    for name in pols:
        assert np.array_equal(gpu[name], ora[name]), name


@pytest.mark.gpu
def test_sweep_runs_impatient_cells_as_one_launch(cuda):
    """``fastsim.sweep`` on the card: every impatient FCFS cell a lane of
    one S2 launch, equal to the oracle cell for cell; the cells without
    tau take the closed form and launch nothing."""
    from repro_torch.core import fastsim, simulate
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import PAPER_A100_LLAMA2_7B
    from repro_torch.core.policies import FCFSPolicy
    ln, lat = LogNormalTokens(7.0, 0.7), PAPER_A100_LLAMA2_7B
    pols = {f"n{n_max}_t{tau}": FCFSPolicy(n_max=n_max, tau=tau)
            for n_max in (None, 1600) for tau in (30.0, 120.0, None)}
    lams = [1 / 60, 1 / 40, 1 / 30]
    before, got = dict(K.LAUNCHES), {}
    gpu = fastsim.sweep(pols, lams, ln, lat, num_requests=6000, seed=2,
                        scan_out=got)
    assert K.LAUNCHES["impatience_scan"] == \
        before.get("impatience_scan", 0) + 1
    s2 = got["impatience"]
    assert len(s2["lanes"]) == 4 * len(lams) and got["cells"] == {}
    assert s2["out"][0].is_cuda and s2["out"][0].shape == (6000, 12)
    ora = simulate.simulate_policy_sweep(lams, ln, lat, pols,
                                         num_requests=6000, seed=2)
    for name in pols:
        assert np.array_equal(gpu[name], ora[name]), name
    waits = s2["out"][0].cpu().numpy()
    for col, (name, li) in enumerate(s2["lanes"]):
        with simulate.no_warmup():
            cell = simulate.simulate_policy(pols[name], lams[li], ln, lat,
                                            num_requests=6000, seed=2)
        assert np.array_equal(waits[:, col], cell["waits"]), (name, li)


# ----------------------------------------------------------------------------
# The batch-event loops (S3 multibin_scan, S4 wait_scan, S5 srpt_scan):
# float64, equal bit for bit to their plain versions on edge cases
# ----------------------------------------------------------------------------

EVENT_LAT = (0.05, 0.5, 2e-4, 0.002)


def _event_inputs(n, lanes, seed, tie_every=0):
    """Sorted arrivals [n, lanes] from t=0, at loads from idle to
    saturated, with runs of equal arrival times when ``tie_every`` > 0, and
    integer token counts with repeats (ties in SRPT's rank order)."""
    rng = np.random.default_rng(seed)
    lam = np.geomspace(0.05, 3.0, lanes)
    gaps = rng.exponential(1.0, (n, lanes)) / lam
    gaps[0] = 0.0
    if tie_every:
        gaps[::tie_every] = 0.0
    arr = np.cumsum(gaps, axis=0)
    tok = rng.integers(1, 40, (n, lanes)).astype(np.float64) * 50.0
    return arr, tok


def _multibin_bins(case, tok, lanes, rng):
    """(num_bins, [n, lanes] bins) of a multi-bin case."""
    n = tok.shape[0]
    if case.startswith("bins_"):              # every bin, at random
        num_bins = int(case.split("_")[1])
        return num_bins, rng.integers(0, num_bins, (n, lanes))
    if case == "mixed_layouts":               # each lane its own layout
        bins = np.stack([np.zeros(n, np.int64),               # one bin
                         rng.integers(0, 64, n),              # all 64
                         np.where(rng.random(n) < 0.5, 5, 63),  # two
                         np.searchsorted([500.0, 1000.0, 1500.0],
                                         tok[:, 3 % lanes])][:lanes],
                        axis=1)
        return 64, bins
    edges = {"one_bin": [1e9, 2e9, 3e9],      # every request in bin 0
             "empty_bin": [600.0, 600.5, 1200.0]}.get(  # bin 1 empty
                 case, [500.0, 1000.0, 1500.0])
    bins = np.searchsorted(edges, tok, side="left")
    if case == "early_empty":                 # bin 3's members all early
        bins = np.where(bins == 3, 0, bins)
        bins[: n // 20: 3] = 3
    return 4, bins


def _event_case(kernel, case, n, lanes, dev):
    """(wrapper, plain version, args on ``dev``) of one edge case."""
    from repro_torch.kernels.multibin_scan import (
        multibin_scan, multibin_scan_reference)
    from repro_torch.kernels.srpt_scan import srpt_scan, srpt_scan_reference
    from repro_torch.kernels.wait_scan import wait_scan, wait_scan_reference
    arr, tok = _event_inputs(n, lanes, seed=n + lanes,
                             tie_every=3 if case == "ties" else 0)
    if case == "wide":          # saturated lanes: batches of hundreds
        arr = arr / 20.0
    cap = {"b_max_1": 1, "ties": 4, "b_max_16": 16}.get(case, 8)
    b_max = np.where(np.arange(lanes) % 2 == 0, cap, 0)     # 0: no cap
    if case == "wide":
        b_max[:] = 0

    def i64(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    def f64(x):
        return torch.from_numpy(np.asarray(x, np.float64)).to(dev)

    if kernel == "multibin_scan":
        num_bins, bins = _multibin_bins(case, tok, lanes,
                                        np.random.default_rng(n))
        return multibin_scan, multibin_scan_reference, (
            f64(arr), f64(tok), i64(bins), num_bins, i64(b_max))
    if kernel == "wait_scan":
        timeout = {"timeout_0": 0.0}.get(case, 3.0)
        timeouts = np.where(np.arange(lanes) % 3 == 2, np.inf, timeout)
        return wait_scan, wait_scan_reference, (
            f64(arr), f64(tok), i64(np.full(lanes, 5)), f64(timeouts),
            i64(b_max))
    order = np.argsort(tok, axis=0, kind="stable")
    return srpt_scan, srpt_scan_reference, (
        f64(arr), f64(tok), i64(order), i64(b_max))


# every batch-event kernel on the shared edge cases; S3 also across the
# warp's bins (1, 4, 32, 33 and 64: two bins a thread past 32), a bin that
# empties early, caps of 1, 16 and none, batches of hundreds (past the
# 32-member window) and lanes of different bin layouts
EVENT_CASES = [(kernel, case, n, lanes)
               for kernel in ("multibin_scan", "wait_scan", "srpt_scan")
               for case, n, lanes in (
                   ("plain", 4001, 5), ("ties", 3001, 3), ("b_max_1", 2001, 2),
                   ("n_1", 1, 3), ("one_bin", 2001, 2), ("empty_bin", 2001, 3),
                   ("timeout_0", 2001, 3))] + [
    ("multibin_scan", case, n, lanes) for case, n, lanes in (
        ("bins_1", 3001, 3), ("bins_32", 4001, 3), ("bins_33", 4001, 3),
        ("bins_64", 6001, 4), ("early_empty", 4001, 3), ("b_max_16", 4001, 4),
        ("wide", 6001, 3), ("mixed_layouts", 4001, 4))]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,case,n,lanes", EVENT_CASES)
def test_event_kernels_bit_equal_to_plain(cuda, monkeypatch, kernel, case, n,
                                          lanes):
    fn, ref, args = _event_case(kernel, case, n, lanes, cuda)
    before = K.LAUNCHES[kernel]
    # S3's outputs start as a sentinel: the kernel writes every row
    with (_sentinel_empty(monkeypatch) if kernel == "multibin_scan"
          else contextlib.nullcontext()):
        starts, first = fn(*args, *EVENT_LAT)
        torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == before + 1
    assert starts.shape == (n, lanes) and starts.dtype == torch.float64
    assert first.dtype == torch.bool
    ref_s, ref_f = ref(*args, *EVENT_LAT)
    assert torch.equal(starts, ref_s) and torch.equal(first, ref_f)
    assert bool(first[0].all())          # request 0 heads the first batch
    arr = args[0]
    assert bool((starts >= arr).all())
    cpu = fn(*(a.cpu() if torch.is_tensor(a) else a for a in args),
             *EVENT_LAT)
    assert torch.equal(starts.cpu(), cpu[0]) and torch.equal(first.cpu(),
                                                             cpu[1])
    if case == "wide":          # a batch (one start) spans several windows
        assert max(int(torch.unique(starts[:, c], return_counts=True)[1].max())
                   for c in range(lanes)) > 64
    if case == "early_empty":   # bin 3 is empty long before the end
        bins = args[2][:, 0].cpu()
        assert int(torch.nonzero(bins == 3).max()) < n // 20


# S4's staged window at its edges: a trigger count k of 0 (counts as 1), 1,
# 16 and three past the window W (read from device memory); caps of none, 1,
# 16 and W + 3; timeouts of 0, 2.5 and none; one lane or ten.  The loads run
# from idle to far past saturation, so batches of hundreds cross the window.
# (multiple of W, offset)
S4_WINDOW_VALUES = {"0": (0, 0), "1": (0, 1), "16": (0, 16), "W+3": (1, 3)}


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 10])
@pytest.mark.parametrize("timeout", [0.0, 2.5, float("inf")])
@pytest.mark.parametrize("b_max_case", sorted(S4_WINDOW_VALUES))
@pytest.mark.parametrize("k_case", sorted(S4_WINDOW_VALUES))
def test_wait_scan_window_edges_bit_equal_to_plain(cuda, k_case, b_max_case,
                                                   timeout, lanes):
    from repro_torch.kernels.wait_scan import wait_scan, wait_scan_reference
    from repro_torch.kernels.wait_scan.ops import window
    w = window()
    assert w >= 64
    k, b_max = (S4_WINDOW_VALUES[c][0] * w + S4_WINDOW_VALUES[c][1]
                for c in (k_case, b_max_case))
    n = 4 * w + 37
    rng = np.random.default_rng(k + 7 * b_max + lanes)
    lam = np.geomspace(0.05, 60.0, lanes) if lanes > 1 else np.array([60.0])
    gaps = rng.exponential(1.0, (n, lanes)) / lam
    gaps[0] = 0.0
    arr = np.cumsum(gaps, axis=0)
    tok = rng.integers(1, 40, (n, lanes)).astype(np.float64) * 50.0

    def i64(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(cuda)
    args = (torch.from_numpy(arr).to(cuda), torch.from_numpy(tok).to(cuda),
            i64(np.full(lanes, k)),
            torch.full((lanes,), timeout, dtype=torch.float64, device=cuda),
            i64(np.full(lanes, b_max)))
    before = K.LAUNCHES["wait_scan"]
    starts, first = wait_scan(*args, *EVENT_LAT)
    torch.cuda.synchronize()
    assert K.LAUNCHES["wait_scan"] == before + 1
    ref_s, ref_f = wait_scan_reference(*(a.cpu() for a in args), *EVENT_LAT)
    assert torch.equal(starts.cpu(), ref_s) and torch.equal(first.cpu(), ref_f)
    if timeout == float("inf") and b_max in (0, w + 3):
        # the saturated lane's batches run past the window
        sizes = torch.unique(starts[:, -1], return_counts=True)[1]
        assert int(sizes.max()) > w


@pytest.mark.gpu
def test_wait_scan_refuses_lanes_past_its_int_positions(cuda):
    """The kernel keeps a lane's positions in 32-bit ints: the wrapper
    refuses a lane one request past the kernel's bound instead of
    launching (the lane a broadcast view, so nothing of its size is
    allocated)."""
    from repro_torch.kernels.wait_scan import ops, wait_scan
    bound = ops.max_requests()
    assert 2 ** 30 < bound < 2 ** 31
    a = torch.zeros(1, 1, dtype=torch.float64, device=cuda).expand(bound + 1, 1)
    one = torch.ones(1, dtype=torch.int64, device=cuda)
    before = K.LAUNCHES["wait_scan"]
    with pytest.raises(ValueError, match=f"at most {bound} requests"):
        wait_scan(a, a, one, a[0], one, *EVENT_LAT)
    assert K.LAUNCHES["wait_scan"] == before


@contextlib.contextmanager
def _nan_filled_empty():
    """torch.empty fills floats with NaN (and bools with True) inside, so
    the requests a lane leaves unserved read NaN in the plain version's
    starts too, and the two compare as wholes."""
    det, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


@contextlib.contextmanager
def _sentinel_empty(monkeypatch):
    """torch.empty and torch.empty_like fill what they return with -7
    (True for bools) inside, so an output a kernel leaves unwritten
    shows."""
    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        return t.fill_(True if t.dtype == torch.bool else -7)
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", lambda *a, **kw: fill(empty(*a, **kw)))
        m.setattr(torch, "empty_like",
                  lambda *a, **kw: fill(empty_like(*a, **kw)))
        yield


def _srpt_oracle(arr, tok, b_max):
    """One lane through the NumPy oracle's SRPT formation (its heap of
    (predicted, index) over arrivals in time order), the predicted lengths
    the true ones: (starts, first)."""
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import _SRPTFormation
    lat = BatchLatencyModel(*EVENT_LAT)
    fs = _SRPTFormation(arr, tok, b_max if b_max > 0 else None)
    starts, first = np.empty(len(arr)), np.zeros(len(arr), bool)
    t_free = 0.0
    while (nb := fs.next_batch(t_free)) is not None:
        start, idx = nb
        starts[idx], first[idx[0]] = start, True
        t_free = start + lat.batch_time(len(idx), tok[idx].max())
    return starts, first


# S5's fanout-32 tree at its edges: a level that just fills a word of 32
# and one that spills into the next, at 32, 1,024 and 32,768 ranks; every
# arrival at one instant; arrivals out of time order; caps of n and more; a
# NaN arrival in one lane; one cap per lane; and a lane whose level 0
# outgrows shared memory and sits in the scratch (at 2**21 + 3 requests
# level 0 is in the scratch, levels 1 to 3 in shared memory)
SRPT_TREE_CASES = [("n", n, 2) for n in (31, 32, 33, 1023, 1024, 1025, 32767,
                                         32768, 32769)] + [
    ("equal_arrivals", 3001, 3), ("unsorted", 3001, 3), ("cap_ge_n", 2001, 3),
    ("nan_one_lane", 2001, 3), ("mixed_caps", 4001, 6),
    ("global_levels", 2 ** 21 + 3, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("case,n,lanes", SRPT_TREE_CASES)
def test_srpt_scan_wide_tree_bit_equal(cuda, monkeypatch, case, n, lanes):
    from repro_torch.kernels.srpt_scan import srpt_scan, srpt_scan_reference
    from repro_torch.kernels.srpt_scan.ops import lane_words
    arr, tok = _event_inputs(n, lanes, seed=n + lanes)
    if case == "equal_arrivals":
        arr[:] = 5.0
    if case == "global_levels":       # saturated, so the plain loop is short
        arr = np.cumsum(np.full((n, 1), 1 / 3.0), axis=0)
        assert lane_words(n) > 4 * n      # tree words beyond the arrays
    if case == "unsorted":            # shuffled, with runs of equal arrivals
        arr = np.random.default_rng(n).permutation(arr)
        arr[::7] = arr[3::7]
    if case == "nan_one_lane":
        arr[n // 2, lanes - 1] = np.nan
    b_max = {"cap_ge_n": [n, n + 5, 0], "mixed_caps": [1, 2, 16, 0, 33, 1000],
             "global_levels": [128]}.get(case, [8, 0, 3][:lanes])
    order = np.argsort(tok, axis=0, kind="stable")
    args = tuple(torch.from_numpy(np.asarray(a)).to(cuda) for a in (
        arr, tok, order.astype(np.int64), np.asarray(b_max, np.int64)))
    before = K.LAUNCHES["srpt_scan"]
    with _sentinel_empty(monkeypatch):
        starts, first = srpt_scan(*args, *EVENT_LAT)
        torch.cuda.synchronize()
    assert K.LAUNCHES["srpt_scan"] == before + 1
    # the kernel writes every start and flag: NaN and False for a request a
    # NaN arrival leaves unserved, which the plain version leaves unset
    assert not bool((starts == -7).any())
    with _nan_filled_empty():
        ref_s, ref_f = srpt_scan_reference(*args, *EVENT_LAT)
    torch.testing.assert_close(starts, ref_s, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(first, ref_f)
    s, f = starts.cpu().numpy(), first.cpu().numpy()
    for lane in range(lanes):
        if case == "nan_one_lane" and lane == lanes - 1:
            served = ~np.isnan(s[:, lane])
            assert 0 < served.sum() < n and not served[n // 2]
            assert not f[~served, lane].any()
            continue
        if case == "unsorted":        # the oracle takes arrivals in time order
            continue
        assert not np.isnan(s[:, lane]).any()
        ora_s, ora_f = _srpt_oracle(arr[:, lane], tok[:, lane],
                                    int(b_max[lane]))
        assert np.array_equal(s[:, lane], ora_s), (case, lane)
        assert np.array_equal(f[:, lane], ora_f), (case, lane)


@pytest.mark.gpu
def test_event_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.multibin_scan import multibin_scan
    from repro_torch.kernels.srpt_scan import srpt_scan
    from repro_torch.kernels.wait_scan import wait_scan
    a = torch.zeros(40, 2, dtype=torch.float64, device=cuda)
    i = torch.zeros(40, 2, dtype=torch.int64, device=cuda)
    cap = torch.full((2,), 8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        multibin_scan(a.float(), a, i, 4, cap, *EVENT_LAT)
    with pytest.raises(ValueError):                     # bins out of range
        multibin_scan(a, a, i + 4, 4, cap, *EVENT_LAT)
    with pytest.raises(ValueError):
        srpt_scan(a, a, i - 1, cap, *EVENT_LAT)
    with pytest.raises(ValueError):                     # CPU + CUDA
        wait_scan(a, a, cap, a[0].cpu(), cap, *EVENT_LAT)
    with pytest.raises(ValueError):
        srpt_scan(a, a[:39], i, cap, *EVENT_LAT)


@pytest.mark.gpu
def test_event_simulators_on_the_card_equal_the_oracle(cuda):
    """``core.fastsim`` through S3-S5 on the card against the NumPy oracle,
    and ``sweep`` handing back each cell's launch."""
    from repro_torch.core import fastsim, simulate
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        MultiBinPolicy, SRPTPolicy, WaitPolicy)
    ln = LogNormalTokens(7.0, 0.7)
    lat = BatchLatencyModel(*EVENT_LAT)
    pols = {"mb": MultiBinPolicy(num_bins=4), "mb8": MultiBinPolicy(b_max=8),
            "wait": WaitPolicy(k=16), "wait_t": WaitPolicy(k=4, timeout=1.0),
            "srpt": SRPTPolicy(b_max=16), "srpt1": SRPTPolicy(b_max=1)}
    for pol in pols.values():
        for lam in (0.3, 1.0):
            name = {"multibin": "multibin_scan", "wait": "wait_scan",
                    "srpt": "srpt_scan"}[pol.name]
            before = K.LAUNCHES[name]
            with simulate.no_warmup():
                gpu = fastsim.simulate_policy_fast(pol, lam, ln, lat,
                                                   num_requests=6000, seed=2)
                ora = simulate.simulate_policy(pol, lam, ln, lat,
                                               num_requests=6000, seed=2)
            assert K.LAUNCHES[name] == before + 1
            assert np.array_equal(gpu["waits"], ora["waits"]), (pol, lam)
            assert gpu["mean_batch"] == ora["mean_batch"], (pol, lam)
    got = {}
    gpu = fastsim.sweep(pols, [0.3, 1.0], ln, lat, num_requests=6000,
                        scan_out=got)
    ora = simulate.simulate_policy_sweep([0.3, 1.0], ln, lat, pols,
                                         num_requests=6000)
    assert sorted(got["cells"]) == sorted((p, li) for p in pols
                                          for li in (0, 1))
    for name in pols:
        assert np.array_equal(gpu[name], ora[name]), name



# ----------------------------------------------------------------------------
# The fleet's routing scan (S6) and the fleet simulators on the card
# ----------------------------------------------------------------------------

def _routing_inputs(n, R, lanes, seed):
    """[n, lanes] arrivals and work with ties (runs of equal arrivals, zero
    work, every backlog 0 at t = 0) and an [n, R, lanes] uint8 mask with
    rows where every replica is down."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0, (n, lanes)), axis=0)
    arr[: n // 3] = np.floor(arr[: n // 3])
    arr[0] = 0.0
    work = rng.exponential(2.0, (n, lanes))
    work[::5] = 0.0
    up = (rng.random((n, R, lanes)) < 0.6).astype(np.uint8)
    up[::7] = 0
    return arr, work, up


# every template of S6 (R = 2..8, 16, 32, 64; the thread-a-lane and the
# warp-a-lane kernels) and a count rounded up to each of 16, 32 and 64; at
# n = 37 70 lanes, more than one block of the thread-a-lane kernel
@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 37, 40_000])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 32, 33, 64])
def test_backlog_scan_kernel_bit_equal_to_plain(cuda, monkeypatch, R, n):
    from repro_torch.kernels.backlog_scan import (
        backlog_scan, backlog_scan_reference)
    lanes = 70 if n == 37 else 3
    arr, work, up = (torch.from_numpy(x).to(cuda)
                     for x in _routing_inputs(n, R, lanes, seed=R + n))
    for mask in (None, up):
        before = K.LAUNCHES["backlog_scan"]
        with _sentinel_empty(monkeypatch):     # the kernel writes every row
            out = backlog_scan(arr, work, R, mask)
            torch.cuda.synchronize()
        assert K.LAUNCHES["backlog_scan"] == before + (R > 1)
        assert out.dtype == torch.int64 and out.shape == arr.shape
        assert torch.equal(out, backlog_scan_reference(arr, work, R, mask))
        if mask is not None:
            assert (out[::7] == 0).all()          # every replica down


@pytest.mark.gpu
def test_backlog_scan_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.backlog_scan import MAX_REPLICAS, backlog_scan
    a = torch.zeros(40, 2, dtype=torch.float64, device=cuda)
    up = torch.ones(40, 3, 2, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        backlog_scan(a.float(), a, 3)
    with pytest.raises(TypeError):
        backlog_scan(a, a, 3, up.bool())
    with pytest.raises(ValueError):
        backlog_scan(a, a, MAX_REPLICAS + 1)
    with pytest.raises(ValueError):
        backlog_scan(a, a, 4, up)                 # a mask of 3 columns
    with pytest.raises(ValueError):
        backlog_scan(a, a.cpu(), 3)


@pytest.mark.gpu
def test_fleet_simulators_on_the_card_equal_cpu(cuda):
    """``simulate_fleet_fast`` and the fault-injected fleet on the card
    (S6, then S1/S5/S2 per replica) equal the same calls with
    ``device="cpu"`` (the plain versions) on one router x policy grid."""
    from repro_torch.core import fastsim, faults
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        DynamicPolicy, FCFSPolicy, SRPTPolicy)
    ln = LogNormalTokens(7.0, 0.7)
    lat = BatchLatencyModel(*EVENT_LAT)
    for router in ("jsq", "least_work", "round_robin",
                   {"kind": "least_work",
                    "predictor": {"kind": "lognormal_noise", "sigma": 0.5}}):
        for pol in (DynamicPolicy(b_max=8), SRPTPolicy(b_max=16),
                    FCFSPolicy(tau=30.0)):
            kw = dict(num_requests=4000, seed=3, traffic="mmpp")
            before = K.LAUNCHES["backlog_scan"]
            gpu = fastsim.simulate_fleet_fast(router, pol, 1.6, 4, ln, lat,
                                              **kw)
            cpu = fastsim.simulate_fleet_fast(router, pol, 1.6, 4, ln, lat,
                                              device="cpu", **kw)
            stateful = router != "round_robin"
            assert K.LAUNCHES["backlog_scan"] == before + stateful
            assert np.array_equal(gpu["replica_of"], cpu["replica_of"])
            for a, b in zip(gpu["per_replica"], cpu["per_replica"]):
                assert np.array_equal(a["waits"], b["waits"]), (router, pol)
    for key in ("crash", "drop"):
        kw = dict(num_requests=1500, seed=2, fast=True)
        gpu = faults.simulate_fleet_faulty("least_work", DynamicPolicy(16),
                                           4.0, 3, ln, lat, key, **kw)
        cpu = faults.simulate_fleet_faulty("least_work", DynamicPolicy(16),
                                           4.0, 3, ln, lat, key,
                                           device="cpu", **kw)
        assert np.array_equal(gpu["replica_of"], cpu["replica_of"])
        assert np.array_equal(gpu["waits"], cpu["waits"])
        assert gpu["retries"] == cpu["retries"]


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["srpt", "multibin", "wait"])
def test_sweep_noise_on_the_card_equals_cpu(cuda, policy):
    from repro_torch.core import fastsim
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import get_policy
    from repro_torch.core.predictors import LogNormalNoisePredictor
    ln = LogNormalTokens(7.0, 0.7)
    lat = BatchLatencyModel(*EVENT_LAT)
    kw = {"srpt": {"b_max": 16}, "multibin": {"num_bins": 4},
          "wait": {"k": 16}}[policy]

    def factory(s):
        return get_policy(policy, predictor=LogNormalNoisePredictor(s), **kw)
    args = (factory, [0.6, 1.0], [0.0, 0.5, 1.5], ln, lat)
    name = policy + "_scan"
    before = K.LAUNCHES[name]
    got = {}
    gpu = fastsim.sweep_noise(*args, num_requests=5000, seed=15,
                              launch_out=got)
    cpu = fastsim.sweep_noise(*args, num_requests=5000, seed=15,
                              device="cpu")
    assert np.array_equal(gpu["mean_wait"], cpu["mean_wait"])
    # SRPT, multi-bin and WAIT alike: all six cells are lanes of one launch
    assert K.LAUNCHES[name] == before + 1
    assert got["kernel"] == name and got["args"][0].shape == (5000, 6)
    assert got["cells"] == [(li, si) for li in range(2) for si in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_mesh_sweeps_on_the_card_equal_cpu(cuda, shards):
    """``core.shardsweep`` with the card listed ``shards`` times (the lanes
    split, launched a shard at a time and concatenated on the card) equals
    the single-device sweeps run with ``device="cpu"``; ``fleet_sweep``
    launches S6 once a shard for the whole grid."""
    from repro_torch.core import fastsim, fleet, shardsweep
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, FCFSPolicy, SRPTPolicy)
    from repro_torch.core.predictors import LogNormalNoisePredictor
    from repro_torch.distributed import cells_mesh
    mesh = cells_mesh([cuda] * shards)
    ln = LogNormalTokens(7.0, 0.7)
    lat = BatchLatencyModel(*EVENT_LAT)
    args = ([1, 2, 3, 4], [0.8, 1.6], "jsq", DynamicPolicy(b_max=8), ln, lat)
    before = K.LAUNCHES["backlog_scan"]
    gpu = shardsweep.fleet_sweep(*args, num_requests=4000, seed=3, mesh=mesh)
    assert K.LAUNCHES["backlog_scan"] == before + shards
    cpu = fleet.sweep(*args, num_requests=4000, seed=3, device="cpu")
    assert np.array_equal(gpu["mean_wait"], cpu["mean_wait"])
    pols = {"dynamic": DynamicPolicy(), "elastic": ElasticPolicy(b_max=8),
            "fcfs": FCFSPolicy()}
    gpu = shardsweep.sweep(pols, [0.3, 0.9, 1.6], ln, lat, num_requests=4000,
                           seed=1, mesh=mesh)
    cpu = fastsim.sweep(pols, [0.3, 0.9, 1.6], ln, lat, num_requests=4000,
                        seed=1, device="cpu")
    for k in pols:
        assert np.array_equal(gpu[k], cpu[k]), k
    noise = (lambda s: SRPTPolicy(b_max=16,
                                  predictor=LogNormalNoisePredictor(s)),
             [0.6, 1.0], [0.0, 0.5, 1.5], ln, lat)
    gpu = shardsweep.sweep_noise(*noise, num_requests=3000, seed=15,
                                 mesh=mesh)
    cpu = fastsim.sweep_noise(*noise, num_requests=3000, seed=15,
                              device="cpu")
    assert np.array_equal(gpu["mean_wait"], cpu["mean_wait"])


# ----------------------------------------------------------------------------
# Re-entrant sessions (one kernel launch a fixed-point pass) and the
# resilient engine fleet
# ----------------------------------------------------------------------------

SESSION_POLICIES = {"batch_scan": ("dynamic", {"b_max": 16}),
                    "multibin_scan": ("multibin", {"num_bins": 4,
                                                   "b_max": 16}),
                    "wait_scan": ("wait", {"k": 16, "timeout": 2.0,
                                           "b_max": 16}),
                    "srpt_scan": ("srpt", {"b_max": 16})}


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["geometric", "chain"])
@pytest.mark.parametrize("kernel", sorted(SESSION_POLICIES))
def test_session_cells_on_the_card_equal_cpu_and_oracle(cuda, kernel, model):
    """``simulate_policy_sessions(fast=True)`` on the card launches the
    policy's kernel once a pass and equals the same call on the CPU (the
    plain versions) and the oracle."""
    from repro_torch.core import sessions
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import get_policy
    kind, kw = SESSION_POLICIES[kernel]
    pol = get_policy(kind, **kw)
    sm = {"geometric": sessions.GeometricSession(p=0.5, think_mean=2.0),
          "chain": sessions.ChainSession(k=3, think=1.0)}[model]
    args = (pol, 0.1, LogNormalTokens(5.0, 0.6),
            BatchLatencyModel(0.05, 0.5, 0.0005, 0.02), 400, 5, sm)
    before = K.LAUNCHES[kernel]
    gpu = sessions.simulate_policy_sessions(*args, fast=True)
    assert K.LAUNCHES[kernel] == before + gpu["passes"]
    cpu = sessions.simulate_policy_sessions(*args, fast=True, device="cpu")
    ora = sessions.simulate_policy_sessions(*args)
    assert gpu["converged"] and gpu["passes"] == cpu["passes"]
    assert np.array_equal(gpu["waits"], cpu["waits"])
    np.testing.assert_allclose(gpu["waits"], ora["waits"], rtol=0, atol=1e-9)


@pytest.mark.gpu
def test_fleet_session_cell_launches_backlog_scan(cuda):
    """A ``least_work`` fleet session cell routes every pass on S6 and runs
    every replica on S1, equal to the same call on the CPU."""
    from repro_torch.core import fastsim
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import DynamicPolicy
    args = ("least_work", DynamicPolicy(b_max=8), 1.5, 3,
            LogNormalTokens(5.0, 0.6),
            BatchLatencyModel(0.05, 0.5, 0.0005, 0.02))
    kw = dict(num_requests=300, seed=5, prefix_discount=0.5,
              sessions={"name": "geometric", "p": 0.5, "think_mean": 2.0})
    before = dict(K.LAUNCHES)
    gpu = fastsim.simulate_fleet_fast(*args, **kw)
    assert K.LAUNCHES["backlog_scan"] - before["backlog_scan"] == \
        gpu["passes"]
    assert K.LAUNCHES["batch_scan"] > before["batch_scan"]
    cpu = fastsim.simulate_fleet_fast(*args, device="cpu", **kw)
    assert np.array_equal(gpu["replica_of"], cpu["replica_of"])
    assert np.array_equal(gpu["waits"], cpu["waits"])


@pytest.mark.gpu
def test_resilient_engine_fleet_card_equals_cpu(cuda):
    """``run_fleet_schedule(..., kill_at=...)`` on the small fp32 engine:
    the card and the CPU give the same final replica of every request and
    the same report (victims are picked on the batch law's virtual clock;
    only the waits are wall clock)."""
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import DynamicPolicy
    from repro_torch.data.pipeline import make_request_stream
    from repro_torch.serving import run_fleet_schedule
    gpu, cpu = _small_engines(cuda)
    reqs = make_request_stream(24, 4.0, LogNormalTokens(2.5, 0.6,
                                                        support=40),
                               vocab=512, prompt_len_range=(3, 40), seed=5)
    kill = {0: float(np.median([r.arrival for r in reqs]))}
    lat = BatchLatencyModel(0.05, 0.5, 0.0005, 0.02)
    out, launches = _launch_delta(lambda: [
        run_fleet_schedule("jsq", DynamicPolicy(b_max=8), eng, reqs, R=3,
                           lat=lat, kill_at=kill, seed=1)
        for eng in (gpu, cpu)])
    g, c = out
    for name in ("ragged_decode_attention", "flash_attention",
                 "fused_rmsnorm"):
        assert launches.get(name, 0) > 0, name
    assert np.array_equal(g.replica_of, c.replica_of)
    assert vars(g.resilience) == vars(c.resilience)
    rep = g.resilience
    assert rep.kill_events and rep.retries > 0
    assert rep.served == rep.arrived == len(reqs)
    assert np.isfinite(g.waits).all() and (g.replica_of >= 0).all()


# ----------------------------------------------------------------------------
# The memory-gated tandem loop (S7 tandem_scan): float64, equal bit for bit
# to its plain version, a lane's batches compared up to its batch count
# ----------------------------------------------------------------------------

def _tandem_inputs(ns, caps, b_maxs, seed, prompt=0.0, tok=None):
    """Lanes of ``ns`` requests (padded to the longest with +inf arrivals
    and +inf prefix sums), arrivals with runs of ties, integer tokens,
    footprint prefix sums summed on the host; as float64 CPU tensors."""
    rng = np.random.default_rng(seed)
    L, lanes = max(ns), len(ns)
    arr = np.full((L, lanes), np.inf)
    toks = np.zeros((L, lanes))
    fp_cum = np.full((L + 1, lanes), np.inf)
    fp_cum[0] = 0.0
    for c, n in enumerate(ns):
        gaps = rng.exponential(1.0 / (0.05 + 0.3 * c), n)
        gaps[0] = 0.0
        gaps[rng.random(n) < 0.05] = 0.0
        arr[:n, c] = np.cumsum(gaps)
        toks[:n, c] = rng.integers(1, 1001, n) if tok is None else tok
        fp_cum[1:n + 1, c] = np.cumsum(toks[:n, c] + prompt)
    caps = [max(cap, float((toks[:n, c] + prompt).max()))
            for c, (n, cap) in enumerate(zip(ns, caps))]
    return [torch.from_numpy(np.asarray(x, np.float64))
            for x in (arr, toks, fp_cum, caps, b_maxs)]


def _tandem_equal(got, ref):
    """Kernel and plain outputs equal: per lane its first nb batches and
    every per-lane figure."""
    starts, ends, dends, nb, blocked, blocked_t, deferred = \
        (t.cpu() for t in got)
    r_starts, r_ends, r_dends, r_nb, *r_lane = ref
    assert torch.equal(nb, r_nb)
    for x, y in zip((blocked, blocked_t, deferred), r_lane):
        assert torch.equal(x, y)
    for c, k in enumerate(nb.tolist()):
        for x, y in ((starts, r_starts), (ends, r_ends), (dends, r_dends)):
            assert torch.equal(x[:k, c], y[:k, c]), c


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 1000, 2 ** 17 + 3])
def test_tandem_scan_kernel_bit_equal_to_plain(cuda, n):
    """Four lanes: the largest footprint as budget, two fractional
    budgets, one that never binds; caps of none, 8, none and 3."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import (
        tandem_scan, tandem_scan_reference)
    args = _tandem_inputs([n] * 4, [0.0, 1777.25, 4000.25, 1e12],
                          [NO_CAP, 8.0, NO_CAP, 3.0], seed=n % 97)
    lat = (0.05, 0.5, 0.0005, 0.02)
    before = K.LAUNCHES["tandem_scan"]
    got = tandem_scan(*(a.to(cuda) for a in args), *lat)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tandem_scan"] == before + 1
    ref = tandem_scan_reference(*args, *lat)
    _tandem_equal(got, ref)


@pytest.mark.gpu
def test_tandem_scan_largest_footprint_blocks_every_batch(cuda):
    """Every request's footprint is the budget: each batch is one request
    and waits for the last one's release."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import (
        tandem_scan, tandem_scan_reference)
    args = _tandem_inputs([3000, 2000], [0.0, 0.0], [NO_CAP, 4.0], seed=5,
                          prompt=12.0, tok=500.0)
    lat = (0.05, 0.5, 0.0005, 0.02)
    got = tandem_scan(*(a.to(cuda) for a in args), *lat)
    _tandem_equal(got, tandem_scan_reference(*args, *lat))
    starts, _, dends, nb, blocked = (t.cpu() for t in got[:5])
    assert nb.tolist() == [3000, 2000]
    # batch j blocks exactly when its candidate start, the later of its
    # arrival and the last batch's prefill end, precedes the last release
    arr = args[0]
    for c in range(2):
        k = int(nb[c])
        cand = torch.maximum(arr[1:k, c], starts[:k - 1, c] + (
            lat[0] * 1.0 + lat[1]))
        assert int(blocked[c]) == int((cand < dends[:k - 1, c]).sum()) > 0
        assert bool((starts[1:k, c] >= dends[:k - 1, c]).all())


@pytest.mark.gpu
def test_tandem_scan_padded_rows_never_admitted(cuda):
    """Lanes of 1, 37, 1000 and 4099 requests padded to 4099: each lane's
    batches end at its own length and cover it exactly once."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import (
        tandem_scan, tandem_scan_reference)
    ns = [1, 37, 1000, 4099]
    args = _tandem_inputs(ns, [1777.25, 1e12, 2500.5, 4000.25],
                          [NO_CAP, NO_CAP, 16.0, NO_CAP], seed=11,
                          prompt=3.5)
    lat = (0.05, 0.5, 0.0005, 0.02)
    got = tandem_scan(*(a.to(cuda) for a in args), *lat)
    _tandem_equal(got, tandem_scan_reference(*args, *lat))
    ends, nb = got[1].cpu(), got[3].cpu()
    for c, n in enumerate(ns):
        k = int(nb[c])
        e = ends[:k, c]
        assert int(e[-1]) == n and bool((e[1:] > e[:-1]).all())


@pytest.mark.gpu
def test_tandem_scan_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.tandem_scan import tandem_scan
    a = torch.zeros(4, 2, dtype=torch.float64, device=cuda)
    f = torch.zeros(5, 2, dtype=torch.float64, device=cuda)
    v = torch.ones(2, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tandem_scan(a.float(), a, f, v, v, 1, 1, 1, 1)
    with pytest.raises(ValueError):                       # fp_cum not n + 1
        tandem_scan(a, a, a, v, v, 1, 1, 1, 1)
    with pytest.raises(ValueError):                       # mixed devices
        tandem_scan(a, a, f.cpu(), v, v, 1, 1, 1, 1)


def _tandem_stack(lanes, caps, b_maxs, prompt=0.0):
    """Lanes given as (arrivals, tokens) arrays, stacked [L, lanes] with
    +inf arrivals and prefix sums past each lane's requests; each budget
    raised to the lane's largest footprint.  Float64 CPU tensors."""
    L = max(len(a) for a, _ in lanes)
    arr = np.full((L, len(lanes)), np.inf)
    toks = np.zeros((L, len(lanes)))
    fp_cum = np.full((L + 1, len(lanes)), np.inf)
    fp_cum[0] = 0.0
    for c, (a, t) in enumerate(lanes):
        arr[:len(a), c], toks[:len(a), c] = a, t
        fp_cum[1:len(a) + 1, c] = np.cumsum(t + prompt)
    caps = [max(cap, float((t + prompt).max()))
            for cap, (_, t) in zip(caps, lanes)]
    return [torch.from_numpy(np.asarray(x, np.float64))
            for x in (arr, toks, fp_cum, caps, b_maxs)]


def _poisson_lane(n, rate, seed, tok=None, ties=0.05):
    """n arrivals at ``rate`` with runs of ties, and integer tokens."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    gaps[0] = 0.0
    gaps[rng.random(n) < ties] = 0.0
    t = rng.integers(1, 1001, n).astype(float) if tok is None else \
        np.full(n, float(tok))
    return np.cumsum(gaps), t


def _tandem_on_card(cuda, args, lat):
    """One S7 launch on the card against the plain version on the CPU;
    returns the kernel's outputs on the CPU."""
    from repro_torch.kernels.tandem_scan import (
        tandem_scan, tandem_scan_reference)
    before = K.LAUNCHES["tandem_scan"]
    got = tandem_scan(*(a.to(cuda) for a in args), *lat)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tandem_scan"] == before + 1
    n, lanes = args[0].shape
    assert got[0].shape == got[1].shape == got[2].shape == (n, lanes)
    _tandem_equal(got, tandem_scan_reference(*args, *lat))
    return [t.cpu() for t in got]


S7_LAT = (0.05, 0.5, 0.0005, 0.02)
# prefill far faster than decode: the decode backlog, and with it the live
# release ledger, grows with the lane
S7_SLOW_DECODE = (0.001, 0.01, 0.0005, 0.02)


@pytest.mark.gpu
def test_tandem_scan_shape_constants(cuda):
    from repro_torch.kernels.tandem_scan import ops
    assert ops.ring_depth() >= 2 * ops.tile() >= 256
    assert ops.ledger() >= 256
    assert ops.max_requests() >= 2 ** 30 - 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_case", ["1", "tile+1", "3tile-1",
                                    "5rings+3"])
def test_tandem_scan_lane_lengths_about_the_ring(cuda, n_case):
    """One lane of 1 request, of a tile and one, of three tiles but one,
    and of five rings and three; two budgets and two caps as lanes."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import ops
    T, D = ops.tile(), ops.ring_depth()
    n = {"1": 1, "tile+1": T + 1, "3tile-1": 3 * T - 1,
         "5rings+3": 5 * D + 3}[n_case]
    lanes = [_poisson_lane(n, 0.1 * (c + 1), seed=n + c) for c in range(4)]
    args = _tandem_stack(lanes, [1777.25, 4000.25, 1e12, 2000.25],
                         [NO_CAP, NO_CAP, 8.0, 3.0])
    _, ends, _, nb, *_ = _tandem_on_card(cuda, args, S7_LAT)
    for c in range(4):
        assert int(ends[int(nb[c]) - 1, c]) == n


@pytest.mark.gpu
@pytest.mark.parametrize("binding", [False, True])
def test_tandem_scan_live_ledger_past_its_ring(cuda, binding):
    """Decode far slower than prefill, so the batches in decode (the live
    ledger, from the release search's pointer to the batch count) grow
    past the on-chip ledger, over ten rings of it: the release search
    reads them from device memory.  Under a budget of 1.5 ledgers of
    one-token requests the budget binds with the ledger that long, and the
    delayed starts search it too."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import ops
    R = ops.ledger()
    n = 12 * R
    lane = _poisson_lane(n, 2.0, seed=R, tok=1.0 if binding else None)
    cap = 1.5 * R + 0.25 if binding else 1e12
    lat = (0.001, 0.01, 0.5, 0.5) if binding else S7_SLOW_DECODE
    starts, _, dends, nb, blocked, *_ = _tandem_on_card(
        cuda, _tandem_stack([lane], [cap], [NO_CAP]), lat)
    k = int(nb[0])
    assert k >= 10 * R
    # batches still decoding when the last one starts: the live ledger
    live = int((dends[:k, 0] > starts[k - 1, 0]).sum())
    assert live > R
    assert (int(blocked[0]) > 0) == binding


@pytest.mark.gpu
@pytest.mark.parametrize("b_max", [2.0, "none"])
def test_tandem_scan_arrivals_far_ahead_of_the_head(cuda, b_max):
    """Overload: arrivals far faster than a batch.  Under a cap of 2 every
    batch is full; with no cap and a tight budget each batch admits a few
    of a backlog that runs past the ring's window, so the arrival search
    and its members' reads go to device memory."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import ops
    D = ops.ring_depth()
    n = 3 * D
    lane = _poisson_lane(n, 100.0, seed=D)
    cap, bm = (1e12, b_max) if b_max == 2.0 else (3000.25, NO_CAP)
    _, ends, _, nb, _, _, deferred = _tandem_on_card(
        cuda, _tandem_stack([lane], [cap], [bm]), S7_LAT)
    k = int(nb[0])
    sizes = torch.diff(ends[:k, 0], prepend=torch.zeros(1, dtype=torch.int64))
    if b_max == 2.0:
        assert int((sizes == 2).sum()) >= k - 2
    else:
        # the deferred backlog averages more than a ring
        assert int(deferred[0]) > k * D


@pytest.mark.gpu
def test_tandem_scan_law_with_a_negative_prefill_constant(cuda):
    """k2 < 0, so a batch's prefill end can fall before its start and the
    kernel's other instance runs the release search that steps back."""
    from repro_torch.kernels.batch_scan import NO_CAP
    lanes = [_poisson_lane(1500, 1.0, seed=22), _poisson_lane(1500, 5.0,
                                                             seed=23)]
    _tandem_on_card(cuda, _tandem_stack(lanes, [2000.25, 4000.25],
                                        [NO_CAP, 3.0]),
                    (0.05, -0.6, 0.0005, 0.02))


@pytest.mark.gpu
def test_tandem_scan_equal_arrival_times(cuda):
    """Arrivals in runs of ten equal times, and a lane that all arrives at
    once, capped and not."""
    from repro_torch.kernels.batch_scan import NO_CAP
    rng = np.random.default_rng(3)
    n = 3000
    runs = np.repeat(np.arange(n // 10) * 4.0, 10)
    lanes = [(runs, rng.integers(1, 1001, n).astype(float)),
             (np.zeros(n), rng.integers(1, 1001, n).astype(float)),
             (np.zeros(n), rng.integers(1, 1001, n).astype(float))]
    _tandem_on_card(cuda, _tandem_stack(lanes, [2500.5, 1e12, 4000.25],
                                        [NO_CAP, 5.0, NO_CAP]), S7_LAT)


@pytest.mark.gpu
def test_tandem_scan_blocks_every_batch_past_the_ring(cuda):
    """Every footprint is the budget, over two rings and five: each batch
    is one request and waits for the last one's release."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import ops
    n = 2 * ops.ring_depth() + 5
    lanes = [_poisson_lane(n, 0.3, seed=5, tok=500.0),
             _poisson_lane(n, 5.0, seed=6, tok=500.0)]
    args = _tandem_stack(lanes, [0.0, 0.0], [NO_CAP, 4.0], prompt=12.0)
    starts, _, dends, nb, blocked, *_ = _tandem_on_card(cuda, args, S7_LAT)
    assert nb.tolist() == [n, n]
    assert bool((starts[1:n] >= dends[:n - 1]).all())
    assert int(blocked.min()) > 0


@pytest.mark.gpu
def test_tandem_scan_lanes_of_1_to_50000(cuda):
    """Lanes of 1, 2, 37, a tile and one, and 50,000 requests in one
    launch: each ends at its own length."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import ops
    ns = [1, 2, 37, ops.tile() + 1, 50_000]
    lanes = [_poisson_lane(n, 0.1, seed=n) for n in ns]
    _, ends, _, nb, *_ = _tandem_on_card(
        cuda, _tandem_stack(lanes, [4000.25, 1777.25, 1e12, 2000.25,
                                    4000.25],
                            [NO_CAP, 1.0, NO_CAP, 16.0, NO_CAP]), S7_LAT)
    for c, n in enumerate(ns):
        assert int(ends[int(nb[c]) - 1, c]) == n


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 1025, 4096])
def test_tandem_scan_layout_padding_never_read(cuda, n):
    """The layout on the card equals the CPU's; the kernel alone on laid
    inputs whose padding columns hold NaN equals the plain version."""
    from repro_torch.kernels.batch_scan import NO_CAP
    from repro_torch.kernels.tandem_scan import ops, tandem_scan_reference
    lanes = [_poisson_lane(n, 0.2, seed=n + c) for c in range(3)]
    args = _tandem_stack(lanes, [1777.25, 4000.25, 1e12],
                         [NO_CAP, 4.0, NO_CAP])
    laid = ops.layout(*(a.to(cuda) for a in args[:3]))
    for x, y, rows in zip(laid, ops.layout(*args[:3]), (n, n, n + 1)):
        assert x.shape == y.shape == (3, n + 1 + (n + 1) % 2)
        assert torch.equal(x[:, :rows].cpu(), y[:, :rows])
        x[:, rows:] = float("nan")
    out = ops.launch(laid, args[3].to(cuda), args[4].to(cuda), n, *S7_LAT)
    torch.cuda.synchronize()
    got = [x[:, :n].t() for x in out[:3]] + list(out[3:])
    _tandem_equal(got, tandem_scan_reference(*args, *S7_LAT))


@pytest.mark.gpu
def test_tandem_simulators_on_the_card_equal_cpu(cuda):
    """``simulate_policy_fast(memory=)`` (one S7 launch for dynamic
    batching, the oracle for elastic and SRPT) and ``simulate_fleet_fast(
    memory=)`` (S6, then one S7 launch of a lane a replica) on the card
    equal the CPU and the oracle."""
    from repro_torch.core import fastsim, fleet, simulate
    from repro_torch.core.distributions import UniformTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, SRPTPolicy)
    uni = UniformTokens(1000)
    lat = BatchLatencyModel(0.05, 0.5, 0.0005, 0.02)
    for pol, M, launched in ((DynamicPolicy(None), 1777.25, 1),
                             (DynamicPolicy(8), 4000.25, 1),
                             (DynamicPolicy(0), 2000.25, 1),
                             (ElasticPolicy(None), 4000.25, 0),
                             (SRPTPolicy(b_max=8), 1777.25, 0)):
        kw = dict(num_requests=8000, seed=7, memory=M)
        before = K.LAUNCHES["tandem_scan"]
        gpu = fastsim.simulate_policy_fast(pol, 0.1, uni, lat, **kw)
        assert K.LAUNCHES["tandem_scan"] == before + launched
        cpu = fastsim.simulate_policy_fast(pol, 0.1, uni, lat,
                                           device="cpu", **kw)
        ora = simulate.simulate_policy(pol, 0.1, uni, lat, **kw)
        for r in (cpu, ora):
            assert np.array_equal(gpu["waits"], r["waits"]), pol
            assert gpu["memory"] == r["memory"], pol
    for router in ("least_work", "round_robin"):
        kw = dict(num_requests=6000, seed=9, memory=1777.25)
        before = dict(K.LAUNCHES)
        gpu = fastsim.simulate_fleet_fast(router, DynamicPolicy(None), 0.3,
                                          2, uni, lat, **kw)
        # the two replicas: two lanes of one S7 launch
        assert K.LAUNCHES["tandem_scan"] == before.get("tandem_scan", 0) + 1
        assert K.LAUNCHES["backlog_scan"] == \
            before.get("backlog_scan", 0) + (router == "least_work")
        cpu = fastsim.simulate_fleet_fast(router, DynamicPolicy(None), 0.3,
                                          2, uni, lat, device="cpu", **kw)
        ora = fleet.route_oracle(router, DynamicPolicy(None), 0.3, 2, uni,
                                 lat, **kw)
        for r in (cpu, ora):
            assert gpu["memory"] == r["memory"]
            for a, b in zip(gpu["per_replica"], r["per_replica"]):
                assert np.array_equal(a["waits"], b["waits"]), router


# ----------------------------------------------------------------------------
# The dense families at full width, and the closed-loop autoscaler
# ----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma-7b"])
def test_two_layer_dense_model_at_full_width_card_equals_cpu(cuda, arch):
    """Two layers of internlm2-1.8b ((G, D) = (2, 128), untied head) and of
    gemma-7b ((1, 256), GeGLU, scaled embeddings) at full width in fp32:
    the card (K1, K3 and K4 in fp32, decode chunks as graphs, a
    compaction by K2) emits the CPU's greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32",
                              decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=4, max_seq=128, prompt_bucket=16,
                        decode_chunk=8, cache_dtype="float32")
    gpu = Engine(cfg, ecfg, seed=5, device=cuda)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    prompts = _prompts(4, 8, vocab=cfg.vocab_size)
    targets = [13, 3, 9, 2]
    before = dict(K.LAUNCHES)
    rg = gpu.generate(prompts, targets, elastic=True, return_tokens=True)
    rc = cpu.generate(prompts, targets, elastic=True, return_tokens=True)
    assert rg["tokens"] == rc["tokens"]
    assert list(rg["produced"]) == list(rc["produced"]) == targets
    for name in ("ragged_decode_attention", "flash_attention", "fused_rmsnorm",
                 "gather_rows"):
        assert K.LAUNCHES[name] > before.get(name, 0), name


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [{}, {"fixed": (2, "least_work")},
                                  {"clairvoyant": True}])
def test_run_controlled_on_the_card_equals_the_oracle(cuda, mode):
    """The closed loop on the card (one S1 launch a replica a window) on
    the reference test's small cell: the oracle twin's actions, waits
    within 1e-9 s."""
    from repro_torch.core.control import simulate_controlled
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.fastsim import run_controlled
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import ElasticPolicy
    from repro_torch.core.traffic import SinusoidTraffic
    args = (ElasticPolicy(), 4.0, LogNormalTokens(5.0, 0.6),
            BatchLatencyModel(k1=0.05, k2=0.5, k3=0.0005, k4=0.02))
    kw = dict(traffic=SinusoidTraffic(amplitude=0.8, period=250.0),
              num_requests=2_000, seed=1, window=50.0, max_replicas=4,
              replica_cost=1.0, **mode)
    before = K.LAUNCHES["batch_scan"]
    card = run_controlled(*args, **kw)
    assert K.LAUNCHES["batch_scan"] > before
    ora = simulate_controlled(*args, fast=False, **kw)
    assert card.actions == ora.actions
    np.testing.assert_allclose(card.waits, ora.waits, rtol=0, atol=1e-9)
    assert abs(card.objective - ora.objective) <= 1e-9


# ----------------------------------------------------------------------------
# The MoE family: the MoE block on the card, and a small MoE model's decode
# chunk as a graph replay against the eager loop
# ----------------------------------------------------------------------------

def _moe_cfg(**kw):
    """mixtral's pattern at (G, D) = (4, 128): 2 layers, 4 experts, window
    32 below the engines' max_seq (K1 runs on the ring)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    base = dict(num_groups=2, d_model=128, num_heads=8, num_kv_heads=2,
                head_dim=128, moe_d_ff=128, num_experts=4,
                decode_cache_update="scatter")
    base.update(kw)
    return scaled_down(get_config("mixtral-8x7b"), **base)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cf,shared", [((16, 1), 1.25, 0),
                                             ((16, 1), 0.3, 2),
                                             ((4, 64), 1.25, 1),
                                             ((4, 64), 0.3, 0)])
def test_moe_block_card_equals_cpu(cuda, shape, cf, shared, dtype):
    """The MoE block on CUDA tensors, with no host sync, against the same
    block on the CPU: equal drops, outputs within 2e-5 of their scale in
    fp32 and 2e-2 in bf16 (the expert products' sums run in another order
    on each device, over activations of a few hundred)."""
    from repro_torch.models.moe import count_drops, moe_block, moe_specs
    from repro_torch.models.params import init_params, map_tree
    cfg = _moe_cfg(capacity_factor=cf, num_shared_experts=shared)
    gen = torch.Generator().manual_seed(0)
    p = init_params(moe_specs(cfg), gen, torch.float32, "cpu")
    p = map_tree(lambda t: t.to(dtype), p)
    x = _randn(shape + (cfg.d_model,), dtype, "cpu", 1)
    with count_drops() as cpu_log:
        ref, ref_aux = moe_block(p, x, cfg, return_aux=True)
    pc = map_tree(lambda t: t.to(cuda), p)
    xc = x.to(cuda)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with count_drops() as card_log:
            out, aux = moe_block(pc, xc, cfg, return_aux=True)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert [int(n) for _, n in card_log] == [int(n) for _, n in cpu_log]
    if cf < 1:                  # capacity below the tokens' mean load
        assert int(cpu_log[0][1]) > 0
    scale = max(float(ref.float().abs().max()), 1.0)
    band = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), rtol=0,
                               atol=band * scale)
    torch.testing.assert_close(aux.cpu(), ref_aux, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_moe_decode_chunk_graph_replay_equals_eager_loop_with_drops(cuda):
    """A 2-layer fp32 MoE model at (G, D) = (4, 128) with capacity factor
    0.5 (an expert takes at most 8 of bucket 16's tokens): one decode
    chunk as a graph replay and through the eager loop from the same
    state, past the 32-slot window ring, gives equal tokens, carry and
    caches; the eager loop drops assignments in its decode steps."""
    from repro_torch.models.moe import count_drops
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import Engine, EngineConfig
    cfg = _moe_cfg(capacity_factor=0.5)
    eng = Engine(cfg, EngineConfig(max_batch=16, max_seq=128,
                                   prompt_bucket=16, decode_chunk=8),
                 seed=3, device=cuda)
    assert eng.new_cache(16)["pos0"]["k"].shape[2] == 32      # the ring
    cache, kv, last, b, _ = eng.prefill_batch(_prompts(16, 0))
    tok = last.argmax(-1).to(torch.int32)
    prod = torch.ones(b, dtype=torch.int32, device=cuda)
    targ = torch.full((b,), 100, dtype=torch.int32, device=cuda)
    steps = 16
    out = eng.decode_chunk(cache, kv, tok, prod, targ, steps)
    assert eng.step_log[-1]["graph"] == "capture"
    _, tok, kv, prod = out[:4]
    cache_e = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    state = [t.clone() for t in (tok, kv, prod)]
    keys = torch.zeros((b, 2), dtype=torch.int64, device=cuda)
    out, d_graph = _launch_delta(lambda: eng.decode_chunk(
        cache, kv, tok, prod, targ, steps))
    assert eng.step_log[-1]["graph"] == "replay"
    with count_drops() as log:
        (t_e, kv_e, prod_e, _, packed), d_eager = _launch_delta(
            lambda: eng._chunk_eager(cache_e, *state, targ, keys, steps,
                                     0.0, None))
    assert sum(int(n) for s, n in log if s == 1) > 0, "no decode drop"
    assert int(kv_e.max()) > 32                      # past the window
    host = packed.cpu().numpy()
    n = steps * b
    np.testing.assert_array_equal(out[5], host[:n].reshape(steps, b))
    for a, e in zip(out[1:4], (t_e, kv_e, prod_e)):
        assert torch.equal(a, e)
    for a, e in zip(tree_leaves(cache), tree_leaves(cache_e)):
        assert torch.equal(a, e)
    assert d_graph == d_eager
    assert d_graph["ragged_decode_attention"] == steps * 2
    assert d_graph["fused_rmsnorm"] == steps * (2 * 2 + 1)


# ----------------------------------------------------------------------------
# The SSD chunk-state scan (S8) and the state-space families
# ----------------------------------------------------------------------------

def _ssd_scan_inputs(b, c, h, p, n, dev, seed):
    rng = np.random.default_rng(seed)
    decay = torch.from_numpy(
        np.exp(-rng.random((b, c, h)) * 4).astype(np.float32)).to(dev)
    states = torch.from_numpy(
        rng.standard_normal((b, c, h, p, n)).astype(np.float32)).to(dev)
    h0 = torch.from_numpy(
        rng.standard_normal((b, h, p, n)).astype(np.float32)).to(dev)
    return decay, states, h0


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("c", [1, 3, 8])
def test_ssd_scan_kernel_bit_equal_to_plain(cuda, c, with_h0):
    """mamba2-2.7b's 80 heads of 64 x 128 at two batch rows, and an odd
    shape whose state count is no multiple of the thread block."""
    from repro_torch.kernels.ssd_scan import (
        ssd_state_scan, ssd_state_scan_reference)
    for shape in ((2, c, 80, 64, 128), (3, c, 5, 7, 9)):
        decay, states, h0 = _ssd_scan_inputs(*shape, cuda, seed=c)
        h0 = h0 if with_h0 else None
        before = K.LAUNCHES["ssd_scan"]
        hb, ht = ssd_state_scan(decay, states, h0)
        torch.cuda.synchronize()
        assert K.LAUNCHES["ssd_scan"] == before + 1
        rb, rt = ssd_state_scan_reference(decay, states, h0)
        assert hb.shape == states.shape and ht.shape == states[:, 0].shape
        assert torch.equal(hb, rb) and torch.equal(ht, rt)


@pytest.mark.gpu
def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_state_scan
    decay, states, h0 = _ssd_scan_inputs(2, 3, 4, 5, 6, cuda, seed=0)
    before = dict(K.LAUNCHES)
    with pytest.raises(TypeError, match="fp32"):
        ssd_state_scan(decay.double(), states.double())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_state_scan(decay, states.transpose(3, 4))
    with pytest.raises(ValueError, match="devices"):
        ssd_state_scan(decay, states, h0.cpu())
    assert dict(K.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_ssm_smoke_engines_card_equal_cpu(cuda, arch):
    """mamba2's smoke config and jamba's pattern at (G, D) = (4, 128) (the
    attention kernels' built instance), fp32, elastic, decode chunks as
    graphs (a capture, then replays on a second batch), compacting the
    conv and SSM leaves: the card's greedy tokens equal the CPU's, and the
    prefills ran S8."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.config import scaled_down
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    if arch.startswith("jamba"):
        cfg = scaled_down(get_config(arch), d_model=128, num_heads=8,
                          num_kv_heads=2, head_dim=128, d_ff=256,
                          moe_d_ff=128, num_experts=4, ssm_n_groups=2,
                          decode_cache_update="scatter")
    else:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=8, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    gpu = Engine(cfg, ecfg, seed=3, device=cuda)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    targets = [20, 3, 9, 14, 2, 30]
    for seed in (1, 2):
        prompts = _prompts(6, seed, vocab=cfg.vocab_size)
        (rg, d), rc = _launch_delta(lambda: gpu.generate(
            prompts, targets, elastic=True, return_tokens=True)), \
            cpu.generate(prompts, targets, elastic=True, return_tokens=True)
        assert rg["tokens"] == rc["tokens"]
        assert list(rg["produced"]) == targets
        assert d["ssd_scan"] == cfg.num_layers - (cfg.num_layers // 8
                                                   if arch.startswith("jamba")
                                                   else 0)
        assert d["gather_rows"] > 0 and d["fused_rmsnorm"] > 0


# ----------------------------------------------------------------------------
# The last two families (M8c): llama-3.2-vision-90b's cross-attention, the
# audio family's (1, 64) heads and the head-major cache layout
# ----------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_at_the_cross_attention_shape(cuda, dtype):
    """K1 over a vision cross-attention position's image K/V: 64 / 8 heads
    of 128, B = 16, S = vision_seq = 6,400, every length 6,400; also a
    smaller B, and two calls bit-equal."""
    for b in (16, 3):
        q = _randn((b, 64, 128), dtype, cuda, 0)
        kc = _randn((b, 6400, 8, 128), dtype, cuda, 1)
        vc = _randn((b, 6400, 8, 128), dtype, cuda, 2)
        ln = torch.full((b,), 6400, dtype=torch.int32, device=cuda)
        out = ragged_decode_attention(q, kc, vc, ln)
        torch.testing.assert_close(
            out.float(), decode_attention_reference(q, kc, vc, ln).float(),
            **TOL[dtype])
        assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out)


def _set_gates(cfg, params):
    """Every ``attn_gate`` and ``ffn_gate`` of a cross-attention model to a
    value in [0.5, 1.5] (they init to 0, and tanh(0) = 0)."""
    for i, (mixer, _) in enumerate(cfg.group_pattern):
        if mixer == "cross_attn":
            pos = params["groups"][f"pos{i}"]
            pos["mixer"]["attn_gate"].fill_(0.8 + 0.1 * i)
            pos["ffn_gate"].fill_(1.2 - 0.1 * i)


def _vlm_stream(engine, toks, lens, image, targets, steps=8):
    """A vision model's path through the engine: ``prefill(cross_kv=)`` into
    the engine's own cache of the bucket, decode chunks (graphs on the
    card), one fused compaction to the live slots, more chunks.  Returns
    the greedy tokens each slot emitted."""
    from repro_torch.models.model import prefill
    b = toks.shape[0]
    dev = engine.device
    cache = engine.new_cache(b)
    last, cache = prefill(engine.cfg, engine.params,
                          torch.from_numpy(toks).to(dev),
                          cross_kv=torch.from_numpy(image).to(dev),
                          cache=cache, prompt_lens=torch.from_numpy(lens).to(dev))
    tok = torch.argmax(last, -1).to(torch.int32)
    out = [[int(t)] for t in tok.cpu()]
    kv = torch.from_numpy(lens).to(dev)
    produced = torch.ones(b, dtype=torch.int32, device=dev)
    tg = torch.tensor(targets, dtype=torch.int32, device=dev)
    live = list(range(b))
    while True:
        (cache, tok, kv, produced, _, toks_np, active, _, _) = \
            engine.decode_chunk(cache, kv, tok, produced, tg, steps)
        for j, slot in enumerate(live):
            out[slot] += toks_np[active[:, j], j].tolist()
        still = [slot for slot in live if len(out[slot]) < targets[slot]]
        if not still:
            return out
        if len(still) <= len(live) // 2:
            cache, kv, tok, nb, _ = engine.compact_fused(
                cache, kv, tok, produced, tg, len(still))
            # the live slots first, in slot order; padding slots owe nothing
            n = len(still)
            produced = torch.zeros(nb, dtype=torch.int32, device=dev)
            tg = torch.zeros(nb, dtype=torch.int32, device=dev)
            produced[:n] = torch.tensor([len(out[s]) for s in still],
                                        dtype=torch.int32, device=dev)
            tg[:n] = torch.tensor([targets[s] for s in still],
                                  dtype=torch.int32, device=dev)
            live = still


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["vlm", "audio", "bhsd"])
def test_m8c_small_models_card_equal_cpu(cuda, family):
    """Small fp32 models of the last two families and the bhsd layout, card
    (K1-K4, decode chunks as graphs) against CPU, greedy, token for token:
    llama-3.2-vision-90b's pattern at (G, D) = (4, 128) with vision_seq 64
    and non-zero gates (through ``prefill(cross_kv=)``, decode chunks and
    a compaction of the image K/V); musicgen-large's at (1, 64), two
    layers, through the engine; qwen's at (8, 128) with head-major caches
    (decode reads them with the plain version on both devices, as the
    reference does)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    if family == "vlm":
        cfg = scaled_down(get_config("llama-3.2-vision-90b"), d_model=128,
                          num_heads=8, num_kv_heads=2, head_dim=128, d_ff=256,
                          vision_seq=64, decode_cache_update="scatter")
    elif family == "audio":
        cfg = scaled_down(get_config("musicgen-large"), num_groups=2,
                          d_model=256, num_heads=4, num_kv_heads=4,
                          head_dim=64, d_ff=512, vocab_size=256,
                          decode_cache_update="scatter")
    else:
        cfg = scaled_down(get_config("qwen2.5-3b"), num_groups=2, d_model=128,
                          num_heads=16, num_kv_heads=2, head_dim=128,
                          d_ff=256, cache_layout="bhsd",
                          decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=8, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    gpu = Engine(cfg, ecfg, seed=3, device=cuda)
    _set_gates(cfg, gpu.params)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    targets = [20, 3, 9, 14, 2, 30, 5, 11]
    for seed in (1, 2):
        if family == "vlm":
            rng = np.random.default_rng(seed)
            toks = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
            lens = rng.integers(1, 17, 8).astype(np.int32)
            image = rng.standard_normal((8, cfg.vision_seq, cfg.d_model),
                                        np.float32)
            tg, d = _launch_delta(lambda: _vlm_stream(gpu, toks, lens, image,
                                                      targets))
            tc = _vlm_stream(cpu, toks, lens, image, targets)
        else:
            prompts = _prompts(6, seed, vocab=cfg.vocab_size)
            (rg, d), rc = _launch_delta(lambda: gpu.generate(
                prompts, targets[:6], elastic=True, return_tokens=True)), \
                cpu.generate(prompts, targets[:6], elastic=True,
                             return_tokens=True)
            tg, tc = rg["tokens"], rc["tokens"]
        assert tg == tc
        assert [len(t) for t in tg] == targets[:len(tg)]
        assert d["flash_attention"] > 0 and d["fused_rmsnorm"] > 0
        assert d["gather_rows"] > 0
        # bhsd decode reads the cache with the plain version
        assert (d.get("ragged_decode_attention", 0) > 0) == (family != "bhsd")


# ----------------------------------------------------------------------------
# The backward kernels of K3 and K4 (training), against the plain versions
# under autograd.  Each gradient's largest |kernel - plain| is held to a
# fraction of the plain gradient's max-abs: 1e-4 in fp32 (sums over up to
# S positions in another order), 2e-2 in bf16 (the kernel rounds each
# gradient once to bf16 and forms rowsum(dO * O) from the forward kernel's
# bf16 O; the plain autograd from its fp32 O)
# ----------------------------------------------------------------------------

GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_PAIRS = [(8, 128), (2, 128), (1, 256), (4, 128), (1, 128), (1, 64)]
BWD_SHAPES = [(2, 80, None), (1, 300, 64), (3, 65, 16), (1, 1, None)]


def _assert_grads_close(got, ref, dtype):
    """Each gradient within the tolerance of its own max-abs, or of 1% of
    the largest of the grads when its own is smaller: at S = 1 the
    softmax over one key has no gradient, and dq and dk are the rounding
    of P * (dP - rowsum(dO * O)), about 1e-7 of dv on either side."""
    floor = max(float(c.float().abs().max()) for c in ref)
    for a, c in zip(got, ref):
        assert a.dtype == c.dtype and a.shape == c.shape
        scale = max(float(c.float().abs().max()), 1e-2 * floor)
        gap = float((a.float() - c.float()).abs().max())
        assert gap <= GRAD_TOL[dtype] * scale, (gap, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,win", BWD_SHAPES)
@pytest.mark.parametrize("g,d", BWD_PAIRS)
def test_flash_backward_matches_plain(cuda, g, d, b, s, win, dtype):
    """dq, dk, dv of K3 (one backward launch) against the plain version's
    autograd grads at every (G, D) the kernels are built for."""
    q = _randn((b, s, 2 * g, d), dtype, cuda, 0).requires_grad_()
    k = _randn((b, s, 2, d), dtype, cuda, 1).requires_grad_()
    v = _randn((b, s, 2, d), dtype, cuda, 2).requires_grad_()
    do = _randn((b, s, 2 * g, d), dtype, cuda, 3)
    before = K.LAUNCHES["flash_attention_bwd"]
    got = torch.autograd.grad(flash_attention(q, k, v, window=win),
                              (q, k, v), do)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention_bwd"] == before + 1
    ref = torch.autograd.grad(attention_reference(q, k, v, window=win),
                              (q, k, v), do)
    _assert_grads_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_non_causal_and_strided_views(cuda, dtype):
    """q, k and v as views of one fused projection (the grad lands in the
    projection), and non-causal attention with and without a window."""
    qkv = _randn((2, 150, 20, 128), dtype, cuda, 4).requires_grad_()
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:18], qkv[:, :, 18:]
    do = _randn((2, 150, 16, 128), dtype, cuda, 5)
    for causal, win in ((True, None), (True, 32), (False, None), (False, 7)):
        got = torch.autograd.grad(
            flash_attention(q, k, v, causal=causal, window=win), qkv, do)
        ref = torch.autograd.grad(
            attention_reference(q, k, v, causal=causal, window=win), qkv, do)
        _assert_grads_close(got, ref, dtype)


@pytest.mark.gpu
def test_flash_backward_is_deterministic_and_only_under_grad(cuda):
    """No atomics: two backward passes are bit-equal; without autograd
    (or with no input that needs a grad) the forward kernel runs alone."""
    q = _randn((2, 333, 16, 128), torch.bfloat16, cuda, 0).requires_grad_()
    k = _randn((2, 333, 2, 128), torch.bfloat16, cuda, 1).requires_grad_()
    do = _randn((2, 333, 16, 128), torch.bfloat16, cuda, 2)
    g1 = torch.autograd.grad(flash_attention(q, k, k), (q, k), do)
    g2 = torch.autograd.grad(flash_attention(q, k, k), (q, k), do)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with torch.no_grad():
        out = flash_attention(q, k, k)
    assert not out.requires_grad
    assert not flash_attention(q.detach(), k.detach(), k.detach()).requires_grad


@pytest.mark.gpu
def test_flash_backward_rejects_what_it_does_not_take(cuda):
    """Shapes outside the built (G, D) raise before any launch, forward or
    backward; a bad upstream grad raises in the backward."""
    from repro_torch.kernels.flash_attention import ops
    before = dict(K.LAUNCHES)
    q = _randn((1, 32, 6, 128), torch.float32, cuda, 0).requires_grad_()
    k = _randn((1, 32, 2, 128), torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="built for"):    # G = 3
        flash_attention(q, k, k)
    q = _randn((1, 32, 16, 128), torch.float32, cuda, 0)
    lse = ops.lse_buffer(1, 32, 2, 8, cuda)
    out = ops._launch(q, k, k, True, None, lse)
    with pytest.raises(ValueError, match="shape"):
        ops._launch_bwd(q, k, k, out, out[:, :16], lse, True, None)
    with pytest.raises(ValueError, match="built for"):
        ops._launch_bwd(q[:, :, :6], k, k, out[:, :, :6], out[:, :, :6],
                        lse, True, None)
    with pytest.raises(ValueError, match="lse"):            # not the buffer
        ops._launch_bwd(q, k, k, out, out, lse[:, :, :32], True, None)
    assert K.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"]


# the bf16 backward splits a 64-key tile's query tiles over 1, 2 or 4
# blocks of a cluster (``ops._dkv_splits``); these shapes give each count
# on a 132-SM card: (B, S, window)
SPLIT_SHAPES = [(1, 1000, None), (2, 640, 100), (1, 129, None)]


def _flash_lse(q, k, v, causal=True, window=None):
    """The forward kernel with and without its log-sum-exp output: (out,
    out without lse, lse as [B, Hq, S])."""
    from repro_torch.kernels.flash_attention import ops
    b, s, hq, _ = q.shape
    hkv = k.shape[2]
    buf = ops.lse_buffer(b, s, hkv, hq // hkv, q.device)
    out = ops._launch(q, k, v, causal, window, buf)
    return out, ops._launch(q, k, v, causal, window), ops.lse_as_bhs(buf, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,win,causal", [(2, 80, None, True),
                                            (1, 300, 64, True),
                                            (3, 65, None, False),
                                            (16, 256, None, True)])
@pytest.mark.parametrize("g,d", BWD_PAIRS)
def test_flash_forward_lse_bit_equal_and_matches_plain(cuda, g, d, b, s, win,
                                                       causal, dtype):
    """The forward writes each row's log-sum-exp only when asked, and its
    output is bit-equal with and without it; the lse within 1e-4 of the
    plain version's (natural base, fp32 over the scaled, masked scores)."""
    from repro_torch.kernels.flash_attention import attention_lse_reference
    q = _randn((b, s, 2 * g, d), dtype, cuda, 0)
    k = _randn((b, s, 2, d), dtype, cuda, 1)
    v = _randn((b, s, 2, d), dtype, cuda, 2)
    out, plain_out, lse = _flash_lse(q, k, v, causal, win)
    assert torch.equal(out, plain_out)
    ref_out, ref_lse = attention_lse_reference(q, k, v, causal=causal,
                                               window=win)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,win", BWD_SHAPES[:3] + SPLIT_SHAPES)
@pytest.mark.parametrize("g,d", BWD_PAIRS)
def test_flash_backward_matches_bwd_reference(cuda, g, d, b, s, win, dtype):
    """dq, dk, dv of the backward kernels against ``attention_bwd_reference``
    on the same out, dout and log-sum-exp (the forward kernel's)."""
    from repro_torch.kernels.flash_attention import (
        attention_bwd_reference, ops)
    q = _randn((b, s, 2 * g, d), dtype, cuda, 5)
    k = _randn((b, s, 2, d), dtype, cuda, 6)
    v = _randn((b, s, 2, d), dtype, cuda, 7)
    do = _randn((b, s, 2 * g, d), dtype, cuda, 8)
    buf = ops.lse_buffer(b, s, 2, g, cuda)
    out = ops._launch(q, k, v, True, win, buf)
    got = ops._launch_bwd(q, k, v, out, do, buf, True, win)
    ref = attention_bwd_reference(q, k, v, out, do, ops.lse_as_bhs(buf, s),
                                  window=win)
    _assert_grads_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("g,d", BWD_PAIRS)
def test_flash_backward_every_split_count_and_deterministic(cuda, monkeypatch,
                                                            g, d):
    """The bf16 dk/dv kernel at 1, 2 and 4 blocks a key tile: each within
    the band of the plain grads, two passes at each bit-equal (the cluster
    sums its partials in rank order), and dq the same at every count."""
    from repro_torch.kernels.flash_attention import ops
    q = _randn((2, 333, 2 * g, d), torch.bfloat16, cuda, 0).requires_grad_()
    k = _randn((2, 333, 2, d), torch.bfloat16, cuda, 1).requires_grad_()
    v = _randn((2, 333, 2, d), torch.bfloat16, cuda, 2).requires_grad_()
    do = _randn((2, 333, 2 * g, d), torch.bfloat16, cuda, 3)
    ref = torch.autograd.grad(attention_reference(q, k, v, window=100),
                              (q, k, v), do)
    dqs = []
    for n in (1, 2, 4):
        monkeypatch.setattr(ops, "_dkv_splits", lambda *a, n=n: n)
        g1 = torch.autograd.grad(flash_attention(q, k, v, window=100),
                                 (q, k, v), do)
        g2 = torch.autograd.grad(flash_attention(q, k, v, window=100),
                                 (q, k, v), do)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2)), n
        _assert_grads_close(g1, ref, torch.bfloat16)
        dqs.append(g1[0])
    assert all(torch.equal(dqs[0], x) for x in dqs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", BWD_PAIRS)
def test_flash_backward_strided_views_every_pair(cuda, g, d, dtype):
    """q, k and v as views of one fused projection at every (G, D): the
    tensor maps read them through their strides; the grad lands in the
    projection."""
    hq = 2 * g
    qkv = _randn((2, 97, hq + 4, d), dtype, cuda, 4).requires_grad_()
    q, k, v = qkv.split((hq, 2, 2), dim=2)
    do = _randn((2, 97, hq, d), dtype, cuda, 5)
    for win in (None, 17):
        got = torch.autograd.grad(flash_attention(q, k, v, window=win), qkv, do)
        ref = torch.autograd.grad(attention_reference(q, k, v, window=win),
                                  qkv, do)
        _assert_grads_close(got, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("round_sum", [False, True])
@pytest.mark.parametrize("pair", [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)],
                         ids=["fp32", "bf16", "bf16-fp32w"])
@pytest.mark.parametrize("rows,d", [(2048, 2048), (4096, 2048), (5, 12288),
                                    (300, 8192), (1, 8)])
def test_rmsnorm_backward_matches_bwd_reference_and_is_deterministic(
        cuda, rows, d, pair, round_sum):
    """dx and dweight of the backward kernels (the rows kernel, one
    partial row of dweight a block, then the column sums of every partial
    row spread over ceil(D / 16) blocks) against ``rmsnorm_bwd_reference``,
    and two passes bit-equal."""
    from repro_torch.kernels.rmsnorm import ops, rmsnorm_bwd_reference
    xdt, wdt = pair
    if xdt == torch.float32 and d == 12288:
        d = 8192                                 # the widest fp32 row
    if xdt == torch.float32 and d == 8:
        d = 4
    x = _randn((rows, d), xdt, cuda, 0) * 3
    r = _randn((rows, d), xdt, cuda, 1)
    w = _randn((d,), wdt, cuda, 2) * 0.1
    ds, dn = _randn((rows, d), xdt, cuda, 3), _randn((rows, d), xdt, cuda, 4)
    got = ops._launch_bwd(x, r, w, ds, dn, 1e-6, round_sum)
    again = ops._launch_bwd(x, r, w, ds, dn, 1e-6, round_sum)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = rmsnorm_bwd_reference(x, r, w, ds, dn, 1e-6, round_sum)
    assert got[0].dtype == xdt and got[1].dtype == wdt
    _assert_grads_close(got, ref, xdt)


@pytest.mark.gpu
@pytest.mark.parametrize("round_sum", [False, True])
@pytest.mark.parametrize("pair", [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)],
                         ids=["fp32", "bf16", "bf16-fp32w"])
@pytest.mark.parametrize("d", [8, 2048, 2056, 8192])
@pytest.mark.parametrize("rows", [1, 3, 16, 600, 4096, (2, 37)])
def test_rmsnorm_backward_matches_plain(cuda, rows, d, pair, round_sum):
    """dx, dresidual and dweight of K4 (one backward launch) against the
    plain version's autograd grads, from both outputs' grads, for each
    pair of row and weight dtypes the kernels take."""
    xdt, wdt = pair
    if xdt == torch.float32 and d == 8:
        d = 4                                    # one fp32 vector
    shape = (rows if isinstance(rows, tuple) else (rows,)) + (d,)
    x = (_randn(shape, xdt, cuda, 0) * 3).requires_grad_()
    r = _randn(shape, xdt, cuda, 1).requires_grad_()
    w = (_randn((d,), wdt, cuda, 2) * 0.1).requires_grad_()
    ds, dn = _randn(shape, xdt, cuda, 3), _randn(shape, xdt, cuda, 4)
    before = K.LAUNCHES["fused_rmsnorm_bwd"]
    got = torch.autograd.grad(
        fused_rmsnorm(x, r, w, eps=1e-6, round_sum=round_sum), (x, r, w),
        (ds, dn))
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused_rmsnorm_bwd"] == before + 1
    ref = torch.autograd.grad(rmsnorm_reference(x, r, w, 1e-6, round_sum),
                              (x, r, w), (ds, dn))
    _assert_grads_close(got, ref, xdt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_strided_deterministic_and_one_output(cuda, dtype):
    """Non-contiguous rows, a grad that reaches only one output, and two
    backward passes bit-equal (dweight sums its block partials in order)."""
    wide = _randn((64, 2 * 2048), dtype, cuda, 0)
    x = wide[:, ::2].requires_grad_()
    r = _randn((64, 2048), dtype, cuda, 1).requires_grad_()
    w = (_randn((2048,), dtype, cuda, 2) * 0.1).requires_grad_()
    dn = _randn((64, 2048), dtype, cuda, 3)
    got = torch.autograd.grad(fused_rmsnorm(x, r, w)[1], (x, r, w), dn)
    again = torch.autograd.grad(fused_rmsnorm(x, r, w)[1], (x, r, w), dn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = torch.autograd.grad(rmsnorm_reference(x, r, w)[1], (x, r, w), dn)
    _assert_grads_close(got, ref, dtype)


@pytest.mark.gpu
def test_rmsnorm_backward_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.rmsnorm import ops
    x = _randn((4, 12288), torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="backward kernel takes"):
        ops._launch_bwd(x, x, x[0], x, x, 1e-6, False)   # fp32 beyond 8192
    xb = _randn((4, 2048), torch.float32, cuda, 0)
    with pytest.raises(TypeError):                       # bf16 w, fp32 rows
        ops._launch_bwd(xb, xb, xb[0].bfloat16(), xb, xb, 1e-6, False)


# S8b's shapes (B, C, H, P, N): mamba2-2.7b's training shape (2 x 2,048
# tokens, chunks of 256), one chunk of it, an odd state of 63 elements
# (fewer than the block's threads) and the smoke configs' 32 x 16
SSD_BWD_SHAPES = [(2, 8, 80, 64, 128), (1, 1, 3, 64, 128), (3, 3, 5, 7, 9),
                  (2, 5, 4, 32, 16)]


def _g_decay_bound(g_states, h_before):
    """The error bound of two fp32 sums of the same n = P*N rounded
    products G * h_before, in any orders: 2 gamma_(n-1) sum |G * h|, with
    gamma_k = k u / (1 - k u) and u = 2^-24."""
    n = g_states.shape[-1] * g_states.shape[-2]
    gamma = (n - 1) * 2.0 ** -24 / (1 - (n - 1) * 2.0 ** -24)
    return 2 * gamma * (g_states * h_before).double().abs().sum((-2, -1))


@pytest.mark.gpu
@pytest.mark.parametrize("with_ght", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES,
                         ids=lambda s: "-".join(map(str, s)))
def test_ssd_scan_bwd_kernel_equals_plain(cuda, shape, with_h0, with_ght):
    """S8b against its plain version on the same inputs: g_states and
    g_h0 bit for bit, g_decay within the fp32 summation bound over P*N
    terms (``_g_decay_bound``); two launches give the same bits."""
    from repro_torch.kernels.ssd_scan import (
        ssd_state_scan_bwd_reference, ssd_state_scan_reference)
    from repro_torch.kernels.ssd_scan import ops
    decay, states, h0 = _ssd_scan_inputs(*shape, cuda, seed=sum(shape))
    g_hb, g_ht = (_randn(t.shape, torch.float32, cuda, 5 + i)
                  for i, t in enumerate((states, h0)))
    g_ht = g_ht if with_ght else None
    hb, _ = ssd_state_scan_reference(decay, states, h0 if with_h0 else None)
    before = K.LAUNCHES["ssd_scan_bwd"]
    gd, gs, g0 = ops._launch_bwd(decay, hb, g_hb, g_ht, with_h0)
    again = ops._launch_bwd(decay, hb, g_hb, g_ht, with_h0)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ssd_scan_bwd"] == before + 2
    rd, rs, r0 = ssd_state_scan_bwd_reference(decay, hb, g_hb, g_ht, with_h0)
    assert gd.shape == decay.shape and gs.shape == states.shape
    assert torch.equal(gs, rs)
    assert (g0 is None) == (r0 is None) == (not with_h0)
    if with_h0:
        assert torch.equal(g0, r0)
    gap = (gd.double() - rd.double()).abs()
    assert bool((gap <= _g_decay_bound(rs, hb)).all()), float(gap.max())
    for a, b in zip((gd, gs, g0), again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
def test_ssd_scan_bwd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ops
    decay, states, h0 = _ssd_scan_inputs(2, 3, 4, 5, 6, cuda, seed=0)
    with pytest.raises(ValueError, match="g_h_before"):
        ops._launch_bwd(decay, states, states.transpose(3, 4), None, False)
    with pytest.raises(ValueError, match="devices"):
        ops._launch_bwd(decay, states, states, h0.cpu(), False)
    big = torch.zeros(1, 1, 1, 64, 129, device=cuda)
    with pytest.raises(ValueError, match="at most 8192"):
        ops._launch_bwd(torch.ones(1, 1, 1, device=cuda), big, big, None,
                        False)


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_under_grad_launches_s8_and_s8b(cuda, monkeypatch, with_h0):
    """A CUDA call under autograd launches S8, its backward S8b, and the
    plain versions never run (they raise here); without grad it launches
    S8 alone.  The gradients equal the plain backward's on the forward's
    h_before (g_states and g_h0 bit for bit)."""
    from repro_torch.kernels.ssd_scan import (
        ssd_state_scan, ssd_state_scan_bwd_reference)
    from repro_torch.kernels.ssd_scan import ops

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(ops, "ssd_state_scan_reference", refuse)
    monkeypatch.setattr(ops, "ssd_state_scan_bwd_reference", refuse)
    decay, states, h0 = _ssd_scan_inputs(2, 4, 80, 64, 128, cuda, seed=3)
    leaves = [decay.requires_grad_(), states.requires_grad_()] + (
        [h0.requires_grad_()] if with_h0 else [])
    g_hb = _randn(states.shape, torch.float32, cuda, 8)
    K.reset_launches()
    hb, ht = ssd_state_scan(decay, states, h0 if with_h0 else None)
    assert K.LAUNCHES["ssd_scan"] == 1 and ht.requires_grad
    grads = torch.autograd.grad((hb * g_hb).sum(), leaves)
    torch.cuda.synchronize()
    assert K.LAUNCHES["ssd_scan"] == 1 and K.LAUNCHES["ssd_scan_bwd"] == 1
    rd, rs, r0 = ssd_state_scan_bwd_reference(
        decay.detach(), hb.detach(), g_hb, None, with_h0)
    assert torch.equal(grads[1], rs)
    if with_h0:
        assert torch.equal(grads[2], r0)
    gap = (grads[0].double() - rd.double()).abs()
    assert bool((gap <= _g_decay_bound(rs, hb.detach())).all())
    with torch.no_grad():
        ssd_state_scan(decay, states)
    assert K.LAUNCHES["ssd_scan"] == 2 and K.LAUNCHES["ssd_scan_bwd"] == 1


@pytest.mark.gpu
def test_mamba2_smoke_grads_on_cuda_agree_with_the_cpu(cuda):
    """mamba2's smoke config, 4 x 64 tokens (two chunks of 32): the loss
    and every parameter's gradient on the card (S8, S8b, K4, K4b) against
    the CPU's plain versions from the same params and batch, at chip_smoke
    phase 9t(a)'s tolerances (loss 2e-5 relative; grads 2e-3 of a leaf's
    max-abs, the two devices summing in other orders)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_params, map_tree, tree_leaves
    from repro_torch.training.train_step import TrainConfig, make_grad_fn
    cfg = get_smoke_config("mamba2-2.7b")
    params = init_params(param_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    batch = SyntheticLMDataset(cfg, 64, 4, seed=0).batch(0)
    grad_fn = make_grad_fn(cfg, TrainConfig())
    out = {}
    for dev in (cuda, torch.device("cpu")):
        K.reset_launches()
        g, aux = grad_fn(map_tree(lambda t: t.to(dev, copy=True), params),
                         {k: torch.from_numpy(v).to(dev)
                          for k, v in batch.items()})
        out[dev.type] = ([t.cpu() for t in tree_leaves(g)],
                         float(aux["ce"]), dict(K.LAUNCHES))
    launches = out["cuda"][2]
    assert launches["ssd_scan"] == launches["ssd_scan_bwd"] == \
        cfg.num_layers, launches
    assert launches["fused_rmsnorm"] > 0 and \
        launches["fused_rmsnorm_bwd"] > 0, launches
    assert not any(out["cpu"][2].values())
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 2e-5 * abs(out["cpu"][1])
    gaps = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(out["cuda"][0], out["cpu"][0])]
    assert max(gaps) <= 2e-3, gaps
