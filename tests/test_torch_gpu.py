"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports no JAX, so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in fp32; in bf16 4e-3 plus 8e-3 relative, one bf16 ulp
of the output (both sides compute in fp32 and differ only in the final
rounding); the gather, the fused norm's residual sum, the simulators'
float64 scans and batch-event loops (S1-S5) and the fleet's routing scan
(S6) are bit-equal."""

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
                                          (16, 2048, 16, 2, 128)])
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
    with pytest.raises(ValueError, match="built for"):    # D = 64
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
    with pytest.raises(ValueError, match="built for"):    # D = 64
        flash_attention(q64, k64, k64)
    q16 = _randn((1, 32, 16, 128), torch.float32, cuda, 0)
    with pytest.raises(TypeError):                        # mixed dtypes
        flash_attention(q16.bfloat16(), k, k)
    with pytest.raises(ValueError):                       # CPU + CUDA
        flash_attention(q16, k, k.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 16, 4096, (4, 37)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, dtype):
    shape = (rows if isinstance(rows, tuple) else (rows,)) + (2048,)
    x = _randn(shape, dtype, cuda, 0) * 3
    r = _randn(shape, dtype, cuda, 1)
    w = _randn((2048,), dtype, cuda, 2) * 0.1
    before = K.LAUNCHES["fused_rmsnorm"]
    s, n = fused_rmsnorm(x, r, w, eps=1e-6)
    assert K.LAUNCHES["fused_rmsnorm"] == before + 1
    assert s.dtype == n.dtype == dtype and s.shape == n.shape == x.shape
    assert torch.equal(s, x + r)
    torch.testing.assert_close(n.float(),
                               rmsnorm_reference(x, r, w, 1e-6)[1].float(),
                               **TOL[dtype])


@pytest.mark.gpu
def test_rmsnorm_kernel_rejects_what_it_does_not_take(cuda):
    x = _randn((4, 2048), torch.bfloat16, cuda, 0)
    with pytest.raises(TypeError):                        # fp32 weight
        fused_rmsnorm(x, x, torch.zeros(2048, device=cuda))
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


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3, 64])
def test_impatience_scan_kernel_bit_equal_to_plain(cuda, lanes):
    from repro_torch.kernels.impatience_scan import (
        impatience_scan, impatience_scan_reference)
    n = 5003
    rng = np.random.default_rng(lanes)
    inter = rng.exponential(40.0, (n, lanes))
    inter[0] = 0.0
    service = 1.79 + 0.021 * rng.integers(1, 3000, (n, lanes))
    tau = np.where(np.arange(lanes) % 2 == 0, 30.0, 1e12)  # 1e12: none lost
    args = [torch.from_numpy(x).to(cuda) for x in (inter, service, tau)]
    before = K.LAUNCHES["impatience_scan"]
    waits, lost = impatience_scan(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["impatience_scan"] == before + 1
    ref_w, ref_l = impatience_scan_reference(*args)
    assert torch.equal(waits, ref_w) and torch.equal(lost, ref_l)
    assert not bool(lost[:, 1::2].any())
    if lanes > 1:
        assert bool(lost[:, 0].any())


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


def _event_case(kernel, case, n, lanes, dev):
    """(wrapper, plain version, args on ``dev``) of one edge case."""
    from repro_torch.kernels.multibin_scan import (
        multibin_scan, multibin_scan_reference)
    from repro_torch.kernels.srpt_scan import srpt_scan, srpt_scan_reference
    from repro_torch.kernels.wait_scan import wait_scan, wait_scan_reference
    arr, tok = _event_inputs(n, lanes, seed=n + lanes,
                             tie_every=3 if case == "ties" else 0)
    cap = {"b_max_1": 1, "ties": 4}.get(case, 8)
    b_max = np.where(np.arange(lanes) % 2 == 0, cap, 0)     # 0: no cap

    def i64(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    def f64(x):
        return torch.from_numpy(np.asarray(x, np.float64)).to(dev)

    if kernel == "multibin_scan":
        edges = {"one_bin": [1e9, 2e9, 3e9],      # every request in bin 0
                 "empty_bin": [600.0, 600.5, 1200.0]}.get(  # bin 1 empty
                     case, [500.0, 1000.0, 1500.0])
        bins = np.searchsorted(edges, tok, side="left")
        return multibin_scan, multibin_scan_reference, (
            f64(arr), f64(tok), i64(bins), 4, i64(b_max))
    if kernel == "wait_scan":
        timeout = {"timeout_0": 0.0}.get(case, 3.0)
        timeouts = np.where(np.arange(lanes) % 3 == 2, np.inf, timeout)
        return wait_scan, wait_scan_reference, (
            f64(arr), f64(tok), i64(np.full(lanes, 5)), f64(timeouts),
            i64(b_max))
    order = np.argsort(tok, axis=0, kind="stable")
    return srpt_scan, srpt_scan_reference, (
        f64(arr), f64(tok), i64(order), i64(b_max))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["multibin_scan", "wait_scan",
                                    "srpt_scan"])
@pytest.mark.parametrize("case,n,lanes", [
    ("plain", 4001, 5), ("ties", 3001, 3), ("b_max_1", 2001, 2),
    ("n_1", 1, 3), ("one_bin", 2001, 2), ("empty_bin", 2001, 3),
    ("timeout_0", 2001, 3)])
def test_event_kernels_bit_equal_to_plain(cuda, kernel, case, n, lanes):
    fn, ref, args = _event_case(kernel, case, n, lanes, cuda)
    before = K.LAUNCHES[kernel]
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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 37, 40_000])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 64])
def test_backlog_scan_kernel_bit_equal_to_plain(cuda, R, n):
    from repro_torch.kernels.backlog_scan import (
        backlog_scan, backlog_scan_reference)
    arr, work, up = (torch.from_numpy(x).to(cuda)
                     for x in _routing_inputs(n, R, 3, seed=R + n))
    for mask in (None, up):
        before = K.LAUNCHES["backlog_scan"]
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
@pytest.mark.parametrize("policy", ["srpt", "multibin"])
def test_sweep_noise_on_the_card_equals_cpu(cuda, policy):
    from repro_torch.core import fastsim
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import get_policy
    from repro_torch.core.predictors import LogNormalNoisePredictor
    ln = LogNormalTokens(7.0, 0.7)
    lat = BatchLatencyModel(*EVENT_LAT)
    kw = {"srpt": {"b_max": 16}, "multibin": {"num_bins": 4}}[policy]

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
    # SRPT: all six cells are lanes of one launch; multi-bin: one a cell
    assert K.LAUNCHES[name] == before + (1 if policy == "srpt" else 6)
    if policy == "srpt":
        assert got["args"][0].shape == (5000, 6)
