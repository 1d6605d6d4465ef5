#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the four hand-written kernels from
     ``src/repro_torch/kernels/*/csrc`` with nvcc into ``build/kernels/``,
     one nvcc per source, all started together, and print the registers,
     shared memory and spills ptxas reports for the two attention kernels;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes qwen2.5-3b serving gives it, and time kernel, plain version,
     one PyTorch library call and the bound (K3 also as TFLOP/s and share
     of the bound; K1 with its split count and grid);
  3. check a small fp32 model end to end: the engine on the card (all four
     kernels) emits the same greedy tokens as the engine on the CPU (plain
     paths);
  4. serve qwen2.5-3b at full width (random bf16 weights from a seed)
     through ``run_engine_schedule`` with elastic, then dynamic batching,
     and profile one decode chunk;
  5. run the adaptive-control serving launcher
     (``repro_torch.launch.serve.serve``) on qwen2.5-3b at full width.
Each path runs with every kernel's launch counter set to 0 just before it
and read just after it.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# bf16: the kernel and its plain version both compute in fp32 and differ
# only in the output's rounding, at most one bf16 ulp (2^-7 relative)
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=4e-3, rtol=8e-3)}

QWEN = dict(hq=16, hkv=2, d=128)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the device, two ways:
    ``call`` by CUDA events around ``iters`` back-to-back calls (the host's
    launch rate bounds it when the device work is short), and ``device``
    as the summed time of the kernels and copies the calls ran, from
    torch.profiler (host gaps excluded).  Returns (call, device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.device_time for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    assert dev_us > 0, "the profiler saw no device work"
    return call, dev_us / 1e3 / iters


def fmt(t):
    """A (call, device) pair from ``time_ms`` as text."""
    return f"{t[1]:.4f} ms device ({t[0]:.4f} ms per call)"


def rotating(fn, inputs):
    """``fn`` over ``inputs`` in turn, so each launch reads past the L2."""
    turn = iter(range(10 ** 9))
    return lambda: fn(*inputs[next(turn) % len(inputs)])


def bound_ms(nbytes, flops, dtype):
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def ptxas_report(build_log):
    """One line per kernel from nvcc's ``-Xptxas -v`` output: its name,
    registers, shared memory and spills."""
    out, entry, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"([a-z_]+_kernel)", mangled)
            entry = name.group(1) if name else mangled
            entry += (" (bf16)" if "_kernelI13__nv_bfloat16" in mangled else
                      " (fp32)" if "_kernelIf" in mangled else "")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spill}")
            entry = None
    return out


# ----------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------

def check_ragged(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ragged_decode_attention import (
        decode_attention_reference, ragged_decode_attention, split_count)
    from repro_torch.kernels.ragged_decode_attention.ops import _launch
    hq, hkv, d = QWEN["hq"], QWEN["hkv"], QWEN["d"]
    rng = np.random.default_rng(0)
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        err = 0.0
        for b in (1, 4, 16):
            for s in (1024, 2048, 1000):
                lens = np.linspace(1, s, b).astype(np.int32) if b > 1 \
                    else np.array([s], np.int32)
                q = torch.from_numpy(rng.standard_normal((b, hq, d), np.float32))
                kc, vc = (torch.from_numpy(rng.standard_normal(
                    (b, s, hkv, d), np.float32)) for _ in range(2))
                q, kc, vc = (t.to(dev, td) for t in (q, kc, vc))
                ln = torch.from_numpy(lens).to(dev)
                out = ragged_decode_attention(q, kc, vc, ln)
                ref = decode_attention_reference(q, kc, vc, ln)
                torch.testing.assert_close(out.float(), ref.float(),
                                           **TOL[dtype])
                err = max(err, float((out.float() - ref.float()).abs().max()))
        # rows at or past lengths are never read: garbage there changes
        # nothing, bit for bit
        kc2, vc2 = kc.clone(), vc.clone()
        for i, n in enumerate(lens.tolist()):
            kc2[i, n:], vc2[i, n:] = 1e4, -1e4
        assert torch.equal(ragged_decode_attention(q, kc2, vc2, ln), out), \
            "stale cache rows changed the ragged kernel's output"
        assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out), \
            "two calls of the ragged kernel differ"
        # every split count up to the chosen one agrees with the plain version
        ref = decode_attention_reference(q, kc, vc, ln).float()
        for n in range(1, split_count(b, hkv, kc.shape[1]) + 1):
            torch.testing.assert_close(_launch(q, kc, vc, ln, n).float(), ref,
                                       **TOL[dtype])
        max_err[dtype] = err
        log(f"K1 ragged_decode_attention {dtype}: max |kernel - plain| = {err:.3e}")

    # timing at the serving shape: B=16, S=max_seq=2048, bf16, lengths of
    # live requests (prompt 16..256 plus 0..512 generated); four cache
    # copies in rotation (4 x 33 MB) so each launch reads past the 50 MB L2
    b, s, dtype = 16, 2048, "bfloat16"
    lens = (rng.integers(16, 257, b) + rng.integers(0, 513, b)).astype(np.int32)
    ln = torch.from_numpy(lens).to(dev)
    q = torch.randn(b, hq, d, device=dev, dtype=torch.bfloat16)
    caches = [(torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16),
               torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16))
              for _ in range(4)]
    mask = (torch.arange(s, device=dev)[None, :] < ln[:, None])[:, None, None, :]
    ms = time_ms(rotating(lambda k, v: ragged_decode_attention(q, k, v, ln),
                          caches))
    plain_ms = time_ms(rotating(
        lambda k, v: decode_attention_reference(q, k, v, ln), caches))
    lib_ms = time_ms(rotating(lambda k, v: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True), caches))
    kv_rows = int(lens.sum())
    nbytes = kv_rows * hkv * d * 2 * 2 + 2 * q.numel() * 2 + b * 4
    flops = 4 * kv_rows * hq * d
    bnd = bound_ms(nbytes, flops, dtype)
    splits = split_count(b, hkv, s)
    log(f"K1 timing B={b} S={s} bf16 sum(lengths)={kv_rows}: kernel {fmt(ms)}, "
        f"plain {fmt(plain_ms)}, sdpa {fmt(lib_ms)}, bound {bnd:.4f} ms "
        f"(bytes, {100 * bnd / ms[1]:.1f}% of it); {splits} splits, grid "
        f"({splits}, {hkv}, {b}) = {splits * hkv * b} blocks on 132 SMs, then "
        f"a combine grid of {hkv * b}")
    return {"name": "ragged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/ragged_decode_attention/csrc/"
                      "ragged_decode_attention.cu",
            "replaces": "src/repro/kernels/ragged_decode_attention/kernel.py:70",
            "max_abs_err": max(max_err.values()), "ms": ms[1],
            "plain_ms": plain_ms[1], "bound_ms": bnd, "bound_by": "bytes",
            "library_ms": lib_ms[1]}


def check_gather(dev, engine, cfg):
    import torch
    from repro_torch.kernels.compaction import gather_rows
    from repro_torch.kernels.compaction.ref import gather_rows_reference
    gen = torch.Generator(device=dev).manual_seed(1)
    idx = torch.tensor([15, 3, 3, 0, 9, 0, 0, 0], dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        src = torch.randn(36, 16, 4099, generator=gen, device=dev)
        src = (src * 1000).to(dtype)
        assert torch.equal(gather_rows(src, idx), gather_rows_reference(src, idx)), \
            f"gather_rows differs from indexing in {dtype}"
    log("K2 gather_rows: bit-equal in float32, bfloat16, int32 (repeated indices)")

    # one cache leaf of the serving path: [groups, 16, 2048, kv heads, D] bf16
    b, s = 16, engine.ecfg.max_seq
    cache = {"pos0": {k: torch.randn(cfg.num_groups, b, s, cfg.num_kv_heads,
                                     cfg.head_dim, generator=gen, device=dev
                                     ).to(torch.bfloat16) for k in "kv"}}
    kv_lens = torch.randint(1, s, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    produced = np.array([5, 9, 1, 9, 9, 3, 9, 2, 9, 9, 9, 0, 9, 9, 9, 9], np.int32)
    targets = np.full(b, 9, np.int32)
    keep = np.nonzero(produced < targets)[0].astype(np.int32)
    hc, hl, ht, hb, _, _ = engine.compact(cache, kv_lens, tok, keep)
    fc, fl, ft, fb, _ = engine.compact_fused(
        cache, kv_lens, tok, torch.from_numpy(produced).to(dev),
        torch.from_numpy(targets).to(dev), len(keep))
    assert hb == fb == 8
    for a, c in ((fc["pos0"]["k"], hc["pos0"]["k"]), (fc["pos0"]["v"], hc["pos0"]["v"]),
                 (fl, hl), (ft, ht)):
        assert torch.equal(a, c), "fused_compact differs from the host compact"
    log(f"K2 fused_compact: bit-equal to Engine.compact (B={b} -> {fb}, "
        f"{len(keep)} live, padded with slot 0)")

    # timing: a 16 -> 8 compaction with 8 live slots, on one cache leaf
    leaf = cache["pos0"]["k"]
    nb_idx = torch.tensor([0, 2, 3, 5, 8, 9, 12, 14], dtype=torch.int32,
                          device=dev)
    ms = time_ms(lambda: gather_rows(leaf, nb_idx))
    plain_ms = time_ms(lambda: gather_rows_reference(leaf, nb_idx))
    lib_ms = time_ms(lambda: torch.index_select(leaf, 1, nb_idx))
    row = leaf[:, 0].numel() * leaf.element_size()       # one slot, all groups
    nbytes = row * (len(set(nb_idx.tolist())) + len(nb_idx)) + 4 * len(nb_idx)
    bnd = bound_ms(nbytes, 0, "bfloat16")
    log(f"K2 timing leaf {tuple(leaf.shape)} bf16 16 -> 8 slots "
        f"({nbytes / 1e6:.1f} MB read + written): kernel {fmt(ms)}, plain "
        f"{fmt(plain_ms)}, index_select {fmt(lib_ms)}, bound {bnd:.4f} ms "
        f"(bytes)")
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/compaction/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/compaction/kernel.py:30",
            "max_abs_err": 0.0, "ms": ms[1], "plain_ms": plain_ms[1],
            "bound_ms": bnd, "bound_by": "bytes", "library_ms": lib_ms[1]}


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention)
    hq, hkv, d = QWEN["hq"], QWEN["hkv"], QWEN["d"]
    rng = np.random.default_rng(2)
    # prompt buckets, some no multiple of any block; one sliding window
    cases = [(b, s, None) for s in (16, 80, 192, 256, 1000) for b in (1, 16)]
    cases += [(1, 4096, None), (1, 1000, 256), (16, 192, 64)]
    # the bf16 kernel's first, partial and last K/V tiles (64 keys) and a
    # window across tile edges
    cases += [(16, 64, None), (1, 65, None), (16, 129, None), (2, 300, 100)]
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        err = 0.0
        for b, s, win in cases:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b, s, h, d), np.float32)).to(dev, td) for h in (hq, hkv, hkv))
            out = flash_attention(q, k, v, window=win)
            ref = attention_reference(q, k, v, window=win)
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
            err = max(err, float((out.float() - ref.float()).abs().max()))
        max_err[dtype] = err
        log(f"K3 flash_attention {dtype}: max |kernel - plain| = {err:.3e} "
            f"over (B, S, window) in {cases}")

    entry = None
    for b, s in ((16, 256), (1, 8192)):
        q = torch.randn(b, s, hq, d, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: attention_reference(q, k, v), iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * b * hq * d * (s * (s + 1) // 2)    # visible pairs only
        bnd = bound_ms(nbytes, flops, "bfloat16")
        by = "operations" if flops / PEAK_FLOPS["bfloat16"] > \
            nbytes / HBM_BYTES_PER_S else "bytes"
        log(f"K3 timing B={b} S={s} bf16 causal: kernel {fmt(ms)}, plain "
            f"{fmt(plain_ms)}, sdpa {fmt(lib_ms)}, bound {bnd:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
            f"{flops / ms[1] / 1e9:.1f} TFLOP/s, {100 * bnd / ms[1]:.1f}% of "
            f"the bound")
        if entry is None:     # the serving shape goes into the JSON line
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/flash_attention/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
                     "max_abs_err": max(max_err.values()), "ms": ms[1],
                     "plain_ms": plain_ms[1], "bound_ms": bnd, "bound_by": by,
                     "library_ms": lib_ms[1]}
        del q, k, v
    return entry


def check_rmsnorm(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import fused_rmsnorm, rmsnorm_reference
    d, eps = 2048, 1e-6
    rng = np.random.default_rng(3)
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        err = 0.0
        for t in (1, 16, 4096):
            x, r = (torch.from_numpy(rng.standard_normal((t, d), np.float32)
                                     ).to(dev, td) for _ in range(2))
            w = torch.from_numpy(rng.standard_normal(d, np.float32) * 0.1
                                 ).to(dev, td)
            s, n = fused_rmsnorm(x, r, w, eps=eps)
            assert torch.equal(s, x + r), "fused sum differs from x + residual"
            ref = rmsnorm_reference(x, r, w, eps)[1]
            torch.testing.assert_close(n.float(), ref.float(), **TOL[dtype])
            err = max(err, float((n.float() - ref.float()).abs().max()))
        max_err[dtype] = err
        log(f"K4 fused_rmsnorm {dtype}: s bit-equal to x + residual, max "
            f"|n - plain| = {err:.3e} over T in (1, 16, 4096), D={d}")

    entry = None
    for t in (4096, 16):
        sets = [tuple(torch.randn(t, d, device=dev, dtype=torch.bfloat16)
                      for _ in range(2)) for _ in range(4)]
        w = torch.randn(d, device=dev, dtype=torch.bfloat16) * 0.1
        w1 = (1.0 + w.float()).to(torch.bfloat16)   # rms_norm's own weight
        ms = time_ms(rotating(lambda x, r: fused_rmsnorm(x, r, w, eps=eps), sets))
        plain_ms = time_ms(rotating(
            lambda x, r: rmsnorm_reference(x, r, w, eps), sets))
        lib_ms = time_ms(rotating(lambda x, r: F.rms_norm(
            torch.add(x, r), (d,), weight=w1, eps=eps), sets))
        nbytes = 2 * (4 * t * d + d)
        bnd = bound_ms(nbytes, 0, "bfloat16")
        log(f"K4 timing T={t} D={d} bf16: kernel {fmt(ms)}, plain "
            f"{fmt(plain_ms)}, add + rms_norm {fmt(lib_ms)}, bound "
            f"{bnd:.4f} ms (bytes; {nbytes / 1e6:.2f} MB)")
        if entry is None:     # the prefill shape goes into the JSON line
            entry = {"name": "fused_rmsnorm", "route": "cuda",
                     "source": "src/repro_torch/kernels/rmsnorm/csrc/"
                               "fused_rmsnorm.cu",
                     "replaces": "src/repro/kernels/rmsnorm/kernel.py:26",
                     "max_abs_err": max(max_err.values()), "ms": ms[1],
                     "plain_ms": plain_ms[1], "bound_ms": bnd,
                     "bound_by": "bytes", "library_ms": lib_ms[1]}
    return entry


# ----------------------------------------------------------------------------
# Phase 3: small fp32 model, card against CPU
# ----------------------------------------------------------------------------

def check_small_model(dev):
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    # qwen's 16/2 heads of 128 keep the ragged kernel on its one shape
    cfg = scaled_down(get_config("qwen2.5-3b"), num_groups=2, d_model=128,
                      num_heads=16, num_kv_heads=2, head_dim=128, d_ff=256,
                      decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=4, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    gpu = Engine(cfg, ecfg, seed=3, device=dev)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 9)]
    targets = [21, 4, 12]
    K.reset_launches()
    rg = gpu.generate(prompts, targets, elastic=True, return_tokens=True)
    assert all(K.LAUNCHES[name] > 0 for name in K.SOURCES), K.LAUNCHES
    rc = cpu.generate(prompts, targets, elastic=True, return_tokens=True)
    assert rg["tokens"] == rc["tokens"], "card and CPU engines disagree"
    assert list(rg["produced"]) == targets
    assert [e["impl"] for e in gpu.step_log if e["kind"] == "compact"] == \
        ["fused", "fused"]
    log(f"small fp32 model: card (all four kernels, launches "
        f"{dict(K.LAUNCHES)}) and CPU (plain) emit the same "
        f"{sum(len(t) for t in rg['tokens'])} greedy tokens")


# ----------------------------------------------------------------------------
# Phase 4: full-width serving
# ----------------------------------------------------------------------------

class ClippedLogNormal:
    """Lognormal output lengths, rounded and clipped to [1, hi]."""

    def __init__(self, mean_log, std_log, hi):
        self.mean_log, self.std_log, self.hi = mean_log, std_log, hi

    def sample(self, rng, size):
        x = np.rint(rng.lognormal(self.mean_log, self.std_log, size))
        return np.clip(x, 1, self.hi).astype(np.int64)


def serve(engine, policy_name, reqs):
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.policies import get_policy
    from repro_torch.serving import run_engine_schedule
    n0 = len(engine.step_log)
    syncs0, checked0 = engine.host_syncs, engine.sync_checked
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_engine_schedule(get_policy(policy_name, b_max=engine.ecfg.max_batch),
                              engine, reqs)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log_ = engine.step_log[n0:]
    chunks = [e for e in log_ if e["kind"] == "decode_chunk"]
    prefills = [e for e in log_ if e["kind"] == "prefill"]
    compacts = [e for e in log_ if e["kind"] == "compact"]
    assert engine.host_syncs - syncs0 == len(prefills) + len(chunks), \
        "host_syncs != prefills + chunks"
    assert all(e["impl"] == "fused" and e["syncs"] == 0 for e in compacts)
    assert engine.sync_checked - checked0 == len(chunks) + len(compacts), \
        "a chunk or compaction ran outside the sync-error mode"
    assert len(res.batch_sizes) >= 2 and sum(res.batch_sizes) == len(reqs)
    assert launches["ragged_decode_attention"] > 0
    per_bucket = {}
    for e in chunks:
        acc = per_bucket.setdefault(e["batch"], [0, 0.0, 0])
        acc[0] += e["steps"]
        acc[1] += e["seconds"]
        acc[2] += e["tokens"]
    buckets = {b: {"steps": v[0], "ms_per_step": 1e3 * v[1] / v[0],
                   "tokens_per_s": v[2] / v[1]}
               for b, v in sorted(per_bucket.items())}
    pre_ms = [1e3 * e["seconds"] for e in prefills]
    log(f"{policy_name}: batch sizes {res.batch_sizes}, mean wait "
        f"{res.waits.mean():.3f} s, makespan {res.makespan:.2f} s "
        f"(wall {wall:.2f} s), prefills {len(prefills)} "
        f"({', '.join(f'{m:.1f}' for m in pre_ms)} ms), chunks {len(chunks)}, "
        f"compactions {[(e['batch']) for e in compacts]}, launches {launches}")
    for b, v in buckets.items():
        log(f"  {policy_name} bucket {b:2d}: {v['steps']} steps, "
            f"{v['ms_per_step']:.2f} ms/step, {v['tokens_per_s']:.1f} tokens/s")
    return launches, buckets


def profile_decode(engine, reqs, steps=8):
    """Where a decode step's time goes at bucket 16: one profiled chunk of
    ``steps`` steps; device kernels by kind, device busy time per step and
    the host's wall time per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = engine.device
    cache, kv_lens, last, b, _ = engine.prefill_batch(
        [r.prompt_tokens for r in reqs[:16]])
    tok = last.argmax(-1).to(torch.int32)
    produced = torch.ones(b, dtype=torch.int32, device=dev)
    targets = torch.full((b,), 10 ** 6, dtype=torch.int32, device=dev)
    out = engine.decode_chunk(cache, kv_lens, tok, produced, targets, steps)
    cache, tok, kv_lens, produced = out[:4]
    wall_plain = out[-1] / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = engine.decode_chunk(cache, kv_lens, tok, produced, targets, steps)
    wall_prof = out[-1] / steps
    kinds = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("ragged_decode_attention" if "ragged_decode" in name else
                "fused_rmsnorm" if "fused_rmsnorm" in name else
                "flash_attention" if "flash_attention" in name else
                "gemm" if any(w in name for w in ("gemm", "gemv", "cutlass",
                                                  "sm90_xmma", "nvjet")) else
                "copy/fill" if "memcpy" in name or "memset" in name else
                "other (elementwise, reductions, indexing)")
        acc = kinds.setdefault(kind, [0, 0.0])
        acc[0] += 1
        acc[1] += e.device_time / 1e3
    busy = sum(v[1] for v in kinds.values()) / steps
    log(f"decode step at bucket 16 (profiled chunk of {steps}): wall "
        f"{1e3 * wall_plain:.2f} ms/step unprofiled, {1e3 * wall_prof:.2f} "
        f"profiled; device busy {busy:.2f} ms/step "
        f"({100 * busy / (1e3 * wall_plain):.1f}% of the unprofiled step)")
    for kind, (n, ms) in sorted(kinds.items(), key=lambda kv: -kv[1][1]):
        log(f"  {kind}: {n / steps:.0f} launches/step, {ms / steps:.3f} ms/step")
    assert kinds, "the profiler saw no device kernels"


def serve_full(engine):
    import torch
    from repro_torch.data.pipeline import make_request_stream
    cfg = engine.cfg
    reqs = make_request_stream(32, 4.0, ClippedLogNormal(np.log(96.0), 0.8, 512),
                               vocab=cfg.vocab_size, prompt_len_range=(16, 257),
                               seed=0)
    targets = [r.target_output_tokens for r in reqs]
    log(f"serving {len(reqs)} requests: prompts "
        f"{min(len(r.prompt_tokens) for r in reqs)}-"
        f"{max(len(r.prompt_tokens) for r in reqs)} tokens, targets "
        f"{min(targets)}-{max(targets)} (mean {np.mean(targets):.1f})")
    # warm the path (cuBLAS handles, allocator) outside the counted runs
    engine.generate([r.prompt_tokens for r in reqs[:2]], [3, 2], elastic=True)
    torch.cuda.reset_peak_memory_stats()
    totals = {}
    for name in ("elastic", "dynamic"):
        launches, _ = serve(engine, name, reqs)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        if name == "elastic":
            assert launches["gather_rows"] > 0, "no fused compaction ran"
    assert engine.sample_fallbacks == 0, "non-finite logits"
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(engine, reqs)

    # token agreement, elastic vs padded, on one batch (printed: in bf16 a
    # bucket change can reorder a GEMM's sums)
    batch = reqs[:8]
    prompts = [r.prompt_tokens for r in batch]
    tg = [min(r.target_output_tokens, 64) for r in batch]
    re_ = engine.generate(prompts, tg, elastic=True, return_tokens=True)
    rp = engine.generate(prompts, tg, elastic=False, return_tokens=True)
    same = sum(a == b for x, y in zip(re_["tokens"], rp["tokens"])
               for a, b in zip(x, y))
    total = sum(len(x) for x in re_["tokens"])
    assert list(re_["produced"]) == list(rp["produced"]) == tg
    assert all(0 <= t < cfg.vocab_size for x in re_["tokens"] for t in x)
    log(f"elastic vs padded greedy tokens: {same}/{total} equal "
        f"(requests identical: {sum(x == y for x, y in zip(re_['tokens'], rp['tokens']))}/8)")
    return totals


# ----------------------------------------------------------------------------
# Phase 5: the adaptive-control serving launcher
# ----------------------------------------------------------------------------

def serve_launcher(dev):
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch.serve import serve
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve("qwen2.5-3b", requests=32, lam=0.5, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    rec = out["recommendation"]
    assert sum(out["batch_sizes"]) == 32, "a request was not served"
    assert rec.n_max is not None and "reason" not in rec.details, \
        "the controller never left warmup"
    limits = np.repeat([np.inf if n is None else n for n in out["n_max"]],
                       out["batch_sizes"])
    produced = np.asarray(out["produced"])
    assert np.all(produced >= 1) and np.all(produced <= limits), \
        "outputs not clipped at the recommended n_max"
    for name in ("ragged_decode_attention", "flash_attention", "fused_rmsnorm"):
        assert launches[name] > 0, f"{name} never ran in the launcher"
    log_ = out["step_log"]
    seqs = sorted({e["seq"] for e in log_ if e["kind"] == "prefill"})
    pre_ms = [1e3 * e["seconds"] for e in log_ if e["kind"] == "prefill"]
    steps = sum(e["steps"] for e in log_ if e["kind"] == "decode_chunk")
    dec_s = sum(e["seconds"] for e in log_ if e["kind"] == "decode_chunk")
    log(f"launcher: {len(out['batch_sizes'])} batches {out['batch_sizes']}, "
        f"policies {sorted(set(out['policies']))}, final n_max {rec.n_max} "
        f"b_max {rec.b_max} policy {rec.policy}; virtual clock "
        f"{out['clock']:.2f} s (wall {wall:.2f} s); prompt buckets {seqs}, "
        f"prefill {np.mean(pre_ms):.1f} ms mean; decode {steps} steps at "
        f"{1e3 * dec_s / max(steps, 1):.2f} ms/step; launches {launches}")
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import Engine, EngineConfig

    t0 = time.perf_counter()
    secs = K.build()
    log(f"build: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} "
        f"(wall {time.perf_counter() - t0:.1f} s, parallel)")
    for name in ("flash_attention", "ragged_decode_attention"):
        for line in ptxas_report(K.build_log(name)):
            log(f"ptxas {name}: {line}")

    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=16, max_seq=2048, prompt_bucket=64,
                        decode_chunk=32, cache_dtype="bfloat16")
    t0 = time.perf_counter()
    engine = Engine(cfg, ecfg, seed=0)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in tree_leaves(engine.params))
    log(f"qwen2.5-3b: {nparams / 1e9:.3f} B params in {cfg.dtype}, "
        f"{cfg.num_layers} layers, init {time.perf_counter() - t0:.1f} s; "
        f"decode attention resolves to "
        f"{cfg.resolve_decode_attention_impl(engine.device)}")

    kernels = [check_ragged(dev), check_gather(dev, engine, cfg),
               check_flash(dev), check_rmsnorm(dev)]
    check_small_model(dev)
    paths = {"serving schedule": serve_full(engine)}
    del engine
    torch.cuda.empty_cache()
    paths["launcher"] = serve_launcher(dev)
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        assert k["launches"] > 0, f"{k['name']} never ran on a path"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
