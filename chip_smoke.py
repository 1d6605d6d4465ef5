#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the ten hand-written kernels from
     ``src/repro_torch/kernels/*/csrc`` with nvcc into ``build/kernels/``,
     one nvcc per source, all started together, and print the registers,
     shared memory and spills ptxas reports for the two attention kernels
     and the six simulator kernels;
  2. hold each serving kernel against its plain PyTorch version on the card, at the
     shapes qwen2.5-3b serving gives it, and time kernel, plain version,
     one PyTorch library call and the bound (K3 also as TFLOP/s and share
     of the bound; K1 with its split count and grid);
  3. check a small fp32 model end to end: the engine on the card (all four
     kernels, decode chunks as CUDA graphs) emits the same greedy tokens as
     the engine on the CPU (plain paths); sampled at a fixed seed, the two
     draw the same noise bits, and the token agreement is printed;
  4. serve qwen2.5-3b at full width (random bf16 weights from a seed)
     through ``run_engine_schedule`` with elastic, then dynamic batching
     (every bucket that runs replays a graph), then multi-bin (4 bins),
     WAIT (k=8) and SRPT, each capped at the engine's 16 slots, and
     profile one decode chunk at bucket 16 as a graph replay and through
     the eager loop;
  6. serve the same request stream with continuous batching
     (``serve_continuous``, 16 slots, chunk 32) on phase 4's engine;
  8a. serve phase 4's stream, made again under MMPP traffic, through two
     routed fleets of R = 2 replicas on phase 4's engine
     (``run_fleet_schedule``): least_work + SRPT with a noisy length
     predictor, and jsq + elastic; each fleet's split must equal
     ``FleetScheduler``'s on a ``ModelClock``;
  5. run the adaptive-control serving launcher
     (``repro_torch.launch.serve.serve``) on qwen2.5-3b at full width;
  7. run the paper's simulators (``repro_torch.core.fastsim``) on the card:
     the Fig 5 and heavy-tail Fig 6b grids (dynamic, elastic, capped and
     not, as 64 lanes of one ``batch_scan`` launch each; fixed b=4, 8 by
     the closed form) and the Fig 4 FCFS cells (``impatience_scan``), then
     the four scan policies once more on k1..k4 fitted from phase 4's
     engine (ROADMAP M4; a fitted slope below 0 is held at 0), and the
     reference benchmark's heavy-tail grid (dynamic capped at 32, 16 and
     not, elastic: S1 lanes; multi-bin with equal-mass and optimised
     edges: S3; WAIT k=16: S4; SRPT b=16: S5); hold every lane of the
     counted launches, at full length, bit for bit to their plain
     versions on the card, four lanes of the Fig 5 launch and every S3-S5
     lane to the NumPy oracle, assert the benchmark's relations at λ = 1,
     print every lane's mean wait beside the paper's analytic delay or
     envelope, and time the kernels against their bytes bound;
  8b. run the reference benchmarks' fleet, predictor and fault grids on
     the card (``fleet.sweep``, ``simulate_fleet_fast``, ``sweep_noise``
     with its SRPT cells as one ``srpt_scan`` launch,
     ``simulate_fleet_faulty(fast=True)``), the backlog routers on
     ``backlog_scan`` (S6); assert the benchmarks' relations, print each
     figure beside ``benchmarks/BENCH_simulators.json``, hold every S6
     launch at full length to its plain version on the card and to the
     NumPy recursion, and time S6 against its bytes bound.
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12,
              "float64": 34e12}      # float64 outside the tensor cores
# bf16: the kernel and its plain version both compute in fp32 and differ
# only in the output's rounding, at most one bf16 ulp (2^-7 relative)
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=4e-3, rtol=8e-3)}

QWEN = dict(hq=16, hkv=2, d=128)
# the kernels of the model's serving path (the other two are the
# simulators' scans, phase 7)
SERVING_KERNELS = ("ragged_decode_attention", "gather_rows", "flash_attention",
                   "fused_rmsnorm")


def log(*a):
    print(*a, flush=True)


def profiled(fn, tries=3):
    """Run ``fn`` under torch.profiler (CPU and CUDA activities) and return
    (profile, fn's result).  A window in which CUPTI delivered no device
    event at all runs again, ``tries`` times at most: such a window was
    seen once on the card, in a timing that the same code passes in
    other runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof, out
    raise AssertionError(f"the profiler saw no device work in {tries} windows")


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the device, two ways:
    ``call`` by CUDA events around ``iters`` back-to-back calls (the host's
    launch rate bounds it when the device work is short), and ``device``
    as the summed time of the kernels and copies the calls ran, from
    torch.profiler (host gaps excluded).  Returns (call, device)."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(end) / iters
    prof, _ = profiled(lambda: [fn() for _ in range(iters)])
    dev_us = sum(e.device_time for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
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
    # both write into the engine's own bucket-8 cache: keep the host result
    hc = {k: {n: t.clone() for n, t in v.items()} for k, v in hc.items()}
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
    import torch
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
    assert all(K.LAUNCHES[name] > 0 for name in SERVING_KERNELS), K.LAUNCHES
    rc = cpu.generate(prompts, targets, elastic=True, return_tokens=True)
    assert rg["tokens"] == rc["tokens"], "card and CPU engines disagree"
    assert list(rg["produced"]) == targets
    assert [e["impl"] for e in gpu.step_log if e["kind"] == "compact"] == \
        ["fused", "fused"]
    log(f"small fp32 model: card (the four serving kernels, launches "
        f"{dict(K.LAUNCHES)}) and CPU (plain) emit the same "
        f"{sum(len(t) for t in rg['tokens'])} greedy tokens")

    # sampled: the noise words are integer hashes, equal bit for bit; the
    # tokens can differ only where fp32 logits of the two devices reorder
    # a near-tie of logit / T + Gumbel noise
    from repro_torch.serving.engine import (
        _split_slot_keys, sample_noise_bits, slot_keys_for)
    keys = {d: slot_keys_for(0x5EED, 16, d) for d in ("cpu", dev)}
    for _ in range(3):
        for vocab in (cfg.vocab_size, 151936):
            assert torch.equal(sample_noise_bits(keys["cpu"], vocab),
                               sample_noise_bits(keys[dev], vocab).cpu()), \
                "sampling noise bits differ between CPU and card"
        keys = {d: _split_slot_keys(k)[0] for d, k in keys.items()}
    kw = dict(elastic=True, temperature=0.8, top_k=40, seed=5,
              return_tokens=True)
    sg = gpu.generate(prompts, targets, **kw)
    sc = cpu.generate(prompts, targets, **kw)
    assert list(sg["produced"]) == list(sc["produced"]) == targets
    same = sum(a == b for x, y in zip(sg["tokens"], sc["tokens"])
               for a, b in zip(x, y))
    total = sum(len(t) for t in sg["tokens"])
    log(f"small fp32 model sampled (T=0.8, top_k=40, seed 5): noise bits "
        f"equal on card and CPU (3 steps x 16 slots, vocab {cfg.vocab_size} "
        f"and 151936); tokens {same}/{total} equal, requests identical "
        f"{sum(x == y for x, y in zip(sg['tokens'], sc['tokens']))}/"
        f"{len(targets)}")


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


def serve(engine, policy_name, reqs, policy, schedule=None):
    """Serve ``reqs`` with ``policy`` through ``run_engine_schedule``, or
    through ``schedule()`` (a fleet), counting the kernels' launches, and
    assert the engine's host-sync and graph ledgers.  Returns (launches,
    per-bucket decode figures, wall seconds, the schedule's result)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import run_engine_schedule
    n0 = len(engine.step_log)
    syncs0, checked0 = engine.host_syncs, engine.sync_checked
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = schedule() if schedule else run_engine_schedule(policy, engine, reqs)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log_ = engine.step_log[n0:]
    chunks = [e for e in log_ if e["kind"] == "decode_chunk"]
    prefills = [e for e in log_ if e["kind"] == "prefill"]
    compacts = [e for e in log_ if e["kind"] == "compact"]
    captures = [e for e in chunks if e["graph"] == "capture"]
    assert engine.host_syncs - syncs0 == len(prefills) + len(chunks), \
        "host_syncs != prefills + chunks"
    assert all(e["impl"] == "fused" and e["syncs"] == 0 for e in compacts)
    # a chunk runs one checked block (a replay, or the eager run of a
    # capture call), a capture one more, a compaction one
    assert engine.sync_checked - checked0 == \
        len(chunks) + len(captures) + len(compacts), \
        "a chunk or compaction ran outside the sync-error mode"
    assert len(res.batch_sizes) >= 2 and sum(res.batch_sizes) == len(reqs)
    for name in ("ragged_decode_attention", "flash_attention", "fused_rmsnorm"):
        assert launches[name] > 0, f"{name} never ran under {policy_name}"
    per_bucket = {}
    for e in chunks:
        acc = per_bucket.setdefault(e["batch"], [0, 0.0, 0, 0, 0, 0.0])
        acc[0] += e["steps"]
        acc[1] += e["seconds"]
        acc[2] += e["tokens"]
        if e["graph"] == "replay":
            acc[3] += 1
            acc[4] += e["steps"]
            acc[5] += e["seconds"]
    buckets = {b: {"steps": v[0], "ms_per_step": 1e3 * v[1] / v[0],
                   "tokens_per_s": v[2] / v[1], "replays": v[3],
                   "replay_ms_per_step": 1e3 * v[5] / max(v[4], 1)}
               for b, v in sorted(per_bucket.items())}
    pre_ms = [1e3 * e["seconds"] for e in prefills]
    log(f"{policy_name} {policy}: batch sizes {res.batch_sizes}, mean wait "
        f"{res.waits.mean():.3f} s, makespan {res.makespan:.2f} s "
        f"(wall {wall:.2f} s), prefills {len(prefills)} "
        f"({', '.join(f'{m:.1f}' for m in pre_ms)} ms), chunks {len(chunks)} "
        f"({len(chunks) - len(captures)} graph replays, {len(captures)} "
        f"capture calls, whose chunk seconds hold their eager runs and "
        f"{sum(e['capture_seconds'] for e in captures):.2f} s of capture), "
        f"compactions "
        f"{[(e['batch']) for e in compacts]}, launches {launches}")
    for b, v in buckets.items():
        log(f"  {policy_name} bucket {b:2d}: {v['steps']} steps, "
            f"{v['ms_per_step']:.2f} ms/step, {v['tokens_per_s']:.1f} tokens/s; "
            f"{v['replays']} replayed chunks at {v['replay_ms_per_step']:.2f} "
            f"ms/step")
    return launches, buckets, wall, res


def decode_ms(chunks):
    """Decode wall ms/step over all chunks and over the graph replays
    only (a capture call's chunk runs eagerly, then captures)."""
    rep = [e for e in chunks if e["graph"] == "replay"]
    return tuple(1e3 * sum(e["seconds"] for e in c) /
                 max(sum(e["steps"] for e in c), 1) for c in (chunks, rep))


def _kernel_kinds(prof):
    """Device kernels of a profile by kind: {kind: [launches, ms]}."""
    from torch.autograd import DeviceType
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
    return kinds


def profile_decode(engine, reqs, steps=8):
    """Where a decode step's time goes at bucket 16, for one chunk of
    ``steps`` steps run twice on the same inputs: as the engine's graph
    replay and through its eager loop (on a copy of the cache).  Prints
    the wall ms/step of each, the tokens they agree on, the device busy
    time per step of each from a profiled chunk (kernels by kind), and the
    replay's time by CUDA events.  Asserts that each profiled chunk ran
    the K1 and K4 kernels that the graph's record adds to ``LAUNCHES`` on
    a replay."""
    import torch
    dev = engine.device
    cache, kv_lens, last, b, pre_s = engine.prefill_batch(
        [r.prompt_tokens for r in reqs[:16]])
    log(f"prefill of the first 16 prompts (bucket 16, seq "
        f"{engine.step_log[-1]['seq']}): {1e3 * pre_s:.2f} ms")
    tok = last.argmax(-1).to(torch.int32)
    produced = torch.ones(b, dtype=torch.int32, device=dev)
    targets = torch.full((b,), 10 ** 6, dtype=torch.int32, device=dev)
    keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
    out = engine.decode_chunk(cache, kv_lens, tok, produced, targets, steps)
    state = out[1:4]                        # a graph exists from here on
    copy = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    eager_state = [t.clone() for t in state]
    torch.cuda.synchronize()

    def eager(st):
        t0 = time.perf_counter()
        with engine._no_sync():
            res = engine._chunk_eager(copy, *st, targets, keys, steps, 0.0,
                                      None)
        host = res[4].cpu().numpy()
        return res[:3], host, time.perf_counter() - t0

    out = engine.decode_chunk(cache, state[1], state[0], state[2], targets,
                              steps)
    assert engine.step_log[-1]["graph"] == "replay"
    wall_graph = out[-1] / steps
    eager_state, host, dt = eager(eager_state)
    wall_eager = dt / steps
    same = int((out[5] == host[:steps * b].reshape(steps, b)).sum())
    state = out[1:4]

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = engine.decode_chunk(cache, state[1], state[0], state[2], targets,
                              steps)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / steps
    state = out[1:4]
    pg, out = profiled(lambda: engine.decode_chunk(
        cache, state[1], state[0], state[2], targets, steps))
    wall_graph_prof = out[-1] / steps
    pe, (_, _, dt) = profiled(lambda: eager(eager_state))
    wall_eager_prof = dt / steps
    kinds = {"graph": _kernel_kinds(pg), "eager": _kernel_kinds(pe)}
    # a replay adds the launches its capture recorded to LAUNCHES: hold
    # that record to the kernels the profiler saw (K1 is a split and a
    # combine kernel per call)
    rec = engine._graphs[(b, steps, 0.0, None)].launches
    want = {"ragged_decode_attention": 2 * rec["ragged_decode_attention"],
            "fused_rmsnorm": rec["fused_rmsnorm"]}
    for k in ("graph", "eager"):
        seen = {n: kinds[k].get(n, [0])[0] for n in want}
        assert seen == want, f"{k} chunk ran {seen}, the graph record " \
            f"says {want}"
    log(f"profiled kernels per chunk equal the graph record's launches: "
        f"{want} (K1 as split + combine)")
    busy = {k: sum(v[1] for v in kd.values()) / steps for k, kd in kinds.items()}
    log(f"decode chunk of {steps} steps at bucket 16, same inputs: graph "
        f"replay {1e3 * wall_graph:.2f} ms/step wall, eager loop "
        f"{1e3 * wall_eager:.2f} ms/step wall; greedy tokens equal "
        f"{same}/{steps * b}; replay by CUDA events {event_ms:.2f} ms/step")
    for k in ("graph", "eager"):
        wp = wall_graph_prof if k == "graph" else wall_eager_prof
        log(f"  {k}: device busy {busy[k]:.3f} ms/step, profiled wall "
            f"{1e3 * wp:.2f} ms/step ({100 * busy[k] / (1e3 * wp):.1f}% busy)")
        for kind, (n, ms) in sorted(kinds[k].items(), key=lambda kv: -kv[1][1]):
            log(f"    {kind}: {n / steps:.0f} launches/step, {ms / steps:.3f} "
                f"ms/step")


def serve_full(engine, reqs):
    import torch
    from repro_torch.core.policies import (
        MultiBinPolicy, SRPTPolicy, WaitPolicy, get_policy)
    cfg = engine.cfg
    cap = engine.ecfg.max_batch   # with no cap a batch can outgrow the engine
    targets = [r.target_output_tokens for r in reqs]
    log(f"serving {len(reqs)} requests: prompts "
        f"{min(len(r.prompt_tokens) for r in reqs)}-"
        f"{max(len(r.prompt_tokens) for r in reqs)} tokens, targets "
        f"{min(targets)}-{max(targets)} (mean {np.mean(targets):.1f})")
    # warm the path (cuBLAS handles, allocator) outside the counted runs
    engine.generate([r.prompt_tokens for r in reqs[:2]], [3, 2], elastic=True)
    torch.cuda.reset_peak_memory_stats()
    totals, replayed, ran, walls = {}, set(), set(), {}
    for name, pol in (("elastic", get_policy("elastic", b_max=cap)),
                      ("dynamic", get_policy("dynamic", b_max=cap)),
                      ("multibin", MultiBinPolicy(num_bins=4, b_max=cap)),
                      ("wait", WaitPolicy(k=8, b_max=cap)),
                      ("srpt", SRPTPolicy(b_max=cap))):
        launches, buckets, walls[name], _ = serve(engine, name, reqs, pol)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        if name == "elastic":
            assert launches["gather_rows"] > 0, "no fused compaction ran"
        if name in ("elastic", "dynamic"):
            ran |= set(buckets)
            replayed |= {b for b, v in buckets.items() if v["replays"]}
    assert ran == replayed, f"buckets {sorted(ran - replayed)} never replayed"
    log(f"schedule walls: {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}")
    assert engine.sample_fallbacks == 0, "non-finite logits"
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({len(engine._graphs)} decode graphs)")
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
# Phase 6: continuous batching
# ----------------------------------------------------------------------------

def serve_cont(engine, reqs):
    import torch
    from repro_torch import kernels as K
    from repro_torch.serving import serve_continuous
    prompts = [r.prompt_tokens for r in reqs]
    targets = [r.target_output_tokens for r in reqs]
    n0, syncs0 = len(engine.step_log), engine.host_syncs
    K.reset_launches()
    torch.cuda.synchronize()
    res = serve_continuous(engine, prompts, targets, slots=16, chunk=32)
    launches = dict(K.LAUNCHES)
    log_ = engine.step_log[n0:]
    chunks = [e for e in log_ if e["kind"] == "decode_chunk"]
    prefills = [e for e in log_ if e["kind"] == "prefill"]
    assert list(res.produced) == targets, "continuous: produced != targets"
    assert len(prefills) == len(reqs), "one admission prefill per request"
    assert res.host_syncs == engine.host_syncs - syncs0 == \
        len(prefills) + len(chunks), "host_syncs != admissions + chunks"
    for name in ("ragged_decode_attention", "flash_attention", "fused_rmsnorm"):
        assert launches[name] > 0, f"{name} never ran in continuous batching"
    replays = sum(e["graph"] == "replay" for e in chunks)
    pre_ms = [1e3 * e["seconds"] for e in prefills]
    log(f"continuous (16 slots, chunk 32): {len(reqs)} requests, "
        f"{sum(targets)} tokens, wall {res.wall_seconds:.2f} s; "
        f"{len(chunks)} chunks ({replays} graph replays), {res.decode_steps} "
        f"decode steps at {decode_ms(chunks)[0]:.2f} ms/step "
        f"({decode_ms(chunks)[1]:.2f} over the replays); admissions "
        f"{np.median(pre_ms):.1f} ms median prefill; TTFT mean "
        f"{np.mean(res.ttft):.3f} s, p95 {np.percentile(res.ttft, 95):.3f} s; "
        f"completion mean {np.mean(res.completion):.3f} s, max "
        f"{np.max(res.completion):.3f} s; launches {launches}")
    return launches


# ----------------------------------------------------------------------------
# Phase 8a: the fleet serving path
# ----------------------------------------------------------------------------

# the serving launcher's priors for the latency laws (launch/serve.py)
PRIOR_SINGLE = dict(a=5e-3, c=0.05)
PRIOR_BATCH = dict(k1=5e-3, k2=5e-2, k3=1e-4, k4=5e-3)


def serve_fleet(engine, reqs):
    """Two routed fleets of R = 2 replicas sharing phase 4's engine, on
    phase 4's stream made again under MMPP traffic: least_work in front of
    SRPT with a noisy length predictor, jsq in front of elastic.  Each
    must serve every request once, split the stream as ``FleetScheduler``
    does on a ``ModelClock``, and keep phase 4's ledgers."""
    from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
    from repro_torch.core.policies import ElasticPolicy, SRPTPolicy
    from repro_torch.core.predictors import LogNormalNoisePredictor
    from repro_torch.serving import (
        FleetScheduler, ModelClock, run_fleet_schedule, summarize_fleet)
    single, batch = LatencyModel(**PRIOR_SINGLE), BatchLatencyModel(**PRIOR_BATCH)
    clock = ModelClock(single, batch)
    cap = engine.ecfg.max_batch
    totals, walls = {}, {}
    for name, router, pol in (
            ("least_work+srpt", "least_work",
             SRPTPolicy(b_max=cap, predictor=LogNormalNoisePredictor(0.5))),
            ("jsq+elastic", "jsq", ElasticPolicy(b_max=cap))):
        launches, buckets, walls[name], res = serve(
            engine, f"fleet {name}", reqs, pol,
            schedule=lambda: run_fleet_schedule(router, pol, engine, reqs,
                                                R=2, lat=single))
        assert all(v["replays"] for v in buckets.values()), \
            f"{name}: a bucket that ran never replayed a graph"
        virtual = FleetScheduler(router, pol, clock, 2).run(reqs)
        assert np.array_equal(res.replica_of, virtual.replica_of), \
            f"{name}: the engine fleet split the stream differently"
        assert not res.lost.any() and sorted(set(res.replica_of)) == [0, 1]
        if name == "jsq+elastic":
            assert launches["gather_rows"] > 0, "no fused compaction ran"
        s = summarize_fleet(res)
        per = [(p["requests"], p["mean_wait"], p["p95_wait"])
               for p in s["per_replica"]]
        log(f"fleet {name}: replica requests {s['replica_requests']}, mean "
            f"wait {s['mean_wait']:.3f} s, p95 {s['p95_wait']:.3f} s; per "
            f"replica (requests after warmup, mean, p95 wait s) "
            f"{[(n, round(m, 3), round(q, 3)) for n, m, q in per]}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    log(f"fleet walls: {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}")
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
    chunks = [e for e in log_ if e["kind"] == "decode_chunk"]
    steps = sum(e["steps"] for e in chunks)
    log(f"launcher: {len(out['batch_sizes'])} batches {out['batch_sizes']}, "
        f"policies {sorted(set(out['policies']))}, final n_max {rec.n_max} "
        f"b_max {rec.b_max} policy {rec.policy}; virtual clock "
        f"{out['clock']:.2f} s (wall {wall:.2f} s); prompt buckets {seqs}, "
        f"prefill {np.mean(pre_ms):.1f} ms mean; decode {steps} steps at "
        f"{decode_ms(chunks)[0]:.2f} ms/step ({decode_ms(chunks)[1]:.2f} over "
        f"the {sum(e['graph'] == 'replay' for e in chunks)} replayed of "
        f"{len(chunks)} chunks); launches {launches}")
    return launches


# ----------------------------------------------------------------------------
# Phase 7: the paper's simulators
# ----------------------------------------------------------------------------

SIM_N = 150_000           # requests a lane (Figs 5 and 6b, the fitted law)
HT_N, HT_SEED = 60_000, 15   # the reference benchmark's heavy-tail grid
FIG4_N = 200_000          # requests a Fig 4 cell


def event_ms(fn, iters=3, warmup=1):
    """Milliseconds per call of ``fn`` by CUDA events, after ``warmup``
    calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn):
    """Milliseconds of one call of ``fn`` on the host's clock, the card
    synchronized before and after (for the plain versions' Python loops)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _fit_line(x, y, what):
    """Least-squares line y = a x + b with a >= 0.  ``np.polyfit``'s line
    when its slope is not negative; else the times do not grow with x
    beyond their noise, and the best line with a >= 0 is a = 0, b =
    mean(y)."""
    from repro_torch.core.latency_model import linear_fit_r2
    a, b = np.polyfit(x, y, 1)
    log(f"  {what}: np.polyfit slope {a:.4e} s, intercept {b:.4e} s, R^2 "
        f"{linear_fit_r2(x, y):.3f}, {len(x)} points at "
        f"{sorted({int(v) for v in x})}")
    if a < 0:
        a, b = 0.0, float(np.mean(y))
        log(f"  {what}: a slope below 0 (time falling as the batch grows) "
            f"is no latency law: slope held at 0, intercept the mean "
            f"{b:.4e} s")
    assert b > 0, f"{what}: intercept {b}"
    return float(a), float(b)


def fit_engine_latency(cal):
    """ROADMAP M4: k3, k4 from the decode law (per-step seconds of the
    replayed chunks against the batch bucket) and k1, k2 from the prefills
    at the sequence bucket with the most distinct batch sizes, each a
    least-squares line with a slope of at least 0 (``_fit_line``)."""
    from repro_torch.core.latency_model import BatchLatencyModel
    bs = np.array([b for b, _ in cal["decode"]], np.float64)
    ts = np.array([t for _, t in cal["decode"]], np.float64)
    assert len(set(bs)) >= 2, f"decode entries at one bucket only: {set(bs)}"
    by_seq = {}
    for b, seq, t in cal["prefill"]:
        by_seq.setdefault(seq, []).append((b, t))
    seq = max(by_seq, key=lambda q: (len({b for b, _ in by_seq[q]}),
                                     len(by_seq[q])))
    pb = np.array([b for b, _ in by_seq[seq]], np.float64)
    pt = np.array([t for _, t in by_seq[seq]], np.float64)
    assert len(set(pb)) >= 2, f"prefills at seq {seq} of one batch size"
    log("M4 fit on the card (phase 4's calibration log):")
    k3, k4 = _fit_line(bs, ts, "decode step against the batch bucket (k3, "
                       "k4)")
    k1, k2 = _fit_line(pb, pt, f"prefill at seq {seq} against the batch "
                       f"(k1, k2)")
    lat = BatchLatencyModel(k1, k2, k3, k4)
    log(f"  fitted law: {lat}")
    return lat


def _sim_grid(name, dist, lat, lams, policies, dev, n=SIM_N, seed=0):
    """One λ grid through ``sweep``; its scan lanes run in one S1 launch,
    whose inputs and outputs ``scan_out`` hands back, and each batch-event
    cell in a launch of its own, handed back under ``cells``."""
    from repro_torch.core.fastsim import sweep
    scan = {}
    t0 = time.perf_counter()
    waits = sweep(policies, lams, dist, lat, num_requests=n, seed=seed,
                  device=dev, scan_out=scan)
    wall = time.perf_counter() - t0
    return {"name": name, "dist": dist, "lat": lat, "lams": lams,
            "waits": waits, "wall": wall, "scan": scan, "n": n,
            "seed": seed, "policies": policies}


def _print_grid(g, policies):
    log(f"{g['name']}: {len(g['lams'])} λ from {g['lams'][0]:.4f} to "
        f"{g['lams'][-1]:.4f}/s, {len(g['scan']['lanes'])} scan lanes of "
        f"{g['n']} requests in one batch_scan launch and "
        f"{len(g['scan']['cells'])} cells launched one by one, sweep wall "
        f"{g['wall']:.2f} s; mean wait simulated / analytic (s):")
    for name, pol in policies.items():
        pairs = []
        for lam, w in zip(g["lams"], g["waits"][name]):
            a = pol.analytic_delay(lam, g["dist"], g["lat"])
            assert np.isfinite(w), f"{name} at λ={lam}: wait {w}"
            pairs.append(f"{w:.3f}/{'-' if a is None else f'{a:.3f}'}")
        log(f"  {name} [{pol.analytic_kind or 'no closed form'}]: "
            f"{' '.join(pairs)}")


def check_batch_scan(g, dev):
    """Every lane of the grid's counted S1 launch, at full length, against
    the plain version on the card on the same inputs; then the kernel
    timed on them.  Returns (lanes, n, ms, plain_ms, bound_ms)."""
    import torch
    from repro_torch.kernels.batch_scan import (
        NO_CAP, batch_scan, batch_scan_reference)
    scan = g["scan"]
    arr, tok = (torch.from_numpy(scan[k]).to(dev) for k in ("arr", "tok"))
    el = torch.tensor([e for *_, e, _ in scan["lanes"]], device=dev)
    bm = torch.tensor([NO_CAP if b is None else float(b)
                       for *_, b in scan["lanes"]], dtype=torch.float64,
                      device=dev)
    k = (g["lat"].k1, g["lat"].k2, g["lat"].k3, g["lat"].k4)
    (ref_s, ref_c), plain_ms = wall_ms(
        lambda: batch_scan_reference(arr, tok, el, bm, *k))
    assert np.array_equal(ref_s.cpu().numpy(), scan["starts"]) and \
        np.array_equal(ref_c.cpu().numpy(), scan["closed"]), \
        f"{g['name']}: batch_scan differs from its plain version"
    n, lanes = arr.shape
    ms = event_ms(lambda: batch_scan(arr, tok, el, bm, *k))
    nbytes = lanes * n * (8 + 8 + 8 + 1) + lanes * (1 + 8)
    bnd = bound_ms(nbytes, 8 * lanes * n, "float64")
    log(f"S1 batch_scan {lanes} lanes x {n}: {ms:.3f} ms by CUDA events "
        f"({lanes * n / ms / 1e6:.3f} G lane-requests/s), bound {bnd:.4f} ms "
        f"(bytes, {nbytes / 1e6:.1f} MB; {100 * bnd / ms:.2f}% of it); plain "
        f"{plain_ms:.1f} ms; the counted launch's starts and closed equal "
        f"the plain version's over all {lanes} lanes at full length "
        f"({g['name']})")
    return lanes, n, ms, plain_ms, bnd


# the batch-event kernels S3-S5: (the reference loop each replaces, bytes a
# lane-request: each input read once, each output written once)
EVENT_KERNELS = {
    "multibin_scan": ("src/repro/core/fastsim.py:476 (_multibin_loop, a "
                      "lax.while_loop; no Pallas kernel)", 8 + 8 + 8 + 8 + 1),
    "wait_scan": ("src/repro/core/fastsim.py:580 (_wait_loop, a "
                  "lax.while_loop; no Pallas kernel)", 8 + 8 + 8 + 1),
    "srpt_scan": ("src/repro/core/fastsim.py:654 (_srpt_core, a "
                  "lax.while_loop; no Pallas kernel)", 8 + 8 + 8 + 8 + 1),
}


def check_event_cells(g, dev):
    """Every S3-S5 cell of the grid's counted launches, at full length:
    its starts and batch heads against the plain version on the card on
    the same inputs, and its waits and mean batch against the NumPy oracle
    (host CPU); then each kernel timed by CUDA events on the same inputs.
    Returns the kernels' JSON entries (the λ = 1 cell's times)."""
    import importlib
    import torch
    from repro_torch.core.simulate import no_warmup, simulate_policy
    by_kernel = {}
    for (name, li), cell in sorted(g["scan"]["cells"].items()):
        kern, args = cell["kernel"], cell["args"]
        mod = importlib.import_module(f"repro_torch.kernels.{kern}")
        fn, ref = getattr(mod, kern), getattr(mod, f"{kern}_reference")
        starts, first = cell["out"]
        (ref_s, ref_f), plain_ms = wall_ms(lambda: ref(*args))
        assert torch.equal(starts, ref_s) and torch.equal(first, ref_f), \
            f"{kern} differs from its plain version at {name}, λ index {li}"
        lam, pol = g["lams"][li], g["policies"][name]
        c0 = time.process_time()
        with no_warmup():
            ora = simulate_policy(pol, lam, g["dist"], g["lat"],
                                  num_requests=g["n"], seed=g["seed"])
        cpu_s = time.process_time() - c0
        arr = args[0][:, 0].cpu().numpy()
        nb = int(first.sum())
        assert np.array_equal(starts[:, 0].cpu().numpy() - arr,
                              ora["waits"]), f"{name} λ={lam}: oracle differs"
        assert g["n"] / nb == ora["mean_batch"], (name, lam)
        ms = event_ms(lambda: fn(*args))
        n = g["n"]
        _, nbytes = EVENT_KERNELS[kern]
        bnd = bound_ms(nbytes * n, 0, "float64")
        log(f"{kern} {name} λ={lam}: {nb} batches (mean {n / nb:.3f}); "
            f"{ms:.3f} ms by CUDA events ({1e6 * ms / n:.1f} ns a request), "
            f"bound {bnd:.5f} ms (bytes, {nbytes * n / 1e6:.2f} MB; "
            f"{100 * bnd / ms:.3f}% of it); plain {plain_ms:.1f} ms; starts "
            f"and batch heads equal the plain version's, waits and mean "
            f"batch equal the oracle's (oracle {cpu_s:.2f} s of host CPU)")
        by_kernel.setdefault(kern, []).append(
            {"cell": f"{name} λ={lam}", "batches": nb, "ms": ms,
             "ns_per_request": 1e6 * ms / n, "plain_ms": plain_ms,
             "bound_ms": bnd})
    out = []
    for kern, rows in by_kernel.items():
        last = rows[-1]               # the λ = 1 cell of the last policy
        out.append({"name": kern, "route": "cuda",
                    "source": f"src/repro_torch/kernels/{kern}/csrc/{kern}.cu",
                    "replaces": EVENT_KERNELS[kern][0],
                    "shape": [g["n"], 1], "max_abs_err": 0.0,
                    "ms": last["ms"], "plain_ms": last["plain_ms"],
                    "bound_ms": last["bound_ms"], "bound_by": "bytes",
                    "library_ms": None, "cells": rows})
    return out


def run_simulators(dev, cal):
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.bulk import elastic_batching_bound
    from repro_torch.core.distributions import LogNormalTokens, UniformTokens
    from repro_torch.core.fastsim import simulate_policy_fast
    from repro_torch.core.latency_model import (
        PAPER_A100_LLAMA2_7B, BatchLatencyModel)
    from repro_torch.core.bulk import optimize_bin_edges
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, FCFSPolicy, FixedPolicy, MultiBinPolicy,
        SRPTPolicy, WaitPolicy)
    from repro_torch.core.simulate import _warm, no_warmup, simulate_policy
    from repro_torch.kernels.impatience_scan import (
        impatience_scan, impatience_scan_reference)

    pols = {"dynamic": DynamicPolicy(), "dynamic_b8": DynamicPolicy(b_max=8),
            "elastic": ElasticPolicy(), "elastic_b8": ElasticPolicy(b_max=8),
            "fixed_b4": FixedPolicy(b=4), "fixed_b8": FixedPolicy(b=8)}
    scan_pols = {k: v for k, v in pols.items() if v.scan_lane() is not None}
    uni, ln = UniformTokens(1000), LogNormalTokens(7.0, 0.7)
    lat5 = BatchLatencyModel(0.05, 0.5, 0.0005, 0.02)
    lat6 = BatchLatencyModel(0.05, 0.5, 2e-4, 0.002)
    # elastic batching without a cap is the fastest policy here: it
    # saturates at 1 / (k1 + k3 E[N]) (Eq 26's slope)
    sat6 = 1.0 / elastic_batching_bound(ln, lat6, 1.0)["alpha"]
    lat_fit = fit_engine_latency(cal)
    mu16 = float(lat_fit.service_rate(uni, 16)[0])
    fcfs_cells = [(n_max, tau) for n_max in (None, 1600)
                  for tau in (30.0, 120.0, None)]
    # the reference benchmark's heavy-tail grid
    # (benchmarks/bench_batching_policies.py, multi-bin and PR 3 parts)
    ht_edges = tuple(float(e) for e in optimize_bin_edges(ln, lat6, 1.0,
                                                          num_bins=4))
    ht_pols = {"dyn": DynamicPolicy(), "dyn_b32": DynamicPolicy(b_max=32),
               "dyn_b16": DynamicPolicy(b_max=16), "ela": ElasticPolicy(),
               "multibin4": MultiBinPolicy(num_bins=4),
               "multibin4_opt": MultiBinPolicy(edges=ht_edges),
               "wait_k16": WaitPolicy(k=16), "srpt_b16": SRPTPolicy(b_max=16)}

    # the main path, counted: four sweeps and the Fig 4 cells
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fig5 = _sim_grid("Fig 5 (uniform 0..1000, k = 0.05, 0.5, 5e-4, 0.02)",
                     uni, lat5, np.geomspace(0.05, 0.8, 16), pols, dev)
    fig6 = _sim_grid("Fig 6b (lognormal(7, 0.7), k = 0.05, 0.5, 2e-4, "
                     f"0.002; elastic saturates at {sat6:.4f}/s)", ln, lat6,
                     np.geomspace(0.05, 0.9 * sat6, 16), pols, dev)
    fit = _sim_grid(f"fitted law (λ 10%-90% of mu[16] = {mu16:.4f}/s)", uni,
                    lat_fit, np.linspace(0.1, 0.9, 9) * mu16, scan_pols, dev)
    heavy = _sim_grid(f"heavy tail (lognormal(7, 0.7), Fig 6b constants, "
                      f"{HT_N} requests, seed {HT_SEED}; multibin4_opt "
                      f"edges {ht_edges})", ln, lat6, [0.5, 1.0], ht_pols,
                      dev, n=HT_N, seed=HT_SEED)
    fig4 = {}
    for n_max, tau in fcfs_cells:
        fig4[n_max, tau] = simulate_policy_fast(
            FCFSPolicy(n_max=n_max, tau=tau), 1 / 40, ln, PAPER_A100_LLAMA2_7B,
            num_requests=FIG4_N, device=dev)
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert launches == {**launches, "batch_scan": 4, "impatience_scan": 4,
                        "multibin_scan": 4, "wait_scan": 2,
                        "srpt_scan": 2}, launches
    log(f"simulators: main path {main_wall:.2f} s wall (the heavy-tail "
        f"sweep {heavy['wall']:.2f} s), launches {launches}")
    for g in (fig5, fig6):
        _print_grid(g, pols)
    _print_grid(fit, scan_pols)
    _print_grid(heavy, ht_pols)
    # the reference benchmark's own relations at λ = 1
    hw = {name: heavy["waits"][name][1] for name in ht_pols}
    assert hw["srpt_b16"] < 0.1 * hw["dyn_b16"], hw
    assert hw["multibin4"] < 0.1 * hw["dyn"], hw
    assert hw["multibin4"] < 0.1 * hw["dyn_b32"], hw
    assert hw["multibin4_opt"] < 1.02 * hw["multibin4"], hw
    log(f"heavy tail at λ = 1: srpt_b16 {hw['srpt_b16']:.3f} < 0.1 x dyn_b16 "
        f"{hw['dyn_b16']:.3f}; multibin4 {hw['multibin4']:.3f} < 0.1 x dyn "
        f"{hw['dyn']:.3f} and 0.1 x dyn_b32 {hw['dyn_b32']:.3f}; "
        f"multibin4_opt {hw['multibin4_opt']:.3f} < 1.02 x multibin4")
    for (n_max, tau), r in fig4.items():
        pol = FCFSPolicy(n_max=n_max, tau=tau)
        a = pol.analytic_delay(1 / 40, ln, PAPER_A100_LLAMA2_7B)
        log(f"Fig 4 FCFS λ=1/40 n_max={n_max} tau={tau} "
            f"({'S2' if tau else 'closed form'}): mean wait {r['mean_wait']:.3f}"
            f" s (analytic {a:.3f}), loss {r['loss_frac']:.4f}")

    # four lanes of the counted Fig 5 launch at full length against the
    # NumPy oracle (host CPU)
    scan = fig5["scan"]
    col = {(name, li): c for c, (name, li, _, _) in enumerate(scan["lanes"])}
    last = len(fig5["lams"]) - 1
    for name in ("dynamic", "elastic"):
        for li in (0, last):
            lam, c = fig5["lams"][li], col[name, li]
            c0 = time.process_time()
            with no_warmup():
                ora = simulate_policy(pols[name], lam, uni, lat5,
                                      num_requests=SIM_N)
            cpu_s = time.process_time() - c0
            assert np.array_equal(scan["starts"][:, c] - scan["arr"][:, c],
                                  ora["waits"]), \
                f"{name} at λ={lam}: card and oracle waits differ"
            assert SIM_N / scan["closed"][:, c].sum() == ora["mean_batch"]
            log(f"oracle check {name} λ={lam:.4f}: {SIM_N} waits of the "
                f"counted launch equal bit for bit, mean batch "
                f"{ora['mean_batch']:.4f} equal; the oracle took {cpu_s:.2f} "
                f"s of host CPU time")
    for (n_max, tau), r in fig4.items():
        ora = simulate_policy(FCFSPolicy(n_max=n_max, tau=tau), 1 / 40, ln,
                              PAPER_A100_LLAMA2_7B, num_requests=FIG4_N)
        assert np.array_equal(r["waits"], ora["waits"]), (n_max, tau)
    log(f"Fig 4: all {len(fig4)} FCFS cells' {FIG4_N} waits equal the oracle's")

    # S1: every lane of the three counted launches against the plain
    # version on the card, at full length
    rows = [check_batch_scan(g, dev) for g in (fig5, fig6, fit, heavy)]
    lanes, n, ms, plain_ms, bnd = rows[0]
    s1 = {"name": "batch_scan", "route": "cuda",
          "source": "src/repro_torch/kernels/batch_scan/csrc/batch_scan.cu",
          "replaces": "src/repro/core/fastsim.py:300 (_batching_core, a "
                      "lax.scan; no Pallas kernel)",
          "shape": [n, lanes], "max_abs_err": 0.0, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": "bytes",
          "library_ms": None}

    # S2: each impatient Fig 4 cell at the main path's shape [FIG4_N, 1],
    # against the plain version run once over the four cells as lanes and
    # against the counted launch's waits
    cells = [(n_max, tau) for n_max, tau in fcfs_cells if tau is not None]
    inter, service = [], []
    for n_max, tau in cells:
        wl = FCFSPolicy(n_max=n_max, tau=tau).sample_workload(
            1 / 40, ln, FIG4_N, 0)
        inter.append(wl.inter)
        service.append(PAPER_A100_LLAMA2_7B.service_time(wl.tokens))
    inter = torch.from_numpy(np.stack(inter, axis=1)).to(dev)
    service = torch.from_numpy(np.stack(service, axis=1)).to(dev)
    tau = torch.tensor([t for _, t in cells], dtype=torch.float64, device=dev)
    (rw, rl), plain_ms = wall_ms(
        lambda: impatience_scan_reference(inter, service, tau))
    for j, cell in enumerate(cells):
        w, lost = impatience_scan(inter[:, j:j + 1], service[:, j:j + 1],
                                  tau[j:j + 1])
        assert torch.equal(w[:, 0], rw[:, j]) and \
            torch.equal(lost[:, 0], rl[:, j]), \
            f"impatience_scan differs from its plain version at {cell}"
        assert np.array_equal(_warm(w[:, 0].cpu().numpy()), fig4[cell]["waits"])
    one = (inter[:, :1].contiguous(), service[:, :1].contiguous(), tau[:1])
    ms1 = event_ms(lambda: impatience_scan(*one))
    ms = event_ms(lambda: impatience_scan(inter, service, tau))
    lanes = len(cells)
    nbytes = lanes * FIG4_N * (8 + 8 + 8 + 1) + lanes * 8
    bnd = bound_ms(nbytes, 3 * lanes * FIG4_N, "float64")
    log(f"S2 impatience_scan {lanes} lanes x {FIG4_N}: {ms:.3f} ms by CUDA "
        f"events ({lanes * FIG4_N / ms / 1e6:.3f} G lane-requests/s), bound "
        f"{bnd:.4f} ms (bytes; {100 * bnd / ms:.2f}% of it), plain "
        f"{plain_ms:.1f} ms; 1 lane (the main path's launch) {ms1:.3f} ms; "
        f"each cell's launch at [{FIG4_N}, 1] equals the plain version's "
        f"lane at full length and the counted launch's waits")
    s2 = {"name": "impatience_scan", "route": "cuda",
          "source": "src/repro_torch/kernels/impatience_scan/csrc/"
                    "impatience_scan.cu",
          "replaces": "src/repro/core/fastsim.py:224 (_impatience_scan, a "
                      "lax.scan; no Pallas kernel)",
          "shape": [FIG4_N, lanes], "max_abs_err": 0.0, "ms": ms,
          "ms_one_lane": ms1, "plain_ms": plain_ms, "bound_ms": bnd,
          "bound_by": "bytes", "library_ms": None}
    return launches, [s1, s2] + check_event_cells(heavy, dev)


# ----------------------------------------------------------------------------
# Phase 8b: the fleet, predictor and fault simulators
# ----------------------------------------------------------------------------

FLEET_N, FLEET_SEED = 40_000, 3      # benchmarks/bench_fleet.py
NOISE_N, NOISE_SEED = 30_000, 15     # benchmarks/bench_predictors.py
FAULT_N, FAULT_SEED = 5_000, 3       # benchmarks/bench_faults.py
S6_REPLACES = ("src/repro/core/fastsim.py:1076 (_backlog_scan) and :1112 "
               "(_masked_backlog_scan), lax.scans; no Pallas kernel")


def reference_record():
    """The reference's CPU benchmark record (the JAX package on the CPU; the
    shapes to reproduce, not speeds)."""
    path = ROOT / "benchmarks" / "BENCH_simulators.json"
    rec = json.loads(path.read_text())
    return rec["pr4_predictors"], rec["pr5_fleet"], rec["pr6_faults"]


def check_backlog_launches(launches, dev):
    """Every S6 launch of the counted path, at full length: its ids against
    the plain version on the card (the launches of one shape and mask kind
    stacked as lanes of one plain call) and against the NumPy recursion on
    the host; then each launch timed by CUDA events on its own inputs.
    ``launches``: {label: the launch_out dict}.  Returns the JSON entry."""
    import torch
    from repro_torch.core.fleet import (
        _backlog_assign_np, _masked_backlog_assign_np)
    from repro_torch.kernels.backlog_scan import (
        backlog_scan, backlog_scan_reference)
    groups = {}
    for label, lo in launches.items():
        arr, work, R, *up = lo["args"]
        groups.setdefault((R, arr.shape[0], bool(up)), []).append(label)
    plain_s = 0.0
    for (R, n, masked), labels in groups.items():
        cat = [torch.cat([launches[x]["args"][i] for x in labels], dim=-1)
               for i in ((0, 1, 3) if masked else (0, 1))]
        ref, ms = wall_ms(lambda: backlog_scan_reference(
            cat[0], cat[1], R, cat[2] if masked else None))
        plain_s += ms / 1e3
        for j, label in enumerate(labels):
            lo = launches[label]
            out = lo["out"]
            assert torch.equal(out[:, 0], ref[:, j]), \
                f"S6 {label}: kernel differs from its plain version"
            a, w = (lo["args"][i][:, 0].cpu().numpy() for i in (0, 1))
            host = (_masked_backlog_assign_np(
                a, w, R, lo["args"][3][:, :, 0].cpu().numpy().astype(bool))
                if masked else _backlog_assign_np(a, w, R))
            assert np.array_equal(out[:, 0].cpu().numpy(), host), \
                f"S6 {label}: kernel differs from the NumPy recursion"
    log(f"S6: all {len(launches)} counted launches' ids equal the plain "
        f"version on the card ({len(groups)} stacked calls, {plain_s:.1f} s) "
        f"and the NumPy recursion on the host, at full length")
    rows = {}
    for label, lo in launches.items():
        arr, work, R, *up = lo["args"]
        n = arr.shape[0]
        ms = event_ms(lambda: backlog_scan(*lo["args"]), iters=5)
        nbytes = n * (8 + 8 + 8) + (n * R if up else 0)
        bnd = bound_ms(nbytes, 0, "float64")
        rows[label] = dict(R=R, n=n, masked=bool(up), ms=ms,
                           ns_per_request=1e6 * ms / n, bound_ms=bnd)
        log(f"S6 backlog_scan {label}: R={R}{' masked' if up else ''}, "
            f"[{n}, 1]: {ms:.3f} ms by CUDA events "
            f"({1e6 * ms / n:.1f} ns a request), bound {bnd:.5f} ms (bytes, "
            f"{nbytes / 1e6:.2f} MB; {100 * bnd / ms:.4f}% of it)")
    timed = "routers least_work"
    lo = launches[timed]
    _, plain_ms = wall_ms(lambda: backlog_scan_reference(*lo["args"]))
    return {"name": "backlog_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/backlog_scan/csrc/"
                      "backlog_scan.cu",
            "replaces": S6_REPLACES, "shape": [rows[timed]["n"], 1],
            "max_abs_err": 0.0, "ms": rows[timed]["ms"], "plain_ms": plain_ms,
            "bound_ms": rows[timed]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "launch_rows": rows}


def run_fleet_sims(dev):
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.bulk import breakdown_wait
    from repro_torch.core.distributions import LogNormalTokens, UniformTokens
    from repro_torch.core.fastsim import (
        simulate_fleet_fast, simulate_policy_fast, sweep_noise)
    from repro_torch.core.faults import CrashRepair, simulate_fleet_faulty
    from repro_torch.core.fleet import (
        LeastWorkRouter, default_routers, fleet_analytic_delay,
        mgr_whitt_wait, route_oracle, sweep)
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        DynamicPolicy, FCFSPolicy, MultiBinPolicy, SRPTPolicy, WaitPolicy,
        single_from_batch)
    from repro_torch.core.predictors import LogNormalNoisePredictor
    from repro_torch.kernels.srpt_scan import srpt_scan, srpt_scan_reference
    r4, r5, r6 = reference_record()
    uni, ln = UniformTokens(1000), LogNormalTokens(7.0, 0.7)
    lat5 = BatchLatencyModel(0.05, 0.5, 0.0005, 0.02)
    ht = BatchLatencyModel(0.05, 0.5, 2e-4, 0.002)
    s6, fleet_kw = {}, dict(num_requests=FLEET_N, seed=FLEET_SEED, device=dev)
    noise_lams, sigmas = [0.6, 1.0], [0.0, 0.25, 0.5, 1.0, 1.5]
    crash_cells = [(400.0, 5.0), (200.0, 10.0), (100.0, 15.0), (60.0, 20.0)]

    def noise_factory(make):
        return lambda s: make(LogNormalNoisePredictor(s))

    # the main path, counted
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # (a) the replica-count scaling curve (jsq, capped dynamic replicas)
    got = {}
    scal = sweep([1, 2, 4, 8], [0.8], "jsq", DynamicPolicy(b_max=8), uni,
                 lat5, launch_out=got, **fleet_kw)["mean_wait"][:, 0]
    s6.update({f"scaling R={R}": lo for (R, _), lo in got.items()})
    # (b) jsq + FCFS against the QNA approximation and the pooled floor
    got = {}
    fcfs_sim = simulate_fleet_fast("jsq", FCFSPolicy(), 0.25, 3, uni, lat5,
                                   launch_out=got, **fleet_kw)["mean_wait"]
    s6["jsq+fcfs"] = got
    # (c) every default router at the heavy-tail point, then least_work's
    # predictor noise
    routers = {}
    for name, router in default_routers().items():
        got = {}
        routers[name] = simulate_fleet_fast(router, SRPTPolicy(b_max=16), 1.6,
                                            4, ln, ht, launch_out=got,
                                            **fleet_kw)
        if got:
            s6[f"routers {name}"] = got
    noise = {}
    for sg in [0.0, 0.5, 1.0, 2.0]:
        got = {}
        noise[sg] = simulate_fleet_fast(
            LeastWorkRouter(predictor=LogNormalNoisePredictor(sg)),
            SRPTPolicy(b_max=16), 1.6, 4, ln, ht, launch_out=got,
            **fleet_kw)["mean_wait"]
        s6[f"least_work sigma={sg}"] = got
    # (d) the (lambda, sigma) plane: SRPT as one S5 launch of 10 lanes,
    # multi-bin and WAIT a cell at a time
    s5_before = K.LAUNCHES["srpt_scan"]
    s5 = {}
    t_noise = time.perf_counter()
    grids = {"srpt_b16": sweep_noise(
        noise_factory(lambda p: SRPTPolicy(b_max=16, predictor=p)),
        noise_lams, sigmas, ln, ht, num_requests=NOISE_N, seed=NOISE_SEED,
        device=dev, launch_out=s5)["mean_wait"]}
    t_noise = time.perf_counter() - t_noise
    assert K.LAUNCHES["srpt_scan"] == s5_before + 1, "SRPT cells not one launch"
    for name, make in (("multibin4", lambda p: MultiBinPolicy(
            num_bins=4, predictor=p)),
            ("wait_k16", lambda p: WaitPolicy(k=16, predictor=p))):
        grids[name] = sweep_noise(noise_factory(make), noise_lams, sigmas, ln,
                                  ht, num_requests=NOISE_N, seed=NOISE_SEED,
                                  device=dev)["mean_wait"]
    # (e) crash faults on a least_work fleet, masked S6
    crash = {}
    for mtbf, mttr in crash_cells:
        got = {}
        crash[mtbf, mttr] = simulate_fleet_faulty(
            "least_work", DynamicPolicy(16), 4.0, 3, ln, lat5,
            CrashRepair(mtbf=mtbf, mttr=mttr), num_requests=FAULT_N,
            seed=FAULT_SEED, fast=True, device=dev, launch_out=got)
        s6[f"crash {mtbf:g}/{mttr:g}"] = got
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert launches["backlog_scan"] == len(s6) == 14, (launches, sorted(s6))
    log(f"fleet simulators: main path {main_wall:.2f} s wall (the SRPT noise "
        f"plane {t_noise:.2f} s), launches {launches}")

    # the relations, each figure beside the reference's CPU record
    log(f"(a) jsq + dynamic b8, uniform, lambda 0.8, {FLEET_N} requests: mean "
        f"wait by R " + ", ".join(
            f"R={R} {w:.3f} (ref {r5['scaling_mean_wait'][str(R)]:.3f})"
            for R, w in zip([1, 2, 4, 8], scal)))
    assert (np.diff(scal) < 0).all(), f"delay must fall with R: {scal}"
    single = single_from_batch(lat5)
    es, es2 = single.moments(uni, None)
    floor = mgr_whitt_wait(0.25, 3, es, es2)
    qna = fleet_analytic_delay("jsq", FCFSPolicy(), 0.25, 3, uni, lat5)
    rc = r5["jsq_fcfs_analytic_cell"]
    log(f"(b) jsq + FCFS, lambda 0.25, R=3: sim {fcfs_sim:.3f} (ref "
        f"{rc['sim']:.3f}), QNA {qna:.3f} (ref {rc['qna_approx']:.3f}), "
        f"pooled M/G/R floor {floor:.3f} (ref {rc['mgr_pooled_floor']:.3f})")
    assert floor < fcfs_sim
    rw = {k: v["mean_wait"] for k, v in routers.items()}
    log(f"(c) SRPT b16 replicas, lognormal(7, 0.7), lambda 1.6, R=4: " +
        ", ".join(f"{k} {v:.4f} (ref {r5['router_mean_wait_ht'][k]:.4f})"
                  for k, v in rw.items()))
    assert rw["least_work"] < min(v for k, v in rw.items()
                                  if k != "least_work"), rw
    log("    least_work with lognormal_noise(sigma): " + ", ".join(
        f"{sg} {w:.4f} (ref {rv:.4f})" for (sg, w), rv in zip(
            noise.items(), r5["least_work_noise"]["mean_wait"])))
    assert noise[0.0] == rw["least_work"], (noise[0.0], rw["least_work"])
    ref_n = re.search(r"(\d+) requests", r4["workload"]).group(1)
    for name, g in grids.items():
        ref = r4[f"{name}_mean_wait"]
        for li, lam in enumerate(noise_lams):
            log(f"(d) {name} lambda {lam}: mean wait by sigma {sigmas}: "
                f"{[round(float(x), 3) for x in g[li]]} (ref at {ref_n} "
                f"requests: "
                f"{[round(x, 3) for x in ref[li]]})")
    for (mtbf, mttr), res in crash.items():
        assert (res["n_served"] + res["shed"] + res["failed"]
                + res["unserved"] == res["n_arrived"]), (mtbf, mttr)
        env = breakdown_wait(ln, lat5, 4.0, mtbf, mttr, R=3,
                             policy=DynamicPolicy(16))
        ref = next(c for c in r6["crash_grid"] if c["mtbf"] == mtbf)
        log(f"(e) crash mtbf {mtbf:g} mttr {mttr:g}: mean wait "
            f"{res['mean_wait']:.4f} (ref {ref['mean_wait']:.4f}), p99 "
            f"{res['p99_wait']:.4f}, retries {res['retries']} (ref "
            f"{ref['retries']}), failed {res['failed']}, served "
            f"{res['n_served']}/{res['n_arrived']}; breakdown_wait envelope "
            f"{env['wait']:.4f} (ref {ref['envelope_wait']:.4f})")
    log(f"reference record sizes: {r4['workload']}; {r5['workload']}; "
        f"{r6['workload']}")

    # equality checks, outside the counted path
    for label in ("scaling R=4", "routers jsq", "routers least_work"):
        if label.startswith("scaling"):
            ora = route_oracle("jsq", DynamicPolicy(b_max=8), 0.8, 4, uni,
                               lat5, num_requests=FLEET_N, seed=FLEET_SEED)
            fast = simulate_fleet_fast("jsq", DynamicPolicy(b_max=8), 0.8, 4,
                                       uni, lat5, **fleet_kw)
            assert fast["mean_wait"] == scal[2]
        else:
            name = label.split()[1]
            ora = route_oracle(name, SRPTPolicy(b_max=16), 1.6, 4, ln, ht,
                               num_requests=FLEET_N, seed=FLEET_SEED)
            fast = routers[name]
        assert np.array_equal(ora["replica_of"], fast["replica_of"]), label
        for a, b in zip(ora["per_replica"], fast["per_replica"]):
            assert np.array_equal(a["waits"], b["waits"]), label
        assert ora["mean_wait"] == fast["mean_wait"], label
        log(f"oracle check {label}: the route_oracle's split and every "
            f"replica's waits equal the card's")
    for name, make in (("srpt_b16", lambda: SRPTPolicy(b_max=16)),
                       ("multibin4", lambda: MultiBinPolicy(num_bins=4))):
        for li, lam in enumerate(noise_lams):
            ref = simulate_policy_fast(make(), lam, ln, ht,
                                       num_requests=NOISE_N, seed=NOISE_SEED,
                                       device=dev)["mean_wait"]
            assert grids[name][li, 0] == ref, (name, lam)
    log("(d) the sigma = 0 columns equal simulate_policy_fast with the "
        "oracle policy exactly (srpt_b16, multibin4)")
    (ref_s, ref_f), plain_ms = wall_ms(lambda: srpt_scan_reference(
        *s5["args"]))
    starts, first = s5["out"]
    assert torch.equal(starts, ref_s) and torch.equal(first, ref_f), \
        "S5 (sweep_noise) differs from its plain version"
    ms = event_ms(lambda: srpt_scan(*s5["args"]))
    n, lanes = starts.shape
    log(f"S5 srpt_scan, sweep_noise's one launch of {lanes} lanes x {n}: "
        f"{ms:.3f} ms by CUDA events ({1e6 * ms / (n * lanes):.1f} ns a "
        f"lane-request), all lanes equal the plain version's at full length "
        f"(plain {plain_ms:.1f} ms)")
    noise_s5 = {"lanes": lanes, "n": n, "ms": ms, "plain_ms": plain_ms}
    return launches, check_backlog_launches(s6, dev), noise_s5


def main() -> int:
    t_start = time.perf_counter()
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
    for name in ("flash_attention", "ragged_decode_attention", "batch_scan",
                 "impatience_scan", "multibin_scan", "wait_scan", "srpt_scan",
                 "backlog_scan"):
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
    from repro_torch.data.pipeline import make_request_stream
    reqs = make_request_stream(32, 4.0, ClippedLogNormal(np.log(96.0), 0.8, 512),
                               vocab=cfg.vocab_size, prompt_len_range=(16, 257),
                               seed=0)
    t0 = time.perf_counter()
    paths = {"serving schedule": serve_full(engine, reqs)}
    log(f"phase 4 (serving schedule) took {time.perf_counter() - t0:.1f} s")
    cal = engine.calibration_log()          # phase 4's measurements (M4)
    paths["continuous"] = serve_cont(engine, reqs)
    from repro_torch.core.traffic import MMPPTraffic
    fleet_reqs = make_request_stream(
        32, 4.0, ClippedLogNormal(np.log(96.0), 0.8, 512), vocab=cfg.vocab_size,
        prompt_len_range=(16, 257), seed=0,
        traffic=MMPPTraffic(rates=(0.5, 2.0), mean_dwell=(200.0, 100.0)))
    t0 = time.perf_counter()
    paths["fleet serving"] = serve_fleet(engine, fleet_reqs)
    log(f"phase 8a (fleet serving) took {time.perf_counter() - t0:.1f} s")
    del engine
    torch.cuda.empty_cache()
    paths["launcher"] = serve_launcher(dev)
    t0 = time.perf_counter()
    paths["simulators"], sim_kernels = run_simulators(dev, cal)
    log(f"phase 7 (simulators) took {time.perf_counter() - t0:.1f} s")
    kernels += sim_kernels
    t0 = time.perf_counter()
    paths["fleet simulators"], s6, noise_s5 = run_fleet_sims(dev)
    log(f"phase 8b (fleet simulators) took {time.perf_counter() - t0:.1f} s")
    kernels.append(s6)
    next(k for k in kernels if k["name"] == "srpt_scan")["sweep_noise"] = \
        noise_s5
    for k in kernels:
        k["launches_by_path"] = {p: n.get(k["name"], 0)
                                 for p, n in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        assert k["launches"] > 0, f"{k['name']} never ran on a path"
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
