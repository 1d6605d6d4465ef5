#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the fifteen hand-written kernel sources (K3's, K4's and S8's
     backward among them) from ``src/repro_torch/kernels/*/csrc`` with
     nvcc into ``build/kernels/``, one nvcc per source, all started
     together, and print the registers, shared memory and spills ptxas
     reports for the two attention kernels, K4, the three backward
     sources, the seven simulator kernels and S8;
  2. hold each serving kernel against its plain PyTorch version on the card, at the
     shapes qwen2.5-3b serving gives it (K1 and K3 also at the (G, D)
     instances of internlm2-1.8b, gemma-7b, mixtral-8x7b,
     moonshot-v1-16b-a3b and musicgen-large, K1 at llama-3.2-vision-90b's
     cross-attention shape), and time kernel, plain version, one PyTorch
     library call and the bound (K1 and K3 also at each config's serving
     shape, K1 at S = 1024 for the MoE configs and at the cross-attention
     shape, B = 16, S = 6,400, every length 6,400; K3 also as TFLOP/s and
     share of the bound; K1 with its split count and grid; K4 at T = 1,
     16, 64 and 4096 rows, with and without ``round_sum``); hold S8, the
     SSD's chunk-state scan, bit for bit to its plain version at
     mamba2-2.7b's shapes (B = 16, C = 1 with and without h0; B = 4, C =
     8) and jamba's full mixer (B = 4, C = 8), timed against its bytes
     bound; hold S8b, S8's backward, at mamba2-2.7b's training shape (B =
     2, C = 8) and jamba's mixer (B = 4, C = 8), without and with h0 and
     g_hT, to its plain version (the state gradients bit for bit, the
     chunk-decay gradient within the fp32 summation bound over P*N
     terms), timed by ``busy_ms`` beside the plain version and its bytes
     bound; time K3 at qwen's serving shape without and with the
     log-sum-exp output that training's forward writes (outputs bit-equal);
     hold K3's backward (every (G, D) instance, both dtypes, with and
     without a window, S off a multiple of 64, on views of one projection
     too; the forward's lse held to the plain one) and K4's (one row to
     4,096, an fp32 weight beside bf16 rows too, ``round_sum`` off and on)
     to the plain versions' autograd grads and to the plain backwards
     written out as the kernels compute them (``attention_bwd_reference``,
     ``rmsnorm_bwd_reference``), two backward passes bit-equal, and time
     both at phase 9t(c)'s shape (K4's with a bf16 and an fp32 weight), the
     whole call and each of its kernels, beside the plain backward, the
     library's backward (SDPA; ``add`` + ``rms_norm``) and the bound;
  3. check a small fp32 model end to end: the engine on the card (all four
     kernels, decode chunks as CUDA graphs) emits the same greedy tokens as
     the engine on the CPU (plain paths); sampled at a fixed seed, the two
     draw the same noise bits, and the token agreement is printed; then a
     small fp32 MoE model (mixtral's pattern at (G, D) = (4, 128), window
     32 below max_seq, capacity factor 0.5) card against CPU, greedy,
     token for token, with assignments dropped at capacity; then jamba's
     hybrid pattern (attention + MoE, seven Mamba layers) at (G, D) = (4,
     128), card (K1-K4 and S8) against CPU, greedy, token for token,
     through elastic compaction of the K/V, conv and SSM leaves; then
     small fp32 models of llama-3.2-vision-90b's pattern at (4, 128)
     (image embeddings, non-zero gates, through ``prefill(cross_kv=)``,
     decode chunks and compactions of the image K/V), musicgen-large's
     at (1, 64) and qwen's with bhsd caches, card against CPU, greedy;
  4. serve qwen2.5-3b at full width (random bf16 weights from a seed)
     through ``run_engine_schedule`` with elastic, then dynamic batching
     (every bucket that runs replays a graph), then multi-bin (4 bins),
     WAIT (k=8) and SRPT, each capped at the engine's 16 slots, and
     profile one decode chunk at bucket 16 as a graph replay and through
     the eager loop, K4's launches and device ms a step among them;
  6. serve the same request stream with continuous batching
     (``serve_continuous``, 16 slots, chunk 32) on phase 4's engine;
  8a. serve phase 4's stream, made again under MMPP traffic, through two
     routed fleets of R = 2 replicas on phase 4's engine
     (``run_fleet_schedule``): least_work + SRPT with a noisy length
     predictor, and jsq + elastic; each fleet's split must equal
     ``FleetScheduler``'s on a ``ModelClock``;
  8a(c). serve phase 4's stream through a resilient engine fleet on phase
     4's engine (``run_fleet_schedule(..., kill_at=...)``: jsq, dynamic
     b16, R = 3, replica 0 killed at the median arrival): every request
     served once, none started on replica 0 after the kill, the final
     replicas and report equal to ``ResilientFleetScheduler``'s on a
     ``ModelClock`` of the same law;
  4m. serve phase 4's stream under a KV budget of ``KV_BUDGET`` tokens
     (``memory=``): ``run_engine_schedule`` with elastic b16 (K1-K4), then
     ``run_fleet_schedule`` jsq + dynamic b16 with R = 2; every admitted
     batch's real footprint within the budget, requests deferred on the
     single engine, the engine's own KV peak within the budget;
  4d. serve the first 12 requests of phase 4's stream on each of
     internlm2-1.8b ((G, D) = (2, 128)), yi-9b ((8, 128)) and gemma-7b
     ((1, 256), GeGLU, scaled embeddings) at full width and 6 layers
     each (``FAMILY_LAYERS``, as in 4e, 4s and musicgen's 4v), random bf16
     weights made on the card, phase 4's engine settings,
     ``run_engine_schedule`` with elastic b16 (K1-K4 on decode graphs):
     batches, waits, decode ms a step by bucket, prefill ms, host syncs,
     launches and peak memory per model, each engine freed before the
     next;
  4e. after phase 4's engine is freed, serve the same 12 requests on
     mixtral-8x7b and moonshot-v1-16b-a3b at 6 layers (full layer
     width), random bf16 weights made on the card, phase 4's engine settings with
     max_seq 1024, elastic b16 (K1-K4; the MoE FFN is plain PyTorch, as
     the reference's is plain jnp): the same figures as 4d, each engine's
     peak device memory under 75 GiB;
  4s. after phase 4e, serve the same 12 requests on mamba2-2.7b at 6 of
     its 64 Mamba2 layers (d_model 2,560, 80 SSM heads of 64 x 128), random
     bf16 weights made on the card), phase 4's engine settings,
     elastic b16 (S8 in every prefill, K2 and K4; the Mamba decode update
     is plain PyTorch in the decode graphs, as the reference's is plain
     jnp): the figures of 4d, the bucket-16 decode step beside its floor
     (the bf16 weights' read and the SSM state's read and write), one
     decode chunk of 8 steps at bucket 16 profiled by kind of kernel, and
     one long prefill of 4 prompts of 2,048 tokens (S8 at C = 8), timed;
  4v. after phase 4s, serve the same 12 requests on musicgen-large at 6
     of its 48 layers (32/32 heads of 64, sinusoidal positions), as 4e
     (K1-K4, K1 and K3 at (1, 64)), its bucket-16 step beside the
     floor of its weights' read; then llama-3.2-vision-90b at 4 of its 20
     groups (16 self- and 4 cross-attention layers, full layer width,
     19.21 B params, random bf16 weights made on the card with every gate
     non-zero): one ``prefill(cross_kv=)`` of phase 4's first 16 prompts
     with random bf16 patch embeddings [16, 6,400, 8,192] on the engine's
     own bucket-16 cache (K3, K4), decode chunks of 32 steps as graph
     replays (K1 on the self- and the cross-attention), one compaction 16
     -> 8 (K2, the image K/V included): decode ms a step by bucket
     against the weights' and image K/V's read, the prefill's ms, the
     peak (under 75 GiB), no non-finite logits;
  9t. after phase 4v, on freed memory, train (``repro_torch.training``,
     K3 and K4 forward and backward): (a) qwen2.5-3b's smoke config at 2
     layers with 16 / 2 heads of 128, three fp32 AdamW steps on the card
     and on the CPU from the same params and batches, remat off and on,
     losses, grad norms and params held to each other; (b) the training
     launcher ``repro_torch.launch.train`` on that model, 12 steps, a
     checkpoint every 4 under ``build/``, a failure injected at step 6:
     restored at step 4 and data index 4, the last loss below the first;
     (c) qwen2.5-3b at full width (36 layers, remat, random weights made
     on the card), 4 x 512 tokens a step, 4 steps with fp32 params, then
     4 with bf16 params, fp32 moments both: ms a step, peak (under 75
     GiB), losses (finite), and each training kernel's launches and
     device ms a step (and by kernel name) beside the device ms outside
     them;
  9t(m). then train the state-space models (S8 and S8b with K4 and K4b;
     K3 and K3b in jamba's attention position): (a) mamba2-2.7b's smoke
     config and phase 3's small jamba, three fp32 AdamW steps and the
     step-0 gradients on the card and on the CPU from the same params and
     batches (8 x 64 tokens, two chunks of 32), remat off and on, held to
     9t(a)'s tolerances; (b) the training launcher on mamba2's smoke
     config, 8 steps, a checkpoint every 4, a failure injected at step 5:
     restored at step 4 and data index 4, the last loss below the first;
     (c) mamba2-2.7b whole (64 layers at full width, remat, random fp32
     weights made on the card, fp32 moments), 2 x 2,048 tokens a step (S8
     and S8b at C = 8), 4 steps: the figures of 9t(c), S8 and S8b by
     name;
  5. run the adaptive-control serving launcher
     (``repro_torch.launch.serve.serve``) on qwen2.5-3b at full width;
  7. run the paper's simulators (``repro_torch.core.fastsim``) on the card:
     the Fig 5 and heavy-tail Fig 6b grids (dynamic, elastic, capped and
     not, as 64 lanes of one ``batch_scan`` launch each; fixed b=4, 8 by
     the closed form) and the Fig 4 FCFS cells (a ``sweep`` whose four
     cells with impatience are the lanes of one ``impatience_scan``
     launch; the other two by the closed form), then
     the four scan policies once more on k1..k4 fitted from phase 4's
     engine (ROADMAP M4; a fitted slope below 0 is held at 0), and the
     reference benchmark's heavy-tail grid (dynamic capped at 32, 16 and
     not, elastic: S1 lanes; multi-bin with equal-mass and optimised
     edges: S3; WAIT k=16: S4; SRPT b=16: S5); hold every lane of the
     counted launches, at full length, bit for bit to their plain
     versions (on the card, timed, the heavy tail's S1 launch, the S2
     launch and the λ = 1 cell of each of S3-S5 whose times their entries
     report; the other S1 launches and cells on host processes) and to the NumPy
     oracle (every S1 lane on the launch's inputs, four Fig 5 lanes and
     every S2-S5 cell on the oracle's own sampling), assert the
     benchmark's relations
     at λ = 1, print every lane's mean wait beside the paper's analytic
     delay or envelope, time the kernels against their bytes bound (S1, S2
     and S4 beside their first designs' figures from PERF.md; S2 also
     beside its chain, and S2 and S3 also the kernel alone, without the
     wrapper's layout), and print the device
     time of each S5 launch in the counted path (CUDA events);
  8b. run the reference benchmarks' fleet, predictor and fault grids on
     the card (``fleet.sweep``, ``simulate_fleet_fast``, ``sweep_noise``
     with its SRPT, multi-bin and WAIT cells each as one launch of ten
     lanes, ``simulate_fleet_faulty(fast=True)``), the backlog routers on
     ``backlog_scan`` (S6); assert the benchmarks' relations, print each
     figure beside ``benchmarks/BENCH_simulators.json``, hold every S6
     launch at full length to its plain version (the timed launch's on
     the card, the others' on host processes) and to the NumPy
     recursion, and time S6 (the wrapper and the kernel alone)
     against its bytes bound; hold every lane of the counted S5 launches
     (the noise plane and the 40 fleet replicas' sub-streams), of the S3
     and S4 noise launches and of the 27 S1 launches (the fleet replicas'
     dynamic sub-streams) to their plain versions at full length, and
     every S1 and S4 lane to the NumPy oracle, in a pool of host
     processes; time the S4 noise launch and print each S5 and S1 launch's
     device time in the path (CUDA events) and their totals;
  8f. run the mesh sweeps (``repro_torch.core.shardsweep``) on
     ``cells_mesh()`` and on the card listed twice (two shards, so the
     split and the concatenation run on the card): 8b(a)'s scaling curve
     as ``fleet_sweep`` (one S6 launch a shard, one S1 launch a row-length
     bucket and shard, its launches and wall beside ``fleet.sweep``'s),
     8b(d)'s SRPT plane as ``sweep_noise`` and a 40,000-request (λ,
     policy) sweep, each bit for bit equal to the single-device run; then
     ``compressed_mean_rows`` on a one-rank NCCL group, within the
     reference test's bound of the mean;
  8c. run re-entrant sessions on the card (``repro_torch.core.sessions``,
     the feedback fixed point with a kernel launch a pass): the reference
     record ``pr9_sessions`` (``bench_sessions.py``: router x prefix
     discount on S6 and S1, and the feedback amplification on S1), each
     figure within 1e-9 s of the record and the benchmark's relations
     asserted, then a 4,000-session single-server cell per batch kernel
     (S1, S3, S4, S5) and session model (geometric, chain), each held to
     the NumPy oracle on host processes within 1e-9 s, its passes and
     launches printed, and every launch's device time in the path;
  8d. run the memory-gated tandem on the card (``memory=``; kernel S7,
     ``tandem_scan``): the reference record ``pr10_memory``
     (``bench_memory.py``: the budget sweep, a launch a cell and then the
     nine cells as nine lanes of one launch, the null cells on S1, and the
     control cell's aware and blind recommendations on the tandem oracle),
     every integer equal to the record and every wait within 1e-9 s, then
     one 150,000-request lane and the reference test's least_work fleet
     cell (S6, then one S7 launch of a lane a replica); every cell held to
     the oracle and every S7 launch bit for bit to its plain version on
     host processes, S7 timed by CUDA events (the wrapper and the kernel
     alone) beside its first design, its bytes bound and its modelled
     chain.
  8e. run the closed-loop autoscaler on the card (``run_controlled``: a
     launch of S1 a replica a window): the reference record
     ``pr8_autoscale`` (``bench_autoscale.py`` at full size: the adaptive
     run, the eight static (R, router) rows, the clairvoyant run and the
     four-traffic sweep through ``simulate_fleet_fast``), the replica
     trace and shed equal, every objective and mean wait within 1e-6
     relative, the adaptive objective below the best static one, the
     adaptive run held to the port's oracle on a host process, and every
     S1 launch of the path timed by CUDA events.
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

# the (Hq, Hkv, D) each ported config gives the attention kernels: (G, D) =
# (8, 128) for qwen2.5-3b, yi-9b and llama-3.2-vision-90b, (2, 128) for
# internlm2-1.8b, (1, 256) for gemma-7b, (4, 128) for mixtral-8x7b, (1,
# 128) for moonshot-v1-16b-a3b, (1, 64) for musicgen-large
ATTN_HEADS = {"qwen2.5-3b": (16, 2, 128), "internlm2-1.8b": (16, 8, 128),
              "yi-9b": (32, 4, 128), "gemma-7b": (16, 16, 256),
              "mixtral-8x7b": (32, 8, 128),
              "moonshot-v1-16b-a3b": (16, 16, 128),
              "musicgen-large": (32, 32, 64),
              "llama-3.2-vision-90b": (64, 8, 128)}
VISION_ARCH, AUDIO_ARCH = "llama-3.2-vision-90b", "musicgen-large"
VISION_SEQ = 6400          # llama-3.2-vision-90b's image positions
MOE_ARCHS = ("mixtral-8x7b", "moonshot-v1-16b-a3b")
# the kernels of the model's serving path (the other two are the
# simulators' scans, phase 7)
SERVING_KERNELS = ("ragged_decode_attention", "gather_rows", "flash_attention",
                   "fused_rmsnorm")
# with the Mamba mixer's chunk-state scan (S8): the kernels a model runs
MODEL_KERNELS = SERVING_KERNELS + ("ssd_scan",)


def log(*a):
    print(*a, flush=True)


def timed(label, fn, *args):
    """``fn(*args)``, its wall seconds logged as "``label`` took"."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{label} took {time.perf_counter() - t0:.1f} s")
    return out


# CUPTI has dropped the kernel records of a window's first moments: every
# profiled decode chunk of phase 4 lost its first kernels (the first K4
# launch among them, graph replays and eager loops alike, in every window
# of two runs), as mamba2's chunks lost one of 520 K4 records.  So a window
# opens with MARKERS spin kernels of MARKER_CYCLES each, synchronized, and
# the profile returned leaves their records out.
MARKERS, MARKER_CYCLES = 8, 200_000     # spins of about 0.1 ms each


class _Window:
    """A torch.profiler profile without the opening marker kernels'
    records (``events`` is what the callers read)."""

    def __init__(self, prof):
        self._prof = prof

    def events(self):
        return [e for e in self._prof.events() if "spin_kernel" not in e.name]


def profiled(fn, tries=6):
    """Run ``fn`` under torch.profiler (CPU and CUDA activities) and return
    (profile, fn's result), the profile without the markers the window
    opens with (see MARKERS).  A window in which CUPTI delivered no device
    event at all runs again, after a pause of a second, ``tries`` times at
    most: such windows come in runs on the card (three in a row have been
    seen, in a timing of plain PyTorch ops that other runs pass), so the pause
    gives CUPTI time to deliver before the next window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKERS):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        window = _Window(prof)
        if any(e.device_type == DeviceType.CUDA for e in window.events()):
            return window, out
        log(f"profiler: window {attempt + 1} of {tries} saw no device event; "
            f"again after a pause")
        time.sleep(1.0)
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


def kernel_split(fn, iters=20):
    """Device ms a call of each kernel ``fn`` launches, by name
    (torch.profiler), after one warm call."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    prof, _ = profiled(lambda: [fn() for _ in range(iters)])
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name[:50]
            out[name] = out.get(name, 0.0) + e.device_time / 1e3 / iters
    return out


def fmt(t):
    """A (call, device) pair from ``time_ms`` as text."""
    return f"{t[1]:.4f} ms device ({t[0]:.4f} ms per call)"


def rotating(fn, inputs):
    """``fn`` over ``inputs`` in turn, so each launch reads past the L2."""
    turn = iter(range(10 ** 9))
    return lambda: fn(*inputs[next(turn) % len(inputs)])


SPIN_CYCLES = 10 ** 8      # one spinning thread: about 50 ms at 1,980 MHz


def busy_ms(sides, iters=30, rounds=2):
    """Device ms a call of each of ``sides`` (name -> fn), by CUDA events
    around ``iters`` calls queued behind a spin of the card
    (``torch.cuda._sleep``): the host has queued every call before the
    first one starts, so its launch time is hidden and the card runs the
    calls back to back at its loaded clock.  The sides take turns, A B B A,
    ``rounds`` times in this process.  A reading whose calls were not all
    queued when the spin ended is taken again behind a spin twice as long.
    Returns (name -> the readings, the SM clocks in MHz the spins read)."""
    import torch
    order = list(sides) + list(sides)[::-1]
    out = {n: [] for n in sides}
    clocks = []
    for fn in sides.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name in order:
            cycles = SPIN_CYCLES
            while True:
                s0, s1, e = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
                s0.record()
                torch.cuda._sleep(cycles)
                s1.record()
                for _ in range(iters):
                    sides[name]()
                e.record()
                queued = not s1.query()
                torch.cuda.synchronize()
                if queued:
                    break
                cycles *= 2
            out[name].append(s1.elapsed_time(e) / iters)
            clocks.append(cycles / s0.elapsed_time(s1) / 1e3)
    return out, clocks


def card_clocks():
    """The card's SM and memory clocks and P-state as nvidia-smi reads them
    now (after a timing, the clocks it ended at)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                          "pstate", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout else "not read"


def fmt_busy(readings):
    """Readings of ``busy_ms`` as text: the mean and each reading."""
    return (f"{np.mean(readings):.4f} ms ("
            + ", ".join(f"{t:.4f}" for t in readings) + ")")


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
            gd = re.search(r"(?:ragged_decode|flash_attention|flash_bwd)_\w+?"
                           r"_kernelI(?:13__nv_bfloat16|f)?Li(\d+)ELi(\d+)E",
                           mangled)
            entry += f" G={gd.group(1)} D={gd.group(2)}" if gd else ""
            vpt = re.search(r"fused_rmsnorm_kernelI\w+?Li(\d+)E", mangled)
            entry += f" VPT={vpt.group(1)}" if vpt else ""
            rows = re.search(r"rmsnorm_bwd_rows_kernelI\w+?Li(\d+)E", mangled)
            if rows:    # bf16 rows beside an fp32 weight mangle as "...16fLi"
                entry += (" fp32 weight" if "bfloat16fLi" in mangled else
                          "") + f" VPT={rows.group(1)}"
            rt = re.search(r"backlog_\w+?_kernelILi(\d+)ELb([01])E", mangled)
            entry += (f" RT={rt.group(1)}{' masked' if rt.group(2) == '1' else ''}"
                      if rt else "")
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and entry:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spill}")
            entry = None
    return out


# ----------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ----------------------------------------------------------------------------

def card_generator(dev, rng):
    """A generator on the card seeded from the NumPy ``rng``: the checks'
    inputs are drawn there (drawn on the host, K1's and K3's took 110 s of
    the script on the H100's host)."""
    import torch
    return torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 62)))


def _ragged_checks(dev, rng, hq, hkv, d, label):
    """K1 against its plain version at (Hq, Hkv, D) in bf16 and fp32: B in
    (1, 4, 16) x S in (1024, 2048, 1000) with ragged lengths, stale rows
    never read, two calls bit-equal, every split count up to the chosen
    one.  Returns the largest |kernel - plain| by dtype."""
    import torch
    from repro_torch.kernels.ragged_decode_attention import (
        decode_attention_reference, ragged_decode_attention, split_count)
    from repro_torch.kernels.ragged_decode_attention.ops import _launch
    gen = card_generator(dev, rng)
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        err = 0.0
        for b in (1, 4, 16):
            for s in (1024, 2048, 1000):
                lens = np.linspace(1, s, b).astype(np.int32) if b > 1 \
                    else np.array([s], np.int32)
                q, kc, vc = (torch.randn(shape, generator=gen, device=dev)
                             .to(td) for shape in ((b, hq, d), (b, s, hkv, d),
                                                   (b, s, hkv, d)))
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
        log(f"K1 ragged_decode_attention {label} (G, D) = ({hq // hkv}, {d}) "
            f"{dtype}: max |kernel - plain| = {err:.3e}")
    return max_err


def _ragged_cross_check(dev):
    """K1 at the vision model's cross-attention shape against its plain
    version: 64 / 8 heads of 128, B = 16, S = 6,400, every length 6,400,
    in bf16 and fp32; two calls bit-equal.  Returns the largest |kernel -
    plain| by dtype."""
    import torch
    from repro_torch.kernels.ragged_decode_attention import (
        decode_attention_reference, ragged_decode_attention)
    hq, hkv, d = ATTN_HEADS[VISION_ARCH]
    gen = torch.Generator(device=dev).manual_seed(8)
    ln = torch.full((16,), VISION_SEQ, dtype=torch.int32, device=dev)
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        q = torch.randn(16, hq, d, generator=gen, device=dev).to(td)
        kc, vc = (torch.randn(16, VISION_SEQ, hkv, d, generator=gen,
                              device=dev).to(td) for _ in range(2))
        out = ragged_decode_attention(q, kc, vc, ln)
        ref = decode_attention_reference(q, kc, vc, ln)
        torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
        assert torch.equal(ragged_decode_attention(q, kc, vc, ln), out)
        max_err[dtype] = float((out.float() - ref.float()).abs().max())
        log(f"K1 ragged_decode_attention {VISION_ARCH} cross-attention (G, D) "
            f"= ({hq // hkv}, {d}) B=16 S={VISION_SEQ} every length "
            f"{VISION_SEQ} {dtype}: max |kernel - plain| = "
            f"{max_err[dtype]:.3e}")
        del q, kc, vc, out, ref
    return max_err


def _ragged_timing(dev, lens, hq, hkv, d, label, s=2048, copies=4):
    """K1 at a serving shape: B = len(lens), cache span S, bf16, the given
    lengths; ``copies`` cache copies in rotation so each launch reads past
    the 50 MB L2.  Kernel, plain version, SDPA (length mask, GQA) and the
    bytes bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ragged_decode_attention import (
        decode_attention_reference, ragged_decode_attention, split_count)
    b, dtype = len(lens), "bfloat16"
    ln = torch.from_numpy(lens).to(dev)
    q = torch.randn(b, hq, d, device=dev, dtype=torch.bfloat16)
    caches = [(torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16),
               torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16))
              for _ in range(copies)]
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
    log(f"K1 timing {label} ({hq}/{hkv} heads of {d}, G = {hq // hkv}) "
        f"B={b} S={s} bf16 sum(lengths)={kv_rows}: kernel {fmt(ms)}, "
        f"plain {fmt(plain_ms)}, sdpa {fmt(lib_ms)}, bound {bnd:.4f} ms "
        f"(bytes, {100 * bnd / ms[1]:.1f}% of it); {splits} splits, grid "
        f"({splits}, {hkv}, {b}) = {splits * hkv * b} blocks on 132 SMs, then "
        f"a combine grid of {hkv * b}")
    del caches
    return {"G": hq // hkv, "D": d, "B": b, "S": s, "kv_rows": kv_rows,
            "ms": ms[1], "plain_ms": plain_ms[1], "library_ms": lib_ms[1],
            "bound_ms": bnd, "splits": splits}


def check_ragged(dev):
    """K1 at each (G, D) instance against its plain version (qwen2.5-3b's
    heads for (8, 128), internlm2-1.8b's for (2, 128), gemma-7b's for (1,
    256), mixtral-8x7b's for (4, 128), moonshot-v1-16b-a3b's for (1,
    128), musicgen-large's for (1, 64)), then timed at each ported
    config's serving shape (S = 2048 for the dense configs, musicgen and
    llama-3.2-vision-90b's self-attention, phase 4e's S = 1024 for the MoE
    ones) and at the vision model's cross-attention shape (B = 16, S =
    6,400, every length 6,400); the JSON entry's figures are
    qwen2.5-3b's, the other configs' under ``shapes``."""
    rng = np.random.default_rng(0)
    max_err = dict(_ragged_checks(dev, rng, *ATTN_HEADS["qwen2.5-3b"],
                                  "qwen2.5-3b"))
    # serving lengths: prompt 16..256 plus 0..512 generated
    lens = (rng.integers(16, 257, 16) + rng.integers(0, 513, 16)).astype(np.int32)
    shapes = {"qwen2.5-3b": _ragged_timing(dev, lens, *ATTN_HEADS["qwen2.5-3b"],
                                           "qwen2.5-3b")}
    for arch in ("internlm2-1.8b", "gemma-7b") + MOE_ARCHS + (AUDIO_ARCH,):
        err = _ragged_checks(dev, np.random.default_rng(1), *ATTN_HEADS[arch],
                             arch)
        for k, v in err.items():
            max_err[k] = max(max_err[k], v)
    # the cross-attention shape: the image K/V, every length vision_seq
    err = _ragged_cross_check(dev)
    for k, v in err.items():
        max_err[k] = max(max_err[k], v)
    for arch in ("internlm2-1.8b", "yi-9b", "gemma-7b", AUDIO_ARCH,
                 VISION_ARCH):
        shapes[arch] = _ragged_timing(dev, lens, *ATTN_HEADS[arch], arch)
    for arch in MOE_ARCHS:
        shapes[arch] = _ragged_timing(dev, lens, *ATTN_HEADS[arch], arch,
                                      s=1024)
    shapes[f"{VISION_ARCH} cross"] = _ragged_timing(
        dev, np.full(16, VISION_SEQ, np.int32), *ATTN_HEADS[VISION_ARCH],
        f"{VISION_ARCH} cross-attention", s=VISION_SEQ, copies=2)
    qw = shapes["qwen2.5-3b"]
    return {"name": "ragged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/ragged_decode_attention/csrc/"
                      "ragged_decode_attention.cu",
            "replaces": "src/repro/kernels/ragged_decode_attention/kernel.py:70",
            "max_abs_err": max(max_err.values()), "ms": qw["ms"],
            "plain_ms": qw["plain_ms"], "bound_ms": qw["bound_ms"],
            "bound_by": "bytes", "library_ms": qw["library_ms"],
            "shapes": shapes}


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


def _flash_checks(dev, rng, hq, hkv, d, label):
    """K3 against its plain version at (Hq, Hkv, D) in bf16 and fp32 over
    prompt buckets (some no multiple of any block), sliding windows, and the
    bf16 kernel's first, partial and last K/V tiles (64 keys) and a window
    across tile edges.  Returns the largest |kernel - plain| by dtype."""
    import torch
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention)
    cases = [(b, s, None) for s in (16, 80, 192, 256, 1000) for b in (1, 16)]
    cases += [(1, 4096, None), (1, 1000, 256), (16, 192, 64)]
    cases += [(16, 64, None), (1, 65, None), (16, 129, None), (2, 300, 100)]
    gen = card_generator(dev, rng)
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        err = 0.0
        for b, s, win in cases:
            q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
                       .to(td) for h in (hq, hkv, hkv))
            out = flash_attention(q, k, v, window=win)
            ref = attention_reference(q, k, v, window=win)
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
            err = max(err, float((out.float() - ref.float()).abs().max()))
        max_err[dtype] = err
        log(f"K3 flash_attention {label} (G, D) = ({hq // hkv}, {d}) {dtype}: "
            f"max |kernel - plain| = {err:.3e} over (B, S, window) in {cases}")
    return max_err


def _flash_timing(dev, b, s, hq, hkv, d, label):
    """K3 at (B, S) bf16 causal: kernel, plain version, SDPA (causal, GQA)
    and the bound over the visible pairs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_reference, flash_attention)
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
    log(f"K3 timing {label} ({hq}/{hkv} heads of {d}, G = {hq // hkv}) "
        f"B={b} S={s} bf16 causal: kernel {fmt(ms)}, plain "
        f"{fmt(plain_ms)}, sdpa {fmt(lib_ms)}, bound {bnd:.4f} ms "
        f"({by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"{flops / ms[1] / 1e9:.1f} TFLOP/s, {100 * bnd / ms[1]:.1f}% of "
        f"the bound")
    return {"G": hq // hkv, "D": d, "B": b, "S": s, "ms": ms[1],
            "plain_ms": plain_ms[1], "library_ms": lib_ms[1],
            "bound_ms": bnd, "bound_by": by}


def _flash_lse_timing(dev, b=16, s=256, copies=4):
    """K3 at qwen2.5-3b's serving shape (bf16, causal) without the
    log-sum-exp output (serving) and with it (training's forward): the
    outputs bit-equal; each side's device ms by ``busy_ms``, turn about,
    over ``copies`` input sets in turn (37.7 MB each, past the L2).  A tree
    whose K3 has no lse output times the serving side alone, so that
    running this with ``PYTHONPATH`` at each of two trees' ``src`` in turn
    compares their serving K3 on one card."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    hq, hkv, d = ATTN_HEADS["qwen2.5-3b"]
    has_lse = hasattr(ops, "lse_buffer")
    sets = []
    for _ in range(copies):
        q = torch.randn(b, s, hq, d, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        sets.append((q, k, v, ops.lse_buffer(b, s, hkv, hq // hkv, dev)
                     if has_lse else None))
    sides = {"without": rotating(lambda q, k, v, buf: ops._launch(
        q, k, v, True, None), sets)}
    if has_lse:
        q, k, v, buf = sets[0]
        assert torch.equal(ops._launch(q, k, v, True, None),
                           ops._launch(q, k, v, True, None, buf)), \
            "K3's output differs with the lse output"
        sides["with"] = rotating(lambda q, k, v, buf: ops._launch(
            q, k, v, True, None, buf), sets)
    runs, clocks = busy_ms(sides, rounds=3)
    out = {k_: float(np.mean(v_)) for k_, v_ in runs.items()}
    log(f"K3 serving shape B={b} S={s} bf16, {copies} input sets in turn, "
        f"busy card (SM clock {min(clocks):.0f}-{max(clocks):.0f} MHz; after: "
        f"{card_clocks()}), turn about: without the lse output "
        f"{fmt_busy(runs['without'])}"
        + (f", with it {fmt_busy(runs['with'])}, "
           f"{100 * (out['with'] / out['without'] - 1):+.1f}%; outputs "
           f"bit-equal" if has_lse else " (this tree has no lse output)"))
    return {"without_lse_ms": out["without"],
            "with_lse_ms": out.get("with"), "runs": runs,
            "sm_mhz": [min(clocks), max(clocks)]}


def check_flash(dev):
    """K3 at each (G, D) instance against its plain version (as K1), timed
    at qwen2.5-3b's B = 16, S = 256 and B = 1, S = 8192 and at each other
    config's B = 16, S = 256 (musicgen-large's (1, 64) and
    llama-3.2-vision-90b's self-attention among them); the JSON entry's
    figures are qwen's serving shape, the others under ``shapes``."""
    rng = np.random.default_rng(2)
    max_err = dict(_flash_checks(dev, rng, *ATTN_HEADS["qwen2.5-3b"],
                                 "qwen2.5-3b"))
    shapes = {"qwen2.5-3b": _flash_timing(dev, 16, 256,
                                          *ATTN_HEADS["qwen2.5-3b"],
                                          "qwen2.5-3b"),
              "qwen2.5-3b long": _flash_timing(dev, 1, 8192,
                                               *ATTN_HEADS["qwen2.5-3b"],
                                               "qwen2.5-3b")}
    for arch in ("internlm2-1.8b", "gemma-7b") + MOE_ARCHS + (AUDIO_ARCH,):
        err = _flash_checks(dev, np.random.default_rng(3), *ATTN_HEADS[arch],
                            arch)
        for k, v in err.items():
            max_err[k] = max(max_err[k], v)
    for arch in ("internlm2-1.8b", "yi-9b", "gemma-7b") + MOE_ARCHS + (
            AUDIO_ARCH, VISION_ARCH):
        shapes[arch] = _flash_timing(dev, 16, 256, *ATTN_HEADS[arch], arch)
    qw = shapes["qwen2.5-3b"]
    serving_lse = _flash_lse_timing(dev)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
            "max_abs_err": max(max_err.values()), "ms": qw["ms"],
            "plain_ms": qw["plain_ms"], "bound_ms": qw["bound_ms"],
            "bound_by": qw["bound_by"], "library_ms": qw["library_ms"],
            "shapes": shapes, "serving_lse": serving_lse}


def check_rmsnorm(dev):
    """K4 against its plain version at every row count the serving path
    gives it (one decode token to a prefill bucket) in both dtypes; then
    timed at the decode buckets' T = 1, 16, 64 and the prefill shape T =
    4096 beside the plain version, ``add`` + ``rms_norm`` and the bytes
    bound.  The JSON entry carries the prefill shape, and every T under
    ``shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import fused_rmsnorm, rmsnorm_reference
    d, eps = 2048, 1e-6
    rows_checked = (1, 2, 16, 64, 4096)
    rng = np.random.default_rng(3)
    max_err = {}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        err = 0.0
        for t in rows_checked:
            x, r = (torch.from_numpy(rng.standard_normal((t, d), np.float32)
                                     ).to(dev, td) for _ in range(2))
            w = torch.from_numpy(rng.standard_normal(d, np.float32) * 0.1
                                 ).to(dev, td)
            # round_sum: the norm after a layer group normalises the sum
            # as written in the activations' dtype
            for round_sum in (False, True):
                s, n = fused_rmsnorm(x, r, w, eps=eps, round_sum=round_sum)
                assert torch.equal(s, x + r), \
                    "fused sum differs from x + residual"
                ref = rmsnorm_reference(x, r, w, eps, round_sum)[1]
                torch.testing.assert_close(n.float(), ref.float(),
                                           **TOL[dtype])
                err = max(err, float((n.float() - ref.float()).abs().max()))
        max_err[dtype] = err
        log(f"K4 fused_rmsnorm {dtype}: s bit-equal to x + residual, max "
            f"|n - plain| = {err:.3e} over T in {rows_checked}, D={d}, "
            f"round_sum off and on")

    # yardsticks: the device time of the smallest kernel (a one-element
    # add_), and per T a device-to-device copy of the bytes K4 moves but w
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1.0))
    log(f"K4 yardstick: a one-element add_ takes {fmt(floor_ms)}")
    entry, shapes = None, {}
    for t in (4096, 64, 16, 1):
        sets = [tuple(torch.randn(t, d, device=dev, dtype=torch.bfloat16)
                      for _ in range(2)) for _ in range(4)]
        w = torch.randn(d, device=dev, dtype=torch.bfloat16) * 0.1
        w1 = (1.0 + w.float()).to(torch.bfloat16)   # rms_norm's own weight
        ms = time_ms(rotating(lambda x, r: fused_rmsnorm(x, r, w, eps=eps), sets))
        plain_ms = time_ms(rotating(
            lambda x, r: rmsnorm_reference(x, r, w, eps), sets))
        lib_ms = time_ms(rotating(lambda x, r: F.rms_norm(
            torch.add(x, r), (d,), weight=w1, eps=eps), sets))
        pairs = [(torch.empty(2, t, d, device=dev, dtype=torch.bfloat16),
                  torch.stack(xr)) for xr in sets]
        copy_ms = time_ms(rotating(lambda dst, src: dst.copy_(src), pairs))
        nbytes = 2 * (4 * t * d + d)
        bnd = bound_ms(nbytes, 0, "bfloat16")
        log(f"K4 timing T={t} D={d} bf16: kernel {fmt(ms)}, plain "
            f"{fmt(plain_ms)}, add + rms_norm {fmt(lib_ms)}, bound "
            f"{bnd:.5f} ms (bytes; {nbytes / 1e6:.3f} MB; the kernel at "
            f"{100 * bnd / ms[1]:.1f}% of it); a copy of x and r "
            f"{fmt(copy_ms)}")
        shapes[f"T={t}"] = {"ms": ms[1], "call_ms": ms[0],
                            "plain_ms": plain_ms[1], "library_ms": lib_ms[1],
                            "bound_ms": bnd, "copy_ms": copy_ms[1],
                            "one_element_add_ms": floor_ms[1]}
        if entry is None:     # the prefill shape goes into the JSON line
            entry = {"name": "fused_rmsnorm", "route": "cuda",
                     "source": "src/repro_torch/kernels/rmsnorm/csrc/"
                               "fused_rmsnorm.cu",
                     "replaces": "src/repro/kernels/rmsnorm/kernel.py:26",
                     "max_abs_err": max(max_err.values()), "ms": ms[1],
                     "plain_ms": plain_ms[1], "bound_ms": bnd,
                     "bound_by": "bytes", "library_ms": lib_ms[1],
                     "shapes": shapes}
    return entry


# the backward kernels: each gradient's largest |kernel - plain| as a
# fraction of the plain gradient's max-abs.  fp32: both sides sum in fp32
# in other orders over up to S positions; bf16: the kernel rounds each
# gradient once to bf16 (2^-8 relative) and forms rowsum(dO * O) from the
# forward kernel's bf16 O, the plain autograd from its fp32 O
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the training shape of phase 9t(c): qwen2.5-3b's global batch 4 x 512
TRAIN_B, TRAIN_S = 4, 512


def _grad_gap(got, ref):
    scale = float(ref.float().abs().max())
    return float((got.float() - ref.float()).abs().max()) / max(scale, 1e-30)


def _flash_bwd_checks(dev, rng, g, d):
    """K3's backward at (G, D) in both dtypes, causal with and without a
    window, S off a multiple of 64, on contiguous q, k, v and on views of
    one fused projection: against the plain version's autograd grads and
    against ``attention_bwd_reference`` (the kernels' formulas in fp32 on
    the forward kernel's out and log-sum-exp, which is held to
    ``attention_lse_reference``), two backward passes bit-equal.  Returns
    the largest gap (a fraction of each gradient's max-abs) by dtype."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.kernels.flash_attention import (
        attention_bwd_reference, attention_lse_reference, attention_reference,
        flash_attention, ops)
    hkv = 2
    hq = g * hkv
    cases = [(2, 80, None), (2, 192, 64), (1, 300, None), (3, 65, 16)]
    gaps = {}
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        worst = worst_formula = worst_lse = 0.0
        for i, (b, s, win) in enumerate(cases):
            fused = i == len(cases) - 1      # q, k, v views of one tensor
            if fused:
                qkv = torch.from_numpy(rng.standard_normal(
                    (b, s, hq + 2 * hkv, d), np.float32)).to(dev, td)
                base = qkv.requires_grad_()
                q, k, v = base.split((hq, hkv, hkv), dim=2)
                leaves = (base,)
            else:
                q, k, v = (torch.from_numpy(rng.standard_normal(
                    (b, s, h, d), np.float32)).to(dev, td).requires_grad_()
                    for h in (hq, hkv, hkv))
                leaves = (q, k, v)
            do = torch.from_numpy(rng.standard_normal(
                (b, s, hq, d), np.float32)).to(dev, td)
            before = K.LAUNCHES["flash_attention_bwd"]
            got = torch.autograd.grad(flash_attention(q, k, v, window=win),
                                      leaves, do)
            again = torch.autograd.grad(flash_attention(q, k, v, window=win),
                                        leaves, do)
            assert K.LAUNCHES["flash_attention_bwd"] == before + 2
            assert all(torch.equal(a, c) for a, c in zip(got, again)), \
                ("K3b passes differ", g, d, dtype, b, s, win)
            ref = torch.autograd.grad(
                attention_reference(q, k, v, window=win), leaves, do)
            for a, c in zip(got, ref):
                assert a.dtype == td and a.shape == c.shape
                gap = _grad_gap(a, c)
                assert gap <= GRAD_TOL[dtype], (g, d, dtype, b, s, win, gap)
                worst = max(worst, gap)
            # the explicit formulas on the kernels' own out and lse
            with torch.no_grad():
                q0, k0, v0 = (t.detach() for t in (q, k, v))
                buf = ops.lse_buffer(b, s, hkv, g, dev)
                out = ops._launch(q0, k0, v0, True, win, buf)
                lse = ops.lse_as_bhs(buf, s)
                worst_lse = max(worst_lse, float((lse - attention_lse_reference(
                    q0, k0, v0, window=win)[1]).abs().max()))
                assert worst_lse <= 1e-4, (g, d, dtype, b, s, win, worst_lse)
                mine = ops._launch_bwd(q0, k0, v0, out, do, buf, True, win)
                formula = attention_bwd_reference(q0, k0, v0, out, do, lse,
                                                  window=win)
                for a, c in zip(mine, formula):
                    gap = _grad_gap(a, c)
                    assert gap <= GRAD_TOL[dtype], (g, d, dtype, b, s, win, gap)
                    worst_formula = max(worst_formula, gap)
        gaps[dtype] = max(worst, worst_formula)
        log(f"K3 backward (G, D) = ({g}, {d}) {dtype}: dq, dk, dv within "
            f"{worst:.3e} of the plain grads' max-abs and {worst_formula:.3e} "
            f"of attention_bwd_reference's, two passes bit-equal, the "
            f"forward's lse within {worst_lse:.2e} of the plain one, over "
            f"(B, S, window) in {cases} (the last on q, k, v views of one "
            f"projection)")
    return gaps


def check_flash_bwd(dev):
    """K3's backward kernels at every (G, D) of ``_SHAPES`` in both dtypes
    against the plain backwards; timed at the training shape (qwen2.5-3b,
    B = 4, S = 512, bf16, causal) turn about with SDPA's backward on a busy
    card over four input sets (``busy_ms``), then profiled alone kernel by
    kernel, beside the plain version's backward and the bound (2.5x the
    forward's causal operations, or the bytes of q, k, v, o, dout, dq, dk,
    dv)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_reference, ops
    rng = np.random.default_rng(11)
    worst = {}
    for g, d in ops._SHAPES:
        for dtype, gap in _flash_bwd_checks(dev, rng, g, d).items():
            worst[dtype] = max(worst.get(dtype, 0.0), gap)
    hq, hkv, d = ATTN_HEADS["qwen2.5-3b"]
    b, s = TRAIN_B, TRAIN_S
    sets, lib_sets = [], []
    for _ in range(4):       # 37.7 MB a call, four sets past the L2
        q = torch.randn(b, s, hq, d, device=dev, dtype=torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, device=dev, dtype=torch.bfloat16)
                for _ in range(2))
        do = torch.randn_like(q)
        lse = ops.lse_buffer(b, s, hkv, hq // hkv, dev)
        sets.append((q, k, v, ops._launch(q, k, v, True, None, lse), do, lse))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (qg, kg, vg)), is_causal=True,
            enable_gqa=True)
        lib_sets.append((lib_out, (qg, kg, vg), do.transpose(1, 2)))
    kern = rotating(lambda q, k, v, out, do, lse: ops._launch_bwd(
        q, k, v, out, do, lse, True, None), sets)
    lib = rotating(lambda out, leaves, do: torch.autograd.grad(
        out, leaves, do, retain_graph=True), lib_sets)
    runs, clocks = busy_ms({"K3b": kern, "sdpa backward": lib})
    ms, lib_ms = (float(np.mean(runs[n])) for n in ("K3b", "sdpa backward"))
    prof_ms = time_ms(kern)
    split = kernel_split(kern)
    nsplit = ops._dkv_splits(b, s, hkv, d, ops._sm_count(q.device))
    q, k, v, _, do, _ = sets[0]
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    plain_out = attention_reference(qg, kg, vg)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        plain_out, (qg, kg, vg), do, retain_graph=True), iters=5)
    nbytes = 2 * (4 * q.numel() + 4 * k.numel())
    flops = 2.5 * 4 * b * hq * d * (s * (s + 1) // 2)
    bnd = bound_ms(nbytes, flops, "bfloat16")
    by = "operations" if flops / PEAK_FLOPS["bfloat16"] > \
        nbytes / HBM_BYTES_PER_S else "bytes"
    log(f"K3 backward timing qwen2.5-3b ({hq}/{hkv} heads of {d}) B={b} "
        f"S={s} bf16 causal, 4 input sets in turn, busy card (SM clock "
        f"{min(clocks):.0f}-{max(clocks):.0f} MHz; after: {card_clocks()}), "
        f"turn about: kernel "
        f"{fmt_busy(runs['K3b'])}, sdpa backward "
        f"{fmt_busy(runs['sdpa backward'])}: the kernel at "
        f"{ms / lib_ms:.3f}x sdpa's; profiled alone {fmt(prof_ms)} (by "
        "kernel " + ", ".join(f"{n} {t:.4f}" for n, t in split.items())
        + f"; {nsplit} dk/dv blocks a key tile); plain backward "
        f"{fmt(plain_ms)}; bound {bnd:.4f} ms ({by}; {flops / 1e9:.2f} "
        f"GFLOP, {nbytes / 1e6:.1f} MB); {flops / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bnd / ms:.1f}% of the bound")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:86",
            "max_abs_err": max(worst.values()),
            "max_err_is": "fraction of each gradient's max-abs",
            "ms": ms, "runs": runs, "sm_mhz": [min(clocks), max(clocks)],
            "profiled_ms": prof_ms[1], "call_ms": prof_ms[0],
            "kernels_ms": split, "dkv_splits": nsplit,
            "plain_ms": plain_ms[1], "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms,
            "shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d,
                      "dtype": "bfloat16"}}


def check_rmsnorm_bwd(dev):
    """K4's backward against the plain version under autograd (the grads of
    x, the residual and the weight from both outputs) and against
    ``rmsnorm_bwd_reference`` at the row counts of training (one row to
    4,096) in both dtypes, with an fp32 weight beside bf16 rows too,
    round_sum off and on, two passes bit-equal; timed at phase 9t(c)'s
    2,048 rows with a bf16 and an fp32 weight turn about with ``add`` +
    ``rms_norm``'s backward on a busy card over four input sets
    (``busy_ms``), then profiled alone kernel by kernel, beside the plain
    backward and the bytes bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels as K
    from repro_torch.kernels.rmsnorm import (
        fused_rmsnorm, rmsnorm_bwd_reference, rmsnorm_reference)
    from repro_torch.kernels.rmsnorm import ops
    d, eps = 2048, 1e-6
    rng = np.random.default_rng(12)
    worst = {}
    for xdt, wdt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
        name = str(xdt).removeprefix("torch.")
        formula = 0.0
        for t in (1, 16, 600, 4096):
            x, r = (torch.from_numpy(rng.standard_normal(
                (t, d), np.float32)).to(dev, xdt).requires_grad_()
                for _ in range(2))
            w = torch.from_numpy(rng.standard_normal(d, np.float32) * 0.1
                                 ).to(dev, wdt).requires_grad_()
            ds, dn = (torch.from_numpy(rng.standard_normal(
                (t, d), np.float32)).to(dev, xdt) for _ in range(2))
            for round_sum in (False, True):
                before = K.LAUNCHES["fused_rmsnorm_bwd"]
                got = torch.autograd.grad(fused_rmsnorm(
                    x, r, w, eps=eps, round_sum=round_sum), (x, r, w),
                    (ds, dn))
                again = torch.autograd.grad(fused_rmsnorm(
                    x, r, w, eps=eps, round_sum=round_sum), (x, r, w),
                    (ds, dn))
                assert K.LAUNCHES["fused_rmsnorm_bwd"] == before + 2
                assert all(torch.equal(a, c) for a, c in zip(got, again)), \
                    ("K4b passes differ", xdt, wdt, t, round_sum)
                ref = torch.autograd.grad(rmsnorm_reference(
                    x, r, w, eps, round_sum), (x, r, w), (ds, dn))
                for a, c in zip(got, ref):
                    assert a.dtype == c.dtype and a.shape == c.shape
                    gap = _grad_gap(a, c)
                    assert gap <= GRAD_TOL[name], (xdt, wdt, t, gap)
                    worst[name] = max(worst.get(name, 0.0), gap)
                with torch.no_grad():
                    mine = rmsnorm_bwd_reference(x, r, w, ds, dn, eps,
                                                 round_sum)
                for a, c in zip((got[0], got[2]), mine):
                    gap = _grad_gap(a, c)
                    assert gap <= GRAD_TOL[name], (xdt, wdt, t, gap)
                    formula = max(formula, gap)
        log(f"K4 backward rows {xdt}, weight {wdt}: dx, dresidual, dweight "
            f"within {worst[name]:.3e} of the plain grads' max-abs and "
            f"{formula:.3e} of rmsnorm_bwd_reference's, two passes "
            f"bit-equal, over T in (1, 16, 600, 4096), D={d}, round_sum off "
            f"and on")
        worst[name] = max(worst[name], formula)
    t = TRAIN_B * TRAIN_S
    sets = [tuple(torch.randn(t, d, device=dev, dtype=torch.bfloat16)
                  for _ in range(4)) for _ in range(4)]
    w = torch.randn(d, device=dev, dtype=torch.bfloat16) * 0.1
    ws = {"bf16 weight": w, "fp32 weight": w.float()}
    sides = {wname: rotating(lambda x, r, ds, dn, w=w_: ops._launch_bwd(
        x, r, w, ds, dn, eps, False), sets) for wname, w_ in ws.items()}
    lib_sets = []
    for x, r, ds, dn in sets:
        x, r = (a.clone().requires_grad_() for a in (x, r))
        w1 = (1.0 + w.float()).to(torch.bfloat16).requires_grad_()
        s_lib = torch.add(x, r)
        lib_sets.append(((s_lib, F.rms_norm(s_lib, (d,), weight=w1,
                                            eps=eps)), (x, r, w1), (ds, dn)))
    sides["add + rms_norm backward"] = rotating(
        lambda out, leaves, grads: torch.autograd.grad(
            out, leaves, grads, retain_graph=True), lib_sets)
    runs, clocks = busy_ms(sides)
    mean = {n: float(np.mean(v)) for n, v in runs.items()}
    timing = {n: (time_ms(sides[n]), kernel_split(sides[n])) for n in ws}
    ms, lib_ms = mean["bf16 weight"], mean["add + rms_norm backward"]
    x, r = (sets[0][i].clone().requires_grad_() for i in range(2))
    wg = w.clone().requires_grad_()
    ds, dn = sets[0][2], sets[0][3]
    plain = rmsnorm_reference(x, r, wg, eps)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        plain, (x, r, wg), (ds, dn), retain_graph=True), iters=10)
    nbytes = 2 * (5 * t * d + 2 * d)
    bnd = bound_ms(nbytes, 0, "bfloat16")
    log(f"K4 backward timing T={t} D={d} bf16 rows, 4 input sets in turn, "
        f"busy card (SM clock {min(clocks):.0f}-{max(clocks):.0f} MHz; after: "
        f"{card_clocks()}), turn about: " + ", ".join(f"{n} {fmt_busy(v)}" for n, v in runs.items())
        + f"; the kernel (bf16 weight) at {ms / lib_ms:.3f}x the library's "
        f"and {100 * bnd / ms:.1f}% of the bound")
    for wname, (wms, wsplit) in timing.items():
        log(f"K4 backward timing T={t} D={d} bf16 rows, {wname}, profiled "
            f"alone: kernel {fmt(wms)} (by kernel "
            + ", ".join(f"{n} {v:.4f}" for n, v in wsplit.items()) + ")")
    log(f"K4 backward timing T={t} D={d} bf16: plain backward "
        f"{fmt(plain_ms)}, bound {bnd:.5f} ms (bytes; {nbytes / 1e6:.3f} MB)")
    return {"name": "fused_rmsnorm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/rmsnorm/csrc/"
                      "fused_rmsnorm_bwd.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:26",
            "max_abs_err": max(worst.values()),
            "max_err_is": "fraction of each gradient's max-abs",
            "ms": ms, "runs": runs, "sm_mhz": [min(clocks), max(clocks)],
            "profiled_ms": timing["bf16 weight"][0][1],
            "call_ms": timing["bf16 weight"][0][0],
            "kernels_ms": timing["bf16 weight"][1],
            "fp32_weight": {"ms": mean["fp32 weight"],
                            "profiled_ms": timing["fp32 weight"][0][1],
                            "kernels_ms": timing["fp32 weight"][1]},
            "plain_ms": plain_ms[1],
            "bound_ms": bnd, "bound_by": "bytes", "library_ms": lib_ms,
            "shape": {"T": t, "D": d, "dtype": "bfloat16"}}


# kernel S8's shapes (B, C, H, P, N): mamba2-2.7b's at phase 4s's prefills
# (bucket 16; prompts of at most 256 tokens are one chunk of 256) and at
# its long prefill (4 prompts of 2,048 tokens: 8 chunks), and jamba's full
# mixer (256 heads of 64 x 128) at the long prefill's shape
SSD_SHAPES = {"mamba2 B=16 C=1": (16, 1, 80, 64, 128),
              "mamba2 B=4 C=8": (4, 8, 80, 64, 128),
              "jamba B=4 C=8": (4, 8, 256, 64, 128)}


def check_ssd_scan(dev):
    """S8 against its plain version, bit for bit, at ``SSD_SHAPES``
    (mamba2's B = 16 with and without h0, the others with h0), then timed
    per shape by CUDA events (the profiler's kernel sum beside it) beside
    the plain version (a Python loop over C) and the bytes bound: states
    and h0 read, h_before and hT written, fp32.  No PyTorch call computes
    this loop.  The JSON entry carries mamba2's phase 4s prefill shape,
    every shape under ``shapes``."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_state_scan, ssd_state_scan_reference)
    entry, shapes = None, {}
    for label, (b, c, h, p, n) in SSD_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(c)
        sets = []
        for _ in range(3):         # rotated, so each launch reads past the L2
            decay = torch.exp(-4 * torch.rand(b, c, h, device=dev,
                                               generator=gen))
            states = torch.randn(b, c, h, p, n, device=dev, generator=gen)
            h0 = torch.randn(b, h, p, n, device=dev, generator=gen)
            sets.append((decay, states, h0))
        decay, states, h0 = sets[0]
        inits = (None, h0) if c == 1 else (h0,)
        for init in inits:
            out = ssd_state_scan(decay, states, init)
            ref = ssd_state_scan_reference(decay, states, init)
            torch.cuda.synchronize()
            assert all(torch.equal(a, r) for a, r in zip(out, ref)), \
                f"S8 differs from its plain version at {label}"
        del out, ref
        ms = time_ms(rotating(ssd_state_scan, sets))
        plain_ms = time_ms(rotating(ssd_state_scan_reference, sets), iters=5,
                           warmup=1)
        elems = b * h * p * n
        nbytes = 4 * (2 * b * c + 2 * b) * h * p * n
        bnd = bound_ms(nbytes, 2 * c * elems, "float32")
        ns = 1e6 * ms[0] / (elems * c)
        log(f"S8 ssd_scan {label} (H={h}, P={p}, N={n}): bit-equal to the "
            f"plain version ({'without and with' if c == 1 else 'with'} "
            f"h0); kernel {ms[0]:.4f} ms by CUDA events ({ms[1]:.4f} ms "
            f"profiler sum), plain {plain_ms[0]:.4f} ms ({plain_ms[1]:.4f}), "
            f"bound {bnd:.4f} ms (bytes; {nbytes / 1e6:.1f} MB; the kernel "
            f"at {100 * bnd / ms[0]:.1f}% of it), {ns:.4f} ns a state "
            f"element a chunk")
        shapes[label] = {"ms": ms[0], "profiler_ms": ms[1],
                         "plain_ms": plain_ms[0], "bound_ms": bnd,
                         "ns_per_element_chunk": ns}
        if entry is None:   # phase 4s's prefill shape goes into the JSON line
            entry = {"name": "ssd_scan", "route": "cuda",
                     "source": "src/repro_torch/kernels/ssd_scan/csrc/"
                               "ssd_scan.cu",
                     "replaces": "src/repro/models/mamba.py:146 (the "
                                 "lax.scan over chunks of _ssd_chunked)",
                     "max_abs_err": 0.0, "ms": ms[0],
                     "plain_ms": plain_ms[0], "bound_ms": bnd,
                     "bound_by": "bytes", "library_ms": None,
                     "shapes": shapes}
        del sets, decay, states, h0
    torch.cuda.empty_cache()
    return entry


# kernel S8b's shapes (B, C, H, P, N): mamba2-2.7b's at phase 9t(m)(c)'s
# training batch (2 x 2,048 tokens: 8 chunks of 256) and jamba's full mixer
# at 4 x 2,048
SSD_BWD_SHAPES = {"mamba2 train B=2 C=8": (2, 8, 80, 64, 128),
                  "jamba B=4 C=8": (4, 8, 256, 64, 128)}


def g_decay_bound(g_states, h_before):
    """The error bound of two fp32 sums of the same n = P*N rounded
    products G * h_before, in any orders: 2 gamma_(n-1) sum |G * h|, with
    gamma_k = k u / (1 - k u) and u = 2^-24 (float64, [B, C, H])."""
    n = g_states.shape[-1] * g_states.shape[-2]
    gamma = (n - 1) * 2.0 ** -24 / (1 - (n - 1) * 2.0 ** -24)
    return 2 * gamma * (g_states * h_before).double().abs().sum((-2, -1))


def check_ssd_scan_bwd(dev):
    """S8b against its plain version at ``SSD_BWD_SHAPES``, without and
    with h0 and g_hT: g_states and g_h0 bit for bit, g_decay within the
    fp32 summation bound over P*N terms (``g_decay_bound``); then timed
    per shape as training calls it (no h0, no g_hT) by ``busy_ms`` (four
    input sets in turn, past the L2), turn about with the plain version
    (a Python loop over C), beside the bytes bound: h_before and g_h_before
    read, g_states written, chunk_decay read and g_decay written, fp32.
    No PyTorch call computes this loop.  The JSON entry carries mamba2's
    training shape, every shape under ``shapes``."""
    import torch
    from repro_torch.kernels.ssd_scan import (
        ssd_state_scan_bwd_reference, ssd_state_scan_reference)
    from repro_torch.kernels.ssd_scan import ops
    entry, shapes, worst = None, {}, 0.0
    for label, (b, c, h, p, n) in SSD_BWD_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(c + h)

        def randn(*shape):
            return torch.randn(*shape, device=dev, generator=gen)
        sets = []
        for _ in range(4):
            decay = torch.exp(-4 * torch.rand(b, c, h, device=dev,
                                               generator=gen))
            hb, _ = ssd_state_scan_reference(decay, randn(b, c, h, p, n))
            sets.append((decay, hb, randn(b, c, h, p, n)))
        decay, hb, g_hb = sets[0]
        h0, g_ht = randn(b, h, p, n), randn(b, h, p, n)
        gap = rel = 0.0
        for with_h0, ght in ((False, None), (True, g_ht)):
            # with h0 the forward's h_before starts from it
            hb0 = ssd_state_scan_reference(decay, randn(b, c, h, p, n),
                                           h0)[0] if with_h0 else hb
            got = ops._launch_bwd(decay, hb0, g_hb, ght, with_h0)
            ref = ssd_state_scan_bwd_reference(decay, hb0, g_hb, ght, with_h0)
            torch.cuda.synchronize()
            assert torch.equal(got[1], ref[1]), f"S8b g_states at {label}"
            assert (got[2] is None and ref[2] is None) or torch.equal(
                got[2], ref[2]), f"S8b g_h0 at {label}"
            diff = (got[0].double() - ref[0].double()).abs()
            bound = g_decay_bound(ref[1], hb0)
            assert bool((diff <= bound).all()), \
                f"S8b g_decay past its bound at {label}: {float(diff.max())}"
            gap = max(gap, float(diff.max()))
            rel = max(rel, float((diff / bound).max()))
            del got, ref, hb0
        worst = max(worst, gap)

        def kern(d, x, g):
            return ops._launch_bwd(d, x, g, None, False)

        def plain(d, x, g):
            return ssd_state_scan_bwd_reference(d, x, g, None, False)
        busy, clocks = busy_ms({"kernel": rotating(kern, sets),
                                "plain": rotating(plain, sets)}, iters=20)
        ms, plain_ms = (float(np.mean(busy[k])) for k in ("kernel", "plain"))
        nbytes = 4 * (3 * b * c * h * p * n + 2 * b * c * h)
        bnd = bound_ms(nbytes, 4 * b * c * h * p * n, "float32")
        log(f"S8b ssd_scan_bwd {label} (H={h}, P={p}, N={n}): g_states and "
            f"g_h0 bit-equal to the plain version, g_decay within "
            f"{gap:.3e} of it (at most {rel:.2e} of its fp32 summation "
            f"bound), without and with h0 and g_hT; busy kernel "
            f"{fmt_busy(busy['kernel'])}, plain {fmt_busy(busy['plain'])}, "
            f"bound {bnd:.4f} ms (bytes; {nbytes / 1e6:.1f} MB; the kernel "
            f"at {100 * bnd / ms:.1f}% of it), SM clocks "
            f"{min(clocks):.0f}-{max(clocks):.0f} MHz")
        shapes[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                         "g_decay_gap": gap, "busy": busy}
        if entry is None:   # the training shape goes into the JSON line
            entry = {"name": "ssd_scan_bwd", "route": "cuda",
                     "source": "src/repro_torch/kernels/ssd_scan/csrc/"
                               "ssd_scan_bwd.cu",
                     "replaces": "the gradient of src/repro/models/"
                                 "mamba.py:146's lax.scan (jax.grad)",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": "bytes", "library_ms": None,
                     "timing": "busy_ms", "shapes": shapes}
        del sets, decay, hb, g_hb, h0, g_ht
    entry["max_abs_err"] = worst
    torch.cuda.empty_cache()
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


def check_small_moe(dev):
    """Phase 3's MoE model: mixtral's pattern at (G, D) = (4, 128), 2
    layers, 4 experts, capacity factor 0.5 (so decode steps at bucket 8
    drop assignments), window 32 below max_seq 128 (K1 reads the ring), in
    fp32: the card's engine (K1-K4, decode chunks as graphs) emits the
    CPU's greedy tokens, and both drop assignments at capacity.  The card
    counts drops in its eager runs only (a replayed graph's are not
    seen)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    from repro_torch.models.moe import count_drops
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    cfg = scaled_down(get_config("mixtral-8x7b"), num_groups=2, d_model=128,
                      num_heads=8, num_kv_heads=2, head_dim=128,
                      moe_d_ff=128, num_experts=4, capacity_factor=0.5,
                      decode_cache_update="scatter")
    assert cfg.sliding_window == 32
    ecfg = EngineConfig(max_batch=8, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    gpu = Engine(cfg, ecfg, seed=3, device=dev)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 9, 30, 3, 12)]
    targets = [60, 4, 33, 12, 45, 20]
    K.reset_launches()
    with count_drops() as card_log:
        rg = gpu.generate(prompts, targets, elastic=True, return_tokens=True)
    launches = dict(K.LAUNCHES)
    assert all(launches[name] > 0 for name in SERVING_KERNELS), launches
    with count_drops() as cpu_log:
        rc = cpu.generate(prompts, targets, elastic=True, return_tokens=True)
    assert list(rg["produced"]) == list(rc["produced"]) == targets
    same = sum(a == b for x, y in zip(rg["tokens"], rc["tokens"])
               for a, b in zip(x, y))
    total = sum(len(t) for t in rg["tokens"])
    drops = {}
    for name, lg in (("card", card_log), ("cpu", cpu_log)):
        drops[name] = {"prefill": sum(int(n) for q, n in lg if q > 1),
                       "decode": sum(int(n) for q, n in lg if q == 1)}
    log(f"small fp32 MoE model ((G, D) = (4, 128), window 32, max_seq 128): "
        f"greedy tokens {same}/{total} equal on card and CPU; assignments "
        f"dropped at capacity {drops} (the card's counted in its eager runs); "
        f"launches {launches}")
    assert rg["tokens"] == rc["tokens"], "card and CPU MoE engines disagree"
    assert drops["cpu"]["decode"] > 0, "no decode step dropped an assignment"
    assert sum(drops["card"].values()) > 0, "the card dropped no assignment"
    return drops


def small_jamba_cfg(**kw):
    """jamba's 8-position pattern at (G, D) = (4, 128), one group, fp32:
    phase 3's hybrid model, and phase 9t(m)(a)'s."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    return scaled_down(get_config("jamba-1.5-large-398b"), d_model=128,
                       num_heads=8, num_kv_heads=2, head_dim=128, d_ff=256,
                       moe_d_ff=128, num_experts=4, ssm_n_groups=2, **kw)


def check_small_jamba(dev):
    """Phase 3's hybrid model: jamba's 8-position pattern (attention + MoE,
    then seven Mamba layers, four of them with a dense FFN and three with
    MoE) at (G, D) = (4, 128), one group, in fp32: the card's engine (K1-K4
    and S8, decode chunks as graphs) emits the CPU's greedy tokens through
    elastic compaction of the K/V, conv and SSM leaves."""
    from repro_torch import kernels as K
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    cfg = small_jamba_cfg(decode_cache_update="scatter")
    ecfg = EngineConfig(max_batch=8, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    gpu = Engine(cfg, ecfg, seed=3, device=dev)
    cpu = Engine(cfg, ecfg, device="cpu",
                 params=map_tree(lambda t: t.cpu(), gpu.params))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 9, 30, 3, 12)]
    targets = [60, 4, 33, 12, 45, 20]
    K.reset_launches()
    rg = gpu.generate(prompts, targets, elastic=True, return_tokens=True)
    launches = dict(K.LAUNCHES)
    assert all(launches[name] > 0 for name in SERVING_KERNELS + ("ssd_scan",)), \
        launches
    rc = cpu.generate(prompts, targets, elastic=True, return_tokens=True)
    assert list(rg["produced"]) == list(rc["produced"]) == targets
    compacts = [e["batch"] for e in gpu.step_log if e["kind"] == "compact"]
    same = sum(a == b for x, y in zip(rg["tokens"], rc["tokens"])
               for a, b in zip(x, y))
    total = sum(len(t) for t in rg["tokens"])
    log(f"small fp32 jamba model (8 layers: attn + 7 Mamba, (G, D) = (4, "
        f"128), {cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim} x "
        f"{cfg.ssm_state}): greedy tokens {same}/{total} equal on card and "
        f"CPU; compactions to buckets {compacts}; launches {launches}")
    assert rg["tokens"] == rc["tokens"], "card and CPU jamba engines disagree"
    assert compacts, "no compaction ran"


def set_gates(cfg, params, seed=0):
    """Every ``attn_gate`` and ``ffn_gate`` of a cross-attention model's
    params to values drawn in [0.5, 1.5]: they init to 0, and tanh(0) = 0
    would make every cross-attention branch add exactly nothing."""
    rng = np.random.default_rng(seed)
    for i, (mixer, _) in enumerate(cfg.group_pattern):
        if mixer == "cross_attn":
            pos = params["groups"][f"pos{i}"]
            for leaf in (pos["mixer"]["attn_gate"], pos["ffn_gate"]):
                leaf.copy_(leaf.new_tensor(rng.uniform(0.5, 1.5, leaf.shape)))


def vlm_stream(engine, toks, lens, image, targets, steps=8):
    """A vision model's path through the engine, which feeds no image
    embeddings itself: ``prefill(cross_kv=)`` into the engine's own cache
    of the bucket, decode chunks (graphs on the card), a fused compaction
    (the image K/V too) once at most half the slots are live, more
    chunks.  ``toks``/``lens``/``image`` are tensors on the engine's
    device.  Returns (the greedy tokens each slot emitted, the prefill's
    last logits, its seconds)."""
    import torch
    from repro_torch.models.model import prefill
    b, dev = toks.shape[0], engine.device
    cache = engine.new_cache(b)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(engine.cfg, engine.params, toks, cross_kv=image,
                          cache=cache, prompt_lens=lens)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(last, -1).to(torch.int32)
    out = [[int(t)] for t in tok.cpu()]
    kv = lens.clone()
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
            return out, last, prefill_s
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


def check_small_m8c(dev):
    """Phase 3's last two families and the bhsd layout, fp32, card (decode
    chunks as graphs) against CPU, greedy, token for token:
    llama-3.2-vision-90b's 5-layer pattern at (G, D) = (4, 128) with
    vision_seq 64 and gates drawn non-zero, through ``prefill(cross_kv=)``,
    decode chunks and compactions of the image K/V (K1 on the self- and
    cross-attention); musicgen-large's at (1, 64), two layers, through the
    engine (K1 and K3 at their new instance); qwen's at (8, 128) with
    head-major caches (decode reads them with the plain version on both
    devices, as the reference does: no K1)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    from repro_torch.models.params import map_tree
    from repro_torch.serving import Engine, EngineConfig
    cfgs = {
        "vlm": scaled_down(get_config(VISION_ARCH), d_model=128, num_heads=8,
                           num_kv_heads=2, head_dim=128, d_ff=256,
                           vision_seq=64, decode_cache_update="scatter"),
        "audio": scaled_down(get_config(AUDIO_ARCH), num_groups=2,
                             d_model=256, num_heads=4, num_kv_heads=4,
                             head_dim=64, d_ff=512, vocab_size=256,
                             decode_cache_update="scatter"),
        "bhsd": scaled_down(get_config("qwen2.5-3b"), num_groups=2,
                            d_model=128, num_heads=16, num_kv_heads=2,
                            head_dim=128, d_ff=256, cache_layout="bhsd",
                            decode_cache_update="scatter")}
    ecfg = EngineConfig(max_batch=8, max_seq=128, prompt_bucket=16,
                        decode_chunk=8)
    targets = [20, 3, 9, 14, 2, 30, 5, 11]
    rng = np.random.default_rng(8)
    for family, cfg in cfgs.items():
        gpu = Engine(cfg, ecfg, seed=3, device=dev)
        set_gates(cfg, gpu.params)
        cpu = Engine(cfg, ecfg, device="cpu",
                     params=map_tree(lambda t: t.cpu(), gpu.params))
        K.reset_launches()
        if family == "vlm":
            toks = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
            lens = rng.integers(1, 17, 8).astype(np.int32)
            image = rng.standard_normal((8, cfg.vision_seq, cfg.d_model),
                                        np.float32)
            args = [torch.from_numpy(a) for a in (toks, lens, image)]
            tg = vlm_stream(gpu, *(a.to(dev) for a in args), targets)[0]
            launches = dict(K.LAUNCHES)
            tc = vlm_stream(cpu, *args, targets)[0]
        else:
            prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in (5, 17, 9, 30, 3, 12)]
            tg = gpu.generate(prompts, targets[:6], elastic=True,
                              return_tokens=True)["tokens"]
            launches = dict(K.LAUNCHES)
            tc = cpu.generate(prompts, targets[:6], elastic=True,
                              return_tokens=True)["tokens"]
        compacts = [e["batch"] for e in gpu.step_log if e["kind"] == "compact"]
        same = sum(a == b for x, y in zip(tg, tc) for a, b in zip(x, y))
        heads = (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
        log(f"small fp32 {family} model ({cfg.num_layers} layers "
            f"{[m for m, _ in cfg.group_pattern]}, (G, D) = {heads}, cache "
            f"{cfg.cache_layout}): greedy tokens {same}/"
            f"{sum(len(t) for t in tg)} equal on card and CPU; compactions "
            f"to buckets {compacts}; launches {launches}")
        assert tg == tc, f"card and CPU {family} engines disagree"
        assert [len(t) for t in tg] == targets[:len(tg)]
        assert compacts, "no compaction ran"
        need = ("gather_rows", "flash_attention", "fused_rmsnorm") + (
            () if family == "bhsd" else ("ragged_decode_attention",))
        assert all(launches[k] > 0 for k in need), launches
        if family == "bhsd":     # decode reads head-major caches plainly
            assert launches["ragged_decode_attention"] == 0, launches
        del gpu, cpu


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


def serve(engine, policy_name, reqs, policy, schedule=None,
          need=("ragged_decode_attention", "flash_attention",
                "fused_rmsnorm")):
    """Serve ``reqs`` with ``policy`` through ``run_engine_schedule``, or
    through ``schedule()`` (a fleet), counting the kernels' launches, and
    assert the engine's host-sync and graph ledgers and that the kernels
    ``need`` ran.  Returns (launches, per-bucket decode figures, wall
    seconds, the schedule's result)."""
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
    for name in need:
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
        kind = ("flash_attention_bwd" if "flash_bwd" in name else
                "fused_rmsnorm_bwd" if "rmsnorm_bwd" in name else
                "ragged_decode_attention" if "ragged_decode" in name else
                "fused_rmsnorm" if "fused_rmsnorm" in name else
                "flash_attention" if "flash_attention" in name else
                "ssd_scan_bwd" if "ssd_state_scan_bwd" in name else
                "ssd_scan" if "ssd_state_scan" in name else
                "gemm" if any(w in name for w in ("gemm", "gemv", "cutlass",
                                                  "sm90_xmma", "nvjet")) else
                "copy/fill" if "memcpy" in name or "memset" in name else
                "other (elementwise, reductions, indexing)")
        acc = kinds.setdefault(kind, [0, 0.0])
        acc[0] += 1
        acc[1] += e.device_time / 1e3
    return kinds


def profile_decode(engine, reqs, steps=8, exact=True):
    """Where a decode step's time goes at bucket 16, for one chunk of
    ``steps`` steps run twice on the same inputs: as the engine's graph
    replay and through its eager loop (on a copy of the cache).  Prints
    the wall ms/step of each, the tokens they agree on, the device busy
    time per step of each from a profiled chunk (kernels by kind), and the
    replay's time by CUDA events.  Asserts that each profiled chunk ran
    the K1 and K4 kernels that the graph's record adds to ``LAUNCHES`` on
    a replay, in one of three profiled windows (CUPTI has been seen to
    drop a kernel record of a chunk: 519 of mamba2's 520 K4 launches, 583
    of qwen's 584); with ``exact=False`` a third window short of them is
    logged instead."""
    import torch
    dev = engine.device
    cache, kv_lens, last, b, pre_s = engine.prefill_batch(
        [r.prompt_tokens for r in reqs[:16]])
    log(f"prefill of the first {min(16, len(reqs))} prompts (bucket 16, seq "
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
    state = [out[1:4]]
    # a replay adds the launches its capture recorded to LAUNCHES: hold
    # that record to the kernels the profiler saw (K1 is a split and a
    # combine kernel per call).  CUPTI drops a kernel record in some
    # windows (one of 584 K4 records of an eager chunk has been seen
    # missing): a window short of the record is logged and profiled
    # again, three windows at most; with ``exact`` the last must match
    rec = engine._graphs[(b, steps, 0.0, None)].launches
    want = {"ragged_decode_attention": 2 * rec["ragged_decode_attention"],
            "fused_rmsnorm": rec["fused_rmsnorm"]}

    def graph_chunk():
        st = state[0]
        res = engine.decode_chunk(cache, st[1], st[0], st[2], targets, steps)
        state[0] = res[1:4]
        return res[-1]

    kinds, walls = {}, {}
    for k, run in (("graph", graph_chunk),
                   ("eager", lambda: eager(eager_state)[2])):
        for window in range(1, 4):
            prof, seconds = profiled(run)
            kinds[k], walls[k] = _kernel_kinds(prof), seconds / steps
            seen = {n: kinds[k].get(n, [0])[0] for n in want}
            if seen == want:
                break
            log(f"the profiled {k} chunk saw {seen} of the graph record's "
                f"{want} in window {window}: CUPTI dropped kernel records")
        if exact:
            assert seen == want, f"{k} chunk ran {seen}, the graph record " \
                f"says {want}"
    wall_graph_prof, wall_eager_prof = walls["graph"], walls["eager"]
    log(f"profiled kernels per chunk against the graph record's launches: "
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
    n4, ms4 = kinds["graph"]["fused_rmsnorm"]
    log(f"K4 in the replayed decode step at bucket 16: {n4 / steps:.0f} "
        f"launches, {ms4 / steps:.4f} ms of device time a step "
        f"({1e3 * ms4 / n4:.2f} us a launch)")
    return {"bucket": b, "launches_per_step": n4 / steps,
            "device_ms_per_step": ms4 / steps}


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
    k4_step = profile_decode(engine, reqs)

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
    return totals, k4_step


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


def serve_resilient(engine, reqs):
    """Phase 8a(c): the resilient engine fleet, jsq in front of three
    dynamic-batching replicas (b16) sharing phase 4's engine, replica 0
    killed at the stream's median arrival; victims picked on the priors'
    batch law.  Every request must be served exactly once and none start
    on replica 0 after the kill, and the final replicas and the report
    must equal ``ResilientFleetScheduler``'s on a ``ModelClock`` of the
    same law (the reference holds that equality, on the CPU)."""
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import DynamicPolicy, single_from_batch
    from repro_torch.serving import ModelClock, run_fleet_schedule
    from repro_torch.serving.resilience import ResilientFleetScheduler
    lat = BatchLatencyModel(**PRIOR_BATCH)
    pol = DynamicPolicy(b_max=engine.ecfg.max_batch)
    kill_t = float(np.median([r.arrival for r in reqs]))
    kw = dict(kill_at={0: kill_t}, seed=1)
    launches, buckets, wall, res = serve(
        engine, "resilient fleet jsq+dynamic", reqs, pol,
        schedule=lambda: run_fleet_schedule("jsq", pol, engine, reqs, R=3,
                                            lat=lat, **kw))
    assert all(v["replays"] for v in buckets.values()), \
        "resilient fleet: a bucket that ran never replayed a graph"
    rep = res.resilience
    assert rep.served + rep.shed + rep.failed == rep.arrived == len(reqs)
    # exactly once: one run of every request across the replicas, each
    # with a finite wait and a replica
    assert rep.served == len(reqs) and not res.lost.any()
    assert sum(res.batch_sizes) == len(reqs), "a request ran twice"
    assert np.isfinite(res.waits).all() and (res.replica_of >= 0).all()
    assert rep.retries > 0 and rep.kill_events, "the kill moved no request"
    starts = np.array([r.arrival for r in reqs]) + res.waits
    assert (starts[res.replica_of == 0] <= kill_t + 1e-9).all(), \
        "a request started on replica 0 after its kill"
    virtual = ResilientFleetScheduler(
        "jsq", pol, ModelClock(single_from_batch(lat), lat), 3,
        **kw).run(reqs)
    assert np.array_equal(res.replica_of, virtual.replica_of), \
        "the engine fleet's final replicas differ from the virtual fleet's"
    assert vars(res.resilience) == vars(virtual.resilience), \
        "the engine fleet's report differs from the virtual fleet's"
    log(f"resilient fleet: replica 0 killed at {kill_t:.3f} s; final "
        f"replicas {np.bincount(res.replica_of, minlength=3).tolist()}, "
        f"retries {rep.retries}, kill events {rep.kill_events}, "
        f"availability {[round(a, 4) for a in rep.availability]}, served "
        f"{rep.served}/{rep.arrived}; equal to the virtual fleet's replicas "
        f"and report; wall {wall:.2f} s; launches K1 "
        f"{launches['ragged_decode_attention']}, K2 {launches['gather_rows']}"
        f", K3 {launches['flash_attention']}, K4 "
        f"{launches['fused_rmsnorm']}")
    return launches


# ----------------------------------------------------------------------------
# Phase 4m: serving under a KV budget
# ----------------------------------------------------------------------------

# KV tokens a replica may hold: 1,024 tokens of qwen2.5-3b's bf16 cache (36
# layers x K and V x 2 KV heads x 128) are 37.7 MB.  Phase 4's stream has
# footprints (prompt + output tokens) of 286.8 on average and 618 at most,
# 9,178 in all, over 9.2 s of arrivals.  The budget holds the largest request
# and three or four average ones.  Batches form on wall clock: replaying the
# formation with an assumed step time (0.005 + 0.0001 b s, about phase 4's
# 6 ms a step at bucket 16) cuts batches at 2,048 tokens (9 requests
# deferred) but not at half that step time, while 1,024 defers requests at
# any step time from 0.3x to 2x of it (3 to 98).
KV_BUDGET = 1024


def serve_memory(engine, reqs):
    """Phase 4m: phase 4's stream served under a KV budget of ``KV_BUDGET``
    tokens, ``run_engine_schedule`` with elastic b16 (K1-K4; admission on
    each request's real footprint, members that do not fit deferred to the
    next batch), then ``run_fleet_schedule`` jsq + dynamic b16 with R = 2,
    every replica its own budget.  Asserts that every admitted batch fits
    the budget, that the single engine defers requests, and that the
    engine's own tracked KV peak stays within the budget."""
    from repro_torch.core.latency_model import LatencyModel
    from repro_torch.core.policies import DynamicPolicy, ElasticPolicy
    from repro_torch.serving import run_engine_schedule, run_fleet_schedule
    cfg = engine.cfg
    cap = engine.ecfg.max_batch
    fp = np.array([len(r.prompt_tokens) + r.target_output_tokens
                   for r in reqs], np.float64)
    kv_bytes = KV_BUDGET * cfg.num_layers * 2 * cfg.num_kv_heads * \
        cfg.head_dim * 2
    assert fp.max() <= KV_BUDGET, "the budget cannot hold the largest request"
    log(f"KV budget {KV_BUDGET} tokens ({kv_bytes / 1e6:.1f} MB of bf16 KV); "
        f"footprints mean {fp.mean():.1f}, max {fp.max():.0f}, sum "
        f"{fp.sum():.0f}")
    arr = np.array([r.arrival for r in reqs])
    totals = {}
    for name, pol, schedule in (
            ("elastic", ElasticPolicy(b_max=cap),
             lambda p: run_engine_schedule(p, engine, reqs,
                                           memory=KV_BUDGET)),
            ("fleet jsq+dynamic R=2", DynamicPolicy(b_max=cap),
             lambda p: run_fleet_schedule(
                 "jsq", p, engine, reqs, R=2,
                 lat=LatencyModel(**PRIOR_SINGLE), memory=KV_BUDGET))):
        engine.kv_peak = 0             # the engine's own ledger, this run
        launches, _, wall, res = serve(engine, f"kv budget {name}", reqs,
                                       pol, schedule=lambda: schedule(pol))
        mem = res.memory
        # a batch's members share its start; batches start apart
        starts = np.round(arr + res.waits, 9)
        rep = getattr(res, "replica_of", np.zeros(len(reqs), np.int64))
        worst = max(fp[(starts == t) & (rep == r)].sum()
                    for t, r in set(zip(starts, rep)))
        assert worst <= KV_BUDGET, f"{name}: a batch of {worst} KV tokens"
        assert mem["kv_peak"] <= KV_BUDGET and \
            mem["allocated"] == mem["freed"] == fp.sum(), (name, mem)
        engine_peak = engine.kv_report()["kv_peak"]
        assert 0 < engine_peak <= KV_BUDGET, (name, engine_peak)
        if name == "elastic":
            assert mem["deferred_requests"] > 0, "the budget cut no batch"
            assert launches["gather_rows"] > 0, "no fused compaction ran"
        log(f"kv budget {name}: batch sizes {res.batch_sizes}, deferred "
            f"requests {mem['deferred_requests']}, kv_peak "
            f"{mem['kv_peak']:.0f} (largest batch {worst:.0f}; the engine's "
            f"own peak {engine_peak}), utilization {mem['utilization']:.4f}, "
            f"allocated {mem['allocated']:.0f} = freed {mem['freed']:.0f}, "
            f"mean wait {res.waits.mean():.3f} s, wall {wall:.2f} s")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ----------------------------------------------------------------------------
# Phases 4d and 4e: the dense and MoE families at full width
# ----------------------------------------------------------------------------

DENSE_ARCHS = ("internlm2-1.8b", "yi-9b", "gemma-7b")
FAMILY_REQUESTS = 12      # the first requests of phase 4's stream
# the depth at which phases 4d, 4e, 4s and 4v serve each family (the vision
# model apart): its first 6 layers at full layer width.  Whole (mixtral at
# 16 of its 32 layers, whose 87.0 GiB in bf16 do not fit the card), these
# phases took 260 s of the script's 924 s on the H100, and 114 s at 12
# layers; mamba2-2.7b trains whole in phase 9t(m)(c)
FAMILY_LAYERS = 6
# phase 4e's engine: phase 4's, with caches of 1,024 positions (moonshot's
# KV cache is 384 KiB a token: its five bucket caches take 11.6 GiB at
# 1,024, 23.3 at 2,048); phase 4's prompts are at most 256 tokens and its
# targets at most 512, so no request needs more
MOE_MAX_SEQ = 1024
MOE_PEAK_GIB = 75.0


def family_cfg(arch):
    """``arch``'s config at ``FAMILY_LAYERS`` layers, full layer width,
    scatter cache updates (phase 4's engine's)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=FAMILY_LAYERS,
                               decode_cache_update="scatter")


def serve_family(phase, cfgs, ecfg, reqs, peak_limit_gib=None,
                 need=("ragged_decode_attention", "flash_attention",
                       "fused_rmsnorm"), extra=None):
    """Phases 4d, 4e, 4s and 4v: each config of ``cfgs`` ({arch:
    ModelConfig}) at full width, random bf16 weights from a seed (made on
    the card), serving the first ``FAMILY_REQUESTS`` of phase 4's stream
    through ``run_engine_schedule`` with elastic b16 (the kernels ``need``
    on decode graphs; a compaction runs K2).  Asserts each engine's
    parameter count against its config and, given ``peak_limit_gib``, its
    peak device memory.  Logs per model its batches, waits, decode ms a
    step by bucket, prefill ms, host syncs, the kernels' launches and the
    peak device memory; ``extra(engine, reqs, row)``, if given, then runs
    more of the path on the engine and returns its launches, which count
    in the path.  Frees each engine before the next.  Returns the launches
    summed over the configs and the per-config rows."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policies import get_policy
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import Engine
    reqs = reqs[:FAMILY_REQUESTS]
    totals, rows = {}, {}
    for arch, cfg in cfgs.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        engine = Engine(cfg, ecfg, seed=0)
        torch.cuda.synchronize()
        nparams = sum(t.numel() for t in tree_leaves(engine.params))
        assert nparams == cfg.param_count(), (arch, nparams)
        init_s = time.perf_counter() - t0
        # clamp the stream's token ids into this vocabulary (phase 4's
        # stream is drawn for qwen's 151,936)
        mine = [dataclasses.replace(r, prompt_tokens=np.asarray(
            r.prompt_tokens) % cfg.vocab_size) for r in reqs]
        engine.generate([r.prompt_tokens for r in mine[:2]], [3, 2],
                        elastic=True)
        n0, syncs0 = len(engine.step_log), engine.host_syncs
        launches, buckets, wall, res = serve(
            engine, f"{arch} elastic", mine,
            get_policy("elastic", b_max=ecfg.max_batch), need=need)
        assert launches["gather_rows"] > 0, f"{arch}: no fused compaction ran"
        assert engine.sample_fallbacks == 0, f"{arch}: non-finite logits"
        pre = [1e3 * e["seconds"] for e in engine.step_log[n0:]
               if e["kind"] == "prefill"]
        syncs = engine.host_syncs - syncs0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows[arch] = {
            "params": nparams, "layers": cfg.num_layers,
            "batch_sizes": list(res.batch_sizes),
            "mean_wait_s": float(res.waits.mean()), "wall_s": wall,
            "prefill_ms": pre, "host_syncs": syncs,
            "ms_per_step": {b: v["replay_ms_per_step"]
                            for b, v in buckets.items() if v["replays"]},
            "launches": {k: launches.get(k, 0) for k in MODEL_KERNELS},
            "peak_gib": peak, "resident_before_gib": base}
        ffn = (f"{cfg.num_experts} experts of {cfg.moe_d_ff} (top "
               f"{cfg.num_experts_per_tok}, {cfg.num_shared_experts} shared)"
               if cfg.num_experts else f"d_ff {cfg.d_ff}")
        mixer = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}"
                 if cfg.has_attention else
                 f"d_inner {cfg.ssm_d_inner}, {cfg.ssm_heads} SSM heads of "
                 f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
                 f"{cfg.ssm_conv_kernel}, chunk {cfg.ssm_chunk}, no FFN")
        log(f"phase {phase} {arch}: {nparams / 1e9:.3f} B params "
            f"({cfg.num_layers} of {get_config(arch).num_layers} layers, "
            f"d_model {cfg.d_model}, {mixer}), "
            f"init {init_s:.1f} s; batch "
            f"sizes {res.batch_sizes}, mean wait {res.waits.mean():.3f} s, "
            f"wall {wall:.2f} s; prefill ms {[round(m, 1) for m in pre]}; "
            f"host syncs {syncs}; decode graph-replay ms a step by bucket "
            f"{{{', '.join(f'{b}: {v:.2f}' for b, v in rows[arch]['ms_per_step'].items())}}} "
            f"(buckets only captured: "
            f"{sorted(set(buckets) - set(rows[arch]['ms_per_step']))}); "
            f"launches {rows[arch]['launches']}; peak device memory "
            f"{peak:.2f} GiB ({base:.2f} GiB of it allocated before)")
        if peak_limit_gib is not None:
            assert peak < peak_limit_gib, \
                f"{arch}: peak {peak:.2f} GiB over {peak_limit_gib} GiB"
        if extra is not None:
            for k, v in extra(engine, mine, rows[arch]).items():
                launches[k] = launches.get(k, 0) + v
            rows[arch]["launches"] = {k: launches.get(k, 0)
                                      for k in MODEL_KERNELS}
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return totals, rows


def serve_dense(ecfg, reqs):
    """Phase 4d: internlm2-1.8b, yi-9b and gemma-7b at ``FAMILY_LAYERS``
    layers, phase 4's engine settings, qwen's engine resident."""
    return serve_family("4d", {arch: family_cfg(arch) for arch in DENSE_ARCHS},
                        ecfg, reqs)


def serve_moe(ecfg, reqs):
    """Phase 4e: mixtral-8x7b and moonshot-v1-16b-a3b at ``FAMILY_LAYERS``
    layers, phase 4's engine settings with ``max_seq`` = ``MOE_MAX_SEQ``,
    after qwen's engine is freed; each engine's peak under
    ``MOE_PEAK_GIB``."""
    log(f"phase 4e: {', '.join(MOE_ARCHS)} at {FAMILY_LAYERS} layers (full "
        f"layer width); max_seq {ecfg.max_seq}")
    return serve_family("4e", {arch: family_cfg(arch) for arch in MOE_ARCHS},
                        ecfg, reqs, peak_limit_gib=MOE_PEAK_GIB)


# phase 4s: mamba2-2.7b at FAMILY_LAYERS layers, phase 4's engine settings
# (its caches do not grow with max_seq); one long prefill of 4 prompts of
# 2,048 tokens runs S8 over 8 chunks of 256
SSM_ARCH = "mamba2-2.7b"
LONG_PREFILL = (4, 2048)
SSM_PEAK_GIB = 40.0


def _ssm_extra(engine, reqs, row):
    """Phase 4s after its schedule: the decode step's floor beside the
    bucket-16 step, one decode chunk of 8 steps at bucket 16 profiled by
    kind of kernel (as phase 4 does for qwen), then the long prefill,
    timed, with its launches (S8 at C = 8) counted in the path."""
    import torch
    from repro_torch import kernels as K
    cfg = engine.cfg
    weights = 2 * row["params"]
    state = (2 * cfg.num_layers * 16 * cfg.ssm_heads * cfg.ssm_head_dim
             * cfg.ssm_state * 2)        # bf16 SSM state, read and written
    floor = 1e3 * (weights + state) / HBM_BYTES_PER_S
    step = row["ms_per_step"].get(16)
    log(f"phase 4s {cfg.name}: decode step at bucket 16 "
        f"{'not replayed' if step is None else f'{step:.2f} ms'} against "
        f"its floor {floor:.2f} ms (the bf16 weights' read, "
        f"{weights / 1e9:.2f} GB, and the SSM state's read and write, "
        f"{state / 1e9:.2f} GB, at 3.35 TB/s)")
    row["floor_ms"] = floor
    row["decode_profile"] = profile_decode(engine, reqs, exact=False)
    b, s = LONG_PREFILL
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, s).astype(np.int32)
               for _ in range(b)]
    K.reset_launches()
    torch.cuda.synchronize()
    engine.prefill_batch(prompts)           # warm: the first (4, 2048) call
    K.reset_launches()
    cache, _, last, bb, dt = engine.prefill_batch(prompts)
    launches = dict(K.LAUNCHES)
    assert bb == b and engine.step_log[-1]["seq"] == s
    assert bool(torch.isfinite(last).all()), "non-finite long-prefill logits"
    chunks = -(-s // cfg.ssm_chunk)
    assert launches["ssd_scan"] == cfg.num_layers, launches
    log(f"phase 4s {cfg.name}: long prefill of {b} prompts x {s} tokens "
        f"({chunks} chunks of {cfg.ssm_chunk}: S8 at C = {chunks}) "
        f"{1e3 * dt:.1f} ms; launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    row["long_prefill_ms"] = 1e3 * dt
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    assert row["peak_gib"] < SSM_PEAK_GIB, row["peak_gib"]
    return launches


def serve_ssm(ecfg, reqs):
    """Phase 4s: mamba2-2.7b at ``FAMILY_LAYERS`` layers, full width,
    after phase 4e's engines are freed: phase 4's engine settings and 12
    requests, elastic b16 (K2, K4 on decode graphs, S8 in every prefill),
    then ``_ssm_extra``."""
    return serve_family("4s", {SSM_ARCH: family_cfg(SSM_ARCH)}, ecfg, reqs,
                        peak_limit_gib=SSM_PEAK_GIB,
                        need=("ssd_scan", "fused_rmsnorm"), extra=_ssm_extra)


# phase 4v: musicgen-large at FAMILY_LAYERS layers through the engine, then
# llama-3.2-vision-90b at 4 of its 20 groups (20 layers, 16 self- and 4
# cross-attention, full layer width: 19.21 B params, 38.4 GB in bf16; the
# whole model's 163 GiB do not fit the card), both on phase 4e's engine
# (caches of 1,024 positions)
VISION_GROUPS = 4
M8C_PEAK_GIB = 75.0
# the vision model's decode targets: the first 8 slots run 1 + 5 chunks of
# 32 steps, the other 8 stop after 3, so bucket 16 replays two chunks and
# the compaction 16 -> 8 leaves bucket 8 one replay
VISION_TARGETS = [1 + 5 * 32] * 8 + [1 + 3 * 32] * 8


def serve_vision(ecfg, reqs):
    """Phase 4v's vision model: llama-3.2-vision-90b at ``VISION_GROUPS``
    groups, full layer width, random bf16 weights made on the card with
    every gate drawn non-zero, random bf16 patch embeddings [16, 6,400,
    8,192] from a seed.  One ``prefill(cross_kv=)`` of phase 4's first 16
    prompts (clamped to the vocabulary) on the engine's own bucket-16 cache
    (K3 on the self-attention, K4; the cross-attention's dense prefill
    attention is plain PyTorch), decode chunks of 32 steps as graph
    replays (K1 on the self- and the cross-attention), one fused
    compaction 16 -> 8 (K2, the image K/V included).  Logs decode ms a
    step at each bucket against the bf16 weights' and the caches' read,
    the prefill's ms, the peak memory and the launches; asserts finite
    logits, the peak under ``M8C_PEAK_GIB`` and every kernel launched.
    Returns (launches, row)."""
    import gc
    import torch
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import Engine
    full = get_config(VISION_ARCH)
    cfg = dataclasses.replace(
        full, num_layers=VISION_GROUPS * len(full.group_pattern),
        decode_cache_update="scatter")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, ecfg, seed=0)
    set_gates(cfg, engine.params)
    gen = torch.Generator(device=engine.device).manual_seed(12)
    b = 16
    image = torch.randn(b, cfg.vision_seq, cfg.d_model, generator=gen,
                        device=engine.device).to(torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in tree_leaves(engine.params))
    assert nparams == cfg.param_count(), nparams
    init_s = time.perf_counter() - t0
    prompts = [np.asarray(r.prompt_tokens) % cfg.vocab_size
               for r in reqs[:b]]
    s = max(ecfg.prompt_bucket,
            -(-max(len(p) for p in prompts) // ecfg.prompt_bucket)
            * ecfg.prompt_bucket)
    toks = np.zeros((b, s), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.array([len(p) for p in prompts], np.int32)
    dev = engine.device
    K.reset_launches()
    n0 = len(engine.step_log)
    t1 = time.perf_counter()
    out, last, prefill_s = vlm_stream(
        engine, torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
        image, VISION_TARGETS, steps=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert bool(torch.isfinite(last).all()), "non-finite prefill logits"
    assert engine.sample_fallbacks == 0, "non-finite decode logits"
    assert [len(t) for t in out] == VISION_TARGETS
    chunks = [e for e in engine.step_log[n0:] if e["kind"] == "decode_chunk"]
    compacts = [e["batch"] for e in engine.step_log[n0:]
                if e["kind"] == "compact"]
    assert compacts == [8], compacts
    replay = {}
    for e in chunks:
        if e["graph"] == "replay":
            acc = replay.setdefault(e["batch"], [0, 0.0])
            acc[0] += e["steps"]
            acc[1] += e["seconds"]
    ms_step = {bb: 1e3 * v[1] / v[0] for bb, v in sorted(replay.items())}
    assert set(ms_step) == {16, 8}, ms_step
    weights = 2 * nparams
    image_kv = (2 * VISION_GROUPS * cfg.vision_seq * cfg.num_kv_heads
                * cfg.head_dim * 2)          # k_img and v_img, bf16, a slot
    floors = {bb: 1e3 * (weights + bb * image_kv) / HBM_BYTES_PER_S
              for bb in ms_step}
    for k in ("ragged_decode_attention", "gather_rows", "flash_attention",
              "fused_rmsnorm"):
        assert launches[k] > 0, f"{k} never ran in phase 4v's vision model"
    log(f"phase 4v {VISION_ARCH}: {VISION_GROUPS} of {full.num_groups} groups "
        f"({cfg.num_layers} layers: {VISION_GROUPS * 4} self-attention, "
        f"{VISION_GROUPS} cross-attention over {cfg.vision_seq} image "
        f"positions), {nparams / 1e9:.3f} B params, init {init_s:.1f} s; "
        f"prefill(cross_kv=) of {b} prompts x {s} positions "
        f"{1e3 * prefill_s:.1f} ms; {len(chunks)} decode chunks of 32 steps "
        f"({sum(e['graph'] == 'replay' for e in chunks)} graph replays), "
        f"compaction to {compacts}; decode graph-replay ms a step by bucket "
        f"{{{', '.join(f'{bb}: {v:.2f}' for bb, v in ms_step.items())}}} "
        f"against the floors "
        f"{{{', '.join(f'{bb}: {v:.2f}' for bb, v in floors.items())}}} (the "
        f"bf16 weights' read, {weights / 1e9:.2f} GB, and the image K/V's, "
        f"{image_kv / 1e6:.1f} MB a slot, at 3.35 TB/s); wall {wall:.2f} s; "
        f"no non-finite logits; launches {launches}; peak device memory "
        f"{peak:.2f} GiB")
    assert peak < M8C_PEAK_GIB, f"peak {peak:.2f} GiB"
    row = {"params": nparams, "layers": cfg.num_layers,
           "prefill_ms": 1e3 * prefill_s, "prefill_shape": [b, s],
           "ms_per_step": ms_step, "floor_ms": floors, "peak_gib": peak,
           "launches": {k: launches.get(k, 0) for k in MODEL_KERNELS}}
    del engine, image
    gc.collect()
    torch.cuda.empty_cache()
    return launches, row


def serve_m8c(ecfg, reqs):
    """Phase 4v: musicgen-large at ``FAMILY_LAYERS`` layers through
    ``serve_family`` (elastic b16,
    phase 4's first 12 requests: K1, K2, K3 at (1, 64), K4), then
    ``serve_vision``.  Returns the launches summed and the per-model
    rows."""
    totals, rows = serve_family("4v", {AUDIO_ARCH: family_cfg(AUDIO_ARCH)},
                                ecfg, reqs, peak_limit_gib=M8C_PEAK_GIB)
    audio = rows[AUDIO_ARCH]
    weights = 2 * audio["params"]
    audio["floor_ms"] = 1e3 * weights / HBM_BYTES_PER_S
    step = audio["ms_per_step"].get(16)
    log(f"phase 4v {AUDIO_ARCH}: decode step at bucket 16 "
        f"{'not replayed' if step is None else f'{step:.2f} ms'} against "
        f"its floor {audio['floor_ms']:.2f} ms (the bf16 weights' read, "
        f"{weights / 1e9:.2f} GB, at 3.35 TB/s)")
    launches, rows[VISION_ARCH] = serve_vision(ecfg, reqs)
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    return totals, rows


# ----------------------------------------------------------------------------
# Phase 9t: training
# ----------------------------------------------------------------------------

# the kernels of the training path: K3 and K4 forward and backward
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "fused_rmsnorm",
                 "fused_rmsnorm_bwd")
# phase 9t(a): three fp32 steps card against CPU, lr 1e-4.  The small
# model's fp32 gradients depend on the order of their sums: the card and
# the CPU part by up to 6.9e-4 of a leaf's max-abs at step 0 with the
# kernels and the same with the plain K3 and K4 backward on the card
# (one H100), as two orders on the CPU part (1.3e-4).  AdamW's
# first steps move a parameter by about lr * sign(g), so a gradient inside
# that noise can step either way on either device: the params are held to
# two steps of lr a step, and the losses, the grad norms and the step-0
# gradients to the noise
TRAIN_SMALL_STEPS = 3
TRAIN_LR = 1e-4
TRAIN_TOL = {"loss": 2e-5, "grad_norm": 1e-3, "grad": 2e-3,
             "params": 2 * TRAIN_LR * TRAIN_SMALL_STEPS}
TRAIN_PEAK_GIB = 75.0
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train_ckpt"
# phase 9t(m): the state-space training path runs S8 and S8b beside K4 and
# K4b (jamba's attention position adds K3 and K3b); (c) trains mamba2-2.7b
# whole at 2 x 2,048 tokens, 8 chunks of 256 a row
SSM_TRAIN_KERNELS = ("ssd_scan", "ssd_scan_bwd", "fused_rmsnorm",
                     "fused_rmsnorm_bwd")
SSM_TRAIN_B, SSM_TRAIN_S = 2, 2048


def _small_train_cfg(**kw):
    """qwen2.5-3b's smoke config at 2 layers with its heads widened to 16
    / 2 of 128 (the smoke config's 16-dim heads are no (G, D) the
    attention kernels are built for), as phase 3's small model."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import scaled_down
    return scaled_down(get_config("qwen2.5-3b"), num_groups=2, d_model=128,
                       num_heads=16, num_kv_heads=2, head_dim=128, d_ff=256,
                       **kw)


def _train_steps(cfg, params, batches, device):
    """TRAIN_SMALL_STEPS AdamW steps of ``cfg`` from ``params`` on
    ``device``; returns (losses, grad norms, final params on the CPU)."""
    import torch
    from repro_torch.models.params import map_tree
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import TrainConfig, make_train_step
    tcfg = TrainConfig(adamw=AdamWConfig(lr=TRAIN_LR, warmup_steps=0))
    p = map_tree(lambda t: t.to(device, copy=True), params)
    opt = adamw_init(p, tcfg.adamw)
    step = make_train_step(cfg, tcfg)
    losses, norms = [], []
    for b in batches:
        p, opt, m = step(p, opt, {k: torch.from_numpy(v).to(device)
                                  for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, map_tree(lambda t: t.cpu(), p)


def _step0_grads(cfg, params, batch, device):
    import torch
    from repro_torch.models.params import map_tree, tree_leaves
    from repro_torch.training.train_step import TrainConfig, make_grad_fn
    p = map_tree(lambda t: t.to(device, copy=True), params)
    g, _ = make_grad_fn(cfg, TrainConfig())(
        p, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
    return [t.cpu() for t in tree_leaves(g)]


def _card_vs_cpu(phase, make_cfg, kernels):
    """The step-0 gradients and TRAIN_SMALL_STEPS train steps of
    ``make_cfg(remat=...)`` on the card and on the CPU (plain versions)
    from the same fp32 params and batches, remat off and on, held to
    TRAIN_TOL.  Returns the launches of the card's runs."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_params, tree_leaves
    launches = {}
    for remat in (False, True):
        cfg = make_cfg(remat=remat)
        params = init_params(param_specs(cfg),
                             torch.Generator().manual_seed(9), device="cpu")
        ds = SyntheticLMDataset(cfg, 64, 8, seed=0)
        batches = [ds.batch(i) for i in range(TRAIN_SMALL_STEPS)]
        K.reset_launches()
        g_card = _step0_grads(cfg, params, batches[0], "cuda")
        card = _train_steps(cfg, params, batches, "cuda")
        torch.cuda.synchronize()
        for k, v in K.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        missing = [k for k in kernels if K.LAUNCHES[k] == 0]
        assert not missing, f"{phase}: {missing} never launched"
        g_cpu = _step0_grads(cfg, params, batches[0], "cpu")
        grad_gap = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(g_card, g_cpu))
        cpu = _train_steps(cfg, params, batches, "cpu")
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        norm_gap = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
        param_gap = max(float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(card[2]), tree_leaves(cpu[2])))
        log(f"{phase} {cfg.name} remat {'on' if remat else 'off'}: step-0 "
            f"grads card vs CPU within {grad_gap:.2e} of a leaf's max-abs; "
            f"{TRAIN_SMALL_STEPS} fp32 steps card vs CPU: losses "
            f"{[round(x, 6) for x in card[0]]} (CPU "
            f"{[round(x, 6) for x in cpu[0]]}; gap {loss_gap:.2e} relative), "
            f"grad norms gap {norm_gap:.2e} relative, params within "
            f"{param_gap:.2e}; launches "
            f"{ {k: K.LAUNCHES[k] for k in kernels} }")
        assert grad_gap <= TRAIN_TOL["grad"], grad_gap
        assert loss_gap <= TRAIN_TOL["loss"], loss_gap
        assert norm_gap <= TRAIN_TOL["grad_norm"], norm_gap
        assert param_gap <= TRAIN_TOL["params"], param_gap
    return launches


def train_card_vs_cpu():
    """Phase 9t(a): the small model's step-0 gradients and three train
    steps on the card (K3 and K4 forward and backward) and on the CPU
    (plain versions) from the same fp32 params and batches, remat off and
    on.  Returns the launches of the card's runs."""
    return _card_vs_cpu("phase 9t(a)", _small_train_cfg, TRAIN_KERNELS)


def train_ssm_card_vs_cpu():
    """Phase 9t(m)(a): as 9t(a), for mamba2-2.7b's smoke config (one
    layer, 4 SSM heads of 32 x 16; S8, S8b, K4, K4b) and phase 3's small
    jamba (K3, K3b too), 8 x 64 tokens: two chunks of 32.  Returns the
    launches of the card's runs, summed."""
    from repro_torch.configs import get_smoke_config

    def mamba2(**kw):
        return dataclasses.replace(get_smoke_config("mamba2-2.7b"), **kw)
    launches = {}
    for make, kernels in ((mamba2, SSM_TRAIN_KERNELS),
                          (small_jamba_cfg, SSM_TRAIN_KERNELS + TRAIN_KERNELS)):
        for k, v in _card_vs_cpu("phase 9t(m)(a)", make, kernels).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def _launcher_run(phase, argv, steps, fail_at, kernels):
    """``repro_torch.launch.train`` on the card with ``argv``, ``steps``
    steps, a checkpoint every 4 under build/, a failure injected at step
    ``fail_at``: it must restore step 4 at data index 4 and end with a
    lower loss than it started with.  Returns the launches."""
    import shutil
    import torch
    from repro_torch import kernels as K
    from repro_torch.launch import train as launcher
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    K.reset_launches()
    t0 = time.perf_counter()
    out = launcher.main(argv + [
        "--steps", str(steps), "--ckpt-every", "4", "--simulate-failure-at",
        str(fail_at), "--ckpt-dir", str(TRAIN_CKPT)])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    losses = out["losses"]
    log(f"{phase} launcher ({' '.join(argv[:2])}): {out['attempts']} "
        f"attempts, restored {out['restored']} (step, data index), losses "
        f"{[round(losses[i], 4) for i in sorted(losses)]}, launches "
        f"{ {k: launches[k] for k in kernels} }, "
        f"{time.perf_counter() - t0:.1f} s")
    assert out["attempts"] == 2 and out["restored"] == [(4, 4)], out
    assert sorted(losses) == list(range(steps))
    assert losses[steps - 1] < losses[0], losses
    assert all(launches[k] > 0 for k in kernels), launches
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return launches


def train_launcher():
    """Phase 9t(b): the launcher on phase 9t(a)'s model, 12 steps, a
    failure at step 6."""
    return _launcher_run("phase 9t(b)", [
        "--arch", "qwen2.5-3b", "--smoke", "--set", "num_layers=2",
        "--set", "d_model=128", "--set", "num_heads=16",
        "--set", "head_dim=128", "--set", "d_ff=256", "--global-batch", "8",
        "--seq-len", "64", "--lr", "1e-2"], 12, 6, TRAIN_KERNELS)


def train_ssm_launcher():
    """Phase 9t(m)(b): the launcher on mamba2-2.7b's smoke config, 8
    steps, a failure at step 5."""
    return _launcher_run("phase 9t(m)(b)", [
        "--arch", "mamba2-2.7b", "--smoke", "--global-batch", "8",
        "--seq-len", "64", "--lr", "1e-2"], 8, 5, SSM_TRAIN_KERNELS)


def _step_profile(step_once, kernels=TRAIN_KERNELS):
    """Device ms of one train step by kernel: each of ``kernels``' ms, the
    rest, the rest by kind (``_kernel_kinds``) and its five largest
    kernels by name; from torch.profiler."""
    from torch.autograd import DeviceType
    prof, _ = profiled(step_once)
    kinds = _kernel_kinds(prof)
    out = {k: kinds.get(k, [0, 0.0])[1] for k in kernels}
    out["total"] = sum(ms for _, ms in kinds.values())
    out["outside"] = out["total"] - sum(out[k] for k in kernels)
    out["by_kind"] = {k: [n, round(ms, 3)] for k, (n, ms) in kinds.items()}
    names, ours = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"((?:flash|rmsnorm|fused_rmsnorm|ssd_state_scan)\w*"
                      r"_kernel)", e.name)
        acc = (ours.setdefault(m.group(1), [0, 0.0]) if m else
               names.setdefault(e.name[:70], [0, 0.0]))
        acc[0] += 1
        acc[1] += e.device_time / 1e3
    out["top_outside"] = sorted(([n, c, round(ms, 3)] for n, (c, ms) in
                                 names.items()), key=lambda r: -r[2])[:5]
    out["training_kernels"] = {n: [c, round(ms, 3)] for n, (c, ms) in
                               ours.items()}
    return out


def _full_width_run(phase, cfg, name, pdt, batches, kernels, steps):
    """``steps`` AdamW steps of ``cfg`` on the card from random weights
    made there in ``pdt`` (fp32 moments), on ``batches[:steps]``, then one
    profiled step on ``batches[steps]``.  Prints ms a step (the first
    apart) and the host's ms to queue a step (the step holds no sync), the
    peak, the losses, each of ``kernels``' launches and device ms a step
    and the device ms outside them.  Returns (row, launches)."""
    import gc
    import torch
    from repro_torch import kernels as K
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import TrainConfig, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-4, warmup_steps=0,
                                         moment_dtype="float32"))
    t0 = time.perf_counter()
    params = init_params(param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(0), pdt, device="cuda")
    opt = adamw_init(params, tcfg.adamw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(t.numel() for t in tree_leaves(params))
    step = make_train_step(cfg, tcfg)
    K.reset_launches()
    times, host, losses = [], [], []
    per_step = None
    for i in range(steps):
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batches[i])
        host.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        per_step = {k: K.LAUNCHES[k] - before.get(k, 0) for k in kernels}
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    box = {}

    def one():
        box["m"] = step(params, opt, batches[steps])[2]
    prof = _step_profile(one, kernels)
    row = {"params_b": nparams / 1e9, "init_s": init_s,
           "first_step_ms": times[0],
           "ms_per_step": float(np.mean(times[1:])),
           "step_ms": times, "host_ms": host, "losses": losses,
           "peak_gib": peak,
           "launches_per_step": per_step, "device_ms": prof}
    b, s = batches[0]["labels"].shape
    log(f"{phase} {cfg.name} full width, {name} ({nparams / 1e9:.3f} B), "
        f"fp32 moments, batch {b} x {s}, remat: first "
        f"step {times[0]:.1f} ms, then {row['ms_per_step']:.1f} ms a step "
        f"({', '.join(f'{t:.1f}' for t in times[1:])}), of which the "
        f"host took {', '.join(f'{t:.1f}' for t in host[1:])} to queue "
        f"the step; peak {peak:.2f} "
        f"GiB; losses {[round(x, 4) for x in losses]}; launches a step "
        f"{per_step}; device ms a step (profiled step): "
        + ", ".join(f"{k} {prof[k]:.3f}" for k in (
            *kernels, "outside", "total"))
        + f"; by kind [launches, ms] {prof['by_kind']}; the port's "
        f"kernels by name [launches, ms] {prof['training_kernels']}; the "
        f"largest kernels outside [name, launches, ms] "
        f"{prof['top_outside']}")
    assert all(np.isfinite(losses)), losses
    assert np.isfinite(float(box["m"]["loss"]))
    assert peak < TRAIN_PEAK_GIB, peak
    assert all(per_step[k] > 0 for k in kernels), per_step
    del params, opt, step, box
    gc.collect()
    torch.cuda.empty_cache()
    return row, launches


def train_full_width(steps=4):
    """Phase 9t(c): qwen2.5-3b at full width (36 layers, remat on, bf16
    activations, random weights made on the card), global batch 4 x 512:
    ``steps`` steps with fp32 params and moments (the reference launcher's
    params), then ``steps`` with bf16 params and fp32 moments (what the
    reference's dry-run specs pick for it).  Returns (launches, rows)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    cfg = get_config("qwen2.5-3b")
    assert cfg.remat and cfg.num_layers == 36 and cfg.tie_embeddings
    ds = SyntheticLMDataset(cfg, TRAIN_S, TRAIN_B, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                ds.batch(i).items()} for i in range(steps + 1)]
    launches, rows = {}, {}
    for name, pdt in (("fp32 params", torch.float32),
                      ("bf16 params", torch.bfloat16)):
        rows[name], run = _full_width_run("phase 9t(c)", cfg, name, pdt,
                                          batches, TRAIN_KERNELS, steps)
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v
    return launches, rows


def train_mamba2_full_width(steps=4):
    """Phase 9t(m)(c): mamba2-2.7b whole (64 Mamba2 layers at full width,
    remat on, bf16 activations, random weights made on the card), fp32
    params and moments, global batch 2 x 2,048 (S8 and S8b at C = 8),
    ``steps`` steps and a profiled one, as 9t(c).  Returns (launches,
    row)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    cfg = get_config("mamba2-2.7b")
    assert cfg.remat and cfg.num_layers == 64 and cfg.ssm_chunk == 256
    ds = SyntheticLMDataset(cfg, SSM_TRAIN_S, SSM_TRAIN_B, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                ds.batch(i).items()} for i in range(steps + 1)]
    row, launches = _full_width_run("phase 9t(m)(c)", cfg, "fp32 params",
                                    torch.float32, batches,
                                    SSM_TRAIN_KERNELS, steps)
    return launches, row


def run_training():
    """Phase 9t: (a), (b) and (c), then 9t(m)'s (a), (b) and (c), each a
    counted path.  Returns (paths, 9t(c)'s rows, 9t(m)(c)'s row)."""
    t0 = time.perf_counter()
    paths = {"train small (card vs CPU)": train_card_vs_cpu(),
             "train launcher": train_launcher()}
    launches, rows = train_full_width()
    paths["train full width"] = launches
    log(f"phase 9t (training) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["train ssm small (card vs CPU)"] = train_ssm_card_vs_cpu()
    paths["train ssm launcher"] = train_ssm_launcher()
    paths["train mamba2 full width"], ssm_row = train_mamba2_full_width()
    log(f"phase 9t(m) (training the state-space models) took "
        f"{time.perf_counter() - t0:.1f} s")
    return paths, rows, ssm_row


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


# the simulator kernels' tags in the log
SIM_TAGS = {"batch_scan": "S1", "impatience_scan": "S2", "multibin_scan": "S3",
            "wait_scan": "S4", "srpt_scan": "S5", "backlog_scan": "S6",
            "tandem_scan": "S7"}


class PathLaunches:
    """Inside ``with``: every launch of the scan wrapper ``name`` that
    ``core.fastsim`` makes (for S5 ``simulate_policy_fast``'s SRPT cells,
    each fleet replica's sub-stream and ``sweep_noise``'s one launch; for
    S1 each fleet replica's dynamic sub-stream; for S4 ``sweep_noise``'s
    one launch) is recorded with its inputs, its outputs and a CUDA event
    on each side of it on the stream, so its device time in the path is
    read afterwards (``ms``).  The wrapper and its launch counter are the
    same; only the name fastsim calls is wrapped."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import torch
        from repro_torch.core import fastsim
        self.launches, self._orig = [], getattr(fastsim, self.name)

        def recorded(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self._orig(*args)
            ev[1].record()
            self.launches.append({"args": args, "out": out, "events": ev})
            return out

        setattr(fastsim, self.name, recorded)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import fastsim
        setattr(fastsim, self.name, self._orig)

    def ms(self):
        """Device ms of each recorded launch (the card synchronized)."""
        import torch
        torch.cuda.synchronize()
        return [lo["events"][0].elapsed_time(lo["events"][1])
                for lo in self.launches]

    def report(self, path):
        """Print the launches' in-path times and return them as a dict."""
        ms = self.ms()
        req = [lo["out"][0].numel() for lo in self.launches]
        ns = [1e6 * m / r for m, r in zip(ms, req)]
        log(f"{SIM_TAGS[self.name]} {self.name} in the {path} path: "
            f"{len(ms)} launches, {sum(ms):.3f} ms of device time in all by "
            f"CUDA events around each launch ({sum(req)} lane-requests; per "
            f"launch {min(ms):.3f}-{max(ms):.3f} ms, {min(ns):.1f}-"
            f"{max(ns):.1f} ns a lane-request)")
        return {"launches": len(ms), "total_ms": sum(ms),
                "lane_requests": sum(req), "ms": ms}


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


def _sim_grid(key, name, dist, lat, lams, policies, dev, n=SIM_N, seed=0):
    """One λ grid through ``sweep``; its scan lanes run in one S1 launch,
    whose inputs and outputs ``scan_out`` hands back, and each batch-event
    cell in a launch of its own, handed back under ``cells``."""
    from repro_torch.core.fastsim import sweep
    scan = {}
    t0 = time.perf_counter()
    waits = sweep(policies, lams, dist, lat, num_requests=n, seed=seed,
                  device=dev, scan_out=scan)
    wall = time.perf_counter() - t0
    return {"key": key, "name": name, "dist": dist, "lat": lat, "lams": lams,
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


# the first designs of S1 and S4 on the same card and inputs (PERF.md §6,
# "earlier": S1 75 ns a request a lane, S4 136-139 ns), printed beside
# this run's figures
EARLIER_S1_MS = {"fig5": 11.410, "fig6": 11.411, "fit": 11.509, "heavy": 4.188}
EARLIER_S4_MS = {0.5: 8.310, 1.0: 8.139}
# S2's first design at 4 lanes and 1 (PERF.md §6: 55 ns a request a lane),
# and its chain: dependent float64 additions a request, each taken at
# CHAIN_CYCLES cycles of a CHAIN_HZ clock (assumed, not measured)
EARLIER_S2_MS = {4: 10.927, 1: 10.925}
S2_CHAIN_OPS, CHAIN_CYCLES, CHAIN_HZ = 2, 8, 1.755e9


def s1_launch(g, dev):
    """The grid's counted S1 launch as a ``launch_out`` dict: its inputs
    and outputs, on the card."""
    import torch
    from repro_torch.kernels.batch_scan import NO_CAP
    scan = g["scan"]
    arr, tok, starts, closed = (torch.from_numpy(scan[k]).to(dev) for k in
                                ("arr", "tok", "starts", "closed"))
    el = torch.tensor([e for *_, e, _ in scan["lanes"]], device=dev)
    bm = torch.tensor([NO_CAP if b is None else float(b)
                       for *_, b in scan["lanes"]], dtype=torch.float64,
                      device=dev)
    k = (g["lat"].k1, g["lat"].k2, g["lat"].k3, g["lat"].k4)
    return {"kernel": "batch_scan", "args": (arr, tok, el, bm, *k),
            "out": (starts, closed)}


def check_batch_scan(g, lo, plain_on_card):
    """The grid's counted S1 launch ``lo`` timed by CUDA events on its
    inputs; with ``plain_on_card`` every lane is first held at full length
    to the plain version on the card (timed), else ``plain_on_host`` holds
    them.  Returns (lanes, n, ms, plain_ms or None, bound_ms)."""
    import torch
    from repro_torch.kernels.batch_scan import (
        batch_scan, batch_scan_reference)
    args = lo["args"]
    plain_ms, held = None, "held to the plain version on host processes"
    if plain_on_card:
        (ref_s, ref_c), plain_ms = wall_ms(lambda: batch_scan_reference(*args))
        assert torch.equal(ref_s, lo["out"][0]) and \
            torch.equal(ref_c, lo["out"][1]), \
            f"{g['name']}: batch_scan differs from its plain version"
        held = (f"plain {plain_ms:.1f} ms on the card; the counted launch's "
                f"starts and closed equal the plain version's")
    n, lanes = args[0].shape
    ms = event_ms(lambda: batch_scan(*args))
    nbytes = lanes * n * (8 + 8 + 8 + 1) + lanes * (1 + 8)
    bnd = bound_ms(nbytes, 8 * lanes * n, "float64")
    was = EARLIER_S1_MS[g["key"]]
    log(f"S1 batch_scan {lanes} lanes x {n}: {ms:.3f} ms by CUDA events "
        f"({1e6 * ms / n:.1f} ns a request a lane, "
        f"{lanes * n / ms / 1e6:.3f} G lane-requests/s; the first design "
        f"{was:.3f} ms, {1e6 * was / n:.1f} ns, PERF.md), bound {bnd:.4f} ms "
        f"(bytes, {nbytes / 1e6:.1f} MB; {100 * bnd / ms:.2f}% of it); {held} "
        f"over all {lanes} lanes at full length ({g['name']})")
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


def s3_times(args):
    """S3 on one launch's inputs, ms by CUDA events: the wrapper (its
    grouping by bin on the card included) and the kernel alone on the
    grouped inputs."""
    import torch
    from repro_torch.kernels.multibin_scan import multibin_scan, ops
    arr, tok, bins, num_bins, b_max, *lat = args
    laid = ops.layout(arr, tok, bins, num_bins)
    starts = torch.empty(arr.shape, dtype=torch.float64, device=arr.device)
    first = torch.empty(arr.shape, dtype=torch.bool, device=arr.device)
    return (event_ms(lambda: multibin_scan(*args)),
            event_ms(lambda: ops.launch(laid, num_bins, b_max, tuple(lat),
                                        starts, first)))


def check_event_cells(g, pool):
    """Every S3-S5 cell of the grid's counted launches, at full length:
    its starts and batch heads against the plain version on the same
    inputs (on the card, timed, for each kernel's last cell, the λ = 1 cell
    whose times its entry reports; on ``pool``'s host processes for the
    others), and its waits and mean batch against the NumPy oracle (host
    CPU); then each kernel timed by CUDA events on the same inputs.
    Returns the kernels' JSON entries (the λ = 1 cell's times)."""
    import importlib
    import torch
    from repro_torch.core.simulate import no_warmup, simulate_policy
    cells = sorted(g["scan"]["cells"].items())
    on_card = {cell["kernel"]: key for key, cell in cells}
    host = [(cell["kernel"], cell) for key, cell in cells
            if on_card[cell["kernel"]] != key]
    plain_done = plain_on_host(host, pool)
    by_kernel = {}
    for (name, li), cell in cells:
        kern, args = cell["kernel"], cell["args"]
        mod = importlib.import_module(f"repro_torch.kernels.{kern}")
        fn, ref = getattr(mod, kern), getattr(mod, f"{kern}_reference")
        starts, first = cell["out"]
        plain_ms = None
        if on_card[kern] == (name, li):
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
        if kern == "multibin_scan":
            ms, kernel_ms = s3_times(args)
            alone = (f"; the kernel alone {kernel_ms:.3f} ms "
                     f"({1e6 * kernel_ms / g['n']:.1f} ns a request)")
        else:
            ms, kernel_ms, alone = event_ms(lambda: fn(*args)), None, ""
        n = g["n"]
        if kern == "wait_scan":
            was = EARLIER_S4_MS[lam]
            alone = (f" (the first design {was:.3f} ms, "
                     f"{1e6 * was / n:.1f} ns, PERF.md)")
        _, nbytes = EVENT_KERNELS[kern]
        bnd = bound_ms(nbytes * n, 0, "float64")
        log(f"{kern} {name} λ={lam}: {nb} batches (mean {n / nb:.3f}); "
            f"{ms:.3f} ms by CUDA events ({1e6 * ms / n:.1f} ns a request)"
            f"{alone}, bound {bnd:.5f} ms (bytes, {nbytes * n / 1e6:.2f} MB; "
            f"{100 * bnd / ms:.3f}% of it); "
            f"{'plain on host processes' if plain_ms is None else f'plain {plain_ms:.1f} ms'}"
            f"; starts and batch heads equal the plain version's, waits and "
            f"mean batch equal the oracle's (oracle {cpu_s:.2f} s of host "
            f"CPU)")
        by_kernel.setdefault(kern, []).append(
            {"cell": f"{name} λ={lam}", "batches": nb, "ms": ms,
             "ns_per_request": 1e6 * ms / n, "plain_ms": plain_ms,
             "bound_ms": bnd, **({"kernel_ms": kernel_ms} if kernel_ms
                                 else {})})
    jobs, host_s = plain_done()
    log(f"S3-S5: the {jobs} other cells' starts and batch heads equal the "
        f"plain version's on host processes ({host_s:.1f} s from their "
        f"start)")
    out = []
    for kern, rows in by_kernel.items():
        last = rows[-1]               # the λ = 1 cell of the last policy
        out.append({"name": kern, "route": "cuda",
                    "source": f"src/repro_torch/kernels/{kern}/csrc/{kern}.cu",
                    "replaces": EVENT_KERNELS[kern][0],
                    "shape": [g["n"], 1], "max_abs_err": 0.0,
                    "ms": last["ms"], "plain_ms": last["plain_ms"],
                    "bound_ms": last["bound_ms"], "bound_by": "bytes",
                    "library_ms": None, "cells": rows,
                    **({"kernel_ms": last["kernel_ms"]} if "kernel_ms" in last
                       else {})})
    return out


def run_simulators(dev, cal):
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.bulk import elastic_batching_bound
    from repro_torch.core.distributions import LogNormalTokens, UniformTokens
    from repro_torch.core.latency_model import (
        PAPER_A100_LLAMA2_7B, BatchLatencyModel)
    from repro_torch.core.bulk import optimize_bin_edges
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, FCFSPolicy, FixedPolicy, MultiBinPolicy,
        SRPTPolicy, WaitPolicy)
    from repro_torch.core.simulate import _warm, no_warmup, simulate_policy

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
    fig4_pols = {(n_max, tau): FCFSPolicy(n_max=n_max, tau=tau)
                 for n_max in (None, 1600) for tau in (30.0, 120.0, None)}
    # the reference benchmark's heavy-tail grid
    # (benchmarks/bench_batching_policies.py, multi-bin and PR 3 parts)
    ht_edges = tuple(float(e) for e in optimize_bin_edges(ln, lat6, 1.0,
                                                          num_bins=4))
    ht_pols = {"dyn": DynamicPolicy(), "dyn_b32": DynamicPolicy(b_max=32),
               "dyn_b16": DynamicPolicy(b_max=16), "ela": ElasticPolicy(),
               "multibin4": MultiBinPolicy(num_bins=4),
               "multibin4_opt": MultiBinPolicy(edges=ht_edges),
               "wait_k16": WaitPolicy(k=16), "srpt_b16": SRPTPolicy(b_max=16)}

    # the main path, counted: five sweeps (the Fig 4 cells the last)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s5_rec = PathLaunches("srpt_scan").__enter__()
    fig5 = _sim_grid("fig5", "Fig 5 (uniform 0..1000, k = 0.05, 0.5, 5e-4, "
                     "0.02)", uni, lat5, np.geomspace(0.05, 0.8, 16), pols,
                     dev)
    fig6 = _sim_grid("fig6", "Fig 6b (lognormal(7, 0.7), k = 0.05, 0.5, "
                     f"2e-4, 0.002; elastic saturates at {sat6:.4f}/s)", ln,
                     lat6, np.geomspace(0.05, 0.9 * sat6, 16), pols, dev)
    fit = _sim_grid("fit", f"fitted law (λ 10%-90% of mu[16] = "
                    f"{mu16:.4f}/s)", uni, lat_fit,
                    np.linspace(0.1, 0.9, 9) * mu16, scan_pols, dev)
    heavy = _sim_grid("heavy", f"heavy tail (lognormal(7, 0.7), Fig 6b "
                      f"constants, {HT_N} requests, seed {HT_SEED}; "
                      f"multibin4_opt edges {ht_edges})", ln, lat6,
                      [0.5, 1.0], ht_pols, dev, n=HT_N, seed=HT_SEED)
    fig4 = _sim_grid("fig4", "Fig 4 FCFS (lognormal(7, 0.7), the paper's "
                     "A100 law)", ln, PAPER_A100_LLAMA2_7B, [1 / 40],
                     fig4_pols, dev, n=FIG4_N)
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    s5_rec.__exit__()
    launches = dict(K.LAUNCHES)
    assert launches == {**launches, "batch_scan": 4, "impatience_scan": 1,
                        "multibin_scan": 4, "wait_scan": 2,
                        "srpt_scan": 2}, launches
    log(f"simulators: main path {main_wall:.2f} s wall (the heavy-tail "
        f"sweep {heavy['wall']:.2f} s), launches {launches}")
    # the two SRPT cells' launches are the ones check_event_cells holds to
    # the plain version and the oracle below
    assert {id(lo["out"]) for lo in s5_rec.launches} == {
        id(c["out"]) for c in heavy["scan"]["cells"].values()
        if c["kernel"] == "srpt_scan"}
    s5_path = s5_rec.report("simulators")
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
    fig4_s2 = fig4["scan"]["impatience"]
    col = {cell: c for c, (cell, _) in enumerate(fig4_s2["lanes"])}
    lost = fig4_s2["out"][1].cpu().numpy()
    for cell, pol in fig4_pols.items():
        a = pol.analytic_delay(1 / 40, ln, PAPER_A100_LLAMA2_7B)
        loss = _warm(lost[:, col[cell]]).mean() if cell in col else 0.0
        log(f"Fig 4 FCFS λ=1/40 n_max={cell[0]} tau={cell[1]} "
            f"({f'S2 lane {col[cell]}' if cell in col else 'closed form'}): "
            f"mean wait {fig4['waits'][cell][0]:.3f} s (analytic {a:.3f}), "
            f"loss {loss:.4f}")
    log(f"Fig 4: {len(col)} impatient cells as the {len(col)} lanes of one "
        f"impatience_scan launch, {len(fig4_pols) - len(col)} by the closed "
        f"form; sweep wall {fig4['wall']:.2f} s")

    # four lanes of the counted Fig 5 launch at full length against the
    # NumPy oracle sampling its own workload (host CPU)
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
    # every lane of the four counted S1 launches at full length: against
    # the plain version (the heavy tail's on the card, timed; the others on
    # host processes) and against the NumPy oracle (host processes), the
    # host's jobs running while the card checks and times the kernels
    grids = (fig5, fig6, fit, heavy)
    s1_los = [s1_launch(g, dev) for g in grids]
    with host_pool() as pool:
        plain_done = plain_on_host([("batch_scan", lo) for lo in s1_los[:-1]],
                                   pool)
        oracle_done = oracle_on_host(
            [("batch_scan", lo, False) for lo in s1_los], pool)
        s1, s2, event_entries = _simulator_kernels_on_card(
            dev, grids, s1_los, fig4, heavy, s5_path, pool)
        jobs, host_s = plain_done()
        lanes_held, tied, ora_s = oracle_done()
    assert tied == 0, f"{tied} S1 lanes of phase 7 part from the oracle"
    log(f"S1: the {jobs} plain-version jobs of the Fig 5, Fig 6b and "
        f"fitted-law launches equal the kernel's starts and closed; all "
        f"{lanes_held} lanes of the four launches equal the NumPy oracle's "
        f"waits and mean batch at full length (host processes, {host_s:.1f} "
        f"and {ora_s:.1f} s from their start)")
    return launches, [s1, s2] + event_entries


def _simulator_kernels_on_card(dev, grids, s1_los, fig4, heavy, s5_path,
                               pool):
    """Phase 7's checks and timings on the card: S1 on the four counted
    launches (the heavy tail's plain version on the card, whose times S1's
    entry reports), the Fig 4 cells against the oracle, S2's counted launch
    against its plain version, and every S3-S5 cell (``check_event_cells``,
    on ``pool`` in part).  Returns the JSON entries of S1, S2 and S3-S5."""
    import torch
    from repro_torch.core.simulate import _warm, simulate_policy
    from repro_torch.kernels.impatience_scan import (
        impatience_scan, impatience_scan_reference, ops)
    rows = [check_batch_scan(g, lo, plain_on_card=g is heavy)
            for g, lo in zip(grids, s1_los)]

    lanes, n, ms, plain_ms, bnd = rows[grids.index(heavy)]
    s1 = {"name": "batch_scan", "route": "cuda",
          "source": "src/repro_torch/kernels/batch_scan/csrc/batch_scan.cu",
          "replaces": "src/repro/core/fastsim.py:300 (_batching_core, a "
                      "lax.scan; no Pallas kernel)",
          "shape": [n, lanes], "max_abs_err": 0.0, "ms": ms,
          "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": "bytes",
          "library_ms": None,
          "launch_ms": {g["key"]: r[2] for g, r in zip(grids, rows)}}

    # S2: the counted launch, a lane per impatient Fig 4 cell, at full
    # length against the plain version on the card and against the oracle
    # (each cell sampling its own workload); the closed-form cells' mean
    # waits against the oracle's
    launch = fig4["scan"]["impatience"]
    args, (waits, lost) = launch["args"], launch["out"]
    (rw, rl), plain_ms = wall_ms(lambda: impatience_scan_reference(*args))
    assert torch.equal(waits, rw) and torch.equal(lost, rl), \
        "impatience_scan differs from its plain version"
    col = {cell: c for c, (cell, _) in enumerate(launch["lanes"])}
    for cell, pol in fig4["policies"].items():
        ora = simulate_policy(pol, 1 / 40, fig4["dist"], fig4["lat"],
                              num_requests=FIG4_N)
        assert fig4["waits"][cell][0] == ora["mean_wait"], cell
        if cell in col:
            assert np.array_equal(_warm(waits[:, col[cell]].cpu().numpy()),
                                  ora["waits"]), cell
    log(f"Fig 4: all {len(fig4['policies'])} FCFS cells' mean waits equal "
        f"the oracle's; the {len(col)} lanes of the counted S2 launch equal "
        f"the plain version's and the oracle's {FIG4_N} waits")
    lanes = len(col)
    one = tuple(a[..., :1].contiguous() for a in args)
    laid, tau = ops.layout(*args[:2]), args[2].contiguous()
    ms_kernel = event_ms(lambda: ops.launch(laid, tau, FIG4_N))
    ms = event_ms(lambda: impatience_scan(*args))
    ms1 = event_ms(lambda: impatience_scan(*one))
    nbytes = lanes * FIG4_N * (8 + 8 + 8 + 1) + lanes * 8
    bnd = bound_ms(nbytes, 3 * lanes * FIG4_N, "float64")
    chain = 1e3 * FIG4_N * S2_CHAIN_OPS * CHAIN_CYCLES / CHAIN_HZ
    log(f"S2 impatience_scan {lanes} lanes x {FIG4_N} (the counted launch): "
        f"{ms:.3f} ms by CUDA events ({1e6 * ms / FIG4_N:.1f} ns a request a "
        f"lane, {lanes * FIG4_N / ms / 1e6:.3f} G lane-requests/s; the kernel "
        f"alone on laid-out inputs {ms_kernel:.3f} ms; the first design "
        f"{EARLIER_S2_MS[lanes]:.3f} ms, {1e6 * EARLIER_S2_MS[lanes] / FIG4_N:.1f}"
        f" ns, PERF.md); 1 lane {ms1:.3f} ms ({1e6 * ms1 / FIG4_N:.1f} ns a "
        f"request; the first design {EARLIER_S2_MS[1]:.3f}); bound "
        f"{bnd:.4f} ms (bytes, {nbytes / 1e6:.1f} MB; {100 * bnd / ms:.2f}% "
        f"of it); chain {chain:.3f} ms ({S2_CHAIN_OPS} dependent float64 "
        f"additions and 2 selects a request, at {CHAIN_CYCLES} cycles an "
        f"addition and {CHAIN_HZ / 1e9:.3f} GHz, both assumed; "
        f"{100 * chain / ms:.1f}% of it); plain {plain_ms:.1f} ms")
    s2 = {"name": "impatience_scan", "route": "cuda",
          "source": "src/repro_torch/kernels/impatience_scan/csrc/"
                    "impatience_scan.cu",
          "replaces": "src/repro/core/fastsim.py:224 (_impatience_scan, a "
                      "lax.scan; no Pallas kernel)",
          "shape": [FIG4_N, lanes], "max_abs_err": 0.0, "ms": ms,
          "kernel_ms": ms_kernel, "ms_one_lane": ms1, "plain_ms": plain_ms,
          "bound_ms": bnd, "bound_by": "bytes", "library_ms": None}
    event_entries = check_event_cells(heavy, pool)
    next(e for e in event_entries if e["name"] == "srpt_scan")["in_path"] = \
        {"simulators": s5_path}
    return s1, s2, event_entries


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


def _plain_backlog(arr, work, R, up):
    """S6's plain version on stacked lanes on the host CPU (a worker of
    ``check_backlog_launches``'s pool): numpy in, numpy ids out."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.backlog_scan import backlog_scan_reference
    torch.set_num_threads(1)
    return backlog_scan_reference(
        torch.from_numpy(arr), torch.from_numpy(work), R,
        None if up is None else torch.from_numpy(up)).numpy()


# the S6 launch whose times (and plain version's, on the card) the JSON
# entry reports
S6_TIMED = "routers least_work"


def check_backlog_launches(launches, dev, pool):
    """Every S6 launch of the counted path, at full length: its ids against
    the plain version (``S6_TIMED``'s on the card, timed; the others on
    ``pool``'s host processes, the launches of one shape and mask kind
    stacked as lanes of one plain call) and against the NumPy recursion on
    the host; then each launch timed by CUDA events on its own inputs.
    ``launches``: {label: the launch_out dict}.  Returns the JSON entry and
    a function that waits for the host's plain calls, checks them and
    returns their count and the seconds from their start."""
    import torch
    from repro_torch.core.fleet import (
        _backlog_assign_np, _masked_backlog_assign_np)
    from repro_torch.kernels.backlog_scan import (
        backlog_scan, backlog_scan_reference, ops)
    groups = {}
    for label, lo in launches.items():
        arr, work, R, *up = lo["args"]
        if label != S6_TIMED:
            groups.setdefault((R, arr.shape[0], bool(up)), []).append(label)
    jobs = [tuple(torch.cat([launches[x]["args"][i] for x in labels],
                            dim=-1).cpu().numpy() for i in (0, 1))
            + (R, torch.cat([launches[x]["args"][3] for x in labels],
                            dim=-1).cpu().numpy() if masked else None)
            for (R, n, masked), labels in groups.items()]
    t0 = time.perf_counter()
    refs = pool.map(_plain_backlog, *zip(*jobs))
    lo = launches[S6_TIMED]
    ref, plain_ms = wall_ms(lambda: backlog_scan_reference(*lo["args"]))
    assert torch.equal(lo["out"], ref), \
        f"S6 {S6_TIMED}: kernel differs from its plain version"
    for label, lo in launches.items():
        R, masked = lo["args"][2], len(lo["args"]) > 3
        a, w = (lo["args"][i][:, 0].cpu().numpy() for i in (0, 1))
        host = (_masked_backlog_assign_np(
            a, w, R, lo["args"][3][:, :, 0].cpu().numpy().astype(bool))
            if masked else _backlog_assign_np(a, w, R))
        assert np.array_equal(lo["out"][:, 0].cpu().numpy(), host), \
            f"S6 {label}: kernel differs from the NumPy recursion"
    log(f"S6: all {len(launches)} counted launches' ids equal the NumPy "
        f"recursion on the host at full length; {S6_TIMED}'s equal the plain "
        f"version on the card ({plain_ms / 1e3:.1f} s), the other "
        f"{len(launches) - 1}'s are held to it on host processes")
    rows = {}
    for label, lo in launches.items():
        arr, work, R, *up = lo["args"]
        n = arr.shape[0]
        ms = event_ms(lambda: backlog_scan(*lo["args"]), iters=5)
        # the kernel alone, on the wrapper's packed mask
        bits = ops.pack_up(up[0]) if up else None
        out = torch.empty_like(lo["out"])
        kernel_ms = event_ms(lambda: ops.launch(arr, work, bits, R, out),
                             iters=5)
        nbytes = n * (8 + 8 + 8) + (n * R if up else 0)
        bnd = bound_ms(nbytes, 0, "float64")
        rows[label] = dict(R=R, n=n, masked=bool(up), ms=ms,
                           ns_per_request=1e6 * ms / n, kernel_ms=kernel_ms,
                           bound_ms=bnd)
        log(f"S6 backlog_scan {label}: R={R} (template "
            f"{ops.template_of(R)}){' masked' if up else ''}, [{n}, 1]: "
            f"{ms:.3f} ms by CUDA events ({1e6 * ms / n:.1f} ns a request), "
            f"the kernel alone {kernel_ms:.3f} ms ({1e6 * kernel_ms / n:.1f} "
            f"ns), bound {bnd:.5f} ms (bytes, {nbytes / 1e6:.2f} MB; "
            f"{100 * bnd / ms:.4f}% of it)")
    timed = S6_TIMED

    def plain_done():
        for ((R, n, masked), labels), ref in zip(groups.items(), refs):
            for j, label in enumerate(labels):
                assert np.array_equal(
                    launches[label]["out"][:, 0].cpu().numpy(), ref[:, j]), \
                    f"S6 {label}: kernel differs from its plain version"
        return len(jobs), time.perf_counter() - t0
    return {"name": "backlog_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/backlog_scan/csrc/"
                      "backlog_scan.cu",
            "replaces": S6_REPLACES, "shape": [rows[timed]["n"], 1],
            "max_abs_err": 0.0, "ms": rows[timed]["ms"],
            "kernel_ms": rows[timed]["kernel_ms"], "plain_ms": plain_ms,
            "bound_ms": rows[timed]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "launch_rows": rows}, plain_done


def _plain_lane(kern, args):
    """Kernel ``kern``'s plain version on one lane or a few, on the host
    CPU (a worker of ``plain_on_host``): numpy in, numpy out."""
    sys.path.insert(0, str(ROOT / "src"))
    import importlib
    import torch
    torch.set_num_threads(1)
    mod = importlib.import_module(f"repro_torch.kernels.{kern}")
    s, f = getattr(mod, f"{kern}_reference")(*(
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    return s.numpy(), f.numpy()


def _oracle_lane(kern, arr, tok, params):
    """The NumPy oracle on one S1 or S4 lane's inputs (a worker of
    ``oracle_on_host``): its waits and mean batch.  ``params``: the lane's
    (elastic, b_max) for S1, (k, timeout, b_max) for S4, then k1..k4."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, WaitPolicy, Workload)
    from repro_torch.core.simulate import no_warmup, simulate_policy
    from repro_torch.kernels.batch_scan import NO_CAP
    *own, k1, k2, k3, k4 = params
    if kern == "batch_scan":
        elastic, b_max = own
        pol = (ElasticPolicy if elastic else DynamicPolicy)(
            b_max=None if b_max >= NO_CAP else int(b_max))
    else:
        k, timeout, b_max = own
        pol = WaitPolicy(k=max(int(k), 1),
                         timeout=None if np.isinf(timeout) else timeout,
                         b_max=int(b_max) if b_max > 0 else None)
    with no_warmup():
        ora = simulate_policy(pol, None, None, BatchLatencyModel(k1, k2, k3, k4),
                              workload=Workload(arr, tok))
    return ora["waits"], ora["mean_batch"]


def host_pool():
    """A pool of host processes, one a core but the one that drives the
    card (at least 1, at most 8)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        max_workers=max(1, min(8, (os.cpu_count() or 2) - 1)),
        mp_context=multiprocessing.get_context("spawn"))


# lanes a job of plain_on_host: S1's plain loop steps every lane at once, a
# few small tensor ops a request whose cost barely grows with the lanes, so
# a job takes a whole launch of up to 64 lanes
PLAIN_LANES_A_JOB = {"batch_scan": 64}


def plain_on_host(launches, pool):
    """Hold every lane of the given launches ((kernel name, launch_out
    dict) pairs) at full length to the plain version: the same function in
    float64 on the same inputs, on ``pool`` (``host_pool``), a lane a job
    (S1: ``PLAIN_LANES_A_JOB`` lanes; the plain loops are a few small
    tensor ops a batch or a request, faster on the host's cores than as
    launches on the card).  The jobs start now; the returned function
    waits for them, checks, and returns the jobs run and the seconds from
    their start, so the card can work meanwhile."""
    import torch
    jobs, outs = [], []
    for kern, lo in launches:
        host = [a.cpu().numpy() if torch.is_tensor(a) else a
                for a in lo["args"]]
        starts, first = (t.cpu().numpy() for t in lo["out"])
        lanes, step = starts.shape[1], PLAIN_LANES_A_JOB.get(kern, 1)
        for j in range(0, lanes, step):
            cut = slice(j, j + step)
            # [n, lanes] and [lanes] arrays cut to the job's lanes; scalars
            # as they are
            jobs.append((kern, tuple(
                a[:, cut].copy() if isinstance(a, np.ndarray) and a.ndim == 2
                else a[cut].copy() if isinstance(a, np.ndarray) else a
                for a in host)))
            outs.append((kern, starts[:, cut], first[:, cut]))
    t0 = time.perf_counter()
    refs = pool.map(_plain_lane, *zip(*jobs))

    def check():
        for (kern, s, f), (rs, rf) in zip(outs, refs):
            assert np.array_equal(s, rs) and np.array_equal(f, rf), \
                f"{kern} differs from its plain version"
        return len(jobs), time.perf_counter() - t0
    return check


def oracle_on_host(launches, pool):
    """Hold every lane of the given S1 and S4 launches ((kernel name,
    launch_out dict, ties allowed) triples) at full length to the NumPy
    oracle on the same inputs: its waits (starts - arrivals) and mean
    batch, a lane a job on ``pool``, started now and checked by the
    returned function, as ``plain_on_host``.

    One difference is known, and allowed only in the launches marked so
    (the crash-fault replicas'): on equal arrival times (the crash
    faults' operational clock maps the arrivals of a repair to one
    instant) the scan, as the reference's, lets a request arriving at its
    batch's start join it, while the oracle's idle server starts its head
    alone.  Such an S1 lane whose waits part from the oracle's must part
    first at such a request: equal to the one before it, which started
    alone on arrival, and joined by the scan.  The returned function
    returns the lanes held, those parted by a tie, and the seconds from
    the jobs' start."""
    import torch
    jobs, outs = [], []
    for kern, lo, ties in launches:
        arr, tok, *rest = lo["args"]
        arr, tok = arr.cpu().numpy(), tok.cpu().numpy()
        own = [x.cpu().numpy() for x in rest if torch.is_tensor(x)]
        law = tuple(x for x in rest if not torch.is_tensor(x))
        starts, first = (t.cpu().numpy() for t in lo["out"])
        for j in range(arr.shape[1]):
            jobs.append((kern, arr[:, j].copy(), tok[:, j].copy(),
                         tuple(x[j].item() for x in own) + law))
            outs.append((kern, ties, j, arr[:, j], starts[:, j] - arr[:, j],
                         first[:, j]))
    t0 = time.perf_counter()
    refs = pool.map(_oracle_lane, *zip(*jobs))

    def check():
        tied = 0
        for (kern, ties, j, a, waits, first), (ora_w, ora_mb) in zip(outs,
                                                                     refs):
            if np.array_equal(waits, ora_w):
                assert len(waits) / first.sum() == ora_mb, \
                    f"{kern} lane {j}: mean batch differs from the oracle's"
                continue
            i = int(np.flatnonzero(waits != ora_w)[0])
            assert ties and kern == "batch_scan" and i > 0 \
                and a[i] == a[i - 1] and waits[i - 1] == ora_w[i - 1] == 0.0 \
                and waits[i] == 0.0 and not first[i], \
                f"{kern} lane {j}: waits differ from the NumPy oracle's at " \
                f"request {i}"
            tied += 1
        return len(jobs), tied, time.perf_counter() - t0
    return check


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
    s5_rec = PathLaunches("srpt_scan").__enter__()
    s1_rec = PathLaunches("batch_scan").__enter__()
    # (a) the replica-count scaling curve (jsq, capped dynamic replicas)
    got = {}
    scal = sweep([1, 2, 4, 8], [0.8], "jsq", DynamicPolicy(b_max=8), uni,
                 lat5, launch_out=got, **fleet_kw)["mean_wait"][:, 0]
    torch.cuda.synchronize()
    # fleet.sweep's wall and launches, for phase 8f's mesh twin
    scal_run = {"wall_s": time.perf_counter() - t0,
                "launches": {k: K.LAUNCHES[k]
                             for k in ("batch_scan", "backlog_scan")}}
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
    # multi-bin as one S3 launch of 10 lanes, WAIT as one S4 launch of 10
    s5_before = K.LAUNCHES["srpt_scan"]
    s5, s3, s4 = {}, {}, {}
    t_noise = time.perf_counter()
    grids = {"srpt_b16": sweep_noise(
        noise_factory(lambda p: SRPTPolicy(b_max=16, predictor=p)),
        noise_lams, sigmas, ln, ht, num_requests=NOISE_N, seed=NOISE_SEED,
        device=dev, launch_out=s5)["mean_wait"]}
    t_noise = time.perf_counter() - t_noise
    assert K.LAUNCHES["srpt_scan"] == s5_before + 1, "SRPT cells not one launch"
    for name, make, got in (
            ("multibin4", lambda p: MultiBinPolicy(num_bins=4, predictor=p),
             s3),
            ("wait_k16", lambda p: WaitPolicy(k=16, predictor=p), s4)):
        grids[name] = sweep_noise(noise_factory(make), noise_lams, sigmas, ln,
                                  ht, num_requests=NOISE_N, seed=NOISE_SEED,
                                  device=dev, launch_out=got)["mean_wait"]
    # (e) crash faults on a least_work fleet, masked S6 (the S1 launches
    # from here on are the crash-fault replicas')
    crash, s1_fault0 = {}, len(s1_rec.launches)
    for mtbf, mttr in crash_cells:
        got = {}
        crash[mtbf, mttr] = simulate_fleet_faulty(
            "least_work", DynamicPolicy(16), 4.0, 3, ln, lat5,
            CrashRepair(mtbf=mtbf, mttr=mttr), num_requests=FAULT_N,
            seed=FAULT_SEED, fast=True, device=dev, launch_out=got)
        s6[f"crash {mtbf:g}/{mttr:g}"] = got
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    s5_rec.__exit__()
    s1_rec.__exit__()
    launches = dict(K.LAUNCHES)
    assert len(s5_rec.launches) == launches["srpt_scan"] == 41, launches
    assert len(s1_rec.launches) == launches["batch_scan"] == 27, launches
    assert launches["backlog_scan"] == len(s6) == 14, (launches, sorted(s6))
    assert launches["multibin_scan"] == 1, "multi-bin cells not one launch"
    assert launches["wait_scan"] == 1 and s4["kernel"] == "wait_scan", \
        "WAIT cells not one launch"
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
    # every lane of the counted S5 launches (the noise launch's ten, the 40
    # fleet replicas' sub-streams), of the S3 and S4 noise launches and of
    # the 27 S1 launches (the fleet replicas) against the plain version,
    # and every S1 and S4 lane against the NumPy oracle, at full length, on
    # host processes while the card checks and times the kernels
    replicas = [lo for lo in s5_rec.launches if lo["out"] is not s5["out"]]
    assert len(replicas) == 40, len(replicas)
    with host_pool() as pool:
        plain_done = plain_on_host(
            [("srpt_scan", lo) for lo in s5_rec.launches]
            + [("multibin_scan", s3), ("wait_scan", s4)]
            + [("batch_scan", lo) for lo in s1_rec.launches], pool)
        oracle_done = oracle_on_host(
            [("batch_scan", lo, i >= s1_fault0)
             for i, lo in enumerate(s1_rec.launches)]
            + [("wait_scan", s4, False)], pool)
        noise_s5, noise_s3, noise_s4 = _noise_launches_on_card(s5, s3, s4)
        backlog, backlog_done = check_backlog_launches(s6, dev, pool)
        jobs, host_s = plain_done()
        lanes_held, tied, ora_s = oracle_done()
        s6_jobs, s6_s = backlog_done()
    log(f"S6: the {s6_jobs} stacked plain calls on host processes equal the "
        f"kernel's ids ({s6_s:.1f} s from their start)")
    assert tied == 1, f"{tied} crash-fault replica lanes part from the " \
                      f"oracle at a tie, not the one known"
    log(f"every lane of the 41 counted S5 launches (the noise plane and the "
        f"40 fleet replicas), of the S3 and the S4 launch (the noise plane) "
        f"and of the 27 S1 launches (the fleet replicas) equals the plain "
        f"version's at full length ({jobs} jobs on host processes, "
        f"{host_s:.1f} s from their start)")
    log(f"S1 and S4: of the {lanes_held} lanes of the 27 S1 launches and the "
        f"S4 launch, {lanes_held - tied} equal the NumPy oracle's waits and "
        f"mean batch at full length and {tied} of the "
        f"{len(s1_rec.launches) - s1_fault0} crash-fault replicas' lanes part "
        f"from it first at a request that arrives at the same instant as "
        f"the one before it, which the oracle's idle server started alone "
        f"and the scan lets join ({ora_s:.1f} s from their start)")
    noise_s5["in_path"] = s5_rec.report("fleet simulators")
    s1_path = s1_rec.report("fleet simulators")
    mesh_refs = {"scaling": scal, "scaling_run": scal_run,
                 "srpt_b16": grids["srpt_b16"], "noise_grid": (noise_lams, sigmas),
                 "noise_wall_s": t_noise}
    return launches, backlog, noise_s5, noise_s3, noise_s4, s1_path, mesh_refs


def _noise_launches_on_card(s5, s3, s4):
    """The noise plane's S5, S3 and S4 launches timed by CUDA events (S5's
    first lane also held to its plain version on the card, timed).
    Returns their JSON entries."""
    import torch
    from repro_torch.kernels.srpt_scan import srpt_scan, srpt_scan_reference
    from repro_torch.kernels.wait_scan import wait_scan
    one = tuple(a[:, :1].contiguous() for a in s5["args"][:3]) + \
        (s5["args"][3][:1],) + tuple(s5["args"][4:])
    (ref_s, ref_f), plain_ms = wall_ms(lambda: srpt_scan_reference(*one))
    starts, first = s5["out"]
    assert torch.equal(starts[:, :1], ref_s) and \
        torch.equal(first[:, :1], ref_f), \
        "S5 (sweep_noise) differs from its plain version"
    ms = event_ms(lambda: srpt_scan(*s5["args"]))
    n, lanes = starts.shape
    log(f"S5 srpt_scan, sweep_noise's one launch of {lanes} lanes x {n}: "
        f"{ms:.3f} ms by CUDA events ({1e6 * ms / (n * lanes):.1f} ns a "
        f"lane-request); the plain version on the card {plain_ms:.1f} ms for "
        f"its first lane")
    noise_s5 = {"lanes": lanes, "n": n, "ms": ms,
                "plain_ms_first_lane": plain_ms}
    s3_ms, s3_kernel_ms = s3_times(s3["args"])
    n, lanes = s3["args"][0].shape
    nb = int(s3["out"][1].sum())
    log(f"S3 multibin_scan, sweep_noise's one launch of {lanes} lanes x {n} "
        f"({nb} batches): {s3_ms:.3f} ms by CUDA events ("
        f"{1e6 * s3_ms / n:.1f} ns a request a lane, "
        f"{1e6 * s3_ms / (n * lanes):.1f} ns a lane-request), the kernel "
        f"alone {s3_kernel_ms:.3f} ms ({1e6 * s3_kernel_ms / n:.1f} ns a "
        f"request a lane)")
    noise_s3 = {"lanes": lanes, "n": n, "batches": nb, "ms": s3_ms,
                "kernel_ms": s3_kernel_ms}
    n, lanes = s4["args"][0].shape
    nb = int(s4["out"][1].sum())
    s4_ms = event_ms(lambda: wait_scan(*s4["args"]))
    log(f"S4 wait_scan, sweep_noise's one launch of {lanes} lanes x {n} "
        f"({nb} batches): {s4_ms:.3f} ms by CUDA events "
        f"({1e6 * s4_ms / n:.1f} ns a request a lane, "
        f"{1e6 * s4_ms / (n * lanes):.1f} ns a lane-request; the first "
        f"design ran ten one-lane launches at 136-139 ns a request, PERF.md)")
    return noise_s5, noise_s3, {"lanes": lanes, "n": n, "batches": nb,
                                "ms": s4_ms}


# ----------------------------------------------------------------------------
# Phase 8f: the mesh sweeps (the lanes of a sweep split over devices)
# ----------------------------------------------------------------------------

# step (4)'s sweep: the (λ, policy) lanes at Fig 5's constants, the uniform
# lengths of phase 8b(a); FCFS runs at 0.32-0.97 of its single-request load
MESH_LAMS, MESH_N = [0.03, 0.06, 0.09], 40_000
# step (5): the gradient vector a rank reduces (2^24 fp32 elements, 64 MiB)
MEAN_SIZE = 1 << 24


def nccl_mean(rank, world, store, size=MEAN_SIZE, seed=0):
    """``compressed_mean_rows`` on an NCCL group of ``world`` ranks from a
    FileStore at ``store``, rank r on card r with row r of one seeded draw
    as its gradient.  The group is destroyed after the call.  Returns the
    largest gap to the fp32 mean, the reference test's bound on it
    (max |g| / 127 + 0.02) and the call's ms (host clock, synchronized,
    after one call to warm)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compressed_mean_rows
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    g = torch.randn((world, size), generator=torch.Generator().manual_seed(seed))
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        local = g[rank].to(dev)
        compressed_mean_rows(local)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = compressed_mean_rows(local)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    gap = (mean.cpu() - g.mean(dim=0)).abs().max().item()
    return gap, g.abs().max().item() / 127.0 + 0.02, ms


def run_mesh_sweeps(dev, refs):
    """Phase 8f: ``core.shardsweep`` on ``cells_mesh()`` (every visible card)
    and on ``[dev, dev]`` (two shards on one card, so the split and the
    concatenation run), each held bit for bit to what phase 8b computed on
    one device: (1) the fleet scaling curve of 8b(a) as ``fleet_sweep``, its
    launches beside ``fleet.sweep``'s, (2) the same on the second mesh, (3)
    8b(d)'s SRPT noise plane as ``sweep_noise``, (4) a (λ, policy) sweep of
    40,000 requests against ``fastsim.sweep``; then (5)
    ``compressed_mean_rows`` on a one-rank NCCL group.  Returns the
    launches of steps (1)-(4), counted from 0."""
    import tempfile
    import torch
    from repro_torch import kernels as K
    from repro_torch.core import fastsim, fleet, shardsweep
    from repro_torch.core.distributions import LogNormalTokens, UniformTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, FCFSPolicy, SRPTPolicy)
    from repro_torch.core.predictors import LogNormalNoisePredictor
    from repro_torch.distributed import cells_mesh
    uni, ln = UniformTokens(1000), LogNormalTokens(7.0, 0.7)
    lat5 = BatchLatencyModel(0.05, 0.5, 0.0005, 0.02)
    ht = BatchLatencyModel(0.05, 0.5, 2e-4, 0.002)
    meshes = {"cells_mesh()": cells_mesh(),
              f"[{dev}, {dev}]": cells_mesh([dev, dev])}

    def policies():
        return {"dynamic": DynamicPolicy(), "elastic_b8": ElasticPolicy(b_max=8),
                "fcfs": FCFSPolicy()}

    def scaling(mesh):
        return shardsweep.fleet_sweep(
            [1, 2, 4, 8], [0.8], "jsq", DynamicPolicy(b_max=8), uni, lat5,
            num_requests=FLEET_N, seed=FLEET_SEED, mesh=mesh)["mean_wait"][:, 0]

    one = fastsim.sweep(policies(), MESH_LAMS, uni, lat5, num_requests=MESH_N,
                        seed=0, device=dev)
    # the path, counted
    K.reset_launches()
    torch.cuda.synchronize()
    for i, (name, mesh) in enumerate(meshes.items()):
        before = {k: K.LAUNCHES[k] for k in ("batch_scan", "backlog_scan")}
        t0 = time.perf_counter()
        got = scaling(mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1, s6 = (K.LAUNCHES[k] - before[k]
                  for k in ("batch_scan", "backlog_scan"))
        assert np.array_equal(got, refs["scaling"]), (name, got,
                                                      refs["scaling"])
        assert s6 == mesh.size and s1 <= 5 * mesh.size, (name, s1, s6)
        run = refs["scaling_run"]
        log(f"8f({i + 1}) fleet_sweep R in [1, 2, 4, 8], jsq + dynamic b8, "
            f"lambda 0.8, {FLEET_N} requests, on {name} ({mesh.size} "
            f"shard{'s' if mesh.size > 1 else ''}): mean waits equal phase "
            f"8b(a)'s fleet.sweep bit for bit; {s6} S6 and {s1} S1 launches "
            f"in {wall:.3f} s wall, where fleet.sweep made "
            f"{run['launches']['backlog_scan']} S6 and "
            f"{run['launches']['batch_scan']} S1 launches in "
            f"{run['wall_s']:.3f} s wall")
    lams, sigmas = refs["noise_grid"]
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        plane = shardsweep.sweep_noise(
            lambda s: SRPTPolicy(b_max=16, predictor=LogNormalNoisePredictor(s)),
            lams, sigmas, ln, ht, num_requests=NOISE_N, seed=NOISE_SEED,
            mesh=mesh)["mean_wait"]
        wall = time.perf_counter() - t0
        assert np.array_equal(plane, refs["srpt_b16"]), name
        log(f"8f(3) sweep_noise, SRPT b16 over {len(lams)} x {len(sigmas)} "
            f"(lambda, sigma) lanes x {NOISE_N} requests on {name}: equal "
            f"phase 8b(d)'s plane bit for bit ({wall:.3f} s wall, "
            f"{refs['noise_wall_s']:.3f} s in 8b)")
    for name, mesh in meshes.items():
        got = shardsweep.sweep(policies(), MESH_LAMS, uni, lat5,
                               num_requests=MESH_N, seed=0, mesh=mesh)
        assert set(got) == set(one) and all(
            np.array_equal(got[k], one[k]) for k in one), name
    log(f"8f(4) sweep of dynamic, elastic b8 and FCFS at lambda {MESH_LAMS}, "
        f"{MESH_N} requests: equal fastsim.sweep bit for bit on "
        f"{' and '.join(meshes)}")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    # both fleet sweeps again, warm, outside the counted path
    walls = {}
    for name, fn in (("fleet.sweep", lambda: fleet.sweep(
            [1, 2, 4, 8], [0.8], "jsq", DynamicPolicy(b_max=8), uni, lat5,
            num_requests=FLEET_N, seed=FLEET_SEED, device=dev)),
            ("fleet_sweep", lambda: scaling(meshes["cells_mesh()"]))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    log(f"8f warm walls of 8b(a)'s scaling curve: fleet.sweep "
        f"{walls['fleet.sweep']:.3f} s, fleet_sweep on cells_mesh() "
        f"{walls['fleet_sweep']:.3f} s")
    with tempfile.TemporaryDirectory() as tmp:
        gap, bound, ms = nccl_mean(0, 1, str(Path(tmp) / "store"))
    assert gap < bound, (gap, bound)
    log(f"8f(5) compressed_mean_rows on a one-rank NCCL group, {MEAN_SIZE} "
        f"fp32 elements: largest gap to the fp32 mean {gap:.3g} < the "
        f"reference test's bound {bound:.3g}; {ms:.3f} ms a call (host "
        f"clock, synchronized)")
    return launches


# ----------------------------------------------------------------------------
# Phase 8c: re-entrant sessions (the feedback fixed point on the kernels)
# ----------------------------------------------------------------------------

SESS_LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
# the single-server cells: a session cell per batch kernel at a load where
# the fixed point converges in well under its 200 passes (the passes grow
# with the horizon under load); WAIT has a 2 s timeout, without which each
# batch waits on the last one's children and 200 passes do not converge.
# 4,000 sessions a cell (15,000 until phase 4v came: 76.5 s for the eight
# cells, nearly all host work growing with the turns and the passes; the
# cut keeps every kernel and session model, at less depth, inside the
# script's time limit)
SESS_N, SESS_LAM, SESS_SEED = 4_000, 0.1, 5
SESS_MODELS = {"geometric": ("geometric", {"p": 0.5, "think_mean": 2.0}),
               "chain": ("chain", {"k": 3, "think": 1.0})}
SESS_POLICIES = {"batch_scan": ("dynamic", {"b_max": 16}),
                 "multibin_scan": ("multibin", {"num_bins": 4, "b_max": 16}),
                 "wait_scan": ("wait", {"k": 16, "timeout": 2.0,
                                        "b_max": 16}),
                 "srpt_scan": ("srpt", {"b_max": 16})}


def _session_cell(kernel, model, n, fast, device=None):
    """One single-server session cell of phase 8c: the oracle
    (``fast=False``, a worker of the host pool) or the kernels on
    ``device``.  Returns (waits, passes, converged, mean wait)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import get_policy
    from repro_torch.core.sessions import get_session, simulate_policy_sessions
    kind, kw = SESS_POLICIES[kernel]
    name, skw = SESS_MODELS[model]
    res = simulate_policy_sessions(
        get_policy(kind, **kw), SESS_LAM, LogNormalTokens(5.0, 0.6),
        BatchLatencyModel(**SESS_LAT), n, SESS_SEED,
        get_session(name, **skw), fast=fast, device=device)
    return res["waits"], res["passes"], res["converged"], res["mean_wait"]


def run_session_sims(dev):
    """Phase 8c: the reference benchmark ``bench_sessions.py``'s record
    ``pr9_sessions`` on the card (every fleet pass routed on S6 for
    least_work and run on S1 a replica), then one single-server session
    cell per batch kernel (S1, S3, S4, S5), each held to the oracle on
    host processes.  Returns the path's launches."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.fastsim import (
        simulate_fleet_fast, simulate_policy_fast)
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import DynamicPolicy
    from repro_torch.core.sessions import GeometricSession
    rec = json.loads((ROOT / "benchmarks" / "BENCH_simulators.json")
                     .read_text())["pr9_sessions"]
    dist, lat = LogNormalTokens(5.0, 0.6), BatchLatencyModel(**SESS_LAT)
    pol, sm = DynamicPolicy(b_max=8), GeometricSession(p=0.5, think_mean=2.0)
    with host_pool() as pool:
        oracle = {(k, m): pool.submit(_session_cell, k, m, SESS_N, False)
                  for m in SESS_MODELS for k in SESS_POLICIES}
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # (a) router x prefix discount, 500 sessions, seeds 5-9
        by = {}
        for row in rec["grid"]:
            key = (row["router"], row["prefix_discount"])
            before = dict(K.LAUNCHES)
            runs = [simulate_fleet_fast(
                row["router"], pol, 1.5, 3, dist, lat, num_requests=500,
                seed=s, sessions=sm, prefix_discount=row["prefix_discount"],
                device=dev) for s in (5, 6, 7, 8, 9)]
            waits = [r["mean_wait"] for r in runs]
            e2e = [r["sessions"]["mean_session_e2e"] for r in runs]
            by[key] = {"mean_wait": float(np.mean(waits)),
                       "mean_session_e2e": float(np.mean(e2e))}
            launched = {SIM_TAGS[k]: v - before[k]
                        for k, v in K.LAUNCHES.items() if v != before[k]}
            np.testing.assert_allclose(waits, row["per_seed_wait"], rtol=0,
                                       atol=1e-9, err_msg=str(key))
            log(f"sessions {key[0]} gamma {key[1]}: mean wait "
                f"{by[key]['mean_wait']:.6f} s (record "
                f"{row['mean_wait']:.6f}), session e2e "
                f"{by[key]['mean_session_e2e']:.6f} s (record "
                f"{row['mean_session_e2e']:.6f}); passes "
                f"{[r['passes'] for r in runs]} (converged "
                f"{[r['converged'] for r in runs]}; the benchmark asserts "
                f"none); launches {launched}")
        aff, rnd = by[("session_affinity", 0.5)], by[("random", 0.5)]
        assert aff["mean_wait"] < rnd["mean_wait"], (aff, rnd)
        assert aff["mean_session_e2e"] < rnd["mean_session_e2e"], (aff, rnd)
        assert by[("least_work", 0.0)]["mean_wait"] <= \
            by[("session_affinity", 0.0)]["mean_wait"], by
        assert aff["mean_wait"] < by[("session_affinity", 0.0)]["mean_wait"]
        # (b) feedback amplification on one server, λ = 0.4, seed 3
        amp = []
        for row in rec["feedback_amplification"]:
            r = simulate_policy_fast(
                pol, 0.4, dist, lat, num_requests=500, seed=3, device=dev,
                sessions=GeometricSession(p=row["p"], think_mean=2.0))
            amp.append(r["mean_wait"])
            assert abs(r["mean_wait"] - row["mean_wait"]) <= 1e-9, row
        assert amp[0] < amp[1] < amp[2], amp
        recorded = [r["mean_wait"] for r in rec["feedback_amplification"]]
        log(f"sessions feedback amplification p 0, 0.3, 0.5: mean wait "
            f"{[round(a, 6) for a in amp]} s (record "
            f"{[round(a, 6) for a in recorded]}); the benchmark's four "
            f"relations hold; every figure within 1e-9 s of the record")
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        # (c) a single-server cell per batch kernel, SESS_N sessions
        cells, recs = {}, {k: PathLaunches(k) for k in SESS_POLICIES}
        for k, rec_k in recs.items():
            with rec_k:
                for m in SESS_MODELS:
                    before = K.LAUNCHES[k]
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    cells[k, m] = _session_cell(k, m, SESS_N, True, dev)
                    torch.cuda.synchronize()
                    cells[k, m] += (time.perf_counter() - t1,
                                    K.LAUNCHES[k] - before)
        cells_s = time.perf_counter() - t0 - grid_s
        launches = dict(K.LAUNCHES)
        t2 = time.perf_counter()
        for (k, m), fut in oracle.items():
            ow, op, oc, om = fut.result()
            w, p, c, mean, sec, n = cells[k, m]
            assert c and oc and p == op, (k, m, p, op)
            assert n == p, f"{k} {m}: {n} launches for {p} passes"
            err = float(np.max(np.abs(w - ow)))
            assert err <= 1e-9, (k, m, err)
            log(f"sessions {m} {SESS_POLICIES[k][0]} {SESS_POLICIES[k][1]}: "
                f"{SESS_N} sessions, {len(w)} turns after warmup, converged "
                f"in {p} passes, {n} {SIM_TAGS[k]} launches, mean wait "
                f"{mean:.6f} s (oracle {om:.6f}), max |card - oracle| "
                f"{err:.3g} s, {sec:.2f} s on the card")
        oracle_wait_s = time.perf_counter() - t2
    ms = {k: r.report("session simulators") for k, r in recs.items()}
    log(f"phase 8c: the pr9_sessions grid {grid_s:.1f} s, the eight "
        f"single-server cells {cells_s:.1f} s on the card "
        f"({sum(sum(v['ms']) for v in ms.values()):.1f} ms of it in the "
        f"kernels), then {oracle_wait_s:.1f} s more for the oracle on host "
        f"processes")
    return launches


# ----------------------------------------------------------------------------
# Phase 8d: the tandem simulators (kernel S7)
# ----------------------------------------------------------------------------

# benchmarks/bench_memory.py (record pr10_memory): the serve-all tandem
# (dynamic, no cap), uniform(1..1000), λ = 0.1, 20,000 requests a seed
MEM_LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
MEM_SINGLE = dict(a=0.0212, c=1.79)
MEM_LAM, MEM_N, MEM_SEEDS = 0.1, 20_000, (1, 2, 3)
MEM_BUDGETS = (2000.25, 4000.25, 8000.25)
MEM_GATE = 4000.25                   # the control cell's budget
MEM_LONG_N = 150_000                 # the one long lane, seed 0
# the reference test's fleet cell (tests/test_memory.py): least_work +
# dynamic, λ = 0.3, R = 2, 6,000 requests, seed 9, M = 1777.25
MEM_FLEET = dict(lam=0.3, R=2, n=6_000, seed=9, M=1777.25)
S7_REPLACES = ("src/repro/core/fastsim.py:784 (_tandem_loop, a "
               "lax.while_loop; no Pallas kernel)")
# S7's first design on the same card and inputs (PERF.md §6, "earlier":
# one thread, every value of a batch's chain a dependent load from device
# memory), printed beside this run's figures
EARLIER_S7_MS = {"entry": 17.714, "nine lanes": 22.752, "long lane": 132.813}
# S7's modelled chain, from t_pf back to t_pf, for a batch that finds the
# prefill stage idle and the budget free and moves the release search one
# entry: the idle compare, two release compares, the target, the head's
# overflow compare and the prefill end, 6 float64 operations at
# CHAIN_CYCLES each (the loads they need are read ahead of them)
S7_CHAIN_OPS = 6


def _tandem_oracle(n, seed, memory, lam=MEM_LAM):
    """The tandem oracle on one pr10 cell (a worker of ``host_pool``): its
    warm waits and occupancy block."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.distributions import UniformTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import DynamicPolicy
    from repro_torch.core.simulate import simulate_policy
    r = simulate_policy(DynamicPolicy(None), lam, UniformTokens(1000),
                        BatchLatencyModel(**MEM_LAT), num_requests=n,
                        seed=seed, memory=memory)
    return r["waits"], r["memory"]


def _tandem_fleet_oracle():
    """The fleet cell on ``route_oracle`` (a worker of ``host_pool``): each
    replica's warm waits and occupancy block."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.distributions import UniformTokens
    from repro_torch.core.fleet import route_oracle
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import DynamicPolicy
    f = MEM_FLEET
    r = route_oracle("least_work", DynamicPolicy(None), f["lam"], f["R"],
                     UniformTokens(1000), BatchLatencyModel(**MEM_LAT),
                     num_requests=f["n"], seed=f["seed"], memory=f["M"])
    return [(p["waits"], p["memory"]) for p in r["per_replica"]]


def _tandem_plain(args):
    """S7's plain version on one launch's inputs (a worker of
    ``host_pool``): numpy in, numpy out."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels.tandem_scan import tandem_scan_reference
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = tandem_scan_reference(*(
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args))
    return [t.numpy() for t in out], time.perf_counter() - t0


def _tandem_same(out, ref, what):
    """An S7 launch's outputs (numpy) equal to its plain version's: every
    per-lane figure, and each lane's first nb batches."""
    starts, ends, dends, nb, *lane = out
    r_starts, r_ends, r_dends, r_nb, *r_lane = ref
    assert np.array_equal(nb, r_nb), f"{what}: batch counts differ"
    for x, y in zip(lane, r_lane):
        assert np.array_equal(x, y), f"{what}: per-lane figures differ"
    for c, k in enumerate(nb):
        for x, y in ((starts, r_starts), (ends, r_ends), (dends, r_dends)):
            assert np.array_equal(x[:k, c], y[:k, c]), f"{what}: lane {c}"


def _tandem_bytes(args, nb):
    """Bytes an S7 launch must move: arrivals, tokens and prefix sums read
    once, the per-lane inputs, three figures a batch and four a lane
    written."""
    n, lanes = args[0].shape
    return lanes * (16 * n + 8 * (n + 1) + 16 + 32) + 24 * int(np.sum(nb))


def run_tandem_sims(dev):
    """Phase 8d: the reference record ``pr10_memory`` on the card (the
    budget sweep a launch of S7 a cell, then its nine cells as nine lanes
    of one launch; the null cells on S1; the control cell's aware and blind
    recommendations on the tandem oracle), one 150,000-request lane and
    the reference test's least_work fleet cell (S6, then one S7 launch of
    a lane a replica).
    Every S7 launch is held bit for bit to its plain version on host
    processes (one on the card, timed) and every cell to the oracle.
    Returns (the path's launches, the S7 JSON entry)."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.bulk import tandem_bound
    from repro_torch.core.control import AdaptiveController
    from repro_torch.core.distributions import UniformTokens
    from repro_torch.core.fastsim import (
        simulate_fleet_fast, simulate_policy_fast, tandem_lanes)
    from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
    from repro_torch.core.memory import MemoryBudget
    from repro_torch.core.policies import (
        DynamicPolicy, ElasticPolicy, FixedPolicy)
    from repro_torch.kernels.tandem_scan import (
        tandem_scan, tandem_scan_reference)
    rec = json.loads((ROOT / "benchmarks" / "BENCH_simulators.json")
                     .read_text())["pr10_memory"]
    dist, lat = UniformTokens(1000), BatchLatencyModel(**MEM_LAT)
    pol = DynamicPolicy(None)
    with host_pool() as pool:
        oracle = {(M, s): pool.submit(_tandem_oracle, MEM_N, s, M)
                  for M in MEM_BUDGETS for s in MEM_SEEDS}
        long_oracle = pool.submit(_tandem_oracle, MEM_LONG_N, 0, MEM_GATE)
        fleet_oracle = pool.submit(_tandem_fleet_oracle)
        rec_s7 = PathLaunches("tandem_scan")
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec_s7:
            # (a) the budget sweep: a launch a cell, then one of nine lanes
            cells = {(M, s): simulate_policy_fast(
                pol, MEM_LAM, dist, lat, num_requests=MEM_N, seed=s,
                memory=M, device=dev)
                for M in MEM_BUDGETS + (None,) for s in MEM_SEEDS}
            wls = {s: pol.sample_workload(MEM_LAM, dist, MEM_N, s)
                   for s in MEM_SEEDS}
            nine = tandem_lanes([(wls[s], MemoryBudget(M), None)
                                 for M in MEM_BUDGETS for s in MEM_SEEDS],
                                lat, dev)
            # (b) the control cell, on the tandem oracle
            ctl = _memory_control(AdaptiveController, LatencyModel(
                **MEM_SINGLE), lat, dist, dev, simulate_policy_fast,
                (DynamicPolicy, ElasticPolicy, FixedPolicy))
            # (c) one long lane
            long = simulate_policy_fast(pol, MEM_LAM, dist, lat,
                                        num_requests=MEM_LONG_N, seed=0,
                                        memory=MEM_GATE, device=dev)
            # (d) the reference test's fleet cell
            f = MEM_FLEET
            fleet = simulate_fleet_fast(
                "least_work", pol, f["lam"], f["R"], dist, lat,
                num_requests=f["n"], seed=f["seed"], memory=f["M"],
                device=dev)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        s7 = rec_s7.launches
        # the nine cells, the nine-lane launch, the long lane, the fleet
        assert launches["tandem_scan"] == len(s7) == 9 + 1 + 1 + 1, launches
        assert s7[11]["args"][0].shape[1] == f["R"]
        assert launches["batch_scan"] == 3 and launches["backlog_scan"] == 1
        in_path = rec_s7.report("tandem simulators")
        # every S7 launch against its plain version on host processes
        host = [[a.cpu().numpy() if torch.is_tensor(a) else a
                 for a in lo["args"]] for lo in s7]
        outs = [[t.cpu().numpy() for t in lo["out"]] for lo in s7]
        plains = pool.map(_tandem_plain, host)

        # the record: every cell's integers and kv_peak, per-seed waits
        # within 1e-9 s, the tandem bound's arms
        by_m = {}
        for row in rec["budget_sweep"]:
            M = row["memory"]
            waits = [cells[M, s]["mean_wait"] for s in MEM_SEEDS]
            np.testing.assert_allclose(waits, row["per_seed_wait"], rtol=0,
                                       atol=1e-9, err_msg=str(M))
            by_m[M] = float(np.mean(waits))
            if M is None:
                continue
            for s, occ in zip(MEM_SEEDS, row["occupancy"]):
                mem = cells[M, s]["memory"]
                for k in ("blocked_batches", "deferred_requests", "kv_peak",
                          "utilization"):
                    assert mem[k] == occ[k], (M, s, k, mem[k], occ[k])
            tb = tandem_bound(dist, lat, MEM_LAM, memory=M)
            for k, v in row["tandem_bound"].items():
                assert tb[k] == v or abs(tb[k] - v) <= 1e-12 * abs(v), (M, k)
            log(f"tandem M={M}: mean wait {by_m[M]:.9f} s (record "
                f"{row['mean_wait']:.9f}); per seed blocked batches "
                f"{[cells[M, s]['memory']['blocked_batches'] for s in MEM_SEEDS]}"
                f", deferred {[cells[M, s]['memory']['deferred_requests'] for s in MEM_SEEDS]}"
                f", kv_peak {[cells[M, s]['memory']['kv_peak'] for s in MEM_SEEDS]}"
                f", all equal to the record; tandem bound "
                f"{tb['wait_bound']:.6f} s (b_mem {tb['b_mem']})")
        log(f"tandem M=None (S1): mean wait {by_m[None]:.9f} s (record "
            f"{rec['budget_sweep'][-1]['mean_wait']:.9f})")
        assert all(by_m[M] > by_m[None] for M in MEM_BUDGETS), by_m
        assert by_m[2000.25] > by_m[8000.25], by_m
        for j, (M, s) in enumerate((M, s) for M in MEM_BUDGETS
                                   for s in MEM_SEEDS):
            one, lane = cells[M, s], nine[j]
            assert np.array_equal(one["waits"], lane["waits"]) and \
                one["memory"] == lane["memory"], (M, s)
        log("tandem: the nine cells as nine lanes of one S7 launch equal the "
            "nine single-lane launches, waits and occupancy")
        # the oracle on host processes
        for (M, s), fut in oracle.items():
            ow, om = fut.result()
            assert np.array_equal(cells[M, s]["waits"], ow) and \
                cells[M, s]["memory"] == om, (M, s)
        ow, om = long_oracle.result()
        assert np.array_equal(long["waits"], ow) and long["memory"] == om
        for p, (ow, om) in zip(fleet["per_replica"], fleet_oracle.result()):
            assert np.array_equal(p["waits"], ow) and p["memory"] == om
        log(f"tandem fleet least_work R={f['R']} M={f['M']}: replica requests "
            f"{fleet['replica_counts']}, mean wait {fleet['mean_wait']:.6f} s,"
            f" blocked batches {fleet['memory']['blocked_batches']}, deferred "
            f"{fleet['memory']['deferred_requests']}; per-replica waits and "
            f"occupancy equal to route_oracle's")
        plain_s = []
        for j, (out, (ref, sec)) in enumerate(zip(outs, plains)):
            _tandem_same(out, ref, f"S7 launch {j}")
            plain_s.append(sec)
        log(f"tandem: all {len(s7)} S7 launches equal their plain versions "
            f"(host processes, {sum(plain_s):.1f} s of plain loops), every "
            f"cell, the long lane and both replicas equal the oracle; the "
            f"path took {path_s:.1f} s on the card")
    # timings on the entry cell (M = 4000.25, seed 1: one lane of 20,000,
    # as simulate_policy_fast launches it), the nine-lane launch and the
    # long lane, by CUDA events on each launch's own inputs: the wrapper
    # (its layout copies and transposes included) and the kernel alone
    from repro_torch.kernels.tandem_scan import ops as s7_ops
    entry = 3                                   # M = 4000.25, seed 1
    rows, chains = {}, {}
    for label, j in (("entry", entry), ("nine lanes", 9),
                     ("long lane", 10)):
        args = s7[j]["args"]
        n, lanes = args[0].shape
        ms = event_ms(lambda: tandem_scan(*args))
        laid = s7_ops.layout(*args[:3])
        alone = event_ms(lambda: s7_ops.launch(laid, *args[3:5], n,
                                               *args[5:]))
        nbytes = _tandem_bytes(args, outs[j][3])
        # the slowest lane's batches: the launch's chain
        most = int(np.max(outs[j][3]))
        chain = 1e3 * most * S7_CHAIN_OPS * CHAIN_CYCLES / CHAIN_HZ
        rows[label] = {"shape": [n, lanes], "ms": ms, "kernel_only_ms": alone,
                       "ns_per_request": 1e6 * ms / n,
                       "ns_per_lane_request": 1e6 * ms / (n * lanes),
                       "batches": int(np.sum(outs[j][3])),
                       "ns_per_batch": 1e6 * alone / most,
                       "bound_ms": bound_ms(nbytes, 0, "float64")}
        chains[label] = chain
    e_args = s7[entry]["args"]
    plain_out, plain_ms = wall_ms(lambda: tandem_scan_reference(*e_args))
    _tandem_same(outs[entry], [t.cpu().numpy() for t in plain_out],
                 "S7 entry on the card")
    for label, r in rows.items():
        log(f"S7 tandem_scan {label} {r['shape']}: {r['ms']:.3f} ms by CUDA "
            f"events, the wrapper ({r['kernel_only_ms']:.3f} the kernel "
            f"alone; the first design {EARLIER_S7_MS[label]:.3f} ms, "
            f"PERF.md); "
            f"{r['ns_per_request']:.1f} ns a request, "
            f"{r['ns_per_lane_request']:.1f} ns a lane-request, "
            f"{r['ns_per_batch']:.1f} ns a batch of the slowest lane "
            f"(kernel alone; {r['batches']} batches in all); bound "
            f"{r['bound_ms']:.5f} ms (bytes; {100 * r['bound_ms'] / r['ms']:.3f}"
            f"% of it); modelled chain {chains[label]:.3f} ms "
            f"({100 * chains[label] / r['kernel_only_ms']:.1f}% of the "
            f"kernel alone)")
    log(f"S7 plain version on the card, entry cell: {plain_ms:.1f} ms; "
        f"equal to the kernel")
    log(f"tandem control λ={MEM_LAM} M={MEM_GATE}: {ctl}")
    e = rows["entry"]
    return launches, {
        "name": "tandem_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/tandem_scan/csrc/tandem_scan.cu",
        "replaces": S7_REPLACES, "shape": e["shape"], "max_abs_err": 0.0,
        "ms": e["ms"], "kernel_only_ms": e["kernel_only_ms"],
        "ns_per_request": e["ns_per_request"],
        "ns_per_batch": e["ns_per_batch"],
        "plain_ms": plain_ms, "bound_ms": e["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "nine_lanes": rows["nine lanes"],
        "long_lane": rows["long lane"], "in_path": {"tandem simulators":
                                                    in_path}}


def _memory_control(controller, single, lat, dist, dev, fast, policies):
    """The record's control cell: the budget-blind and the memory-aware
    controller fed the same organic stream (bench_memory.py), each
    recommendation deployed under the gate's budget for seeds 1-3 (on the
    tandem oracle, as fixed and elastic run it); each field and wait
    within 1e-9 s of the record.  Returns a line for the log."""
    rec = json.loads((ROOT / "benchmarks" / "BENCH_simulators.json")
                     .read_text())["pr10_memory"]["control"]
    dynamic, elastic, fixed = policies

    def fed(memory=None):
        ctrl = controller(single, lat, theta=1.0, memory=memory)
        rng = np.random.default_rng(0)
        t = 0.0
        for _ in range(1500):
            t += rng.exponential(1.0 / MEM_LAM)
            ctrl.observe_arrival(t)
            ctrl.observe_completion(int(rng.integers(1, 1001)))
        return ctrl.recommendation(force=True)

    def deploy(r):
        return (fixed(b=r.b_max) if r.policy == "fixed" else
                elastic(b_max=r.b_max) if r.policy == "elastic" else
                dynamic(b_max=r.b_max))

    blind, aware = fed(), fed(memory=MEM_GATE)
    assert (aware.policy, aware.b_max, aware.details["b_mem"]) == \
        (rec["aware"]["policy"], rec["aware"]["b_max"],
         rec["aware"]["b_mem"]), aware
    assert (blind.policy, blind.b_max) == (rec["blind"]["policy"],
                                           rec["blind"]["b_max"]), blind
    assert aware.details["memory_binding"] and aware.memory_budget == MEM_GATE
    got = []
    for row in rec["per_seed"]:
        kw = dict(num_requests=MEM_N, seed=row["seed"], memory=MEM_GATE,
                  device=dev)
        w_b = fast(deploy(blind), MEM_LAM, dist, lat, **kw)["mean_wait"]
        w_a = fast(deploy(aware), MEM_LAM, dist, lat, **kw)["mean_wait"]
        assert abs(w_b - row["blind_wait"]) <= 1e-9, (row, w_b)
        assert abs(w_a - row["aware_wait"]) <= 1e-9, (row, w_a)
        assert w_a < w_b
        got.append((row["seed"], round(w_a, 6), round(w_b, 6)))
    return (f"aware {aware.policy} b_max {aware.b_max} (b_mem "
            f"{aware.details['b_mem']}), blind {blind.policy} b_max "
            f"{blind.b_max}, as recorded; per seed (seed, aware, blind wait "
            f"s) {got}, each within 1e-9 s of the record")


# ----------------------------------------------------------------------------
# Phase 8e: the closed-loop autoscaler (M7e)
# ----------------------------------------------------------------------------

# benchmarks/bench_autoscale.py (record pr8_autoscale), full size: elastic,
# lognormal(5, 0.8), λ = 8, sinusoid amplitude 0.9 and period 2,000, 32,000
# requests, seed 0, windows of 200 s, at most 8 replicas at a cost of 5
AUTOSCALE = dict(num_requests=32_000, seed=0, window=200.0, max_replicas=8,
                 replica_cost=5.0, shed_cost=0.0)
AUTOSCALE_LAM = 8.0
AUTOSCALE_CTRL = {"replica_target_util": 0.4}


def _autoscale_args():
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.policies import ElasticPolicy
    from repro_torch.core.traffic import SinusoidTraffic
    return (ElasticPolicy(), AUTOSCALE_LAM, LogNormalTokens(5.0, 0.8),
            BatchLatencyModel(k1=0.05, k2=0.5, k3=0.0005, k4=0.02),
            SinusoidTraffic(amplitude=0.9, period=2000.0))


def _autoscale_oracle():
    """The adaptive run on the port's NumPy oracle (``fast=False``; a
    worker of ``host_pool``): its actions as tuples and its waits."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.control import simulate_controlled
    pol, lam, dist, lat, tm = _autoscale_args()
    t0 = time.perf_counter()
    r = simulate_controlled(pol, lam, dist, lat, traffic=tm, fast=False,
                            controller_kwargs=AUTOSCALE_CTRL, **AUTOSCALE)
    return ([dataclasses.astuple(a) for a in r.actions], r.waits,
            time.perf_counter() - t0)


def run_autoscale_sims(dev):
    """Phase 8e: ``pr8_autoscale`` on the card through ``run_controlled``
    (each window's replicas a launch of S1 each): the adaptive run, the
    eight static (R, router) rows and the clairvoyant run, then the
    four-traffic sweep through ``simulate_fleet_fast`` (S1, S6).  Holds the
    replica trace and shed count equal to the record, every objective and
    mean wait within 1e-6 relative, the adaptive objective below the best
    static one, and the adaptive run to the port's oracle on a host process
    (equal actions, waits within 1e-9 s).  Times every S1 launch of the
    path by CUDA events."""
    import torch
    from repro_torch import kernels as K
    from repro_torch.core.fastsim import run_controlled, simulate_fleet_fast
    from repro_torch.core.traffic import default_traffic
    rec = json.loads((ROOT / "benchmarks" / "BENCH_simulators.json")
                     .read_text())["pr8_autoscale"]
    pol, lam, dist, lat, tm = _autoscale_args()
    kw = dict(AUTOSCALE, traffic=tm, device=dev)
    with host_pool() as pool:
        oracle = pool.submit(_autoscale_oracle)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with PathLaunches("batch_scan") as s1:
            adaptive = run_controlled(pol, lam, dist, lat,
                                      controller_kwargs=AUTOSCALE_CTRL, **kw)
            statics = [(R, rt, run_controlled(pol, lam, dist, lat,
                                              fixed=(R, rt), **kw))
                       for R in (1, 2, 4, 8)
                       for rt in ("round_robin", "least_work")]
            clair = run_controlled(pol, lam, dist, lat, clairvoyant=True, **kw)
            t_ctrl = time.perf_counter() - t0
            sweep = {name: float(simulate_fleet_fast(
                "least_work", pol, lam, 4, dist, lat,
                num_requests=min(AUTOSCALE["num_requests"], 16_000),
                seed=AUTOSCALE["seed"], traffic=m, device=dev)["mean_wait"])
                for name, m in default_traffic().items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        in_path = s1.report("autoscale")
        actions, o_waits, o_s = oracle.result()

    def rel(a, b):
        return abs(a - b) / abs(b)

    trace = [a.replicas for a in adaptive.actions]
    assert trace == rec["replica_trace"], (trace, rec["replica_trace"])
    assert adaptive.shed == rec["adaptive"]["shed"]
    rows = [("adaptive", adaptive, rec["adaptive"]),
            ("clairvoyant", clair, rec["clairvoyant"])]
    for (R, rt, r), row in zip(statics, rec["static_grid"]):
        assert (row["replicas"], row["router"]) == (R, rt), (row, R, rt)
        rows.append((f"static R={R} {rt}", r, row))
    deltas = {}
    for name, got, want in rows:
        d_obj = rel(got.objective, want["objective"])
        d_wait = rel(got.mean_wait, want["mean_wait"])
        assert d_obj <= 1e-6 and d_wait <= 1e-6, (name, d_obj, d_wait)
        deltas[name] = (d_obj, d_wait)
        log(f"8e {name}: objective {got.objective:.6f} (record "
            f"{want['objective']:.6f}, rel. delta {d_obj:.2e}), mean wait "
            f"{got.mean_wait:.6f} s (record {want['mean_wait']:.6f}, rel. "
            f"delta {d_wait:.2e}), average replicas {got.avg_replicas:.4f}")
    best = min(r.objective for _, _, r in statics)
    assert adaptive.objective < best, (adaptive.objective, best)
    regret = adaptive.objective - clair.objective
    assert np.isfinite(regret) and abs(regret) < best
    for name, w in sweep.items():
        want = next(r["mean_wait"] for r in rec["traffic_sweep"]
                    if r["traffic"] == name)
        assert rel(w, want) <= 1e-6, (name, w, want)
    assert sweep["sinusoid"] > sweep["stationary"]
    log(f"8e traffic sweep (least_work, R = 4, 16,000 requests): "
        f"{', '.join(f'{k} {v:.6f} s' for k, v in sweep.items())}, each within "
        f"1e-6 of the record")
    # the adaptive run against the port's oracle twin
    assert [dataclasses.astuple(a) for a in adaptive.actions] == actions, \
        "the card's actions differ from the oracle's"
    diff = float(np.nanmax(np.abs(adaptive.waits - o_waits)))
    assert np.array_equal(np.isnan(adaptive.waits), np.isnan(o_waits))
    assert diff <= 1e-9, diff
    bit = np.array_equal(adaptive.waits, o_waits, equal_nan=True)
    log(f"8e adaptive vs the oracle (fast=False, a host process, "
        f"{o_s:.1f} s): actions equal over {len(actions)} windows, largest "
        f"wait difference {diff:.3e} s, bit-equal: {bit}")
    share = in_path["total_ms"] / 1e3 / wall
    log(f"8e replica trace {trace} (as recorded); adaptive objective "
        f"{adaptive.objective:.4f} < best static {best:.4f}, clairvoyant "
        f"{clair.objective:.4f}, regret {regret:.4f}; the control runs "
        f"{t_ctrl:.2f} s, the path {wall:.2f} s on the host's clock, "
        f"{in_path['launches']} S1 launches {in_path['total_ms']:.1f} ms of "
        f"it ({100 * share:.1f}%); launches {launches}")
    return launches, {"launches": in_path["launches"],
                      "total_ms": in_path["total_ms"], "wall_s": wall,
                      "deltas": deltas}


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
    for name in ("flash_attention", "flash_attention_bwd",
                 "ragged_decode_attention", "fused_rmsnorm",
                 "fused_rmsnorm_bwd", "batch_scan", "impatience_scan", "multibin_scan", "wait_scan",
                 "srpt_scan", "backlog_scan", "tandem_scan", "ssd_scan",
                 "ssd_scan_bwd"):
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

    kernels = [timed(f"phase 2 {check.__name__}", check, dev, *more)
               for check, *more in (
                   (check_ragged,), (check_gather, engine, cfg),
                   (check_flash,), (check_rmsnorm,), (check_flash_bwd,),
                   (check_rmsnorm_bwd,), (check_ssd_scan,),
                   (check_ssd_scan_bwd,))]
    for check in (check_small_model, check_small_moe, check_small_jamba,
                  check_small_m8c):
        timed(f"phase 3 {check.__name__}", check, dev)
    from repro_torch.data.pipeline import make_request_stream
    reqs = make_request_stream(32, 4.0, ClippedLogNormal(np.log(96.0), 0.8, 512),
                               vocab=cfg.vocab_size, prompt_len_range=(16, 257),
                               seed=0)
    paths = {}
    paths["serving schedule"], k4_step = timed(
        "phase 4 (serving schedule)", serve_full, engine, reqs)
    cal = engine.calibration_log()          # phase 4's measurements (M4)
    paths["continuous"] = timed("phase 6 (continuous batching)", serve_cont,
                                engine, reqs)
    from repro_torch.core.traffic import MMPPTraffic
    fleet_reqs = make_request_stream(
        32, 4.0, ClippedLogNormal(np.log(96.0), 0.8, 512), vocab=cfg.vocab_size,
        prompt_len_range=(16, 257), seed=0,
        traffic=MMPPTraffic(rates=(0.5, 2.0), mean_dwell=(200.0, 100.0)))
    paths["fleet serving"] = timed("phase 8a (fleet serving)", serve_fleet,
                                   engine, fleet_reqs)
    paths["resilient fleet serving"] = timed(
        "phase 8a(c) (resilient fleet serving)", serve_resilient, engine, reqs)
    paths["serving under a KV budget"] = timed(
        "phase 4m (serving under a KV budget)", serve_memory, engine, reqs)
    paths["dense families"], dense = timed(
        "phase 4d (the dense families)", serve_dense, ecfg, reqs)
    del engine
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4e starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated on the card")
    moe_ecfg = dataclasses.replace(ecfg, max_seq=MOE_MAX_SEQ)
    paths["moe families"], moe = timed(
        "phase 4e (the MoE families)", serve_moe, moe_ecfg, reqs)
    paths["ssm family"], ssm = timed(
        "phase 4s (the state-space family)", serve_ssm, ecfg, reqs)
    paths["m8c families"], m8c = timed(
        "phase 4v (the audio and vision families)", serve_m8c, moe_ecfg, reqs)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9t starts with {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated on the card")
    train_paths, train_rows, ssm_train_row = run_training()
    paths.update(train_paths)
    paths["launcher"] = timed("phase 5 (the serving launcher)",
                              serve_launcher, dev)
    paths["simulators"], sim_kernels = timed("phase 7 (simulators)",
                                             run_simulators, dev, cal)
    kernels += sim_kernels
    (paths["fleet simulators"], s6, noise_s5, noise_s3, noise_s4,
     s1_path, mesh_refs) = timed("phase 8b (fleet simulators)",
                                 run_fleet_sims, dev)
    paths["mesh sweeps"] = timed("phase 8f (the mesh sweeps)",
                                 run_mesh_sweeps, dev, mesh_refs)
    paths["session simulators"] = timed("phase 8c (session simulators)",
                                        run_session_sims, dev)
    paths["tandem simulators"], s7 = timed("phase 8d (tandem simulators)",
                                           run_tandem_sims, dev)
    paths["autoscale"], s1_autoscale = timed(
        "phase 8e (the closed-loop autoscaler)", run_autoscale_sims, dev)
    kernels.append(s7)
    kernels.append(s6)
    next(k for k in kernels if k["name"] == "fused_rmsnorm")[
        "decode_step"] = k4_step
    s5 = next(k for k in kernels if k["name"] == "srpt_scan")
    s5["in_path"]["fleet simulators"] = noise_s5.pop("in_path")
    s5["sweep_noise"] = noise_s5
    next(k for k in kernels if k["name"] == "multibin_scan")["sweep_noise"] = \
        noise_s3
    next(k for k in kernels if k["name"] == "wait_scan")["sweep_noise"] = \
        noise_s4
    next(k for k in kernels if k["name"] == "batch_scan")["in_path"] = \
        {"fleet simulators": s1_path, "autoscale": s1_autoscale}
    for k in kernels:
        if k["name"] in SERVING_KERNELS:
            k["dense_families"] = {arch: row["launches"][k["name"]]
                                   for arch, row in dense.items()}
            k["moe_families"] = {arch: row["launches"][k["name"]]
                                 for arch, row in moe.items()}
        if k["name"] in MODEL_KERNELS:
            k["ssm_family"] = {arch: row["launches"][k["name"]]
                               for arch, row in ssm.items()}
            k["m8c_families"] = {arch: row["launches"][k["name"]]
                                 for arch, row in m8c.items()}
    for k in kernels:
        if k["name"] in TRAIN_KERNELS:
            k["train_full_width"] = {
                name: {"launches_per_step": row["launches_per_step"][k["name"]],
                       "device_ms_per_step": row["device_ms"][k["name"]]}
                for name, row in train_rows.items()}
        if k["name"] in SSM_TRAIN_KERNELS:
            k["train_mamba2_full_width"] = {
                "launches_per_step":
                    ssm_train_row["launches_per_step"][k["name"]],
                "device_ms_per_step": ssm_train_row["device_ms"][k["name"]]}
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
