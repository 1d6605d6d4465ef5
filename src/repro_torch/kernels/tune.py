"""Time variants of the simulator kernels S1 (``batch_scan``), S2
(``impatience_scan``), S4 (``wait_scan``) and S7 (``tandem_scan``) on the
card, to choose their shape constants.

Each kernel's source fixes its shape constants as ``constexpr int NAME =
value;`` lines.  This module writes copies of the source with other values
into ``build/kernels/variants/``, compiles them all at once with the
committed kernel's flags, and times each by CUDA events on the inputs the
main path gives the kernel (``chip_smoke.py`` phases 7, 8b and 8d), beside
the committed kernel.  Every variant's outputs must equal the committed
kernel's, bit for bit, or the run fails; a variant that does not build
(one that breaks a ``static_assert`` of the source, such as a ring past
shared memory) is reported and skipped.  The committed kernel itself is
held to its plain version by ``chip_smoke.py`` and the GPU tests.

    PYTHONPATH=src python -m repro_torch.kernels.tune [kernel ...]

(every kernel of ``GRIDS`` when none is named).  Needs a CUDA device and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import itertools
import re
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import kernels as K

# the grids timed: constant name -> candidate values (a variant must keep
# the source's static_asserts, or it fails to build and is reported)
GRIDS = {
    "batch_scan": {"STAGES": (2, 4, 8)},
    "impatience_scan": {"TILE": (256, 512, 1024, 2048), "STAGES": (2, 4, 8)},
    "wait_scan": {"CHUNKS": (4, 8, 16), "AHEAD": (2, 4, 6)},
    "tandem_scan": {"TILE": (128, 256, 512), "STAGES": (2, 4)},
}
S2_RING_LIMIT = 227 * 1024     # a block's shared memory, bytes


def variant_source(text: str, values: dict) -> str:
    """``text`` with each ``constexpr int NAME = v;`` set to values[NAME]."""
    for name, v in values.items():
        text, hits = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{v};",
                             text)
        if hits != 1:
            raise ValueError(f"constexpr int {name} found {hits} times")
    return text


def build_sources(name: str, sources: dict) -> dict:
    """Compile {label: source text} of kernel ``name`` in parallel; returns
    {label: CDLL, or the compiler's output if it failed}."""
    out_dir = K.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = K._nvcc(), {}
    for label, text in sources.items():
        stem = out_dir / f"{name}-{re.sub(r'[^A-Za-z0-9]+', '_', label)}"
        stem.with_suffix(".cu").write_text(text)
        cmd = [nvcc, *K._flags(name), "-o", str(stem.with_suffix(".so")),
               str(stem.with_suffix(".cu"))]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        stem)
    libs = {}
    for label, (proc, stem) in procs.items():
        log, _ = proc.communicate()
        libs[label] = ctypes.CDLL(str(stem.with_suffix(".so"))) \
            if proc.returncode == 0 else log
    return libs


def _s1_inputs(dev):
    """(label, args) of S1 launches at the main path's shapes."""
    from repro_torch.core.distributions import LogNormalTokens, UniformTokens
    from repro_torch.core.fastsim import scan_lane_inputs
    from repro_torch.core.policies import DynamicPolicy, ElasticPolicy
    from repro_torch.kernels.batch_scan import NO_CAP
    uni, ln = UniformTokens(1000), LogNormalTokens(7.0, 0.7)
    lat5, lat6 = (0.05, 0.5, 0.0005, 0.02), (0.05, 0.5, 2e-4, 0.002)
    fig5 = {"dynamic": DynamicPolicy(), "dynamic_b8": DynamicPolicy(b_max=8),
            "elastic": ElasticPolicy(), "elastic_b8": ElasticPolicy(b_max=8)}
    heavy = {"dyn": DynamicPolicy(), "dyn_b32": DynamicPolicy(b_max=32),
             "dyn_b16": DynamicPolicy(b_max=16), "ela": ElasticPolicy()}
    cases = [("Fig 5, 64 lanes x 150,000", fig5, np.geomspace(0.05, 0.8, 16),
              uni, 150_000, 0, lat5),
             ("heavy tail, 8 lanes x 60,000", heavy, [0.5, 1.0], ln, 60_000,
              15, lat6),
             ("one fleet replica, 1 lane x 10,000", {"dyn_b8": DynamicPolicy(
                 b_max=8)}, [0.2], uni, 10_000, 3, lat5)]
    out = []
    for label, pols, lams, dist, n, seed, lat in cases:
        lanes, arr, tok = scan_lane_inputs(pols, lams, dist, n, seed)
        el = torch.tensor([e for *_, e, _ in lanes], device=dev)
        bm = torch.tensor([NO_CAP if b is None else float(b)
                           for *_, b in lanes], dtype=torch.float64,
                          device=dev)
        out.append((label, (torch.from_numpy(arr).to(dev),
                            torch.from_numpy(tok).to(dev), el, bm, *lat)))
    return out


def _s4_inputs(dev):
    """(label, args) of S4 launches at the main path's shapes: phase 7's
    heavy-tail WAIT k16 cells and phase 8b's noise plane as one launch."""
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.policies import WaitPolicy
    ln, lat = LogNormalTokens(7.0, 0.7), (0.05, 0.5, 2e-4, 0.002)

    def launch(wls):
        arr = np.stack([w.arrivals for w in wls], axis=1)
        tok = np.stack([w.tokens for w in wls], axis=1)
        lanes = len(wls)
        return (torch.from_numpy(arr).to(dev), torch.from_numpy(tok).to(dev),
                torch.full((lanes,), 16, dtype=torch.int64, device=dev),
                torch.full((lanes,), float("inf"), dtype=torch.float64,
                           device=dev),
                torch.zeros(lanes, dtype=torch.int64, device=dev), *lat)
    pol = WaitPolicy(k=16)
    out = [(f"heavy tail λ={lam}, 1 lane x 60,000",
            launch([pol.sample_workload(lam, ln, 60_000, 15)]))
           for lam in (0.5, 1.0)]
    # WAIT ignores the predicted lengths: the plane's lanes are its λ rows
    out.append(("noise plane, 10 lanes x 30,000", launch(
        [pol.sample_workload(lam, ln, 30_000, 15) for lam in (0.6, 1.0)
         for _ in range(5)])))
    return out


def _s2_inputs(dev):
    """(label, args) of S2 launches at the main path's shapes: phase 7's
    four impatient Fig 4 cells as one launch, and the first alone; args are
    the kernel's laid-out inputs, tau and n."""
    from repro_torch.core.distributions import LogNormalTokens
    from repro_torch.core.fastsim import impatience_lane_inputs
    from repro_torch.core.latency_model import PAPER_A100_LLAMA2_7B
    from repro_torch.core.policies import FCFSPolicy
    from repro_torch.kernels.impatience_scan.ops import layout
    n = 200_000
    pols = {(n_max, tau): FCFSPolicy(n_max=n_max, tau=tau)
            for n_max in (None, 1600) for tau in (30.0, 120.0)}
    _, inter, service, tau = impatience_lane_inputs(
        pols, [1 / 40], LogNormalTokens(7.0, 0.7), PAPER_A100_LLAMA2_7B, n)
    out = []
    for label, cut in (("Fig 4, 4 lanes x 200,000", slice(None)),
                       ("one Fig 4 cell, 1 lane x 200,000", slice(0, 1))):
        laid = layout(torch.from_numpy(inter[:, cut]).to(dev),
                      torch.from_numpy(service[:, cut]).to(dev))
        out.append((label, (*laid, torch.from_numpy(tau[cut]).to(dev), n)))
    return out


def _s7_inputs(dev):
    """(label, args) of S7 launches at the main path's shapes (phase 8d):
    the entry cell (``pr10_memory``'s M = 4000.25, seed 1: one lane of
    20,000), the nine cells as one launch and the 150,000-request lane;
    args are the kernel's laid-out inputs, cap, b_max, n and the law."""
    from repro_torch.core.distributions import UniformTokens
    from repro_torch.core.fastsim import tandem_lanes
    from repro_torch.core.latency_model import BatchLatencyModel
    from repro_torch.core.memory import MemoryBudget
    from repro_torch.core.policies import DynamicPolicy
    from repro_torch.kernels.tandem_scan.ops import layout
    dist, pol = UniformTokens(1000), DynamicPolicy(None)
    lat = BatchLatencyModel(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
    wls = {s: pol.sample_workload(0.1, dist, 20_000, s) for s in (1, 2, 3)}
    cases = [("pr10 entry cell, 1 lane x 20,000",
              [(wls[1], MemoryBudget(4000.25), None)]),
             ("pr10 nine cells, 9 lanes x 20,000",
              [(wls[s], MemoryBudget(M), None)
               for M in (2000.25, 4000.25, 8000.25) for s in (1, 2, 3)]),
             ("long lane, 1 lane x 150,000",
              [(pol.sample_workload(0.1, dist, 150_000, 0),
                MemoryBudget(4000.25), None)])]
    out = []
    for label, cells in cases:
        lo = {}
        tandem_lanes(cells, lat, dev, launch_out=lo)
        arr, tok, fp_cum, cap, b_max, *law = lo["args"]
        out.append((label, (layout(arr, tok, fp_cum), cap, b_max,
                            arr.shape[0], law)))
    return out


def _shape(name, args):
    """(requests a lane, the shape of each output) of a launch: [n, lanes],
    or for S2 and S7 [lanes, ld], lanes major as their kernels write
    them."""
    if name == "impatience_scan":
        return args[3], tuple(args[0].shape)
    if name == "tandem_scan":
        return args[3], tuple(args[0][0].shape)
    return args[0].shape[0], tuple(args[0].shape)


def _outputs(name, shape, dev):
    """A launch's outputs, zeroed (so that what a kernel leaves unwritten
    compares equal)."""
    f64 = dict(dtype=torch.float64, device=dev)
    if name == "tandem_scan":
        lanes = shape[0]
        return (torch.zeros(shape, **f64),
                torch.zeros(shape, dtype=torch.int64, device=dev),
                torch.zeros(shape, **f64),
                *(torch.zeros(lanes, dtype=torch.int64, device=dev)
                  for _ in range(2)),
                torch.zeros(lanes, **f64),
                torch.zeros(lanes, dtype=torch.int64, device=dev))
    return (torch.zeros(shape, **f64),
            torch.zeros(shape, dtype=torch.uint8, device=dev))


def _run(lib, name, args, outs):
    """Launch kernel ``name`` of ``lib`` on the wrapper's arguments (S2: on
    its laid-out inputs)."""
    from repro_torch.kernels.batch_scan.ops import _ARGTYPES as S1_ARGS
    from repro_torch.kernels.impatience_scan.ops import _ARGTYPES as S2_ARGS
    from repro_torch.kernels.tandem_scan.ops import _ARGTYPES as S7_ARGS
    from repro_torch.kernels.wait_scan.ops import _ARGTYPES as S4_ARGS
    fn = getattr(lib, name)
    fn.argtypes = {"batch_scan": S1_ARGS, "impatience_scan": S2_ARGS,
                   "wait_scan": S4_ARGS, "tandem_scan": S7_ARGS}[name]
    fn.restype = ctypes.c_int
    if name == "tandem_scan":
        laid, cap, b_max, n, law = args
        status = fn(*(x.data_ptr() for x in laid), laid[0].shape[1],
                    cap.data_ptr(), b_max.data_ptr(),
                    *(o.data_ptr() for o in outs), n, laid[0].shape[0],
                    *law, K.stream_ptr(cap))
        K.check_status(name, status)
        return
    if name == "impatience_scan":
        inter, service, tau, n = args
        status = fn(inter.data_ptr(), service.data_ptr(), inter.shape[1],
                    tau.data_ptr(), *(o.data_ptr() for o in outs), n,
                    tau.shape[0], K.stream_ptr(tau))
        K.check_status(name, status)
        return
    arr, tok, *rest = args
    n, lanes = arr.shape
    if name == "batch_scan":
        el, bm, *lat = rest
        ptrs = (el.data_ptr(), bm.data_ptr())
    else:
        k, timeout, bm, *lat = rest
        ptrs = (k.data_ptr(), timeout.data_ptr(), bm.data_ptr())
    status = fn(arr.data_ptr(), tok.data_ptr(), *ptrs,
                *(o.data_ptr() for o in outs), n, lanes, *lat,
                K.stream_ptr(arr))
    K.check_status(name, status)


def time_ms(fn, iters=5, warmup=1):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tune(name: str, dev) -> list:
    src = K.SOURCES[name]
    text = src.read_text()
    grid = GRIDS[name]
    sources = {"committed": text}
    for combo in itertools.product(*grid.values()):
        values = dict(zip(grid, combo))
        if "AHEAD" in values and values["CHUNKS"] - values["AHEAD"] < 2:
            continue                  # S4's step needs two landed chunks
        if name == "impatience_scan" and \
                values["TILE"] * values["STAGES"] * 16 > S2_RING_LIMIT:
            continue                  # S2's ring past shared memory
        sources[" ".join(f"{k}={v}" for k, v in values.items())] = \
            variant_source(text, values)
    t0 = time.perf_counter()
    libs = build_sources(name, sources)
    print(f"{name}: {len(libs)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    inputs = {"batch_scan": _s1_inputs, "impatience_scan": _s2_inputs,
              "wait_scan": _s4_inputs, "tandem_scan": _s7_inputs}[name](dev)
    for label, args in inputs:
        n, shape = _shape(name, args)

        def outputs():
            return _outputs(name, shape, dev)
        ref = outputs()
        _run(libs["committed"], name, args, ref)
        torch.cuda.synchronize()
        for variant, lib in libs.items():
            if isinstance(lib, str):
                print(f"{name} [{variant}]: did not build", flush=True)
                rows.append({"kernel": name, "variant": variant,
                             "shape": label, "error": lib[-2000:]})
                continue
            got = outputs()
            ms = time_ms(lambda: _run(lib, name, args, got))
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            rows.append({"kernel": name, "variant": variant, "shape": label,
                         "ms": ms, "ns_per_request": 1e6 * ms / n,
                         "equal_to_committed": same})
            print(f"{name} [{variant}] {label}: {ms:.3f} ms "
                  f"({1e6 * ms / n:.1f} ns a request a lane)"
                  f"{'' if same else '  DIFFERS from the committed kernel'}",
                  flush=True)
    return rows


def main(names=None) -> int:
    names = list(names or GRIDS)
    unknown = set(names) - set(GRIDS)
    if unknown:
        print(f"tune: no grid for {sorted(unknown)}; have {sorted(GRIDS)}")
        return 2
    if not torch.cuda.is_available():
        print("tune: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    rows = [r for name in names for r in tune(name, dev)]
    bad = [r for r in rows if "error" not in r
           and not r["equal_to_committed"]]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
