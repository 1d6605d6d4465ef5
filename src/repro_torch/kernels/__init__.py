"""Hand-written Hopper kernels: the build-and-load helper, the launch
counters, and the one place that decides where a tensor runs.

Each kernel is a CUDA C++ source under ``<kernel>/csrc`` with a plain C
interface.  ``library(name)`` compiles it with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout (file name keyed by a hash
of the source and its flags, so an edited source rebuilds) and loads it
with ``ctypes``; the compiler's output is kept beside it (``.log``).
Nothing is built or loaded at import: the CPU tests import every module on
a machine with no ``nvcc``.

``on_cuda(*tensors)`` is the device check every wrapper uses: True for
CUDA tensors (launch the kernel), False for CPU tensors (run the plain
PyTorch version), an error for anything else or a mix.  There is no
fallback from one to the other.

``LAUNCHES`` counts kernel launches by name; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

SOURCES = {
    "ragged_decode_attention":
        _PKG / "ragged_decode_attention" / "csrc" / "ragged_decode_attention.cu",
    "gather_rows": _PKG / "compaction" / "csrc" / "gather_rows.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "fused_rmsnorm": _PKG / "rmsnorm" / "csrc" / "fused_rmsnorm.cu",
    # the port's own kernels: the simulators' per-request recursions (S1,
    # S2), batch-event loops (S3-S5) and the fleet's routing scan (S6)
    "batch_scan": _PKG / "batch_scan" / "csrc" / "batch_scan.cu",
    "impatience_scan": _PKG / "impatience_scan" / "csrc" / "impatience_scan.cu",
    "multibin_scan": _PKG / "multibin_scan" / "csrc" / "multibin_scan.cu",
    "wait_scan": _PKG / "wait_scan" / "csrc" / "wait_scan.cu",
    "srpt_scan": _PKG / "srpt_scan" / "csrc" / "srpt_scan.cu",
    "backlog_scan": _PKG / "backlog_scan" / "csrc" / "backlog_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# flags for one source only, after NVCC_FLAGS: the redesigned kernels and
# the simulator scans report their registers, shared memory and spills
# (ptxas -v) into the build log
EXTRA_FLAGS = {
    "ragged_decode_attention": ("-Xptxas=-v",),
    "flash_attention": ("-Xptxas=-v",),
    "batch_scan": ("-Xptxas=-v",),
    "impatience_scan": ("-Xptxas=-v",),
    "multibin_scan": ("-Xptxas=-v",),
    "wait_scan": ("-Xptxas=-v",),
    "srpt_scan": ("-Xptxas=-v",),
    "backlog_scan": ("-Xptxas=-v",),
}

LAUNCHES: Dict[str, int] = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches():
    for name in SOURCES:
        LAUNCHES[name] = 0


def resolve_device(device=None) -> torch.device:
    """An entry point's device: CUDA unless the caller names one.  With
    ``device=None`` and no GPU this raises instead of running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the plain PyTorch paths on the CPU")
    return torch.device("cuda")


def on_cuda(*tensors) -> bool:
    """True if every tensor is on CUDA, False if every one is on the CPU."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: need all on one "
                     "CUDA device or all on the CPU")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _flags(name: str):
    return (*NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()))


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output from building kernel ``name`` ('' if it was
    not built here)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    compile took (0.0 for a library already on disk); raises with the
    compiler's output if one fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, secs = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check_status(name: str, status: int):
    """Raise if a launch returned a CUDA error (the C functions return
    ``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{status}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
