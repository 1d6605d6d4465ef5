"""Wrapper for the SSD chunk-state scan kernel (``csrc/ssd_scan.cu``,
S8).

``ssd_state_scan(chunk_decay, states, h0)`` runs the recurrence
``h_c = h_{c-1} * chunk_decay[:, c] + states[:, c]`` over the C chunks
and returns the state before each chunk and the final state.  CUDA
tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes (fp32, contiguous,
matching shapes, one device) and raises on the rest; it never falls back
from one to the other.  Under autograd a CUDA call raises
``NotImplementedError`` (ROADMAP.md M10b: S8 has no backward kernel yet);
on the CPU autograd differentiates the plain version."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_reference

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(chunk_decay, states, h0):
    tensors = (chunk_decay, states) + (() if h0 is None else (h0,))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_state_scan takes fp32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_state_scan takes contiguous tensors")
    if states.ndim != 5:
        raise ValueError(f"states must be [B, C, H, P, N], got "
                         f"{tuple(states.shape)}")
    b, c, h, p, n = states.shape
    if tuple(chunk_decay.shape) != (b, c, h):
        raise ValueError(f"chunk_decay must be {(b, c, h)}, got "
                         f"{tuple(chunk_decay.shape)}")
    if h0 is not None and tuple(h0.shape) != (b, h, p, n):
        raise ValueError(f"h0 must be {(b, h, p, n)}, got {tuple(h0.shape)}")
    return tensors


def _launch(chunk_decay, states, h0):
    b, c, h, p, n = states.shape
    if not (b > 0 and c > 0 and h > 0 and p > 0 and n > 0
            and b * h * p * n < 2 ** 31 and b * c * h < 2 ** 31):
        raise ValueError(f"kernel takes a nonempty state of fewer than 2^31 "
                         f"elements, got {tuple(states.shape)}")
    h_before = torch.empty_like(states)
    h_t = states.new_empty((b, h, p, n))
    fn = K.library("ssd_scan").ssd_state_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(chunk_decay.data_ptr(), states.data_ptr(),
                0 if h0 is None else h0.data_ptr(), h_before.data_ptr(),
                h_t.data_ptr(), b, c, h, p, n, K.stream_ptr(states))
    K.check_status("ssd_scan", status)
    K.LAUNCHES["ssd_scan"] += 1
    return h_before, h_t


def ssd_state_scan(chunk_decay, states, h0=None):
    """chunk_decay [B, C, H] (``exp`` of each chunk's summed dt·A),
    states [B, C, H, P, N] (each chunk's own contribution), h0 [B, H, P,
    N] or None (zeros); fp32 and contiguous.  Returns (h_before [B, C, H,
    P, N], hT [B, H, P, N])."""
    tensors = _check(chunk_decay, states, h0)
    if K.on_cuda(*tensors):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            # no backward kernel yet; the plain version does not run in
            # the kernel's place
            from repro_torch.core.policies import not_ported
            not_ported("the backward of the SSD chunk-state scan (S8), to "
                       "train a Mamba2 or jamba model on CUDA", "M10b")
        return _launch(chunk_decay, states, h0)
    return ssd_state_scan_reference(chunk_decay, states, h0)
