"""Wrapper for the SSD chunk-state scan kernel (``csrc/ssd_scan.cu``,
S8) and its backward (``csrc/ssd_scan_bwd.cu``, S8b).

``ssd_state_scan(chunk_decay, states, h0)`` runs the recurrence
``h_c = h_{c-1} * chunk_decay[:, c] + states[:, c]`` over the C chunks
and returns the state before each chunk and the final state.  CUDA
tensors launch the kernel; CPU tensors run the plain version in
``ref.py``, which autograd differentiates.  Under autograd (grad enabled
and an input that requires grad) a CUDA call goes through
``_SSDStateScan``, whose backward launches S8b.  The wrapper checks what
the kernels take (fp32, contiguous, matching shapes, one device) and
raises on the rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ssd_scan.ref import (ssd_state_scan_bwd_reference,
                                              ssd_state_scan_reference)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# the backward kernel's largest P * N: 256 threads of at most 32 elements
# (ssd_scan_bwd.cu's kThreads * kMaxEpt)
_MAX_PN_BWD = 8192


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


def _launch_bwd(chunk_decay, h_before, g_h_before, g_hT, has_h0):
    """(g_decay, g_states, g_h0 or None) of ``ssd_state_scan`` for the
    upstream grads of its two outputs (``g_hT`` None: zeros), from its
    input ``chunk_decay`` and its output ``h_before``."""
    _check(chunk_decay, h_before, g_hT)
    if g_h_before.dtype != torch.float32 or not g_h_before.is_contiguous() \
            or g_h_before.shape != h_before.shape:
        raise ValueError(f"g_h_before must be a contiguous fp32 tensor of "
                         f"shape {tuple(h_before.shape)}")
    K.on_cuda(chunk_decay, h_before, g_h_before,
              *(() if g_hT is None else (g_hT,)))
    b, c, h, p, n = h_before.shape
    if not (b > 0 and c > 0 and h > 0 and 0 < p * n <= _MAX_PN_BWD
            and b * c * h < 2 ** 31):
        raise ValueError(f"backward kernel takes a nonempty state of at most "
                         f"{_MAX_PN_BWD} elements a head, got "
                         f"{tuple(h_before.shape)}")
    g_decay = torch.empty_like(chunk_decay)
    g_states = torch.empty_like(h_before)
    g_h0 = h_before.new_empty((b, h, p, n)) if has_h0 else None
    fn = K.library("ssd_scan_bwd").ssd_state_scan_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    status = fn(chunk_decay.data_ptr(), h_before.data_ptr(),
                g_h_before.data_ptr(), 0 if g_hT is None else g_hT.data_ptr(),
                g_decay.data_ptr(), g_states.data_ptr(),
                0 if g_h0 is None else g_h0.data_ptr(), b, c, h, p, n,
                K.stream_ptr(h_before))
    K.check_status("ssd_scan_bwd", status)
    K.LAUNCHES["ssd_scan_bwd"] += 1
    return g_decay, g_states, g_h0


class _SSDStateScan(torch.autograd.Function):
    """S8 forward and S8b for its gradient on CUDA tensors; on CPU tensors
    the plain versions of both (what the tests differentiate).  It keeps
    chunk_decay and the forward's h_before, the only tensors the gradient
    reads."""

    @staticmethod
    def forward(ctx, chunk_decay, states, h0):
        if K.on_cuda(chunk_decay, states):
            h_before, h_t = _launch(chunk_decay, states, h0)
        else:
            h_before, h_t = ssd_state_scan_reference(chunk_decay, states, h0)
        ctx.save_for_backward(chunk_decay, h_before)
        ctx.has_h0 = h0 is not None
        ctx.set_materialize_grads(False)
        return h_before, h_t

    @staticmethod
    def backward(ctx, g_h_before, g_hT):
        chunk_decay, h_before = ctx.saved_tensors
        g_h_before = (torch.zeros_like(h_before) if g_h_before is None
                      else g_h_before.contiguous())
        g_hT = None if g_hT is None else g_hT.contiguous()
        if K.on_cuda(chunk_decay, h_before):
            g_decay, g_states, g_h0 = _launch_bwd(
                chunk_decay, h_before, g_h_before, g_hT, ctx.has_h0)
        else:
            g_decay, g_states, g_h0 = ssd_state_scan_bwd_reference(
                chunk_decay, h_before, g_h_before, g_hT, ctx.has_h0)
        return g_decay, g_states, g_h0


def ssd_state_scan(chunk_decay, states, h0=None):
    """chunk_decay [B, C, H] (``exp`` of each chunk's summed dt·A),
    states [B, C, H, P, N] (each chunk's own contribution), h0 [B, H, P,
    N] or None (zeros); fp32 and contiguous.  Returns (h_before [B, C, H,
    P, N], hT [B, H, P, N]).  Differentiable: on CUDA through S8b, on the
    CPU through the plain version."""
    tensors = _check(chunk_decay, states, h0)
    if K.on_cuda(*tensors):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return _SSDStateScan.apply(chunk_decay, states, h0)
        return _launch(chunk_decay, states, h0)
    return ssd_state_scan_reference(chunk_decay, states, h0)
