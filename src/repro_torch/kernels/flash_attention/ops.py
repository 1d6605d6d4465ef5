"""Wrapper for the prefill flash attention kernels
(``csrc/flash_attention.cu``: bf16 on the tensor cores, fp32 on the fp32
cores, chosen by dtype inside the one C entry point) and their backward
(``csrc/flash_attention_bwd.cu``).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``, which autograd differentiates.  Under autograd (grad enabled
and an input that requires grad) a CUDA call goes through
``_FlashAttention``: its forward also writes each row's log-sum-exp
(``lse_buffer``), which its backward hands to the backward kernels.  The
wrapper checks what the kernels take and raises on the rest; it never
falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (G, D) pairs the kernel is instantiated for: those the repo's configs give
# it (qwen2.5-3b: G = 16 / 2, yi-9b: 32 / 4, llama-3.2-vision-90b: 64 / 8,
# D = 128; internlm2-1.8b: 16 / 8, D = 128; gemma-7b: 16 / 16, D = 256;
# mixtral-8x7b: 32 / 8, D = 128; moonshot-v1-16b-a3b: 16 / 16, D = 128;
# musicgen-large: 32 / 32, D = 64)
_SHAPES = ((8, 128), (2, 128), (1, 256), (4, 128), (1, 128), (1, 64))
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + \
    [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 9 + \
    [ctypes.c_int] * 9 + [ctypes.c_void_p]
# the bf16 dk/dv kernel splits a 64-key tile's query tiles over this many
# blocks (a cluster) at most
_MAX_SPLITS = 4


def _check(q, k, v):
    """Raise on what the kernels do not take; returns (B, S, Hq, Hkv, D)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d \
            or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if (hq // hkv, d) not in _SHAPES:
        raise ValueError(f"kernel built for (G, D) in {_SHAPES}, got "
                         f"G={hq // hkv}, D={d}")
    if not (0 < b <= 65535 and s > 0):
        raise ValueError(f"kernel takes 0 < B <= 65535 and S > 0, got "
                         f"B={b}, S={s}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit stride over D and "
                             f"16-byte aligned rows")
    return b, s, hq, hkv, d


def lse_buffer(b, s, hkv, g, device):
    """An fp32 buffer for the rows' log-sum-exp (and, in the backward, for
    rowsum(dout * out)) as the kernels lay it out: [B, Hkv, S_pad, G] with
    S_pad = S rounded up to 64, so that a tile's 64 rows (64 / G positions
    x the G query heads of one KV head) are consecutive."""
    return torch.empty((b, hkv, -(-s // 64) * 64, g), dtype=torch.float32,
                       device=device)


def _check_lse(lse, b, s, hkv, g):
    if lse.dtype != torch.float32 or not lse.is_contiguous() or \
            lse.shape != (b, hkv, -(-s // 64) * 64, g):
        raise ValueError(f"lse must be a contiguous fp32 lse_buffer of "
                         f"({b}, {hkv}, S_pad, {g}), got {lse.dtype} "
                         f"{tuple(lse.shape)}")


def lse_as_bhs(buf, s):
    """The log-sum-exp of ``lse_buffer``'s layout as [B, Hq, S]."""
    b, hkv, _, g = buf.shape
    return buf[:, :, :s].permute(0, 1, 3, 2).reshape(b, hkv * g, s)


def _dkv_splits(b, s, hkv, d, sms):
    """The blocks (1, 2 or 4, one cluster) that the bf16 dk/dv kernel
    splits each 64-key tile's query tiles over: the fewest that give two
    blocks an SM."""
    blocks = -(-s // 64) * hkv * b * (2 if d == 256 else 1)
    n = 1
    while n < _MAX_SPLITS and blocks * n < 2 * sms:
        n *= 2
    return n


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, k, v, causal, window, lse=None):
    """out; with ``lse`` (a ``lse_buffer``) the kernel also writes each
    row's log-sum-exp there, for the backward.  Without it (serving) the
    kernel writes nothing more; ``out`` is bit-equal either way."""
    b, s, hq, hkv, d = _check(q, k, v)
    if lse is not None:
        _check_lse(lse, b, s, hkv, hq // hkv)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = K.library("flash_attention").flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, s, hq, hkv, d, int(causal), 0 if window is None else window,
                _DTYPES[q.dtype], None if lse is None else lse.data_ptr(),
                K.stream_ptr(q))
    if status == -2:
        raise RuntimeError(f"flash_attention: no TMA tensor map for k/v with "
                           f"strides {k.stride()}/{v.stride()}")
    K.check_status("flash_attention", status)
    K.LAUNCHES["flash_attention"] += 1
    return out


def _launch_bwd(q, k, v, out, dout, lse, causal, window):
    """dq, dk, dv (contiguous, in q's dtype) of ``out = flash_attention(q,
    k, v)`` for the upstream grad ``dout``, from the forward's log-sum-exp
    ``lse`` (the ``lse_buffer`` that ``_launch`` filled): the dq kernel
    (which also writes rowsum(dout * out)), then the dk/dv kernel."""
    b, s, hq, hkv, d = _check(q, k, v)
    out, dout = out.contiguous(), dout.to(q.dtype).contiguous()
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    _check_lse(lse, b, s, hkv, hq // hkv)
    if dout.data_ptr() % 16:       # a view that TMA cannot read
        dout = dout.clone()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty_like(lse)
    nsplit = _dkv_splits(b, s, hkv, d, _sm_count(q.device))
    fn = K.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], b, s, hq, hkv, d,
                int(causal), 0 if window is None else window,
                _DTYPES[q.dtype], nsplit, K.stream_ptr(q))
    if status == -2:
        raise RuntimeError(f"flash_attention_bwd: no TMA tensor map for "
                           f"q/k/v with strides {q.stride()}/{k.stride()}/"
                           f"{v.stride()}")
    K.check_status("flash_attention_bwd", status)
    K.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (writing each row's log-sum-exp), and the
    backward kernels for its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        b, s, hq, hkv, _ = _check(q, k, v)
        lse = lse_buffer(b, s, hkv, hq // hkv, q.device)
        out = _launch(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, dout, lse, ctx.causal,
                                 ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: [B,S,Hq,D]; k/v: [B,S,Hkv,D] -> [B,S,Hq,D] in q's dtype.

    Causal attention with an optional sliding window (a query sees the
    ``window`` most recent positions, itself included), GQA by reading KV
    head h // G for query head h.  Any S works: the kernel masks the tail
    itself, so there are no block arguments.  Differentiable: on CUDA
    through the backward kernels, on the CPU through the plain version."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if K.on_cuda(q, k, v):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, causal, window)
        return _launch(q, k, v, causal, window)
    return attention_reference(q, k, v, causal=causal, window=window)
