"""Wrapper for the prefill flash attention kernels
(``csrc/flash_attention.cu``: bf16 on the tensor cores, fp32 on the fp32
cores, chosen by dtype inside the one C entry point).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.flash_attention.ref import attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (G, D) pairs the kernel is instantiated for: those the repo's configs give
# it (qwen2.5-3b: G = 16 / 2, D = 128)
_SHAPES = ((8, 128),)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + \
    [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _launch(q, k, v, causal, window):
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
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = K.library("flash_attention").flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, s, hq, hkv, d, int(causal), 0 if window is None else window,
                _DTYPES[q.dtype], K.stream_ptr(q))
    if status == -2:
        raise RuntimeError(f"flash_attention: no TMA tensor map for k/v with "
                           f"strides {k.stride()}/{v.stride()}")
    K.check_status("flash_attention", status)
    K.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: [B,S,Hq,D]; k/v: [B,S,Hkv,D] -> [B,S,Hq,D] in q's dtype.

    Causal attention with an optional sliding window (a query sees the
    ``window`` most recent positions, itself included), GQA by reading KV
    head h // G for query head h.  Any S works: the kernel masks the tail
    itself, so there are no block arguments."""
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if K.on_cuda(q, k, v):
        return _launch(q, k, v, causal, window)
    return attention_reference(q, k, v, causal=causal, window=window)
