"""Wrapper for the ragged decode attention kernel
(``csrc/ragged_decode_attention.cu``).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.ragged_decode_attention.ref import (
    decode_attention_reference)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (G, D) pairs the kernel is instantiated for: those the repo's configs give
# it (qwen2.5-3b: G = 16 / 2, D = 128)
_SHAPES = ((8, 128),)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# the H100's streaming multiprocessors; the split rule aims at two blocks
# on each
SMS = 132


def split_count(b: int, hkv: int, s: int) -> int:
    """How many blocks share one (request, KV head)'s positions: enough for
    ``B * Hkv * splits`` to reach about two blocks per SM, and never more
    than the S positions of the cache.  It reads only shapes, never
    ``lengths`` (on the device: reading it would cost a host sync)."""
    if min(b, hkv, s) < 1:
        raise ValueError(f"split_count takes B, Hkv, S >= 1, got {b}, {hkv}, {s}")
    return max(1, min(s, -(-2 * SMS // (b * hkv))))


def _launch(q, k_cache, v_cache, lengths, splits):
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"ragged_decode_attention takes fp32 or bf16 q and "
                        f"caches of one dtype, got {q.dtype}/{k_cache.dtype}"
                        f"/{v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise TypeError(f"lengths must be int32 [{b}], got {lengths.dtype} "
                        f"{tuple(lengths.shape)}")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d or hq % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if (hq // hkv, d) not in _SHAPES:
        raise ValueError(f"kernel built for (G, D) in {_SHAPES}, got "
                         f"G={hq // hkv}, D={d}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    if not 1 <= splits <= 65535:
        raise ValueError(f"splits must be in [1, 65535], got {splits}")
    lib = K.library("ragged_decode_attention")
    fn = lib.ragged_decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    # each split's fp32 (m, l) per head, then its acc [G, D]
    scratch = torch.empty(b * hkv * splits * (hq // hkv) * (d + 2),
                          dtype=torch.float32, device=q.device)
    status = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, s,
                hq, hkv, d, splits, _DTYPES[q.dtype], K.stream_ptr(q))
    K.check_status("ragged_decode_attention", status)
    K.LAUNCHES["ragged_decode_attention"] += 1
    return out


def ragged_decode_attention(q, k_cache, v_cache, lengths):
    """q: [B,Hq,D] one new token per request; caches [B,S,Hkv,D] (bshd);
    lengths [B] valid KV entries per request (>= 1). Returns [B,Hq,D] in
    q's dtype.

    Each request reads only its first ``lengths[b]`` KV rows: elastic
    batching at the kernel level.  Any S works (the kernel masks the tail
    itself, so there is no ``block_kv``).  On the card the positions are
    split ``split_count(B, Hkv, S)`` ways and merged in a second kernel."""
    if K.on_cuda(q, k_cache, v_cache, lengths):
        b, s, hkv = k_cache.shape[:3]
        return _launch(q, k_cache, v_cache, lengths.to(torch.int32),
                       split_count(b, hkv, s))
    return decode_attention_reference(q, k_cache, v_cache, lengths)
