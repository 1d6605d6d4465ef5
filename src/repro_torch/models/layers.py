"""Core transformer layers: norm specs, RoPE, attention (dense / blockwise /
decode), dense FFN.  Plain functions over param dicts, mirroring
``repro.models.layers`` name for name; the sharding constraints of the
reference are dropped (one device).

Decode-time cache writes are in place: the reference donates the cache to
a jitted step and gets a new buffer back; here ``attention_block`` writes
the new row into the cache tensors it was given and returns them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec

_NEG_INF = -1e30


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

# The norm itself is ``repro_torch.kernels.rmsnorm.fused_rmsnorm``: the
# model adds each branch's residual as it normalizes (``models.model``).

def rmsnorm_specs(d_model: int):
    return Spec((d_model,), ("embed",), init="zeros")


# ----------------------------------------------------------------------------
# Positional embeddings
# ----------------------------------------------------------------------------

def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of shape [..., seq, 1, head_dim/2] for ``positions``
    [..., seq]; computed once per forward and shared by every layer."""
    # built on the device: an upload from host memory would sync the host
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device)
                             * 2.0 / head_dim))
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------

def attention_specs(cfg: ModelConfig):
    d = cfg.d_model
    specs = {
        "wq": Spec((d, cfg.num_heads, cfg.head_dim), ("embed", "heads", "head_dim")),
        "wk": Spec((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, cfg.num_kv_heads, cfg.head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((cfg.num_heads, cfg.head_dim, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = Spec((cfg.num_heads, cfg.head_dim), ("heads", "head_dim"), init="zeros")
        specs["bk"] = Spec((cfg.num_kv_heads, cfg.head_dim), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = Spec((cfg.num_kv_heads, cfg.head_dim), ("kv_heads", "head_dim"), init="zeros")
    return specs


def _proj(x, w):
    """x [B,S,d] times w [d,H,K] -> [B,S,H,K] (the reference's
    ``einsum("bsd,dhk->bshk")`` as one matmul)."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p, x, cfg: ModelConfig):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _expand_kv(k, hq: int):
    """Repeat KV heads to the full query-head count ([B,S,Hkv,D] ->
    [B,S,Hq,D])."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    return k.repeat_interleave(hq // hkv, dim=2)


def _softmax_fp32(scores):
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    return e / e.sum(dim=-1, keepdim=True)


def dense_attention(q, k, v, *, causal: bool, window: Optional[int],
                    softcap: Optional[float] = None, kv_len_mask=None):
    """Attention materializing the score matrix.

    q: [B,Sq,Hq,D], k/v: [B,Skv,Hkv,D]. Used for seq <= attn_dense_max_seq.
    """
    b, sq, hq, d = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    dev = q.device
    qpos = torch.arange(sq, device=dev)
    kpos = torch.arange(k.shape[1], device=dev)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=dev)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    if kv_len_mask is not None:                              # [B,Skv] bool
        scores = torch.where(kv_len_mask[:, None, None, :], scores, _NEG_INF)
    probs = _softmax_fp32(scores).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q, k, v, *, causal: bool, window: Optional[int],
                        block_q: int, block_kv: int):
    """Flash-style blockwise causal attention with online softmax; never
    materializes [Sq,Skv].  As in the reference, masked blocks are still
    computed (the loop has no early exit)."""
    b, s, hq, d = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    if s % block_q or s % block_kv:
        raise ValueError(f"seq {s} not a multiple of blocks "
                         f"{block_q}/{block_kv}")
    scale = 1.0 / np.sqrt(d)
    dev = q.device
    outs = []
    for qi in range(s // block_q):
        qblk = q[:, qi * block_q:(qi + 1) * block_q]
        qpos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((b, hq, block_q), _NEG_INF, device=dev)
        l = torch.zeros((b, hq, block_q), device=dev)
        acc = torch.zeros((b, hq, block_q, d), device=dev)
        for kj in range(s // block_kv):
            kblk = k[:, kj * block_kv:(kj + 1) * block_kv]
            vblk = v[:, kj * block_kv:(kj + 1) * block_kv]
            scores = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).float() * scale
            kpos = kj * block_kv + torch.arange(block_kv, device=dev)
            mask = torch.ones((block_q, block_kv), dtype=torch.bool, device=dev)
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            scores = torch.where(mask[None, None], scores, _NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vblk.dtype), vblk)
            acc = acc * alpha[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                     # [b, h, bq, d]
    return torch.cat(outs, dim=2).transpose(1, 2)        # [b, s, h, d]


def decode_attention(q, k_cache, v_cache, kv_lens):
    """Single-token attention against a padded bshd KV cache.

    q: [B,1,Hq,D]; caches: [B,Smax,Hkv,D]; kv_lens: [B] valid entries.
    """
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)                     # [B,Hkv,G,D]
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * scale
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] < kv_lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    probs = _softmax_fp32(scores).to(v_cache.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache)
    return out.reshape(b, 1, hq, d)


def _write_decode_row(cache, new, slot, mode: str):
    """Write this step's row ``new`` [B,1,H,D] into ``cache`` [B,S,H,D] at
    ``slot`` [B], in place."""
    new = new.to(cache.dtype)
    if mode == "uniform":
        # static-bucket serving: every slot is at the same position
        cache.index_copy_(1, slot[:1].long(), new)
    elif mode == "scatter":
        bidx = torch.arange(cache.shape[0], device=cache.device)
        cache[bidx, slot.long()] = new[:, 0]
    else:  # onehot (baseline): arithmetic full-cache read-modify-write
        span = cache.shape[1]
        oh = (torch.arange(span, device=cache.device)[None, :] ==
              slot[:, None]).to(cache.dtype)[:, :, None, None]
        cache.copy_(cache * (1 - oh) + oh * new)


def attention_block(p, x, cfg: ModelConfig, *, positions, cache=None,
                    kv_lens=None, rope=None):
    """Self-attention mixer. Returns (out, cache).

    cache: dict(k=[B,Smax,Hkv,D], v=...) or None (full-sequence mode); the
    tensors are updated in place and returned.  ``rope``: (cos, sin) from
    ``rope_tables`` for ``positions`` (computed here when None).
    """
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.pos_embedding == "rope":
        if rope is None:
            rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)

    if cache is not None:
        k_cache, v_cache = cache["k"], cache["v"]
        span = k_cache.shape[1]
        if x.shape[1] == 1:
            # ring-buffer slot when a sliding window bounds the cache span
            slot = kv_lens % span
            mode = cfg.decode_cache_update
            _write_decode_row(k_cache, k, slot, mode)
            _write_decode_row(v_cache, v, slot, mode)
            valid = torch.clamp(kv_lens + 1, max=span)
            # the ring holds the most recent `valid` tokens; absolute RoPE
            # was applied before caching, so slot order is irrelevant
            if cfg.resolve_decode_attention_impl(k_cache.device) == "ragged":
                from repro_torch.kernels.ragged_decode_attention import (
                    ragged_decode_attention)
                out = ragged_decode_attention(
                    q[:, 0], k_cache, v_cache, valid)[:, None]
            else:
                out = decode_attention(q, k_cache, v_cache, valid)
        else:
            # prefill: attend within the prompt, then store the (windowed)
            # tail of k/v at the start of the cache
            out = _self_attention_full(q, k, v, cfg)
            if k.shape[1] > span:
                k, v = k[:, -span:], v[:, -span:]
            k_cache[:, :k.shape[1]] = k.to(k_cache.dtype)
            v_cache[:, :v.shape[1]] = v.to(v_cache.dtype)
        cache = {"k": k_cache, "v": v_cache}
    else:
        out = _self_attention_full(q, k, v, cfg)

    wo = p["wo"]
    proj = torch.matmul(out.flatten(-2), wo.to(x.dtype).reshape(-1, wo.shape[-1]))
    return proj, cache


def _self_attention_full(q, k, v, cfg: ModelConfig):
    """Prefill attention.  On CUDA tensors the hand-written flash kernel
    runs at every length (a softcap config keeps the dense path: the
    kernel has none); on the CPU, dense up to ``attn_dense_max_seq`` and
    blockwise above it, as in the reference."""
    from repro_torch.kernels import on_cuda
    if on_cuda(q, k, v) and not cfg.attn_logit_softcap:
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    if q.shape[1] <= cfg.attn_dense_max_seq:
        return dense_attention(q, k, v, causal=True, window=cfg.sliding_window,
                               softcap=cfg.attn_logit_softcap)
    return blockwise_attention(q, k, v, causal=True, window=cfg.sliding_window,
                               block_q=cfg.attn_chunk_q,
                               block_kv=cfg.attn_chunk_kv)


# ----------------------------------------------------------------------------
# Dense FFN
# ----------------------------------------------------------------------------

def ffn_specs(cfg: ModelConfig, d_ff: Optional[int] = None):
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    specs = {
        "w_up": Spec((d, f), ("embed", "ffn")),
        "w_down": Spec((f, d), ("ffn", "embed")),
    }
    if cfg.gated_ffn:
        specs["w_gate"] = Spec((d, f), ("embed", "ffn"))
    return specs


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return (lambda t: F.gelu(t, approximate="tanh")) if name == "gelu" else F.silu


def ffn_block(p, x, cfg: ModelConfig):
    act = _act(cfg.ffn_activation)
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    if cfg.gated_ffn:
        h = act(torch.matmul(x, p["w_gate"].to(x.dtype))) * up
    else:
        h = act(up)
    return torch.matmul(h, p["w_down"].to(x.dtype))
