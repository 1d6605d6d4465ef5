"""Core transformer layers: norm specs, RoPE, sinusoidal positions,
attention (dense / blockwise / decode, self and cross), dense FFN.  Plain
functions over param dicts, mirroring ``repro.models.layers`` name for
name; the sharding constraints of the reference are dropped (one device).

Decode-time cache writes are in place: the reference donates the cache to
a jitted step and gets a new buffer back; here ``attention_block`` writes
the new row into the cache tensors it was given and returns them.

Self-attention caches are bshd ([B, S, Hkv, D]) or, with
``cache_layout="bhsd"``, head-major ([B, Hkv, S, D]).  Decode reads a bshd
cache with the ragged kernel (``kernels.ragged_decode_attention``) on
CUDA and a bhsd cache with the plain ``decode_attention(layout="bhsd")``
on every device: the reference runs its Pallas decode kernel only for
bshd too, and the kernel is bshd-only.
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


def rmsnorm(x, weight, eps: float):
    """The reference's plain RMSNorm (fp32 math, result in x's dtype), for
    the per-head ``q_norm``/``k_norm`` of cross-attention, which the
    reference computes outside any kernel too."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


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


# XLA's float32 exp on the CPU (the Cephes scheme: a reduction by ln 2 in
# two parts and a degree-5 polynomial, its multiply-adds fused) is not
# torch.exp's: the two differ by one ulp in 1 of 10 arguments, and the
# sinusoid multiplies a frequency by positions up to thousands, so one ulp
# of a frequency moves sin(pos * freq) by 2.4e-4 at d_model 2048 and
# position 4,095.  ``_exp_f32_xla`` computes that scheme step for step; a
# fused multiply-add of float32 operands is exact in float64 before its
# one rounding (their product has at most 48 bits), so the fma is a
# float64 multiply and add rounded once to float32, on either device.  It
# equals jnp.exp bit for bit over [-87, 88] (tests/test_torch_audio.py).
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _fma_f32(a, b, c):
    """a * b + c rounded once to float32 (a, b, c float32 or scalars)."""
    return (a.double() * b + c).float()


def _exp_f32_xla(x):
    """exp of a float32 tensor, equal to XLA:CPU's float32 exp bit for bit
    (for |x| < 87, the range before its clamps)."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    fx = torch.floor(_fma_f32(x, f32(1.44269504088896341), 0.5))
    r = x - fx * f32(0.693359375)              # exact: 9 bits times an integer
    r = _fma_f32(fx, f32(2.12194440e-4), r)
    z = r * r
    y = _fma_f32(r, f32(_EXP_POLY[0]), f32(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        y = _fma_f32(y, r, f32(c))
    y = _fma_f32(y, z, r)
    return torch.ldexp(1.0 + y, fx.to(torch.int32))


def sinusoidal_embedding(positions, d_model: int):
    """The reference's sinusoid table [..., d_model] (sin then cos) at
    ``positions`` [...], in fp32.  The frequencies are the reference's to
    the bit (``_exp_f32_xla``); the table is built on the positions'
    device, so a captured decode graph recomputes it from the device's
    ``kv_lens``."""
    half = d_model // 2
    arg = -np.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half
    ang = positions[..., None].float() * _exp_f32_xla(arg)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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

def attention_specs(cfg: ModelConfig, cross: bool = False):
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
    if cross:
        specs["attn_gate"] = Spec((), (), init="zeros")
        specs["q_norm"] = rmsnorm_specs(cfg.head_dim)
        specs["k_norm"] = rmsnorm_specs(cfg.head_dim)
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


def _tracked(t) -> bool:
    """True if autograd records ops on ``t``: an in-place op there could
    overwrite what a backward needs, so the forward path goes out of
    place (the same values)."""
    return torch.is_grad_enabled() and t.requires_grad


def _softmax_fp32(scores):
    # in place on the fresh difference: one score-sized buffer beside
    # ``scores`` (a vision cross-attention prefill's scores take 6.7 GB);
    # under autograd out of place, the row max held constant as the
    # reference's stop_gradient holds it (the shift changes no value)
    if _tracked(scores):
        e = torch.exp(scores - scores.detach().amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True)
    m = scores.amax(dim=-1, keepdim=True)
    e = (scores - m).exp_()
    return e.div_(e.sum(dim=-1, keepdim=True))


def dense_attention(q, k, v, *, causal: bool, window: Optional[int],
                    softcap: Optional[float] = None, kv_len_mask=None):
    """Attention materializing the score matrix.

    q: [B,Sq,Hq,D], k/v: [B,Skv,Hkv,D]. Used for seq <= attn_dense_max_seq.
    """
    b, sq, hq, d = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scale = 1.0 / np.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * scale if _tracked(scores) else scores.mul_(scale)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    dev = q.device
    qpos = torch.arange(sq, device=dev)
    kpos = torch.arange(k.shape[1], device=dev)
    mask = None                # none: every key seen (cross-attention)
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        upper = kpos[None, :] > qpos[:, None] - window
        mask = upper if mask is None else mask & upper
    if mask is not None:
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


def decode_attention(q, k_cache, v_cache, kv_lens, layout: str = "bshd"):
    """Single-token attention against a padded KV cache.

    q: [B,1,Hq,D]; caches: [B,Smax,Hkv,D] ("bshd") or [B,Hkv,Smax,D]
    ("bhsd", head-major); kv_lens: [B] valid entries.
    """
    b, _, hq, d = q.shape
    hm = layout == "bhsd"
    hkv = k_cache.shape[1] if hm else k_cache.shape[2]
    smax = k_cache.shape[2] if hm else k_cache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d)                     # [B,Hkv,G,D]
    scale = 1.0 / np.sqrt(d)
    kv = "bhkd" if hm else "bkhd"
    scores = torch.einsum(f"bhgd,{kv}->bhgk", qg, k_cache).float() * scale
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] < kv_lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    probs = _softmax_fp32(scores).to(v_cache.dtype)
    out = torch.einsum(f"bhgk,{kv}->bhgd", probs, v_cache)
    return out.reshape(b, 1, hq, d)


def _write_decode_row(cache, new, slot, mode: str, hm: bool = False):
    """Write this step's row ``new`` [B,1,H,D] into ``cache`` at ``slot``
    [B], in place: [B,S,H,D], or [B,H,S,D] when ``hm`` (head-major), where
    the row goes in transposed."""
    new = new.to(cache.dtype)
    seq = 2 if hm else 1
    if hm:
        new = new.transpose(1, 2)                            # [B,H,1,D]
    if mode == "uniform":
        # static-bucket serving: every slot is at the same position
        cache.index_copy_(seq, slot[:1].long(), new)
    elif mode == "scatter":
        bidx = torch.arange(cache.shape[0], device=cache.device)
        if hm:
            cache[bidx, :, slot.long()] = new[:, :, 0]
        else:
            cache[bidx, slot.long()] = new[:, 0]
    else:  # onehot (baseline): arithmetic full-cache read-modify-write
        span = cache.shape[seq]
        oh = (torch.arange(span, device=cache.device)[None, :] ==
              slot[:, None]).to(cache.dtype)
        oh = oh[:, None, :, None] if hm else oh[:, :, None, None]
        cache.copy_(cache * (1 - oh) + oh * new)


def attention_block(p, x, cfg: ModelConfig, *, positions, cache=None,
                    kv_lens=None, rope=None):
    """Self-attention mixer. Returns (out, cache).

    cache: dict(k=[B,Smax,Hkv,D], v=...) ([B,Hkv,Smax,D] for the bhsd
    layout) or None (full-sequence mode); the tensors are updated in place
    and returned.  ``rope``: (cos, sin) from ``rope_tables`` for
    ``positions`` (computed here when None).
    """
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.pos_embedding == "rope":
        if rope is None:
            rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)

    if cache is not None:
        k_cache, v_cache = cache["k"], cache["v"]
        hm = cfg.cache_layout == "bhsd"      # head-major cache
        span = k_cache.shape[2] if hm else k_cache.shape[1]
        if x.shape[1] == 1:
            # ring-buffer slot when a sliding window bounds the cache span
            slot = kv_lens % span
            mode = cfg.decode_cache_update
            _write_decode_row(k_cache, k, slot, mode, hm)
            _write_decode_row(v_cache, v, slot, mode, hm)
            valid = torch.clamp(kv_lens + 1, max=span)
            # the ring holds the most recent `valid` tokens; absolute RoPE
            # was applied before caching, so slot order is irrelevant
            if hm:
                out = decode_attention(q, k_cache, v_cache, valid,
                                       layout="bhsd")
            elif cfg.resolve_decode_attention_impl(k_cache.device) == "ragged":
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
            if hm:
                k_cache[:, :, :k.shape[1]] = k.transpose(1, 2).to(k_cache.dtype)
                v_cache[:, :, :v.shape[1]] = v.transpose(1, 2).to(v_cache.dtype)
            else:
                k_cache[:, :k.shape[1]] = k.to(k_cache.dtype)
                v_cache[:, :v.shape[1]] = v.to(v_cache.dtype)
        cache = {"k": k_cache, "v": v_cache}
    else:
        out = _self_attention_full(q, k, v, cfg)

    wo = p["wo"]
    proj = torch.matmul(out.flatten(-2), wo.to(x.dtype).reshape(-1, wo.shape[-1]))
    return proj, cache


def tanh_gate(p, name, out):
    """``tanh(p[name]) * out``, the gate in fp32 rounded to out's dtype."""
    return torch.tanh(p[name].float()).to(out.dtype) * out


def cross_attention_block(p, x, cfg: ModelConfig, cross_kv):
    """Cross-attention over image embeddings ``cross_kv`` [B, Sv, d] at
    prefill.  Returns (gated out [B, S, d], k, v): the normed K and the V
    [B, Sv, Hkv, D] that the cache keeps.

    Q comes from ``x``, K and V from ``cross_kv``; Q gets ``q_norm`` and K
    ``k_norm``; the attention is dense, non-causal, unmasked and has no
    RoPE, as the reference's ``attention_block(cross_kv=)``.  It stays
    plain PyTorch: the reference computes it with ``dense_attention``, and
    the prefill kernel takes only Sq = Skv causal prompts.  A
    ``cross_kv`` of another dtype than ``x`` promotes as JAX does: fp32
    image embeddings in a bf16 model give fp32 K, V, scores and output
    (the weights cast to x's dtype first, as the reference casts them)."""
    dt = torch.promote_types(cross_kv.dtype, x.dtype)
    w = lambda name: p[name].to(x.dtype).to(dt)  # noqa: E731
    q = _proj(x, p["wq"])
    k = _proj(cross_kv.to(dt), w("wk"))
    v = _proj(cross_kv.to(dt), w("wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype).to(dt)
        v = v + p["bv"].to(x.dtype).to(dt)
    q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    out = dense_attention(q.to(dt), k, v, causal=False, window=None)
    wo = p["wo"]
    proj = torch.matmul(out.flatten(-2),
                        w("wo").reshape(-1, wo.shape[-1]))
    return tanh_gate(p, "attn_gate", proj), k, v


def cross_attention_decode(p, x, cfg: ModelConfig, k_img, v_img):
    """One decode token's cross-attention over the cached image K/V
    (``k_img``/``v_img`` [B, Sv, Hkv, D]), every request at length Sv.
    On CUDA (``decode_attention_impl`` resolving to ragged) the ragged
    decode kernel reads the cache, on the CPU the plain
    ``decode_attention``: the two compute the reference's
    ``decode_attention`` there."""
    q = rmsnorm(_proj(x, p["wq"]), p["q_norm"], cfg.norm_eps)
    b, sv = k_img.shape[0], k_img.shape[1]
    lens = torch.full((b,), sv, dtype=torch.int32, device=k_img.device)
    if cfg.resolve_decode_attention_impl(k_img.device) == "ragged":
        from repro_torch.kernels.ragged_decode_attention import (
            ragged_decode_attention)
        out = ragged_decode_attention(q[:, 0], k_img, v_img, lens)[:, None]
    else:
        out = decode_attention(q, k_img, v_img, lens)
    wo = p["wo"]
    proj = torch.matmul(out.flatten(-2), wo.to(x.dtype).reshape(-1, wo.shape[-1]))
    return tanh_gate(p, "attn_gate", proj)


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
