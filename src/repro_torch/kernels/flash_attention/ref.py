"""Plain PyTorch version of prefill flash attention: a copy of the
reference package's ``attention_reference`` (a dense fp32 softmax).  The
wrapper runs it for CPU tensors (autograd differentiates it there); the
tests and ``chip_smoke.py`` hold the kernel against it.

``attention_lse_reference`` and ``attention_bwd_reference`` write out what
the kernels compute for training, the rows' log-sum-exp and the backward
from it by its explicit formulas; the tests and ``chip_smoke.py`` hold the
forward kernel's log-sum-exp and the backward kernels against them."""

from __future__ import annotations

import numpy as np
import torch


def _mask(s, causal, window, device):
    """[S, S]: query position q sees key position k."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _expand(t, g):
    """KV head h // g for query head h, in fp32."""
    return t.float().repeat_interleave(g, dim=2) if g > 1 else t.float()


def attention_reference(q, k, v, *, causal: bool = True, window=None):
    """q: [B,S,Hq,D]; k/v: [B,S,Hkv,D] -> [B,S,Hq,D] in q's dtype (fp32
    softmax)."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(d)
    mask = _mask(s, causal, window, q.device)
    scores = torch.where(mask[None, None], scores, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def attention_lse_reference(q, k, v, *, causal: bool = True, window=None):
    """(out, lse): ``attention_reference``'s output, and each row's
    log-sum-exp of the scaled, masked scores in fp32, [B, Hq, S] (natural
    base), which the forward kernel writes for the backward."""
    b, s, hq, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          _expand(k, hq // k.shape[2])) / np.sqrt(d)
    scores = torch.where(_mask(s, causal, window, q.device)[None, None],
                         scores, -torch.inf)
    return (attention_reference(q, k, v, causal=causal, window=window),
            torch.logsumexp(scores, dim=-1))


def attention_bwd_reference(q, k, v, out, dout, lse, *, causal: bool = True,
                            window=None):
    """(dq, dk, dv) in q's dtype of ``out = attention(q, k, v)`` for the
    upstream grad ``dout``, from the rows' log-sum-exp ``lse`` [B, Hq, S],
    by the formulas the kernels compute, in fp32: P = exp(scale Q K^T -
    lse) on the visible pairs, dV = P^T dO, dP = dO V^T, D = rowsum(dO *
    out), dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q, dK and dV
    summed over the G query heads of each KV head."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(d)
    qf, do = q.float(), dout.float()
    kf, vf = _expand(k, g), _expand(v, g)
    mask = _mask(s, causal, window, q.device)[None, None]
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(sc - lse.float()[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
    delta = (do * out.float()).sum(-1).permute(0, 2, 1)      # [B, Hq, S]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk, dv = (t.reshape(b, s, hkv, g, d).sum(3) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
