"""Plain PyTorch versions of ragged decode attention.

``decode_attention_reference`` is the function of the CUDA kernel, as a
masked fp32 softmax over the whole cache span; the wrapper runs it for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel against it.
``split_decode_attention_reference`` is the kernel's algorithm written
plainly: each of ``splits`` shares of ``lengths[b]`` positions gives a
partial (m, l, acc), and the partials merge in split order."""

from __future__ import annotations

import numpy as np
import torch


def decode_attention_reference(q, k_cache, v_cache, lengths):
    """q: [B,Hq,D]; caches: [B,S,Hkv,D]; lengths: [B] -> [B,Hq,D] in q's
    dtype (math in fp32)."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    k = k_cache.repeat_interleave(g, dim=2) if g > 1 else k_cache
    v = v_cache.repeat_interleave(g, dim=2) if g > 1 else v_cache
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) / np.sqrt(d)
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, :], scores, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return out.to(q.dtype)


def split_partials(q, k_cache, v_cache, lengths, splits: int):
    """Per-split softmax partials, as the split kernel writes them (natural
    log domain here).  Split i of request b covers positions
    [i * c, min((i + 1) * c, lengths[b])) with c = ceil(lengths[b] /
    splits).  Returns m, l [splits, B, Hq] and acc [splits, B, Hq, D], fp32;
    an empty share has m = -inf, l = 0, acc = 0."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    k = k_cache.repeat_interleave(g, dim=2) if g > 1 else k_cache
    v = v_cache.repeat_interleave(g, dim=2) if g > 1 else v_cache
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) / np.sqrt(d)
    lens = lengths.to(torch.int64).clamp(0, s)
    chunk = (lens + splits - 1) // splits
    pos = torch.arange(s, device=q.device)[None, :]
    ms, ls, accs = [], [], []
    for i in range(splits):
        lo = (i * chunk)[:, None]
        mask = (pos >= lo) & (pos < torch.minimum(lo + chunk[:, None],
                                                  lens[:, None]))
        sc = torch.where(mask[:, None, :], scores, -torch.inf)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p, v.float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials(m, l, acc):
    """Merge split partials in split order: the combine kernel's fixed
    order.  m, l [splits, B, Hq]; acc [splits, B, Hq, D] -> [B, Hq, D]."""
    mx = m.amax(dim=0)
    mx = torch.where(torch.isinf(mx), 0.0, mx)
    tot_l = torch.zeros_like(l[0])
    tot = torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        f = torch.exp(m[i] - mx)          # 0 for an empty share
        tot_l = tot_l + f * l[i]
        tot = tot + f[..., None] * acc[i]
    return tot / tot_l.clamp_min(1e-30)[..., None]


def split_decode_attention_reference(q, k_cache, v_cache, lengths,
                                     splits: int):
    """The split-KV algorithm in plain PyTorch: ``split_partials`` then
    ``merge_partials``.  Same function as ``decode_attention_reference``;
    result in q's dtype."""
    out = merge_partials(*split_partials(q, k_cache, v_cache, lengths,
                                         splits))
    return out.to(q.dtype)
