"""Plain PyTorch version of ragged decode attention: the same function as
the CUDA kernel, as a masked fp32 softmax over the whole cache span.  The
wrapper runs it for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernel against it."""

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
