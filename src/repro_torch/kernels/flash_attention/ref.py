"""Plain PyTorch version of prefill flash attention: a copy of the
reference package's ``attention_reference`` (a dense fp32 softmax).  The
wrapper runs it for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernel against it."""

from __future__ import annotations

import numpy as np
import torch


def attention_reference(q, k, v, *, causal: bool = True, window=None):
    """q: [B,S,Hq,D]; k/v: [B,S,Hkv,D] -> [B,S,Hq,D] in q's dtype (fp32
    softmax)."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask[None, None], scores, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)
