"""Mixture-of-Experts FFN (token-choice top-k, capacity-bounded dispatch),
as ``repro.models.moe`` computes it.

Tokens are scattered into an ``[experts, capacity, d_model]`` buffer per
group (position-in-expert by an exclusive cumsum over the flat token-major
``[t*k, E]`` one-hot, GShard style), the expert FFNs run as batched matrix
products over the expert dim, and the results combine with the routing
weights.  Assignments past an expert's capacity are dropped (their residual
passes through); ``capacity_factor >= E/k`` is dropless because capacity
then clamps at the group's token count.  Routing runs in fp32.

Every shape is fixed by the token count, so the block runs without a host
sync and inside a captured decode graph: the dispatch is a one-hot cumsum
and an ``index_copy_`` into a buffer with a spare row ``E`` that takes
every dropped assignment and is then discarded (kept ``(expert, position)``
pairs are unique, so only that row sees colliding writes).  The expert
products are plain matrix products, as the reference's einsums are; there
is no kernel in this module.

``count_drops()`` collects each block's dropped-assignment count, for the
tests and the smoke run that must see a drop happen.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _act
from repro_torch.models.params import Spec

# (sequence length of the block's input, dropped assignments as a device
# tensor) per moe_block call while ``count_drops`` is active
_drop_log: Optional[List[tuple]] = None


@contextlib.contextmanager
def count_drops():
    """Collect ``(seq, dropped)`` for every ``moe_block`` call in the
    block: ``seq`` is the input's sequence length (1 for a decode step),
    ``dropped`` the number of (token, expert) assignments past capacity, a
    0-d tensor on the input's device (reading it is the caller's sync).
    Calls captured into a CUDA graph are not seen, nor are their
    replays."""
    global _drop_log
    prev, _drop_log = _drop_log, []
    try:
        yield _drop_log
    finally:
        _drop_log = prev


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    specs = {
        "router": Spec((d, e), ("embed", "experts"), scale=0.1),
        "w_up": Spec((e, d, f), ("experts", "embed", "expert_ffn")),
        "w_down": Spec((e, f, d), ("experts", "expert_ffn", "embed")),
    }
    if cfg.gated_ffn:
        specs["w_gate"] = Spec((e, d, f), ("experts", "embed", "expert_ffn"))
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        specs["shared_up"] = Spec((d, fs), ("embed", "ffn"))
        specs["shared_down"] = Spec((fs, d), ("ffn", "embed"))
        if cfg.gated_ffn:
            specs["shared_gate"] = Spec((d, fs), ("embed", "ffn"))
    return specs


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    cap = int(math.ceil(cfg.capacity_factor * group_tokens *
                        cfg.num_experts_per_tok / cfg.num_experts))
    cap = max(4, ((cap + 3) // 4) * 4)
    # a single expert can never receive more than group_tokens assignments
    # (top-k indices are distinct), so capacity_factor >= E/k is dropless.
    return min(cap, group_tokens)


def _one_hot(idx, e: int):
    """int64 one-hot of ``idx`` over ``e`` classes, by comparison (no
    range check, so no host sync)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def _dispatch_group(xg, top_idx, e: int, cap: int):
    """xg: [t,d]; top_idx: [t,k].  Returns (buf [E,cap,d], e_flat [t*k],
    p_flat [t*k], keep [t,k]); dropped assignments have ``e_flat == E`` and
    ``p_flat == 0``."""
    t, d = xg.shape
    k = top_idx.shape[1]
    top_idx = top_idx.long()
    flat = _one_hot(top_idx, e).reshape(t * k, e)             # [t*k,E]
    pos_in_e = torch.cumsum(flat, dim=0) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(t, k)             # [t,k]
    keep = pos < cap
    e_flat = torch.where(keep, top_idx, e).reshape(-1)        # drop -> row e
    p_flat = torch.where(keep, pos, 0).reshape(-1)
    tok_src = xg[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros(((e + 1) * cap, d), dtype=xg.dtype, device=xg.device)
    buf.index_copy_(0, e_flat * cap + p_flat, tok_src)
    return buf.view(e + 1, cap, d)[:e], e_flat, p_flat, keep


def _combine(out_buf, e_flat, p_flat, keep, w, tg: int):
    """Gather each kept assignment's expert output, weight it by its
    routing weight in the activations' dtype and sum over k.  out_buf
    [E,cap,d]; e_flat/p_flat [t*k]; keep/w [t,k]."""
    e, cap, d = out_buf.shape
    rows = torch.clamp(e_flat, max=e - 1) * cap + p_flat
    gathered = out_buf.reshape(e * cap, d).index_select(0, rows)
    gathered = torch.where(keep.reshape(-1, 1), gathered, 0.0)
    weighted = gathered * w.reshape(-1, 1).to(out_buf.dtype)
    return weighted.reshape(tg, -1, d).sum(dim=1)


def moe_block(p, x, cfg: ModelConfig, *, return_aux: bool = False):
    """x: [B,S,D] -> ([B,S,D], Switch load-balance loss or 0.0)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    g = cfg.moe_groups if t % max(cfg.moe_groups, 1) == 0 else 1
    tg = t // g
    cap = _capacity(cfg, tg)
    act = _act(cfg.ffn_activation)

    xt = x.reshape(t, d)
    gates = torch.matmul(xt.float(), p["router"].float())
    probs = torch.softmax(gates, dim=-1)
    top_w, top_idx = torch.topk(probs, k, dim=-1, sorted=True)   # [T,k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # group-local dispatch: g is a Python int (1 in every ported config)
    xg, wg, ig = (a.reshape(g, tg, -1) for a in (xt, top_w, top_idx))
    parts = [_dispatch_group(xg[i], ig[i], e, cap) for i in range(g)]
    buf = (parts[0][0][None] if g == 1
           else torch.stack([pt[0] for pt in parts]))         # [G,E,cap,d]
    if _drop_log is not None and not (
            x.is_cuda and torch.cuda.is_current_stream_capturing()):
        _drop_log.append((s, sum((~pt[3]).sum() for pt in parts)))

    up = torch.matmul(buf, p["w_up"].to(x.dtype))             # [G,E,cap,f]
    if cfg.gated_ffn:
        h = act(torch.matmul(buf, p["w_gate"].to(x.dtype))) * up
    else:
        h = act(up)
    out_buf = torch.matmul(h, p["w_down"].to(x.dtype))        # [G,E,cap,d]

    out = torch.cat([_combine(out_buf[i], pt[1], pt[2], pt[3], wg[i], tg)
                     for i, pt in enumerate(parts)]).reshape(t, d)

    if cfg.num_shared_experts:
        s_up = torch.matmul(xt, p["shared_up"].to(x.dtype))
        if cfg.gated_ffn:
            s_h = act(torch.matmul(xt, p["shared_gate"].to(x.dtype))) * s_up
        else:
            s_h = act(s_up)
        out = out + torch.matmul(s_h, p["shared_down"].to(x.dtype))

    out = out.reshape(b, s, d)
    if return_aux:
        # Switch-style load-balance loss: E * sum_e (frac_tokens_e * mean_prob_e)
        frac = _one_hot(top_idx, e).float().sum(dim=(0, 1)) / (t * k)
        mean_p = probs.mean(dim=0)
        return out, e * torch.sum(frac * mean_p)
    return out, 0.0
