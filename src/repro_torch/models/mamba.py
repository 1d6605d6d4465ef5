"""Mamba2 (state-space duality) mixer, as ``repro.models.mamba`` computes
it.

The chunked SSD algorithm (arXiv:2405.21060): an intra-chunk quadratic
attention-like term plus an inter-chunk linear state recurrence.  The
recurrence, the reference's ``lax.scan`` over chunks, is the hand-written
kernel S8 (``kernels.ssd_scan``) on CUDA tensors and its plain version on
the CPU; the rest is torch einsums, as the reference's is jnp einsums.
The single-token decode recurrence is plain PyTorch, as in the reference.

Shapes: x [B,S,D] -> in_proj -> z [B,S,Din], xs [B,S,Din], B/C [B,S,G,N],
dt [B,S,H]; heads H = Din / P (P = ssm_head_dim).

Casts follow the reference: ``in_proj``, the conv and ``out_proj`` run in
the activations' dtype; silu, softplus, the SSD and the state in fp32; the
new conv window and SSM state are written back in the cache's dtype.  The
cache is updated in place (the reference returns new leaves), with fixed
shapes and no host read, so a decode step runs inside a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_state_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def mamba_specs(cfg: ModelConfig):
    d = cfg.d_model
    din = cfg.ssm_d_inner
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    proj_out = 2 * din + 2 * g * n + h
    return {
        "in_proj": Spec((d, proj_out), ("embed", "ssm_inner")),
        "conv_w": Spec((cfg.ssm_conv_dim, cfg.ssm_conv_kernel),
                       ("conv_dim", None), scale=0.5),
        "A_log": Spec((h,), ("ssm_heads",), init="ones"),
        "D": Spec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": Spec((h,), ("ssm_heads",), init="zeros"),
        "norm_w": Spec((din,), ("ssm_inner",), init="zeros"),
        "out_proj": Spec((din, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg: ModelConfig, proj):
    din, g, n = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
    z = proj[..., :din]
    xs = proj[..., din:2 * din]
    Bm = proj[..., 2 * din:2 * din + g * n]
    Cm = proj[..., 2 * din + g * n:2 * din + 2 * g * n]
    dt = proj[..., 2 * din + 2 * g * n:]
    return z, xs, Bm, Cm, dt


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d. x: [B,S,C]; w: [C,K]; state: [B,K-1,C].
    Returns (out [B,S,C] in fp32, the last K-1 inputs [B,K-1,C]).

    The taps are multiplied and summed in order in the activations'
    dtype, as in the reference, but for the last sum: the reference casts
    the conv's output to fp32 for its silu, and XLA adds the last term
    into that fp32 value without rounding it to the activations' dtype
    first, so the port does too (a change only in bf16)."""
    k, s = w.shape[1], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                           # [B,S+K-1,C]
    taps = [xp[:, i:i + s] * w[:, i].to(x.dtype) for i in range(k)]
    out = taps[0]
    for tap in taps[1:-1]:                 # the reference's sum, in order
        out = out + tap
    out = out.float()
    if k > 1:
        out = out + taps[-1].float()
    return out, xp[:, -(k - 1):]


def _gated_rmsnorm(y, z, weight, eps):
    """Gate, then RMSNorm with weight ``1 + w``; not the fused kernel's
    function (a gate and no residual), so plain PyTorch, as the reference
    is plain jnp.  The gate is rounded to the activations' dtype; the
    product goes to fp32 as it is (exact for two bf16 values), as XLA
    computes the reference's product that is cast to fp32 at once."""
    y32 = y.float() * F.silu(z.float()).to(y.dtype).float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    out = y32 * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(y.dtype)


# jnp.cumsum's summation order on the reference's CPU backend: XLA sums a
# scan of up to 16 elements in order, and a longer one in blocks of 16,
# each in order, plus the in-order sum of the blocks before it
_CUMSUM_BLOCK = 16


def _ordered_cumsum(x):
    """Inclusive prefix sum along the last dim, one fp32 add at a time."""
    acc = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., i])
    return torch.stack(acc, dim=-1)


def _cumsum(x, dim: int):
    """``jnp.cumsum(x, axis=dim)`` summed in the order XLA's CPU backend
    sums it (``_CUMSUM_BLOCK``).  The SSD exponentiates differences of
    these sums, which turns a cumsum's last-bit rounding into a change of
    about 4e-5 of the state's scale, so the order is kept: the port then
    agrees with the reference on the CPU, and every add is rounded alike
    on the card and the CPU (``torch.cumsum`` sums in another order on
    each).  Exact for up to 16 blocks (chunks of up to 256 tokens)."""
    xm = x.movedim(dim, -1)
    n = xm.shape[-1]
    if n <= _CUMSUM_BLOCK:
        return _ordered_cumsum(xm).movedim(-1, dim)
    nb = -(-n // _CUMSUM_BLOCK)
    xb = F.pad(xm, (0, nb * _CUMSUM_BLOCK - n)).unflatten(-1, (nb, _CUMSUM_BLOCK))
    inner = _ordered_cumsum(xb)
    totals = _cumsum(inner[..., :-1, -1], -1)           # the blocks before
    before = F.pad(totals, (1, 0))
    out = (inner + before[..., None]).flatten(-2)[..., :n]
    return out.movedim(-1, dim)


def _ssd_chunked(xh, dt, A, Bm, Cm, cfg: ModelConfig, init_state=None):
    """Chunked SSD scan.

    xh: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (negative);
    Bm/Cm: [B,S,G,N].  Returns (y [B,S,H,P], final_state [B,H,P,N]),
    both fp32.
    """
    b, s, h, p_dim = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = min(cfg.ssm_chunk, s)
    orig_s = s
    if s % q:
        # pad with dt=0 tokens: zero dA and zero input weight, so they do not
        # perturb the state; their outputs are sliced away below.
        pad = q - s % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // q
    rep = h // g                                             # heads per group

    def chunk(a):
        return a.reshape((b, nc, q) + tuple(a.shape[2:]))

    xh_c = chunk(xh).float()                                  # [B,C,Q,H,P]
    dt_c = chunk(dt)                                          # [B,C,Q,H]
    B_c = chunk(Bm).float()                                   # [B,C,Q,G,N]
    C_c = chunk(Cm).float()

    dA = dt_c * A                                             # [B,C,Q,H] (<=0)
    cums = _cumsum(dA, 2)                                     # within-chunk cumsum
    total = cums[:, :, -1, :]                                 # [B,C,H]

    # intra-chunk: att[i,j] = exp(cums_i - cums_j) * (C_i . B_j)  (i >= j)
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]     # [B,C,Q,Q,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    # masked before exp: above-diagonal entries are positive and overflow
    seg = torch.where(tri[None, None, :, :, None], seg, -1e30)
    decay = torch.exp(seg)
    cb = torch.einsum("bcigm,bcjgm->bcijg", C_c, B_c)         # [B,C,Q,Q,G]
    # broadcast groups over their heads without materializing a repeat
    att = (cb[..., :, None] *
           decay.reshape(b, nc, q, q, g, rep) *
           dt_c.reshape(b, nc, 1, q, g, rep)).reshape(b, nc, q, q, h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xh_c)

    # chunk states: sum_j exp(total - cums_j) dt_j x_j B_j -> [B,C,H,P,N]
    decay_to_end = torch.exp(total[:, :, None, :] - cums)     # [B,C,Q,H]
    w = decay_to_end * dt_c
    xw = (w[..., None] * xh_c).reshape(b, nc, q, g, rep, p_dim)
    states = torch.einsum("bcqgrp,bcqgn->bcgrpn", xw, B_c
                          ).reshape(b, nc, h, p_dim, n)

    # inter-chunk recurrence over the chunk index: kernel S8
    chunk_decay = torch.exp(total)                            # [B,C,H]
    h0 = None if init_state is None else init_state.float().contiguous()
    h_before, hT = ssd_state_scan(chunk_decay.contiguous(),
                                  states.contiguous(), h0)

    # inter-chunk contribution: C_i . (exp(cums_i) * h_before)
    hb_g = h_before.reshape(b, nc, g, rep, p_dim, n)
    y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp", C_c, hb_g
                           ).reshape(b, nc, q, h, p_dim)
    y_inter = y_inter * torch.exp(cums)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p_dim)
    return y[:, :orig_s], hT


def mamba_block(p, x, cfg: ModelConfig, *, state=None):
    """Full Mamba2 mixer. state: dict(conv=[B,K-1,C], ssm=[B,H,P,N]) for
    the caches, updated in place and returned.

    Returns (out [B,S,D], state or None).  The chunked SSD runs when there
    is no state or more than one token (prefill); one token against a
    state takes the single-step recurrence (decode).
    """
    b, s, _ = x.shape
    h, p_dim = cfg.ssm_heads, cfg.ssm_head_dim
    din = cfg.ssm_d_inner
    g, gn = cfg.ssm_n_groups, cfg.ssm_n_groups * cfg.ssm_state
    proj = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, _, _, _, dt = _split_proj(cfg, proj)

    # the reference concatenates xs, B and C: adjacent columns of proj
    conv_in = proj[..., din:din + cfg.ssm_conv_dim]            # [B,S,conv_dim]
    conv_state = None if state is None else state["conv"]
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], conv_state)
    conv_out = F.silu(conv_out).to(x.dtype)
    xs = conv_out[..., :din]
    Bm = conv_out[..., din:din + gn].reshape(b, s, g, cfg.ssm_state)
    Cm = conv_out[..., din + gn:].reshape(b, s, g, cfg.ssm_state)

    A = -torch.exp(p["A_log"].float())                         # [H], negative
    dt = F.softplus(dt.float() + p["dt_bias"].float())         # [B,S,H]
    xh = xs.reshape(b, s, h, p_dim)

    if state is None or s > 1:
        ssm_init = None if state is None else state["ssm"]
        y, hT = _ssd_chunked(xh, dt, A, Bm, Cm, cfg, init_state=ssm_init)
    else:
        # single-token recurrence: h = h*exp(dt*A) + dt * x B ; y = C.h
        h_prev = state["ssm"].float()                          # [B,H,P,N]
        dt1 = dt[:, 0]                                         # [B,H]
        dec = torch.exp(dt1 * A[None, :])
        rep = h // g
        B1 = Bm[:, 0].repeat_interleave(rep, dim=1)            # [B,H,N]
        C1 = Cm[:, 0].repeat_interleave(rep, dim=1)
        xb = torch.einsum("bhp,bhn->bhpn", xh[:, 0].float(), B1.float())
        hT = h_prev * dec[:, :, None, None] + dt1[:, :, None, None] * xb
        y = torch.einsum("bhn,bhpn->bhp", C1.float(), hT)[:, None]

    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_w"], cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))

    if state is not None:
        # in the cache's dtype, as the reference's astype
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(hT)
    return out, state
