"""The plain backwards of K3 and K4, written out as the kernels compute them
(``attention_lse_reference``, ``attention_bwd_reference``,
``rmsnorm_bwd_reference``), against ``jax.vjp`` of the JAX package's plain
functions and against torch autograd of the port's own plain forwards, on
the CPU.

Inputs come from numpy seeds.  fp32 gradients are held to 2e-5 of each
gradient's max-abs (the two sides sum in other orders), the log-sum-exp
to 2e-5 absolute (it is of order log S)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference as jax_attention)
from repro.kernels.rmsnorm.ref import rmsnorm_reference as jax_rmsnorm  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_bwd_reference, attention_lse_reference, attention_reference)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    rmsnorm_bwd_reference, rmsnorm_reference)

TOL = 2e-5
# every (G, D) the kernels are built for, with one or two KV heads
PAIRS = [(g, d, hkv) for (g, d), hkv in zip(flash_ops._SHAPES, (2, 1, 1, 2, 2, 1))]
# (B, S, causal, window): S off a multiple of 64, windows, non-causal, and
# a row that sees one key (its dq row is rounding noise; at S = 1 every
# dq and dk is, and a max-abs of noise is no scale)
CASES = [(2, 70, True, None), (1, 33, True, 8), (2, 20, False, None),
         (1, 45, False, 6), (1, 3, True, None)]


def _gap(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _attn_inputs(g, d, hkv, b, s, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d), np.float32)
               for h in (g * hkv, hkv, hkv))
    do = rng.standard_normal((b, s, g * hkv, d), np.float32)
    return q, k, v, do


def _jax_lse(q, k, causal, window):
    """The log-sum-exp over keys of the scores as the JAX package's
    ``attention_reference`` forms them (scaled, masked to -1e30)."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    k = jnp.repeat(k, g, axis=2) if g > 1 else k
    scores = jnp.einsum("bqhd,bkhd->bhqk", q.astype(jnp.float32),
                        k.astype(jnp.float32)) / np.sqrt(d)
    qpos, kpos = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    mask = kpos <= qpos if causal else jnp.ones((s, s), bool)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = jnp.where(mask[None, None], scores, -1e30)
    return jax.scipy.special.logsumexp(scores, axis=-1)


def _ids(p):
    return "-".join(str(x) for x in p)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_attention_lse_matches_jax(pair, case):
    g, d, hkv = pair
    b, s, causal, window = case
    q, k, v, _ = _attn_inputs(g, d, hkv, b, s, 0)
    out, lse = attention_lse_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    assert lse.shape == (b, g * hkv, s) and lse.dtype == torch.float32
    ref = np.asarray(_jax_lse(q, k, causal, window))
    assert float(np.abs(lse.numpy() - ref).max()) <= TOL
    jout = jax_attention(q, k, v, causal=causal, window=window)
    assert _gap(out.numpy(), jout) <= TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_attention_bwd_matches_jax_vjp(pair, case):
    """(dq, dk, dv) by the kernels' formulas against ``jax.vjp`` of the
    JAX package's plain attention."""
    g, d, hkv = pair
    b, s, causal, window = case
    q, k, v, do = _attn_inputs(g, d, hkv, b, s, 1)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = attention_lse_reference(tq, tk, tv, causal=causal, window=window)
    got = attention_bwd_reference(tq, tk, tv, out, tdo, lse, causal=causal,
                                  window=window)
    _, vjp = jax.vjp(lambda a, b_, c: jax_attention(
        a, b_, c, causal=causal, window=window), q, k, v)
    for a, c in zip(got, vjp(jnp.asarray(do))):
        assert a.shape == c.shape and a.dtype == torch.float32
        assert _gap(a.numpy(), c) <= TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("pair", PAIRS, ids=_ids)
def test_attention_bwd_matches_autograd_of_plain_forward(pair, case):
    """The same against torch autograd of the port's plain forward (what
    the CPU wrapper differentiates)."""
    g, d, hkv = pair
    b, s, causal, window = case
    q, k, v, do = _attn_inputs(g, d, hkv, b, s, 2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tdo = torch.from_numpy(do)
    out = attention_reference(tq, tk, tv, causal=causal, window=window)
    ref = torch.autograd.grad(out, (tq, tk, tv), tdo)
    with torch.no_grad():
        _, lse = attention_lse_reference(tq, tk, tv, causal=causal,
                                         window=window)
        got = attention_bwd_reference(tq, tk, tv, out, tdo, lse,
                                      causal=causal, window=window)
    for a, c in zip(got, ref):
        assert _gap(a.numpy(), c.numpy()) <= TOL


def test_attention_bwd_reference_in_bf16_rounds_once():
    """bf16 inputs: the formulas run in fp32 and each gradient is rounded
    once to bf16, within one bf16 ulp of the fp32 result."""
    q, k, v, do = _attn_inputs(8, 128, 2, 2, 70, 3)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out, lse = attention_lse_reference(tq, tk, tv)
    got = attention_bwd_reference(tq, tk, tv, out, tdo, lse)
    ref = attention_bwd_reference(tq.float(), tk.float(), tv.float(),
                                  out.float(), tdo.float(), lse)
    for a, c in zip(got, ref):
        assert a.dtype == torch.bfloat16
        assert torch.allclose(a.float(), c, rtol=2 ** -8, atol=1e-30)


def test_lse_buffer_layout():
    """The kernels' [B, Hkv, S_pad, G] buffer: a 64-row tile (64 / G
    positions x the G heads of one KV head) is 64 consecutive floats, and
    ``lse_as_bhs`` reads it back as [B, Hq, S]."""
    b, s, hkv, g = 2, 70, 2, 8
    buf = flash_ops.lse_buffer(b, s, hkv, g, "cpu")
    assert buf.shape == (b, hkv, 128, g) and buf.is_contiguous()
    bhs = torch.arange(b * hkv * g * s, dtype=torch.float32).reshape(
        b, hkv * g, s)
    for bb in range(b):
        for h in range(hkv * g):
            buf[bb, h // g, :s, h % g] = bhs[bb, h]
    assert torch.equal(flash_ops.lse_as_bhs(buf, s), bhs)
    flat = buf.reshape(-1)
    pos0, p = 16, 64 // g      # the tile of positions 16..23, KV head 1
    tile = flat[(1 * 128 + pos0) * g:(1 * 128 + pos0) * g + 64]
    want = torch.stack([bhs[0, g + hh, pos0 + i] for i in range(p)
                        for hh in range(g)])
    assert torch.equal(tile, want)


@pytest.mark.parametrize("shape,sms,want", [
    ((4, 512, 2, 128), 132, 4),     # qwen2.5-3b's training shape: 64 tiles
    ((16, 512, 2, 128), 132, 2),
    ((16, 2048, 8, 128), 132, 1),
    ((1, 65, 1, 256), 132, 4),      # two tiles, each two halves of D
    ((1, 1, 1, 64), 132, 4)])
def test_dkv_splits_fill_the_card(shape, sms, want):
    b, s, hkv, d = shape
    assert flash_ops._dkv_splits(b, s, hkv, d, sms) == want


def _norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x, r, ds, dn = (rng.standard_normal(shape, np.float32) for _ in range(4))
    w = rng.standard_normal(shape[-1]).astype(np.float32) * 0.1
    return x * 3, r, w, ds, dn


NORM_SHAPES = [(1, 8), (5, 32), (3, 7, 64), (16, 2048), (2, 12288)]


@pytest.mark.parametrize("shape", NORM_SHAPES, ids=_ids)
def test_rmsnorm_bwd_matches_jax_vjp(shape):
    """(dx, dweight) by the kernel's formulas against ``jax.vjp`` of the
    JAX package's plain norm, from the grads of both outputs; dx is also
    the residual's grad."""
    x, r, w, ds, dn = _norm_inputs(shape, 4)
    got = rmsnorm_bwd_reference(*(torch.from_numpy(a) for a in (x, r, w, ds, dn)))
    _, vjp = jax.vjp(lambda a, b_, c: jax_rmsnorm(a, b_, c, 1e-6), x, r, w)
    jx, jr, jw = vjp((jnp.asarray(ds), jnp.asarray(dn)))
    assert _gap(got[0].numpy(), jx) <= TOL
    assert _gap(got[0].numpy(), jr) <= TOL
    assert got[1].shape == w.shape and _gap(got[1].numpy(), jw) <= TOL


@pytest.mark.parametrize("round_sum", [False, True])
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=_ids)
def test_rmsnorm_bwd_matches_autograd_of_plain_forward(shape, round_sum):
    """The same against torch autograd of the port's plain norm; the JAX
    function has no ``round_sum``, and in fp32 it changes nothing, so it is
    held here only."""
    x, r, w, ds, dn = _norm_inputs(shape, 5)
    tx, tr, tw = (torch.from_numpy(a).requires_grad_() for a in (x, r, w))
    tds, tdn = torch.from_numpy(ds), torch.from_numpy(dn)
    ref = torch.autograd.grad(rmsnorm_reference(tx, tr, tw, 1e-6, round_sum),
                              (tx, tr, tw), (tds, tdn))
    got = rmsnorm_bwd_reference(tx.detach(), tr.detach(), tw.detach(), tds,
                                tdn, 1e-6, round_sum)
    for a, c in zip((got[0], got[0], got[1]), ref):
        assert _gap(a.numpy(), c.numpy()) <= TOL


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_sum", [False, True])
def test_rmsnorm_bwd_reference_bf16_rows(round_sum, wdtype):
    """bf16 rows (with a bf16 or an fp32 weight): the formulas in fp32,
    round_sum rounding the sum to bf16 first, dx rounded once to bf16 and
    dweight to the weight's dtype; autograd of the plain norm rounds the
    same sums once, so the two agree within one bf16 ulp."""
    x, r, w, ds, dn = _norm_inputs((6, 256), 6)
    tx, tr, tds, tdn = (torch.from_numpy(a).bfloat16() for a in (x, r, ds, dn))
    tw = torch.from_numpy(w).to(wdtype)
    gx, gr, gw = (t.clone().requires_grad_() for t in (tx, tr, tw))
    ref = torch.autograd.grad(rmsnorm_reference(gx, gr, gw, 1e-6, round_sum),
                              (gx, gr, gw), (tds, tdn))
    dx, dw = rmsnorm_bwd_reference(tx, tr, tw, tds, tdn, 1e-6, round_sum)
    assert dx.dtype == torch.bfloat16 and dw.dtype == wdtype
    for a, c in zip((dx, dx, dw), ref):
        assert _gap(a.float().numpy(), c.float().numpy()) <= 2 ** -8
