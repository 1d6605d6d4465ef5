"""The gradient of the SSD's chunk-state scan (kernel S8b's plain version,
``ssd_state_scan_bwd_reference``) on the CPU, through the autograd
Function the card's training runs (``ops._SSDStateScan``, whose CPU route
is the plain forward and the plain backward):
- against ``jax.vjp`` of the reference's ``lax.scan`` and of its whole
  ``_ssd_chunked`` (fp32, 2e-5 of each gradient's max-abs: the two sides
  sum in other orders);
- against torch autograd of the plain forward in float64 (1e-12 of each
  gradient's max-abs), and ``gradcheck`` of the Function;
- the Mamba2 mixer's parameter gradients, mamba2's and jamba's smoke
  configs, against ``jax.grad`` at the training tests' 1e-4 of a leaf's
  max-abs (``tests/test_torch_training.py``'s ``GRAD_TOL``).

Inputs come from numpy seeds and reach both packages as the same arrays."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.distributed.sharding import NULL_CTX  # noqa: E402
from repro.models import mamba as JMa  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_state_scan, ssd_state_scan_bwd_reference, ssd_state_scan_reference)
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.models import mamba as TMa  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4


def _gap(got, ref):
    """max |got - ref| over max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


@pytest.fixture
def through_the_function(monkeypatch):
    """``models.mamba`` calls the scan through ``_SSDStateScan`` (the
    route a CUDA call under grad takes), and each plain backward it runs
    is counted."""
    calls = []

    def bwd(*args):
        calls.append(args[1].shape)
        return ssd_state_scan_bwd_reference(*args)

    monkeypatch.setattr(ops, "ssd_state_scan_bwd_reference", bwd)
    monkeypatch.setattr(TMa, "ssd_state_scan",
                        lambda d, s, h0=None: ops._SSDStateScan.apply(d, s, h0))
    return calls


def _scan_inputs(b, c, h, p, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    decay = np.exp(-rng.random((b, c, h)) * 4).astype(dtype)
    states = rng.standard_normal((b, c, h, p, n)).astype(dtype)
    h0 = rng.standard_normal((b, h, p, n)).astype(dtype)
    g_hb = rng.standard_normal((b, c, h, p, n)).astype(dtype)
    g_ht = rng.standard_normal((b, h, p, n)).astype(dtype)
    return decay, states, h0, g_hb, g_ht


def _ids(p):
    return "-".join(str(x) for x in p) if isinstance(p, tuple) else str(p)


# (B, C, H, P, N): one chunk, several, a head of one element
SCAN_SHAPES = [(2, 1, 3, 4, 5), (2, 3, 3, 4, 5), (1, 8, 2, 8, 16),
               (3, 5, 1, 1, 1)]


def _jax_scan(decay, states, h0):
    """The reference's inter-chunk recurrence (``_ssd_chunked``'s
    ``step``) as its ``lax.scan``."""

    def step(h_prev, inp):
        dec, st = inp
        return h_prev * dec[:, :, None, None] + st, h_prev

    h_t, hb = lax.scan(step, h0, (jnp.moveaxis(decay, 1, 0),
                                  jnp.moveaxis(states, 1, 0)))
    return jnp.moveaxis(hb, 0, 1), h_t


@pytest.mark.parametrize("with_ght", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=_ids)
def test_scan_bwd_reference_matches_jax_vjp_of_the_scan(shape, with_h0,
                                                        with_ght):
    decay, states, h0, g_hb, g_ht = _scan_inputs(*shape, seed=sum(shape))
    if not with_ght:
        g_ht = np.zeros_like(g_ht)
    h0_j = jnp.asarray(h0) if with_h0 else jnp.zeros(h0.shape, jnp.float32)
    _, vjp = jax.vjp(_jax_scan, jnp.asarray(decay), jnp.asarray(states), h0_j)
    jd, js, jh = vjp((jnp.asarray(g_hb), jnp.asarray(g_ht)))
    td, ts, th = map(torch.from_numpy, (decay, states, h0))
    hb, _ = ssd_state_scan_reference(td, ts, th if with_h0 else None)
    gd, gs, g0 = ssd_state_scan_bwd_reference(
        td, hb, torch.from_numpy(g_hb),
        torch.from_numpy(g_ht) if with_ght else None, with_h0)
    assert gd.shape == decay.shape and gs.shape == states.shape
    assert _gap(gd, jd) <= TOL
    assert _gap(gs, js) <= TOL
    if with_h0:
        assert _gap(g0, jh) <= TOL
    else:
        assert g0 is None


@pytest.mark.parametrize("with_ght", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=_ids)
def test_scan_bwd_reference_matches_autograd_in_float64(shape, with_h0,
                                                        with_ght):
    """The plain backward against torch autograd of the plain forward:
    the same function, summed in other orders, so 1e-12 in float64."""
    arrays = _scan_inputs(*shape, seed=7 + sum(shape), dtype=np.float64)
    decay, states, h0, g_hb, g_ht = map(torch.from_numpy, arrays)
    leaves = [decay.requires_grad_(), states.requires_grad_()]
    if with_h0:
        leaves.append(h0.requires_grad_())
    hb, ht = ssd_state_scan_reference(decay, states, h0 if with_h0 else None)
    # without g_hT, hT's cotangent is zeros (at C = 1 without h0, h_before
    # is zeros and does not reach the inputs)
    loss = (hb * g_hb).sum() + (ht * (g_ht if with_ght else 0 * g_ht)).sum()
    auto = torch.autograd.grad(loss, leaves)
    plain = ssd_state_scan_bwd_reference(
        decay.detach(), hb.detach(), g_hb, g_ht if with_ght else None,
        with_h0)
    for a, p in zip(auto, plain):
        assert p.dtype == torch.float64
        assert _gap(p, a) <= 1e-12
    assert (plain[2] is None) == (not with_h0)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 2, 3, 4), (1, 1, 1, 2, 2)], ids=_ids)
def test_function_cpu_route_passes_gradcheck(shape, with_h0):
    decay, states, h0, _, _ = _scan_inputs(*shape, seed=3, dtype=np.float64)
    args = (torch.from_numpy(decay).requires_grad_(),
            torch.from_numpy(states).requires_grad_(),
            torch.from_numpy(h0).requires_grad_() if with_h0 else None)
    assert torch.autograd.gradcheck(ops._SSDStateScan.apply, args)


def test_function_and_wrapper_agree_on_the_cpu():
    """The Function's CPU route and the wrapper (autograd of the plain
    forward) give the same outputs bit for bit and the same gradients to
    fp32 rounding; with only hT used, the Function's backward gets no
    h_before grad and reads it as zeros."""
    decay, states, h0, g_hb, g_ht = map(torch.from_numpy,
                                        _scan_inputs(2, 4, 3, 4, 8, seed=11))
    got = []
    for fn in (ops._SSDStateScan.apply, ssd_state_scan):
        d, s, h = (t.clone().requires_grad_() for t in (decay, states, h0))
        hb, ht = fn(d, s, h)
        grads = torch.autograd.grad((hb * g_hb).sum() + (ht * g_ht).sum(),
                                    (d, s, h))
        only_ht = torch.autograd.grad((fn(d, s, h)[1] * g_ht).sum(), (d, s, h))
        got.append(((hb, ht), grads, only_ht))
    (fo, fg, fh), (wo, wg, wh) = got
    assert all(torch.equal(a, b) for a, b in zip(fo, wo))
    for a, b in zip(fg + fh, wg + wh):
        assert _gap(a, b) <= 1e-6


# ----------------------------------------------------------------------------
# The chunked SSD and the mixer
# ----------------------------------------------------------------------------

def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _ssd_inputs(b, s, seed, h=4, p=32, g=2, n=16):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * 3).astype(np.float32)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    g_ht = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (xh, dt, a, bm, cm), h0, gy, g_ht


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("s", [5, 32, 40])
def test_ssd_chunked_grads_match_jax_vjp(through_the_function, s, chunk,
                                         with_h0):
    """jamba's smoke SSD (2 groups of 2 heads of 32 x 16): S = 5 is one
    short chunk; S = 32 one chunk of 32 or two of 16; S = 40 pads to two
    chunks of 32 or three of 16.  Every input's gradient, through the
    plain backward, within 2e-5 of its max-abs of ``jax.vjp``'s."""
    jc, tc = _cfgs("jamba-1.5-large-398b", ssm_chunk=chunk)
    ins, h0, gy, g_ht = _ssd_inputs(2, s, seed=s + chunk)

    def jfn(*args):
        return JMa._ssd_chunked(*args[:5], jc, NULL_CTX,
                                init_state=args[5] if with_h0 else None)

    jargs = tuple(map(jnp.asarray, ins + ((h0,) if with_h0 else ())))
    (jy, jh), vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(g_ht)))
    targs = [torch.from_numpy(a).requires_grad_()
             for a in ins + ((h0,) if with_h0 else ())]
    ty, th = TMa._ssd_chunked(*targs[:5], tc,
                              init_state=targs[5] if with_h0 else None)
    tgrads = torch.autograd.grad(
        (ty * torch.from_numpy(gy)).sum() + (th * torch.from_numpy(g_ht)).sum(),
        targs)
    nc = -(-s // min(chunk, s))
    assert through_the_function == [(2, nc, 4, 32, 16)]
    assert _gap(ty.detach(), jy) <= TOL and _gap(th.detach(), jh) <= TOL
    gaps = {name: _gap(t, j) for name, t, j in zip(
        ("xh", "dt", "A", "Bm", "Cm", "init_state"), tgrads, jgrads)}
    print(f"S={s} chunk={chunk} h0={with_h0}: gaps {gaps}")
    assert max(gaps.values()) <= TOL, gaps


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_mamba_block_param_grads_match_jax_grad(through_the_function, arch):
    """The mixer's gradients of every parameter and of its input, at S =
    40 (two chunks of 32, padded), through the plain backward, against
    ``jax.vjp`` of the reference's ``mamba_block`` from the same params."""
    jc, tc = _cfgs(arch)
    jp = jax_init_params(JMa.mamba_specs(jc), jax.random.PRNGKey(2),
                         jnp.float32)
    tp = {k: v.requires_grad_() for k, v in
          params_from_numpy(jp, device="cpu").items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 40, jc.d_model)).astype(np.float32)
    go = rng.standard_normal((3, 40, jc.d_model)).astype(np.float32)
    jo, vjp = jax.vjp(lambda p, xx: JMa.mamba_block(p, xx, jc, NULL_CTX)[0],
                      jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(go))
    tx = torch.from_numpy(x).requires_grad_()
    to, _ = TMa.mamba_block(tp, tx, tc)
    names = sorted(tp)
    tg = torch.autograd.grad((to * torch.from_numpy(go)).sum(),
                             [tp[k] for k in names] + [tx])
    assert through_the_function == [(3, 2, tc.ssm_heads, tc.ssm_head_dim,
                                     tc.ssm_state)]
    assert _gap(to.detach(), jo) <= TOL
    gaps = {k: _gap(g, jgp[k]) for k, g in zip(names, tg)}
    gaps["x"] = _gap(tg[-1], jgx)
    print(f"{arch}: mixer grad gaps {gaps}")
    assert max(gaps.values()) <= GRAD_TOL, gaps


def test_backward_launch_refuses_what_the_kernel_does_not_take():
    """The backward kernel's wrapper checks before it builds or launches
    anything (here on CPU tensors, which it never launches on)."""
    d = torch.ones(2, 3, 4)
    hb = torch.ones(2, 3, 4, 5, 6)
    with pytest.raises(TypeError, match="fp32"):
        ops._launch_bwd(d.double(), hb.double(), hb.double(), None, False)
    with pytest.raises(ValueError, match="g_h_before"):
        ops._launch_bwd(d, hb, hb.transpose(3, 4), None, False)
    with pytest.raises(ValueError, match="h0"):
        ops._launch_bwd(d, hb, hb, torch.ones(2, 4, 5, 5), False)
    with pytest.raises(ValueError, match="at most 8192"):
        big = torch.ones(1, 1, 1, 64, 129)
        ops._launch_bwd(torch.ones(1, 1, 1), big, big, None, False)
