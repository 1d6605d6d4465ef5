"""The training path of the port against ``repro`` on the CPU: the
full-sequence ``forward``, the loss and its gradients, AdamW, the
microbatched train step and rematerialisation, and the plain versions of
the two kernels the path runs (K3, K4) under autograd.

Reference params (``jax.random`` init) go through ``params_from_numpy``;
batches and grads come from NumPy seeds and reach both packages as the
same arrays.  Tolerances, each a fraction of the compared tensor's (or
leaf's) largest magnitude:
- logits and the MoE loss: 2e-5 in fp32, jamba 6e-5 (its attention
  layer's fp32 error rides through seven Mamba layers);
- loss gradients: 1e-4 of each leaf's max-abs (the measured gap is
  printed; 3e-6 to 2.8e-5), llama-3.2-vision-90b 1e-3: the reference's own
  gradients there move by 3.0e-3 when every parameter moves by one fp32
  ulp (its first layer's query and key projections), so no fp32
  reimplementation can be held closer than that order (the port's gap
  measured 3.7e-4);
- AdamW, its schedule and the clip on the same grads: 1e-6;
- one train step's params: 5e-5 absolute, the reference test's band for
  two summation orders at lr 1e-3 (``tests/test_training.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_reference as jax_attention)
from repro.kernels.rmsnorm.ref import rmsnorm_reference as jax_rmsnorm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.training import train_step as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels.flash_attention import attention_reference  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_reference  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.params import map_tree, params_from_numpy  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training import train_step as TT  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

LOGITS_TOL = {"jamba-1.5-large-398b": 6e-5}
GRAD_TOL = {"qwen2.5-3b": 1e-4, "mixtral-8x7b": 1e-4, "mamba2-2.7b": 1e-4,
            "musicgen-large": 1e-4, "llama-3.2-vision-90b": 1e-3}


def _setup(arch, seed=0, **kw):
    jc = dataclasses.replace(jax_smoke(arch), **kw)
    tc = dataclasses.replace(get_smoke_config(arch), **kw)
    pj = jax_init_params(JM.param_specs(jc), jax.random.PRNGKey(seed),
                         jnp.float32)
    return jc, tc, pj, params_from_numpy(pj, device="cpu")


def _batch(cfg, seq=16, b=2, index=0, seed=0):
    return SyntheticLMDataset(cfg, seq, b, seed=seed).batch(index)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _gap(ref, got):
    """max |got - ref| over max |ref| (0 when both are all zeros)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / scale) if scale else \
        float(np.abs(got).max())


def _numpy(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ----------------------------------------------------------------------------
# forward and the loss gradients
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    """Full-sequence logits and the summed MoE loss of every smoke config
    (fp32), with each config's inputs: tokens, ``embeds`` (musicgen) and
    image embeddings (llama-3.2-vision)."""
    jc, tc, pj, pt = _setup(arch)
    b = _batch(tc)
    lj, aj = JM.forward(jc, pj, tokens=_jb(b).get("tokens"),
                        embeds=_jb(b).get("embeds"),
                        cross_kv=_jb(b).get("image_embeds"))
    with torch.no_grad():
        lt, at = TM.forward(tc, pt, tokens=_tb(b).get("tokens"),
                            embeds=_tb(b).get("embeds"),
                            cross_kv=_tb(b).get("image_embeds"))
    tol = LOGITS_TOL.get(arch, 2e-5)
    assert lt.shape == lj.shape and lt.dtype == torch.float32
    gap = _gap(lj, lt.numpy())
    print(f"{arch}: forward logits gap {gap:.2e} (tol {tol})")
    assert gap <= tol
    assert abs(float(at) - float(aj)) <= tol * max(1.0, abs(float(aj)))
    if tc.num_experts:
        assert float(aj) > 0


def test_forward_positions_and_remat_under_no_grad():
    """``positions=`` moves RoPE as in the reference; without autograd the
    ``remat`` flag changes nothing."""
    jc, tc, pj, pt = _setup("qwen2.5-3b", num_layers=2)
    b = _batch(tc)
    pos = np.broadcast_to(np.arange(16) + 7, (2, 16)).astype(np.int32)
    lj, _ = JM.forward(jc, pj, tokens=_jb(b)["tokens"],
                       positions=jnp.asarray(pos))
    with torch.no_grad():
        lt, _ = TM.forward(tc, pt, tokens=_tb(b)["tokens"],
                           positions=torch.from_numpy(pos))
        lr, _ = TM.forward(dataclasses.replace(tc, remat=True), pt,
                           tokens=_tb(b)["tokens"],
                           positions=torch.from_numpy(pos))
    assert _gap(lj, lt.numpy()) <= 2e-5
    assert torch.equal(lt, lr)


def test_forward_refuses_a_vision_model_without_image_embeddings():
    _, tc, _, pt = _setup("llama-3.2-vision-90b")
    with pytest.raises(ValueError, match="image embeddings"):
        TM.forward(tc, pt, tokens=torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.parametrize("arch", sorted(GRAD_TOL))
def test_loss_grads_match_reference(arch):
    """The port's gradient of the loss (ce + z-loss + aux) against
    ``jax.grad`` of the reference's ``make_loss_fn``, leaf by leaf."""
    jc, tc, pj, pt = _setup(arch)
    b = _batch(tc)
    gj = jax.grad(lambda p, bb: JT.make_loss_fn(jc, JT.TrainConfig())(
        p, bb)[0])(pj, _jb(b))
    gt, aux = TT.make_grad_fn(tc, TT.TrainConfig())(pt, _tb(b))
    lj, auxj = JT.make_loss_fn(jc, JT.TrainConfig())(pj, _jb(b))
    assert abs(float(aux["ce"]) - float(auxj["ce"])) <= 2e-5 * float(
        auxj["ce"])
    gaps = {jax.tree_util.keystr(path): _gap(a, c.numpy())
            for (path, a), c in zip(jax.tree_util.tree_leaves_with_path(gj),
                                    tree_leaves(gt))}
    assert len(gaps) == len(tree_leaves(gt))
    worst = max(gaps, key=gaps.get)
    print(f"{arch}: grad gap at most {gaps[worst]:.2e} of a leaf's "
          f"max-abs ({worst}; tol {GRAD_TOL[arch]})")
    assert gaps[worst] <= GRAD_TOL[arch], gaps


def test_remat_gives_the_same_grads():
    """Rematerialised layer groups give the grads of the plain run, bit
    for bit on the CPU, for a dense and a MoE model."""
    for arch in ("qwen2.5-3b", "mixtral-8x7b"):
        _, tc, _, pt = _setup(arch, num_layers=2 * len(
            get_smoke_config(arch).group_pattern))
        b = _tb(_batch(tc))
        g0, a0 = TT.make_grad_fn(tc, TT.TrainConfig())(pt, b)
        g1, a1 = TT.make_grad_fn(dataclasses.replace(tc, remat=True),
                                 TT.TrainConfig())(pt, b)
        assert all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(g0), tree_leaves(g1)))
        assert torch.equal(a0["ce"], a1["ce"]) and \
            torch.equal(a0["aux"], a1["aux"])


def test_plain_kernels_under_autograd_match_reference_grads():
    """K3's and K4's plain versions (what the CPU runs, and what the card's
    backward kernels are held to) differentiated by autograd, against
    ``jax.grad`` of the reference's plain versions: causal with and
    without a window and non-causal attention with GQA, and the fused
    norm's grads of x, the residual and the weight from both outputs."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 24, h, 16), np.float32)
               for h in (4, 2, 2))
    do = rng.standard_normal((2, 24, 4, 16), np.float32)
    for causal, window in ((True, None), (True, 5), (False, None)):
        fj = lambda a, b_, c: jnp.sum(jax_attention(  # noqa: E731
            a, b_, c, causal=causal, window=window) * do)
        gj = jax.grad(fj, argnums=(0, 1, 2))(q, k, v)
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = attention_reference(tq, tk, tv, causal=causal, window=window)
        gt = torch.autograd.grad((out * torch.from_numpy(do)).sum(),
                                 (tq, tk, tv))
        for a, c in zip(gj, gt):
            assert _gap(a, c.numpy()) <= 2e-5
    x, r = (rng.standard_normal((5, 32), np.float32) for _ in range(2))
    w = rng.standard_normal(32).astype(np.float32) * 0.1
    ds, dn = (rng.standard_normal((5, 32), np.float32) for _ in range(2))
    fj = lambda a, b_, c: sum(jnp.sum(o * u) for o, u in zip(  # noqa: E731
        jax_rmsnorm(a, b_, c, 1e-6), (ds, dn)))
    gj = jax.grad(fj, argnums=(0, 1, 2))(x, r, w)
    tx, tr, tw = (torch.from_numpy(a).requires_grad_() for a in (x, r, w))
    s, n = rmsnorm_reference(tx, tr, tw, 1e-6)
    gt = torch.autograd.grad((s * torch.from_numpy(ds)).sum()
                             + (n * torch.from_numpy(dn)).sum(), (tx, tr, tw))
    for a, c in zip(gj, gt):
        assert _gap(a, c.numpy()) <= 2e-5


# ----------------------------------------------------------------------------
# AdamW, the loss and the train step
# ----------------------------------------------------------------------------

def _opt_tree(rng, scale=1.0):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "b": rng.standard_normal(5).astype(np.float32) * scale,
            "stack": {"k": rng.standard_normal((2, 3, 4)).astype(np.float32)
                      * scale}}


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_matches_reference(clip):
    """Three AdamW steps on the same NumPy grads in both packages, with the
    warmup and the cosine tail in range and the clip off and on: params,
    moments, step, lr and grad norm within 1e-6; default decay mask
    (ndim >= 2)."""
    rng = np.random.default_rng(1)
    cfg = dict(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
               grad_clip=clip, warmup_steps=2, total_steps=5,
               min_lr_frac=0.1)
    jc, tc = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    p0 = _opt_tree(rng)
    pj = jax.tree.map(jnp.asarray, p0)
    pt = params_from_numpy(p0, device="cpu")
    sj, st = JO.adamw_init(pj, jc), TO.adamw_init(pt, tc)
    for _ in range(3):
        g = _opt_tree(rng, scale=3.0)
        pj, sj, mj = JO.adamw_update(pj, jax.tree.map(jnp.asarray, g), sj, jc)
        pt, st, mt = TO.adamw_update(pt, params_from_numpy(g, device="cpu"),
                                     st, tc)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=1e-6)
    assert int(st.step) == int(sj.step) == 3
    for tree_j, tree_t in ((pj, pt), (sj.m, st.m), (sj.v, st.v)):
        for a, c in zip(jax.tree.leaves(tree_j), tree_leaves(tree_t)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)


def test_adamw_bf16_moments_and_params_match_reference():
    """Moments kept in bf16 (the reference's choice above 100 B params) and
    bf16 params: equal to the reference within one bf16 ulp."""
    rng = np.random.default_rng(2)
    jc = JO.AdamWConfig(lr=1e-2, warmup_steps=0, moment_dtype="bfloat16")
    tc = TO.AdamWConfig(lr=1e-2, warmup_steps=0, moment_dtype="bfloat16")
    p0 = _opt_tree(rng)
    pj = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p0)
    pt = params_from_numpy(pj, device="cpu")
    sj, st = JO.adamw_init(pj, jc), TO.adamw_init(pt, tc)
    for _ in range(2):
        g = _opt_tree(rng)
        pj, sj, _ = JO.adamw_update(pj, jax.tree.map(jnp.asarray, g), sj, jc)
        pt, st, _ = TO.adamw_update(pt, params_from_numpy(g, device="cpu"),
                                    st, tc)
    for tree_j, tree_t in ((pj, pt), (sj.m, st.m), (sj.v, st.v)):
        for a, c in zip(jax.tree.leaves(tree_j), tree_leaves(tree_t)):
            assert c.dtype == torch.bfloat16
            np.testing.assert_allclose(_numpy(c), np.asarray(a, np.float32),
                                       rtol=2 ** -7, atol=1e-6)


def test_lr_schedule_and_clip_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    steps = np.arange(0, 60, dtype=np.int32)
    lj = JO.lr_schedule(JO.AdamWConfig(**cfg), jnp.asarray(steps))
    lt = TO.lr_schedule(TO.AdamWConfig(**cfg), torch.from_numpy(steps))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6)
    g = _opt_tree(np.random.default_rng(3), scale=50.0)
    nj = JO.global_norm(jax.tree.map(jnp.asarray, g))
    nt = TO.global_norm(params_from_numpy(g, device="cpu"))
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    p = {"w": np.ones(4, np.float32)}
    gg = {"w": np.full(4, 100.0, np.float32)}
    cfg = TO.AdamWConfig(grad_clip=1.0, warmup_steps=0)
    pt = params_from_numpy(p, device="cpu")
    _, _, m = TO.adamw_update(pt, params_from_numpy(gg, device="cpu"),
                              TO.adamw_init(pt, cfg), cfg)
    assert abs(float(m["grad_norm"]) - 200.0) < 1e-3


def test_cross_entropy_with_padding_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, 5:] = -1
    labels[2, :3] = -1
    cj, zj = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    ct, zt = TT.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-6)
    np.testing.assert_allclose(float(zt), float(zj), rtol=1e-6)
    # all padding: the mean divides by one, not zero
    pad = torch.full((3, 7), -1, dtype=torch.int32)
    assert float(TT.cross_entropy(torch.from_numpy(logits), pad)[0]) == 0.0


def test_train_step_matches_reference():
    """One train step from the same params, then a second from the
    reference's state carried over (``state_from_numpy``): params within
    5e-5, loss within 2e-5 relative; metrics keys as the reference's.
    AdamW's eps is 1e-6 here: Adam's first step moves a parameter by
    lr * g / (|g| + eps), so at the default 1e-8 a gradient of a few
    1e-9, below the fp32 noise of two summation orders (one such element
    of ``w_down`` is 3.9e-9 in the reference and of the other sign in the
    port), becomes a step of up to lr of either sign in either package."""
    jc, tc, pj, pt = _setup("qwen2.5-3b", num_layers=2)
    adam = dict(lr=1e-3, warmup_steps=0, eps=1e-6)
    jt = JT.TrainConfig(adamw=JO.AdamWConfig(**adam))
    ttc = TT.TrainConfig(adamw=TO.AdamWConfig(**adam))
    step_j = jax.jit(JT.make_train_step(jc, jt))
    step_t = TT.make_train_step(tc, ttc)
    oj = JO.adamw_init(pj, jt.adamw)
    ot = TO.adamw_init(pt, ttc.adamw)
    b0, b1 = (_batch(tc, seq=32, b=4, index=i) for i in (0, 1))
    pj1, oj1, mj = step_j(pj, oj, _jb(b0))
    pt, ot, mt = step_t(pt, ot, _tb(b0))
    assert set(mt) == set(mj)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=2e-5)
    worst = max(float(np.abs(c.numpy() - np.asarray(a)).max())
                for a, c in zip(jax.tree.leaves(pj1), tree_leaves(pt)))
    print(f"one train step: params within {worst:.2e} of the reference's")
    assert worst <= 5e-5
    # the second step starts from the reference's params and state
    pt2 = params_from_numpy(pj1, device="cpu")
    ot2 = TO.state_from_numpy(oj1, pt2)
    assert int(ot2.step) == 1
    pj2, _, mj2 = step_j(pj1, oj1, _jb(b1))
    pt2, ot2, mt2 = step_t(pt2, ot2, _tb(b1))
    np.testing.assert_allclose(float(mt2["loss"]), float(mj2["loss"]),
                               rtol=2e-5)
    assert max(float(np.abs(c.numpy() - np.asarray(a)).max())
               for a, c in zip(jax.tree.leaves(pj2), tree_leaves(pt2))) <= 5e-5
    assert int(ot2.step) == 2


def test_microbatch_equivalence():
    """num_microbatches=2 makes (nearly) the same update as m=1, as the
    reference's test holds m=4 (internlm2's smoke config)."""
    _, tc, _, pt = _setup("internlm2-1.8b")
    batch = _tb(_batch(tc, seq=32, b=8))
    outs = {}
    for m in (1, 2):
        c = dataclasses.replace(tc, num_microbatches=m)
        ttc = TT.TrainConfig(adamw=TO.AdamWConfig(lr=1e-3, warmup_steps=0))
        p = map_tree(torch.clone, pt)        # the step updates in place
        p2, _, metrics = TT.make_train_step(c, ttc)(
            p, TO.adamw_init(p, ttc.adamw), batch)
        outs[m] = (p2, float(metrics["loss"]))
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(outs[1][0]), tree_leaves(outs[2][0])))
    assert d < 5e-5, d
    assert abs(outs[1][1] - outs[2][1]) < 5e-4


def test_loss_decreases_on_learnable_data():
    """The port's own smoke training, the reference test's recipe: 30
    steps of qwen2.5-3b's smoke config at 2 layers, lr 1e-2 with 2 warmup
    steps, on the learnable synthetic stream."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2)
    from repro_torch.models.params import init_params
    params = init_params(TM.param_specs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    tcfg = TT.TrainConfig(adamw=TO.AdamWConfig(lr=1e-2, warmup_steps=2,
                                               total_steps=30))
    step = TT.make_train_step(cfg, tcfg)
    opt = TO.adamw_init(params, tcfg.adamw)
    ds = SyntheticLMDataset(cfg, seq_len=64, global_batch=8, seed=1)
    losses = []
    for i in range(30):
        params, opt, metrics = step(params, opt, _tb(ds.batch(i)))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_train_input_specs_match_reference():
    for arch in ("qwen2.5-3b", "musicgen-large", "llama-3.2-vision-90b"):
        js = JT.train_input_specs(jax_smoke(arch), 4, 32)
        ts = TT.train_input_specs(get_smoke_config(arch), 4, 32)
        assert set(js) == set(ts)
        for k, (shape, dtype) in ts.items():
            assert tuple(js[k].shape) == shape
            assert str(js[k].dtype) == str(dtype).removeprefix("torch.")
