"""AdamW with the reference's numerics, the counterpart of
``repro.training.optimizer``.

The update is the reference's step for step (clip by the global norm,
bias-corrected moments, decoupled weight decay on leaves of ``ndim >= 2``,
linear warmup then cosine decay), with every scalar (the step, the
learning rate, the clip scale) a 0-d tensor on the parameters' device, so
a step never waits on the host.  JAX returns new arrays; here the
parameters and the moments are updated in place, leaf by leaf and in
chunks of ``CHUNK`` elements, so that the update's temporaries stay a few
chunks in size: at qwen2.5-3b's full width a leaf holds up to 811 M
elements, and a fp32 temporary of the whole leaf would take 3.2 GB.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import torch_dtype
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# elements updated at a time within one leaf (64 MiB of fp32)
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: Any        # 0-d int32 tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    # linear warmup then cosine decay
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor), as an fp32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and step
    0 on the first parameter's device."""
    dt = torch_dtype(cfg.moment_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device),
                   params))


def _chunks(t):
    flat = t.reshape(-1)
    return flat.split(CHUNK) if flat.numel() else ()


@torch.no_grad()
def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (each
    leaf summed in chunks of ``CHUNK``), an fp32 tensor."""
    sums = []
    for x in tree_leaves(tree):
        part = [c.float().square().sum() for c in _chunks(x)]
        sums.append(torch.stack(part).sum() if part else
                    torch.zeros((), device=x.device))
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 decay_mask=None):
    """One AdamW step.  Returns (params, new_state, metrics); ``params``
    and the moments are the same tensors, updated in place (see the module
    docstring), and the new state holds step + 1.  ``decay_mask``: a tree
    of bools (False: no weight decay, as for norms and biases); default
    decays leaves of ``ndim >= 2``.  metrics: ``grad_norm`` (before the
    clip) and ``lr``, 0-d tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    flat_p = tree_leaves(params)
    if decay_mask is None:
        flat_d = [p.ndim >= 2 for p in flat_p]
    else:
        flat_d = tree_leaves(decay_mask)
    for p, g, m, v, dm in zip(flat_p, tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v),
                              flat_d):
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adamw_update updates contiguous leaves in "
                             "place")
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g), _chunks(m),
                                  _chunks(v)):
            # the reference's step with fewer passes over memory: fp32
            # moments and params are updated in place, others through an
            # fp32 copy rounded back once
            g32 = gc.float() * scale
            m32, v32 = mc.float(), vc.float()
            m32.mul_(b1).add_(g32, alpha=1 - b1)
            v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            delta = (m32 / c1).div_(torch.sqrt(v32 / c2).add_(cfg.eps))
            if dm:
                delta.add_(pc.float(), alpha=cfg.weight_decay)
            if pc.dtype == torch.float32:
                pc.sub_(delta.mul_(lr))
            else:
                pc.copy_(pc.float() - delta.mul_(lr))
            if m32 is not mc:
                mc.copy_(m32)
            if v32 is not vc:
                vc.copy_(v32)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def state_from_numpy(state, like_params, device=None):
    """The reference's ``AdamWState`` (leaves that ``np.asarray`` takes)
    as the port's, on ``device`` (None: each moment beside its parameter
    in ``like_params``), so that a train step can start from the same
    state in both packages.  bf16 moments keep their bits."""
    from repro_torch.models.params import _leaf_to_torch
    m = tree_leaves(state.m)
    v = tree_leaves(state.v)
    ps = tree_leaves(like_params)
    dev = lambda i: device if device is not None else ps[i].device  # noqa: E731
    step_dev = device if device is not None else (
        ps[0].device if ps else torch.device("cpu"))
    return AdamWState(
        step=_leaf_to_torch(state.step, step_dev, torch.int32),
        m=tree_unflatten(like_params, [_leaf_to_torch(x, dev(i), None)
                                       for i, x in enumerate(m)]),
        v=tree_unflatten(like_params, [_leaf_to_torch(x, dev(i), None)
                                       for i, x in enumerate(v)]))
