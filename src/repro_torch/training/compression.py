"""Gradient compression for a data-parallel reduction: int8 symmetric
quantisation with per-block scales and error feedback, the counterpart of
``repro.training.compression`` (the same blocks, scales and rounding:
round half to even, as ``jnp.round``).

Gradients are quantised before the reduction, dequantised after, and the
quantisation residual is carried into the next step (error feedback keeps
the sum of the dequantised gradients within one quantisation step of the
true sum).  The port runs on one device, so nothing reduces across
devices yet (ROADMAP.md M10b); these are the tree functions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten

BLOCK = 2048


def _pad_to_block(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8.  Returns (q [N, BLOCK] int8, scale [N]
    fp32)."""
    blocks, _ = _pad_to_block(x.float())
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, shape, dtype=torch.float32):
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def compress_tree(grads, errors=None):
    """Quantise every leaf (adding the carried error feedback first).

    Returns (qs, scales, new_errors): three trees congruent with grads."""
    flat_g = tree_leaves(grads)
    if errors is None:
        flat_e = [torch.zeros_like(g, dtype=torch.float32) for g in flat_g]
    else:
        flat_e = tree_leaves(errors)
    qs, scales, errs = [], [], []
    for g, e in zip(flat_g, flat_e):
        g32 = g.float() + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s, g.shape)
        qs.append(q)
        scales.append(s)
        errs.append(g32 - deq)
    return (tree_unflatten(grads, qs), tree_unflatten(grads, scales),
            tree_unflatten(grads, errs))


def decompress_tree(qs, scales, shapes_like):
    out = [dequantize_int8(q, s, r.shape, torch.float32)
           for q, s, r in zip(tree_leaves(qs), tree_leaves(scales),
                              tree_leaves(shapes_like))]
    return tree_unflatten(shapes_like, out)
