"""Parameter specification machinery and the weight bridge.

Models declare parameters as nested dicts of ``Spec(shape, logical_axes,
init)``, as the reference package does; ``init_params`` materializes a spec
tree into tensors from an explicit ``torch.Generator``.  The logical axes
are kept so spec trees compare with the reference ones, but nothing shards
on them: the port runs on one device.

``params_from_numpy`` is the bridge from the reference package: it takes a
nested-dict tree whose leaves ``np.asarray`` accepts (the reference's
param or cache pytree) and returns the same key paths as torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict, keeping the keys."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """Leaves of a nested dict in sorted key order (the order
    ``jax.tree.leaves`` gives the reference's trees)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


# elements drawn in fp32 at a time: a larger leaf (an MoE config's stacked
# expert weights hold billions) is drawn in chunks of this many, so the
# fp32 draw never takes more than 4 GiB beside the leaf itself
INIT_CHUNK = 1 << 30


def _init_one(spec: Spec, generator: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    # same std rule as the reference: the leading dim is the fan-in
    fan_in = spec.shape[0] if spec.shape else 1
    std = spec.scale / np.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - start)
        x = torch.randn(n, generator=generator, dtype=torch.float32,
                        device=device)
        flat[start:start + n] = x.mul_(std)
    return out


def init_params(specs, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Materialize a spec tree into tensors on ``device`` (None: CUDA, and
    an error if there is none).  The generator must live on that device;
    its numbers differ from the reference's
    ``jax.random`` ones, so parity tests convert reference params through
    ``params_from_numpy`` instead."""
    device = resolve_device(device)
    return map_tree(lambda s: _init_one(s, generator, dtype, device), specs)


def stack_group(spec: Spec, num_groups: int) -> Spec:
    """Prepend the stacked layer-group dimension."""
    return Spec((num_groups,) + spec.shape, ("layers",) + spec.axes,
                spec.init, spec.scale)


def stack_specs(tree, num_groups: int):
    return map_tree(lambda s: stack_group(s, num_groups), tree)


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype name (``"float32"``, ``"bfloat16"``, ...) as a
    ``torch.dtype``."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype name: {name!r}")
    return dtype


def _leaf_to_torch(leaf, device, dtype):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: move the raw bits
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device=None, dtype=None):
    """The reference package's param (or cache) pytree as torch tensors on
    ``device`` (None: CUDA, and an error if there is none).

    Every leaf goes through ``np.asarray``, so no JAX import is needed;
    key paths are kept, bf16 leaves keep their bits, and ``dtype`` (None
    keeps each leaf's own) casts after the copy."""
    device = resolve_device(device)
    return map_tree(lambda leaf: _leaf_to_torch(leaf, device, dtype), tree)
