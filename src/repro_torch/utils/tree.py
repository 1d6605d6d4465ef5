"""Tree utilities over the port's parameter and optimizer trees, the
counterparts of ``repro.utils.tree``.

A tree is a nested dict (keys visited in sorted order, as
``jax.tree.leaves`` visits a dict), tuple, list or NamedTuple (fields in
order); ``None`` is an empty subtree; anything else is a leaf.  Leaf paths
join the keys, indices and field names with ``/``, as the reference
formats JAX's key paths.
"""

from __future__ import annotations

import numpy as np
import torch


def _children(tree):
    """[(name, child)] of a node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    if tree is None:
        return []
    return None


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*children)
    if isinstance(tree, (tuple, list)):
        return type(tree)(children)
    return None


def tree_leaves_with_path(tree, prefix: str = ""):
    """[(path, leaf)] in the reference's leaf order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += tree_leaves_with_path(
            child, f"{prefix}/{name}" if prefix else name)
    return out


def tree_leaves(tree):
    """The leaves in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in tree_leaves(child)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure)."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*ls) for ls in zip(leaves, *others)])


def tree_map_with_path(fn, tree, *rest):
    """``tree_map`` with the leaf's '/'-joined path as the first
    argument."""
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(p, *ls) for p, *ls in
                                 zip(paths, tree_leaves(tree), *others)])


def _numel(leaf) -> int:
    return int(np.prod(leaf.shape)) if leaf.shape else 1


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def tree_size_bytes(tree) -> int:
    """Total bytes of all leaves (tensors, arrays, or anything with a
    ``shape`` and a ``dtype``)."""
    return sum(_numel(leaf) * _itemsize(leaf.dtype)
               for leaf in tree_leaves(tree))


def tree_num_params(tree) -> int:
    """Total number of scalar elements across all leaves."""
    return sum(_numel(leaf) for leaf in tree_leaves(tree))


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(x)


def tree_allclose(a, b, *, rtol=1e-5, atol=1e-6) -> bool:
    return all(np.allclose(_to_numpy(x), _to_numpy(y), rtol=rtol, atol=atol)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_cast(tree, dtype):
    """Every tensor leaf cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    else x, tree)
