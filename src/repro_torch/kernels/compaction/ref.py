"""Plain PyTorch versions for compaction: the row gather as indexing, and
the host-driven gathers of ``Engine.compact``.  The wrapper runs
``gather_rows_reference`` for CPU tensors; the tests and ``chip_smoke.py``
hold the kernel against it bit for bit."""

from __future__ import annotations

import torch

from repro_torch.models.params import map_tree


def gather_rows_reference(src, idx, out=None):
    """src [G, B, ...] -> [G, NB, ...] at batch rows ``idx`` [NB], into
    ``out`` if it is given."""
    return torch.index_select(src, 1, idx.long(), out=out)


def compact_reference(cache, kv_lens, tokens, gidx, slot_keys=None):
    """Gather batch axis 1 of every cache leaf (and axis 0 of the per-slot
    vectors) at the padded keep indices ``gidx`` [NB]."""
    gidx = gidx.long()
    cache = map_tree(
        lambda leaf: leaf[:, gidx] if leaf.ndim >= 2 else leaf, cache)
    keys = None if slot_keys is None else slot_keys[gidx]
    return cache, kv_lens[gidx], tokens[gidx], keys
