"""Wrappers for the row-gather kernel (``csrc/gather_rows.cu``):
``gather_rows`` and ``fused_compact``.

``fused_compact`` is the device-resident twin of ``Engine.compact``: it
derives the keep indices on the device from the per-slot ``produced`` /
``targets`` counters and gathers every cache leaf plus ``kv_lens``, the
last tokens and (if any) the per-slot keys through the kernel.  Nothing is
read back to the host, so a compaction adds zero host syncs.  With
``out_cache`` the cache leaves are gathered straight into a cache the
caller owns (the engine's persistent cache of the smaller bucket, whose
addresses its CUDA graphs hold).

CUDA tensors launch the kernel; CPU tensors run the plain version in
``ref.py``.  The wrapper checks what the kernel takes and raises on the
rest; it never falls back from one to the other."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels as K
from repro_torch.kernels.compaction.ref import gather_rows_reference
from repro_torch.models.params import map_tree, tree_leaves

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _launch(src, idx, out=None):
    if src.ndim < 2:
        raise ValueError(f"src must be [G, B, ...], got {tuple(src.shape)}")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"idx must be int32 [NB], got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if not src.is_contiguous() or not idx.is_contiguous():
        raise ValueError("src and idx must be contiguous")
    g, b, nb = src.shape[0], src.shape[1], idx.shape[0]
    if not (0 < g <= 65535 and b > 0 and 0 < nb <= 65535):
        raise ValueError(f"kernel takes 0 < G, NB <= 65535 and B > 0, got "
                         f"G={g}, B={b}, NB={nb}")
    shape = (g, nb) + tuple(src.shape[2:])
    if out is None:
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    elif out.shape != shape or out.dtype != src.dtype \
            or out.device != src.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {src.dtype} {shape} on "
                         f"{src.device}, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    row_bytes = src[0, 0].numel() * src.element_size()
    if row_bytes == 0:
        return out
    width = next(w for w in (16, 8, 4, 2, 1)
                 if (src.data_ptr() | out.data_ptr() | row_bytes) % w == 0)
    fn = K.library("gather_rows").gather_rows
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    status = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), g, b, nb,
                row_bytes, width, K.stream_ptr(src))
    K.check_status("gather_rows", status)
    K.LAUNCHES["gather_rows"] += 1
    return out


def gather_rows(src, idx, out=None):
    """Row gather: src [G, B, ...] -> [G, NB, ...] at batch rows ``idx``
    [NB] (int32, may repeat); bit-equal to ``src[:, idx]`` for any
    dtype.  ``out``, if given, receives the rows and is returned."""
    if K.on_cuda(src, idx):
        return _launch(src, idx.to(torch.int32), out)
    return gather_rows_reference(src, idx, out)


def keep_indices(produced, targets, nb: int):
    """The first ``nb`` slots with ``produced < targets``, in slot order,
    padded with slot 0: ``nonzero(live, size=nb, fill_value=0)`` built from
    a prefix sum and a scatter, so no host read is needed."""
    live = (targets - produced) > 0
    rank = torch.cumsum(live.to(torch.int32), 0) - 1
    dest = torch.where(live & (rank < nb), rank, nb).long()
    keep = torch.zeros(nb + 1, dtype=torch.int32, device=live.device)
    slots = torch.arange(live.shape[0], dtype=torch.int32, device=live.device)
    # every live slot below nb lands on its own entry; the rest on entry nb,
    # which is dropped
    keep.scatter_(0, dest, slots)
    return keep[:nb]


def fused_compact(cache, kv_lens, tokens, slot_keys, produced, targets, *,
                  nb: int, out_cache=None):
    """Compact the live slots of a decode bucket into bucket size ``nb``.

    A slot is live iff it still owes tokens (``produced < targets``;
    padding slots carry 0/0).  Returns ``(cache, kv_lens, tokens,
    slot_keys, keep)`` with every array gathered at the first ``nb`` live
    slots in slot order; entries past the live count repeat slot 0, as
    ``Engine.compact`` pads them.  ``slot_keys`` may be None.
    ``out_cache``, a cache tree of bucket ``nb`` with the same keys,
    receives the gathered leaves in place and is returned as the cache;
    without it, one is allocated."""
    keep = keep_indices(produced, targets, nb)
    if out_cache is None:
        out_cache = map_tree(lambda leaf: leaf.new_empty(
            (leaf.shape[0], nb) + tuple(leaf.shape[2:]))
            if leaf.ndim >= 2 else leaf, cache)
    for src, dst in zip(tree_leaves(cache), tree_leaves(out_cache)):
        if src.ndim >= 2:
            gather_rows(src, keep, out=dst)
        else:                       # no batch axis: passes through
            dst.copy_(src)
    cache = out_cache
    kv_lens = gather_rows(kv_lens.reshape(1, -1, 1), keep).reshape(nb)
    tokens = gather_rows(tokens.reshape(1, -1, 1), keep).reshape(nb)
    if slot_keys is not None:
        slot_keys = gather_rows(slot_keys.reshape(1, -1, 2), keep).reshape(nb, 2)
    return cache, kv_lens, tokens, slot_keys, keep
