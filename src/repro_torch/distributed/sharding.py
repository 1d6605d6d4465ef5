"""Logical-axis sharding rules, the counterpart of
``repro.distributed.sharding``: the rule tables, their resolver and the 1-D
``"cells"`` mesh that :mod:`repro_torch.core.shardsweep` spreads sweep lanes
over.

Every parameter and activation dimension of the model zoo carries a
*logical* axis name (``models.params.Spec``).  A rule table maps logical
names onto mesh axes; resolution checks divisibility against the actual
dimension size and falls back to replication when a dimension cannot shard
(e.g. 4 KV heads on a 16-way model axis).  Rules may map one logical name
onto a *tuple* of mesh axes (``batch -> ("pod", "data")``); axes missing
from the mesh are dropped, so one table serves the single-pod (data, model)
and the multi-pod (pod, data, model) meshes unchanged.

A mesh here is anything with ``axis_names`` and a ``shape`` mapping from
axis name to size: :class:`CellsMesh`, or a plain namespace that describes
a device mesh without devices.  :func:`logical_to_spec` returns the entries
of the reference's ``PartitionSpec`` as a plain tuple: ``None``, an axis
name, or a tuple of axis names per dimension, trailing ``None``s trimmed.

The device placements that consume these specs (``ShardCtx``, ``NULL_CTX``
and ``make_named_sharding`` in the reference) wait for the port's sharded
training and serving (ROADMAP.md M10b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

# Logical axis vocabulary used by the model zoo:
#   batch     request/example dim                      -> DP (pod, data)
#   seq       sequence dim of activations              -> unsharded by default
#   kv_seq    KV-cache sequence dim (decode)           -> model (flash-decoding)
#   embed     d_model dim                              -> unsharded (or data for FSDP)
#   ffn       FFN hidden dim                           -> TP (model)
#   heads     query heads                              -> TP (model)
#   kv_heads  KV heads                                 -> TP (model; replicates if < axis)
#   head_dim  per-head dim                             -> unsharded
#   vocab     vocabulary dim                           -> TP (model)
#   experts   MoE expert dim                           -> EP (model)
#   conv_dim / ssm_state / ssm_heads / ssm_inner       Mamba dims
#   layers    stacked layer-group dim                  -> never sharded

AxisRules = dict


DEFAULT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",
    "embed": None,
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "expert_ffn": None,
    "moe_cap": "data",        # MoE dispatch-buffer capacity dim (token-like)
    "moe_groups": ("pod", "data"),   # GShard dispatch-group dim
    "conv_dim": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "vis_seq": None,
    "layers": None,
}

# FSDP variant for >=70B configs: weights additionally sharded over `data`
# on the embed dim.
FSDP_RULES: AxisRules = dict(
    DEFAULT_RULES,
    embed="data",
)

# Sequence-parallel variant used for very long prefill: activations shard
# their seq dim over `model` between attention blocks.
SEQPAR_RULES: AxisRules = dict(DEFAULT_RULES, seq="model")

# Sweep-cell sharding (repro_torch.core.shardsweep): the stacked (λ, policy,
# σ, replica) lanes of a grid sweep partition over a 1-D "cells" mesh; every
# other sweep input (latency constants, batch caps' scalars) replicates.
SWEEP_RULES: AxisRules = {"lanes": "cells"}


@dataclasses.dataclass(frozen=True)
class CellsMesh:
    """A 1-D mesh of devices along the axis ``"cells"``.  One device may
    appear more than once: its shards then run on it one after another."""

    devices: Tuple[torch.device, ...]
    axis_names = ("cells",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {"cells": self.size}


def cells_mesh(devices=None) -> CellsMesh:
    """The 1-D mesh for grid-cell data parallelism.  With no argument, every
    visible CUDA device (an error without one, as ``kernels.resolve_device``
    raises); else the devices given, all CUDA or all CPU (``["cpu"] * 4``
    is a 4-way mesh on the host, for the CPU tests)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass devices=['cpu', "
                               "...] to run the plain PyTorch paths on the "
                               "CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a cells mesh needs at least one device")
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"a cells mesh takes all CUDA or all CPU devices, "
                         f"got {[str(d) for d in devs]}")
    if kinds == {"cuda"}:
        devs = [d if d.index is not None
                else torch.device("cuda", torch.cuda.current_device())
                for d in devs]
    return CellsMesh(tuple(devs))


def _resolve(logical: Optional[str], rules: AxisRules, mesh,
             dim_size: Optional[int]):
    if logical is None:
        return None
    target = rules.get(logical, None)
    if target is None:
        return None
    axes = target if isinstance(target, tuple) else (target,)
    # drop axes not present in this mesh (e.g. "pod" on the single-pod mesh)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None
    if dim_size is not None:
        total = 1
        for a in axes:
            total *= mesh.shape[a]
        if dim_size % total != 0:
            return None  # cannot shard evenly -> replicate
    return axes if len(axes) > 1 else axes[0]


def logical_to_spec(logical_axes, rules: AxisRules, mesh,
                    shape=None) -> tuple:
    """Map a tuple of logical axis names to the entries of a partition
    spec.  No mesh axis is used twice (first occurrence wins)."""
    used = set()
    entries = []
    for i, name in enumerate(logical_axes):
        dim = None if shape is None else shape[i]
        r = _resolve(name, rules, mesh, dim)
        if r is None:
            entries.append(None)
            continue
        axes = r if isinstance(r, tuple) else (r,)
        if any(a in used for a in axes):
            entries.append(None)
            continue
        used.update(axes)
        entries.append(r)
    # trim trailing Nones for cleanliness
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)
