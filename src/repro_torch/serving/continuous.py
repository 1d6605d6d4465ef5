"""Continuous (iteration-level) batching on the engine, the PyTorch
counterpart of ``repro.serving.continuous``.

A fixed pool of decode slots runs decode iterations; whenever a slot
finishes its request, the next queued request is prefilled in a size-1
bucket and its cache is SPLICED into the pool cache at that slot.  Short
requests neither wait for batch formation nor pay padding decode.

Decode runs through the engine's ``decode_chunk`` (one host sync per chunk;
on CUDA a graph replay per chunk once its key is captured).  Admission
happens at chunk boundaries; to keep the refill-immediately semantics, a
chunk is cut short at the earliest remaining completion among active slots
whenever requests are still queued, and runs full ``chunk`` steps once the
queue is empty.  Step counts are quantized to powers of two, so at most
log2(chunk) + 1 graphs exist per pool size.  Per-request completion times
are interpolated inside a chunk from the per-step active mask.  Decoding
is greedy, as in the reference.

The pool is the engine's own cache of bucket ``slots``, updated in place;
each admission prefills into a staging cache of its own, so the pool is
never the prefill's cache, not even at ``slots == 1``.  The splice finds
each leaf's batch and kv-seq dims from the cache spec's logical axes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_specs, init_cache
from repro_torch.models.params import torch_dtype, tree_leaves


def splice_cache(cfg: ModelConfig, pool, single, slot: int,
                 pool_batch: int, pool_seq: int):
    """Write request cache ``single`` (batch bucket 1) into ``pool`` at
    batch index ``slot``, in place; every other slot is left as it was.
    Returns ``pool``."""
    specs = cache_specs(cfg, pool_batch, pool_seq)
    for spec, big, small in zip(tree_leaves(specs), tree_leaves(pool),
                                tree_leaves(single)):
        axes = spec.axes
        b_dim = axes.index("batch")
        idx = [slice(None)] * big.ndim
        idx[b_dim] = slot
        src = small.select(b_dim, 0)
        # align any seq-bearing dim to the small bucket
        for d, name in enumerate(axes):
            if name in ("kv_seq", "vis_seq"):
                dd = d if d < b_dim else d - 1   # src lost the batch dim
                span = small.shape[d]
                idx[d] = slice(0, span)
                src = src.narrow(dd, 0, span)
        big[tuple(idx)] = src.to(big.dtype)
    return pool


@dataclasses.dataclass
class ContinuousResult:
    produced: np.ndarray
    ttft: np.ndarray            # arrival-agnostic: seconds from serve start
    completion: np.ndarray      # seconds from serve start
    decode_steps: int
    wall_seconds: float
    host_syncs: int = 0


@torch.no_grad()
def serve_continuous(engine, prompts: List[np.ndarray],
                     target_tokens: List[int], *, slots: int = 4,
                     n_max: Optional[int] = None,
                     chunk: Optional[int] = None) -> ContinuousResult:
    """Run all requests through a ``slots``-wide continuous-batching pool.
    Needs per-slot cache updates (``decode_cache_update`` "scatter" or
    "onehot")."""
    cfg = engine.cfg
    if cfg.decode_cache_update not in ("scatter", "onehot"):
        raise ValueError("continuous batching needs per-slot (ragged) cache "
                         "updates: decode_cache_update 'scatter' or 'onehot'")
    chunk = int(chunk if chunk is not None else engine.ecfg.decode_chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n = len(prompts)
    targets = np.asarray(target_tokens)
    if n_max is not None:
        targets = np.minimum(targets, n_max)

    pool_seq = engine.ecfg.max_seq
    pool = engine.new_cache(slots)
    stage = init_cache(cfg, 1, pool_seq, torch_dtype(engine.ecfg.cache_dtype),
                       engine.device)
    kv_lens = np.zeros(slots, np.int64)
    tok = torch.zeros((slots,), dtype=torch.int32, device=engine.device)
    slot_req = np.full(slots, -1)
    produced = np.zeros(n, np.int64)
    ttft = np.full(n, np.nan)
    completion = np.full(n, np.nan)

    t0 = time.perf_counter()
    syncs0 = engine.host_syncs
    queue = list(range(n))
    steps_total = 0

    def admit(slot):
        rid = queue.pop(0)
        for leaf in tree_leaves(stage):
            leaf.zero_()
        _, _, last1, _, _ = engine.prefill_batch([prompts[rid]], cache=stage)
        splice_cache(cfg, pool, stage, slot, slots, pool_seq)
        kv_lens[slot] = engine._prompt_lens([prompts[rid]])[0]
        tok[slot] = last1[0].argmax()           # on the device: no host read
        slot_req[slot] = rid
        produced[rid] = 1
        ttft[rid] = time.perf_counter() - t0
        if targets[rid] <= 1:
            completion[rid] = ttft[rid]
            slot_req[slot] = -1

    while queue or (slot_req >= 0).any():
        for s in range(slots):
            if slot_req[s] < 0 and queue:
                admit(s)
        active = slot_req >= 0
        if not active.any():
            continue
        rem = targets[slot_req[active]] - produced[slot_req[active]]
        # queued work pending: stop the chunk at the earliest completion so
        # the freed slot refills without idle decode; empty queue: full chunk
        steps = int(min(chunk, rem.min() if queue else rem.max()))
        steps = max(steps, 1)
        if steps < chunk:
            steps = 1 << (steps.bit_length() - 1)
        slot_prod = np.zeros(slots, np.int32)
        slot_targ = np.zeros(slots, np.int32)
        slot_prod[active] = produced[slot_req[active]]
        slot_targ[active] = targets[slot_req[active]]
        (pool, tok, _, _, _, _, actives, kv_host, dt) = engine.decode_chunk(
            pool, engine._upload(kv_lens.astype(np.int32)), tok,
            engine._upload(slot_prod), engine._upload(slot_targ), steps)
        steps_total += steps
        kv_lens = kv_host.astype(np.int64)
        now = time.perf_counter() - t0
        for s in np.where(active)[0]:
            rid = slot_req[s]
            # the device counter: the uploaded one plus the active steps
            produced[rid] = slot_prod[s] + actives[:, s].sum()
            if produced[rid] >= targets[rid]:
                hit = np.nonzero(actives[:, s])[0]
                fin = int(hit[-1]) if hit.size else 0
                completion[rid] = now - dt + dt * (fin + 1) / steps
                slot_req[s] = -1

    return ContinuousResult(
        produced=produced, ttft=ttft, completion=completion,
        decode_steps=steps_total, wall_seconds=time.perf_counter() - t0,
        host_syncs=engine.host_syncs - syncs0)
