"""Batched serving engine, the PyTorch counterpart of
``repro.serving.engine``.

The engine keeps the reference's static-bucket structure: a batch runs in
the smallest power-of-two batch bucket that holds it, prompts are padded to
a multiple of ``prompt_bucket``, and elastic batching gets its speedup from
bucket compaction: once at most half the slots are live, the live requests
are gathered into the next smaller bucket and decoding continues there.

Host-sync accounting
--------------------
Decoding is driven by ``decode_chunk``: ``steps`` decode iterations with no
host read inside.  Per-step tokens and active masks are written into
preallocated ``[steps, B]`` device tensors and read back once at the end of
the chunk, together with the sampling fallbacks and the new ``kv_lens``, so
the host waits once per chunk instead of once per token.  Each such wait is
counted in ``Engine.host_syncs`` and logged in ``step_log``: one per
prefill, one per chunk, one per host-path compaction and zero per fused
compaction.  On CUDA the decode loop and the fused compaction run under
``torch.cuda.set_sync_debug_mode("error")``, so a hidden sync there raises
instead of passing unseen.

Compiled decode chunks
----------------------
The reference compiles each chunk into one executable per (batch bucket,
step count, temperature, top_k).  On CUDA the engine keeps one
``torch.cuda.CUDAGraph`` per such key instead.  The first call of a key
runs the chunk eagerly on fresh static input buffers (the real result,
and the warm-up of cuBLAS on the capture stream), reads it back, then
captures the same loop into a graph; capture executes nothing.  Later
calls copy their inputs into the static buffers, replay the graph and read
back once.  A graph holds the addresses of its tensors, so the engine owns
one cache per batch bucket, allocated at first use and zeroed by
``new_cache``: prefill fills it, compaction gathers into the smaller
bucket's, and a chunk on CUDA refuses any other cache.  The wrappers'
launch counters (``kernels.LAUNCHES``) count real launches: what a capture
recorded is left out and added again on every replay.  On the CPU the
chunk runs the eager loop.

Sampling
--------
Temperature / top-k sampling draws Gumbel noise from a counter-based hash
keyed by (seed, request, step) in integer tensor ops, so the bits are the
same on CPU and CUDA and the draw needs no generator state inside a graph.
Each slot carries its key ``[stream, step]`` (``slot_keys`` [B, 2],
int64); compaction gathers the keys with the cache, so a request's stream
does not change with the chunk size or the bucket it sits in.  JAX's
threefry bits are not reproduced: the tests hold the reference's
invariants and the sampled distribution instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.kernels import resolve_device
from repro_torch.kernels.compaction import compact_reference, fused_compact
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    check_supported, decode_step, init_cache, param_specs, prefill)
from repro_torch.models.params import init_params, torch_dtype, tree_leaves


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 16            # largest batch bucket (power of 2)
    max_seq: int = 512             # KV capacity per slot
    prompt_bucket: int = 64        # prompts padded to a multiple of this
    cache_dtype: str = "float32"
    greedy: bool = True
    min_bucket: int = 1
    decode_chunk: int = 32         # decode steps fused per host sync
    temperature: float = 0.0       # 0 -> greedy argmax decoding
    top_k: Optional[int] = None    # sample from the k best logits only
    # elastic bucket compaction implementation:
    #   fused - keep indices derived on the device, every leaf gathered by
    #           the row-gather kernel (repro_torch.kernels.compaction); zero
    #           host syncs
    #   host  - reference path: host-resident keep indices and plain
    #           indexing (one host-visible event per compaction)
    compact_impl: str = "fused"
    # KV-token budget for one engine: generate() refuses a batch whose
    # worst-case footprint (prompt + target tokens per member) exceeds it,
    # and tracks the realized occupancy from the live kv_lens at chunk
    # boundaries (Engine.kv_report).  None = unconstrained.
    kv_budget: Optional[int] = None


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _guard_logits(logits):
    """Per-slot non-finite guard: ``bad[b]`` is True when the slot's logits
    contain NaN/inf, ``safe`` replaces non-finite entries with -inf so
    argmax stays defined.  Finite logits pass through unchanged."""
    finite = torch.isfinite(logits)
    bad = ~finite.all(dim=-1)
    return torch.where(finite, logits, -torch.inf), bad


def _guarded_argmax(logits):
    """Greedy decode over guarded logits; returns (tokens int32, bad)."""
    safe, bad = _guard_logits(logits)
    return safe.argmax(dim=-1).to(torch.int32), bad


# ----------------------------------------------------------------------------
# Counter-based sampling noise (integer ops only: same bits on CPU and CUDA)
# ----------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for x in [0, 2**32) (int64 tensor or int) and
    a constant c < 2**32, in 16-bit halves so no int64 product overflows."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2**32) that mixes
    every input bit into every output bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _stream_base(seed: int, call: int) -> int:
    """The base key of the engine's ``call``-th sampled batch after a reset
    to ``seed`` (the reference's ``split`` of its engine key)."""
    return _fmix32(_fmix32(seed & _M32) ^ _mul32(call & _M32, _GOLDEN))


def slot_keys_for(base: int, b: int, device) -> torch.Tensor:
    """One key per slot, ``[stream, step]`` int64 [b, 2]: slot i's stream
    is the hash of (base, i) (the reference's ``fold_in(base, i)``), its
    step counter starts at 0."""
    ids = torch.arange(b, dtype=torch.int64, device=device)
    stream = _fmix32(_mul32(ids, _GOLDEN) ^ base)
    return torch.stack([stream, torch.zeros_like(stream)], dim=1)


def _split_slot_keys(keys):
    """Advance every slot's key one step: returns (carried, subkeys), the
    subkey being the key of the current step."""
    return torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1), keys


def sample_noise_bits(keys, vocab: int):
    """The 32-bit noise word of every (slot, token) for one step: int64
    [b, vocab] in [0, 2**32), a hash of (stream, step, token id)."""
    slot = _fmix32(keys[:, 1] ^ _fmix32(keys[:, 0]))
    ids = _mul32(torch.arange(vocab, dtype=torch.int64, device=keys.device),
                 _GOLDEN)
    return _fmix32(slot[:, None] ^ ids[None, :])


def _sample_tokens(keys, logits, temperature: float, top_k: Optional[int]):
    """Temperature / top-k sampling over [b, vocab] logits with one key
    per slot, by the Gumbel-max rule: argmax of logits / T + Gumbel noise
    from ``sample_noise_bits`` (24 bits to a uniform in (0, 1), exact in
    fp32).  ``top_k`` masks every logit below the k-th largest.  Slots
    with non-finite logits fall back to greedy over the guarded logits and
    are reported in ``bad``.  Returns (tokens int32, bad)."""
    safe, bad = _guard_logits(logits)
    greedy = safe.argmax(dim=-1).to(torch.int32)
    if top_k is not None:
        kth = torch.topk(safe, top_k, dim=-1).values[..., -1:]
        safe = torch.where(safe < kth, -torch.inf, safe)
    bits = sample_noise_bits(keys, logits.shape[-1])
    u = ((bits >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    gumbel = -torch.log(-torch.log(u))
    sampled = (safe.float() / temperature + gumbel).argmax(dim=-1)
    return torch.where(bad, greedy, sampled.to(torch.int32)), bad


@dataclasses.dataclass
class _ChunkGraph:
    """One captured decode chunk: the graph, its static inputs (tok,
    kv_lens, produced, targets, slot_keys), its outputs (tok, kv_lens,
    produced, slot_keys, packed readback) and the kernel launches one
    replay makes."""
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple
    outputs: tuple
    launches: Dict[str, int]


class Engine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params=None,
                 seed: int = 0, device=None):
        """``device=None`` runs on CUDA and raises if there is none; pass
        ``device="cpu"`` for the plain PyTorch paths.  ``params=None``
        initializes random weights from ``seed`` in ``cfg.dtype``; ``seed``
        also starts the sampling stream."""
        check_supported(cfg)
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(param_specs(cfg), gen,
                                 torch_dtype(cfg.dtype), self.device)
        self.params = params
        self.step_log: List[dict] = []    # (kind, batch, seq, seconds[, steps])
        self.host_syncs = 0               # device->host blocking round-trips
        self.sample_fallbacks = 0         # non-finite-logit greedy fallbacks
        self.kv_peak = 0                  # max live KV tokens observed
        self.sync_checked = 0             # blocks run under sync-error mode
        self._sample_stream = (seed, 0)   # (seed, sampled calls since)
        self._caches: Dict[int, dict] = {}          # batch bucket -> cache
        self._graphs: Dict[tuple, _ChunkGraph] = {}
        self._capture_stream = (torch.cuda.Stream(self.device)
                                if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    def _upload(self, arr: np.ndarray):
        """Host array -> device tensor without blocking the host (pinned
        staging on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _wait(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _no_sync(self):
        """On CUDA, any host sync inside the block raises."""
        if self.device.type != "cuda":
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        self.sync_checked += 1

    def _own_cache(self, batch_bucket: int):
        """The engine's cache for ``batch_bucket``, allocated (zeroed) at
        first use and reused after; its contents are whatever the last
        batch left."""
        cache = self._caches.get(batch_bucket)
        if cache is None:
            cache = init_cache(self.cfg, batch_bucket, self.ecfg.max_seq,
                               torch_dtype(self.ecfg.cache_dtype), self.device)
            self._caches[batch_bucket] = cache
        return cache

    def new_cache(self, batch_bucket: int):
        """The engine's own cache for ``batch_bucket``, zeroed: the same
        bits as ``init_cache``, at the same addresses every time (the
        decode graphs hold them).  A second call for the same bucket
        returns the same tensors, zeroed again."""
        fresh = batch_bucket not in self._caches
        cache = self._own_cache(batch_bucket)
        if not fresh:
            for leaf in tree_leaves(cache):
                leaf.zero_()
        return cache

    def _prompt_lens(self, prompts) -> np.ndarray:
        """The KV length each prompt leaves after prefill: its length cut
        at ``max_seq`` (its seq bucket holds at least that much), at
        least 1."""
        return np.clip([len(p) for p in prompts], 1,
                       self.ecfg.max_seq).astype(np.int32)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill_batch(self, prompts: List[np.ndarray], cache=None):
        """Pad to buckets, run prefill. Returns (cache, kv_lens, last_logits,
        batch_bucket, wall_seconds).  The prompts fill the engine's own
        cache of their bucket, zeroed first, unless ``cache`` names a
        zeroed cache of that bucket to fill instead."""
        b = _bucket(len(prompts), self.ecfg.min_bucket, self.ecfg.max_batch)
        max_p = max(len(p) for p in prompts)
        s = min(_bucket(max_p, self.ecfg.prompt_bucket, self.ecfg.max_seq),
                self.ecfg.max_seq)
        tokens = np.zeros((b, s), np.int32)
        lens = np.ones((b,), np.int32)
        lens[:len(prompts)] = self._prompt_lens(prompts)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p[:s]
        if cache is None:
            cache = self.new_cache(b)
        kv_lens = self._upload(lens)
        t0 = time.perf_counter()
        last, cache = prefill(self.cfg, self.params, self._upload(tokens),
                              cache=cache, prompt_lens=kv_lens)
        self._wait()
        dt = time.perf_counter() - t0
        self.host_syncs += 1
        self.step_log.append(
            {"kind": "prefill", "batch": b, "seq": s, "seconds": dt})
        return cache, kv_lens, last, b, dt

    @torch.no_grad()
    def decode_batch(self, cache, kv_lens, tokens):
        """One decode step for the whole bucket (one host sync). Returns
        (next_tokens, cache, wall_seconds).  Reference path for the fused
        ``decode_chunk``; ``kv_lens`` is not advanced."""
        b = int(tokens.shape[0])
        t0 = time.perf_counter()
        logits, cache = decode_step(self.cfg, self.params, cache, tokens,
                                    kv_lens)
        nxt, bad = _guarded_argmax(logits)
        nbad, seq = torch.stack([bad.sum(), kv_lens.max().long()]).tolist()
        dt = time.perf_counter() - t0
        self.host_syncs += 1
        self.step_log.append(
            {"kind": "decode", "batch": b, "seq": seq, "seconds": dt})
        self.sample_fallbacks += nbad
        return nxt, cache, dt

    def _next_sample_base(self) -> int:
        seed, calls = self._sample_stream
        self._sample_stream = (seed, calls + 1)
        return _stream_base(seed, calls)

    def _chunk_eager(self, cache, tok, kv_lens, produced, targets, keys,
                     steps: int, temperature: float, top_k: Optional[int]):
        """The decode chunk as a plain loop of ``steps`` decode steps: what
        the CPU runs, what a graph captures, and the graph's reference in
        the tests.  Updates ``cache`` in place; returns (tok, kv_lens,
        produced, keys, packed) with ``packed`` = [step tokens, step
        active masks, non-finite count, kv_lens] as one int32 vector."""
        b = int(tok.shape[0])
        max_seq = self.ecfg.max_seq
        advance_all = self.cfg.decode_cache_update == "uniform"
        toks = torch.empty((steps, b), dtype=torch.int32, device=tok.device)
        actives = torch.empty((steps, b), dtype=torch.int32, device=tok.device)
        nbad = torch.zeros((1,), dtype=torch.int32, device=tok.device)
        for s in range(steps):
            logits, cache = decode_step(self.cfg, self.params, cache, tok,
                                        kv_lens)
            if temperature > 0.0:
                keys, subs = _split_slot_keys(keys)
                tok, bad = _sample_tokens(subs, logits, temperature, top_k)
            else:
                tok, bad = _guarded_argmax(logits)
            active = produced < targets
            produced = produced + active.to(produced.dtype)
            step = (torch.ones_like(kv_lens) if advance_all
                    else active.to(kv_lens.dtype))
            kv_lens = torch.clamp(kv_lens + step, max=max_seq - 1)
            nbad += (bad & active).sum(dtype=torch.int32)
            toks[s] = tok
            actives[s] = active.to(torch.int32)
        packed = torch.cat([toks.flatten(), actives.flatten(), nbad,
                            kv_lens.to(torch.int32)])
        return tok, kv_lens, produced, keys, packed

    def _check_own_cache(self, cache, b: int):
        own = self._caches.get(b)
        if own is None or list(map(id, tree_leaves(cache))) != \
                list(map(id, tree_leaves(own))):
            raise ValueError(
                f"decode_chunk on CUDA runs a graph over the engine's own "
                f"cache of bucket {b} (from prefill_batch, new_cache or a "
                f"compaction); got another cache")

    def _capture(self, cache, inputs, steps, temperature, top_k):
        """Capture the chunk over ``cache`` and the static ``inputs`` into
        a graph on the engine's capture stream.  The wrappers count the
        launches they record; those counts move from ``LAUNCHES`` into the
        record, which adds them on every replay."""
        graph = torch.cuda.CUDAGraph()
        before = dict(K.LAUNCHES)
        with torch.cuda.graph(graph, stream=self._capture_stream):
            with self._no_sync():
                outputs = self._chunk_eager(cache, *inputs, steps,
                                            temperature, top_k)
        launches = {}
        for name, n in list(K.LAUNCHES.items()):
            launches[name] = n - before.get(name, 0)
            K.LAUNCHES[name] = before.get(name, 0)
        return _ChunkGraph(graph, inputs, outputs, launches)

    def _replay(self, rec: _ChunkGraph, inputs):
        with self._no_sync():
            for static, new in zip(rec.inputs, inputs):
                static.copy_(new)
            rec.graph.replay()
            # the graph's outputs are overwritten by its next replay: the
            # caller gets copies ([b]-sized, and the packed readback)
            outputs = tuple(t.clone() for t in rec.outputs)
        for name, n in rec.launches.items():
            K.LAUNCHES[name] += n
        return outputs

    @torch.no_grad()
    def decode_chunk(self, cache, kv_lens, tokens, produced, targets,
                     steps: int, temperature: float = 0.0,
                     top_k: Optional[int] = None, slot_keys=None):
        """Run ``steps`` fused decode iterations with one host sync.

        Returns (cache, tok, kv_lens, produced, slot_keys, step_tokens
        [steps,B], step_active [steps,B], kv_host [B], wall_seconds).  The
        carry (cache, tok, kv_lens, produced, slot_keys) stays on the
        device; ``step_tokens``, ``step_active`` and ``kv_host`` (the new
        ``kv_lens``) are numpy arrays read back in the chunk's one
        transfer.  ``kv_lens`` advances only for slots still below their
        target (all slots in 'uniform' cache-update mode, which needs
        lock-step positions) and is clamped at ``max_seq - 1``, so finished
        slots stop moving their ring pointer and, with the ragged kernel,
        stop paying KV reads.  ``temperature > 0`` samples with the
        per-slot ``slot_keys`` (each slot's key advances one step per
        decode step; thread the returned keys into the next chunk);
        ``slot_keys=None`` then forks fresh keys off the engine's stream.

        On CUDA the chunk runs as a graph of key (bucket, steps,
        temperature, top_k) over the engine's own cache of the bucket
        (any other cache raises); the step log marks it ``"capture"``
        (first call: eager run, then capture; the returned and logged
        seconds hold both, ``capture_seconds`` the capture alone) or
        ``"replay"``."""
        b = int(tokens.shape[0])
        temperature = float(temperature)
        if slot_keys is None:
            slot_keys = (slot_keys_for(self._next_sample_base(), b,
                                       self.device) if temperature > 0.0
                         else torch.zeros((b, 2), dtype=torch.int64,
                                          device=self.device))
        inputs = (tokens, kv_lens, produced, targets, slot_keys)
        key = (b, steps, temperature, top_k)
        rec = None
        if self.device.type == "cuda":
            self._check_own_cache(cache, b)
            rec = self._graphs.get(key)
        t0 = time.perf_counter()
        if rec is not None:
            tok, kv_lens, produced, slot_keys, packed = \
                self._replay(rec, inputs)
        else:
            stream = self._capture_stream
            on_stream = contextlib.nullcontext()
            if stream is not None:
                # fresh static buffers in the dtypes every replay copies
                # into; the eager run on the capture stream warms its
                # libraries
                dtypes = (torch.int32,) * 4 + (torch.int64,)
                inputs = tuple(t.to(dt).clone()
                               for t, dt in zip(inputs, dtypes))
                stream.wait_stream(torch.cuda.current_stream(self.device))
                on_stream = torch.cuda.stream(stream)
            with on_stream, self._no_sync():
                tok, kv_lens, produced, slot_keys, packed = \
                    self._chunk_eager(cache, *inputs, steps, temperature,
                                      top_k)
            if stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(stream)
        host = packed.cpu().numpy()           # the chunk's one host sync
        if rec is None and self.device.type == "cuda":
            t1 = time.perf_counter()
            self._graphs[key] = self._capture(cache, inputs, steps,
                                              temperature, top_k)
            capture_s = time.perf_counter() - t1
        # a capture is part of the call, as the reference's compile is
        dt = time.perf_counter() - t0
        n = steps * b
        toks_np = host[:n].reshape(steps, b)
        actives_np = host[n:2 * n].reshape(steps, b).astype(bool)
        kv_host = host[2 * n + 1:]
        self.host_syncs += 1
        self.sample_fallbacks += int(host[2 * n])
        entry = {"kind": "decode_chunk", "batch": b, "steps": steps,
                 "seq": int(kv_host.max()), "tokens": int(actives_np.sum()),
                 "seconds": dt}
        if self.device.type == "cuda":
            entry["graph"] = "replay" if rec is not None else "capture"
            if rec is None:
                entry["capture_seconds"] = capture_s
        self.step_log.append(entry)
        return (cache, tok, kv_lens, produced, slot_keys, toks_np,
                actives_np, kv_host, dt)

    def compact(self, cache, kv_lens, tokens, keep_idx: np.ndarray,
                slot_keys=None):
        """Gather live slots into a smaller bucket: the HOST reference
        path.  The keep indices live on the host and each cache leaf is
        gathered by plain indexing, then copied into the engine's own
        cache of the new bucket, so every compaction is one host-visible
        event (counted in ``host_syncs`` and ``step_log``).
        ``compact_fused`` is the device-resident twin the engine runs by
        default.  Entries past the live count repeat slot 0."""
        nb = _bucket(len(keep_idx), self.ecfg.min_bucket, self.ecfg.max_batch)
        idx = np.zeros((nb,), np.int64)
        idx[:len(keep_idx)] = keep_idx
        gathered, kv_lens, tokens, keys = compact_reference(
            cache, kv_lens, tokens, self._upload(idx), slot_keys)
        cache = self._own_cache(nb)
        for dst, src in zip(tree_leaves(cache), tree_leaves(gathered)):
            dst.copy_(src)
        self.host_syncs += 1
        self.step_log.append(
            {"kind": "compact", "impl": "host", "batch": nb, "syncs": 1})
        return cache, kv_lens, tokens, nb, int(len(keep_idx)), keys

    def compact_fused(self, cache, kv_lens, tokens, produced, targets,
                      n_live: int, slot_keys=None):
        """Device-resident compaction (``compact_impl="fused"``): the keep
        indices come from the chunk's ``produced``/``targets`` carry on the
        device (live iff ``produced < targets``, the host path's
        selection), and every leaf is gathered by the row-gather kernel
        (:mod:`repro_torch.kernels.compaction`) straight into the engine's
        own cache of the new bucket.  Nothing crosses to the host, so
        ``host_syncs`` per event is zero; only the bucket size ``nb`` is a
        host decision, from counts the chunk boundary already read.
        Bit-equal to :meth:`compact`."""
        nb = _bucket(n_live, self.ecfg.min_bucket, self.ecfg.max_batch)
        with self._no_sync():
            cache, kv_lens, tokens, keys, _ = fused_compact(
                cache, kv_lens, tokens, slot_keys, produced, targets, nb=nb,
                out_cache=self._own_cache(nb))
        self.step_log.append(
            {"kind": "compact", "impl": "fused", "batch": nb, "syncs": 0})
        return cache, kv_lens, tokens, nb, keys

    # ------------------------------------------------------------------
    def _track_kv(self, kv_host: np.ndarray, nlive: int) -> int:
        """Record live KV occupancy (sum of kv_lens over occupied slots:
        the real tokens pinned in the cache, not the worst case), from the
        host copy a prefill or chunk already has."""
        live_kv = int(kv_host[:nlive].sum())
        if live_kv > self.kv_peak:
            self.kv_peak = live_kv
        return live_kv

    def kv_report(self) -> dict:
        """Realized KV occupancy vs the configured budget."""
        cap = self.ecfg.kv_budget
        return {
            "kv_budget": cap,
            "kv_peak": int(self.kv_peak),
            "utilization": (self.kv_peak / cap) if cap else 0.0,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray], target_tokens: List[int],
                 elastic: bool = False, n_max: Optional[int] = None,
                 chunk: Optional[int] = None, return_tokens: bool = False,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None, seed: Optional[int] = None):
        """Run one batch to completion on the fused chunked-decode loop.

        Padded ('dynamic') mode decodes everyone until every request is
        done (the paper's padding semantics). Elastic mode lets finished
        replies exit and compacts buckets at chunk boundaries. ``chunk``
        overrides ``EngineConfig.decode_chunk`` (chunk=1 is the per-step
        loop; larger chunks give identical tokens with O(tokens/chunk)
        host syncs).  ``temperature``/``top_k`` override the EngineConfig
        sampling settings (temperature 0 is greedy, the default); ``seed``
        restarts the engine's sampling stream.  Each request samples from
        its own key stream, keyed by (batch base, request index) and
        gathered on compaction, so for a given ``seed`` the sampled tokens
        do not change with the chunk size, with elastic compaction, or
        with the batch a request is served in.  Returns a dict with
        per-request completion times (seconds of engine wall time after
        batch start) and token counts.
        """
        chunk = int(chunk if chunk is not None else self.ecfg.decode_chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        temperature = float(self.ecfg.temperature if temperature is None
                            else temperature)
        top_k = self.ecfg.top_k if top_k is None else top_k
        if seed is not None:
            self._sample_stream = (seed, 0)
        targets = np.asarray(target_tokens)
        if n_max is not None:
            targets = np.minimum(targets, n_max)
        nreq = len(prompts)
        if self.ecfg.kv_budget is not None:
            worst = int(sum(min(len(p), self.ecfg.max_seq) + int(t)
                            for p, t in zip(prompts, targets)))
            if worst > self.ecfg.kv_budget:
                raise ValueError(
                    f"batch worst-case KV footprint {worst} exceeds "
                    f"kv_budget {self.ecfg.kv_budget}; cap the batch "
                    "upstream (memory-gated admission) or raise the budget")
        syncs0 = self.host_syncs
        cache, kv_lens, last, b, t_prefill = self.prefill_batch(prompts)
        self._track_kv(self._prompt_lens(prompts), nreq)
        slot_keys = None
        if temperature > 0.0:
            # one key per request (slot i holds request i right after
            # prefill); padding slots get keys too, but never emit tokens
            slot_keys = slot_keys_for(self._next_sample_base(), b, self.device)
            slot_keys, subs = _split_slot_keys(slot_keys)
            tok, bad0 = _sample_tokens(subs, last, temperature, top_k)
        else:
            tok, bad0 = _guarded_argmax(last)
        tok_np, bad_np = torch.stack([tok, bad0.to(torch.int32)]).cpu().numpy()
        self.sample_fallbacks += int(bad_np[:nreq].sum())
        live = np.arange(nreq)
        produced = np.ones(nreq, np.int64)    # first token from prefill
        done_at = np.full(nreq, np.nan)
        clock = t_prefill
        done_at[targets <= 1] = clock
        out_tokens = ([[int(t)] for t in tok_np[:nreq]] if return_tokens
                      else None)

        def slot_state(bucket, ids):
            prod = np.zeros(bucket, np.int32)
            targ = np.zeros(bucket, np.int32)
            prod[:len(ids)] = produced[ids]
            targ[:len(ids)] = targets[ids]
            return self._upload(prod), self._upload(targ)

        prod_d = targ_d = None      # device twins of the slot counters
        while True:
            rem = targets[live] - produced[live]
            if elastic:
                still = live[rem > 0]
                if len(still) == 0:
                    break
                if len(still) <= b // 2 and b > self.ecfg.min_bucket:
                    if self.ecfg.compact_impl == "fused":
                        # device-resident keep: the produced/targets carry
                        # of the last chunk (or a fresh upload right after
                        # prefill) selects the live slots on the device
                        if prod_d is None:
                            prod_d, targ_d = slot_state(b, live)
                        cache, kv_lens, tok, b, slot_keys = \
                            self.compact_fused(cache, kv_lens, tok, prod_d,
                                               targ_d, len(still), slot_keys)
                    else:
                        # host reference path: map global ids to slot ids
                        slot_of = {g: i for i, g in enumerate(live)}
                        keep = np.array([slot_of[g] for g in still], np.int32)
                        cache, kv_lens, tok, b, _, slot_keys = self.compact(
                            cache, kv_lens, tok, keep, slot_keys)
                    live = still
                    rem = targets[live] - produced[live]
                    prod_d = targ_d = None   # stale after re-bucketing
            else:
                if np.all(produced >= targets):
                    break
            # quantize tail chunks to powers of two: produced counts gate
            # every step, so shorter chunks never change tokens
            rem_max = int(rem.max())
            steps = chunk if rem_max >= chunk else 1 << (rem_max.bit_length() - 1)
            prod_d, targ_d = slot_state(b, live)     # also feeds compaction
            (cache, tok, kv_lens, prod_d, slot_keys, toks_np, actives_np,
             kv_host, dt) = self.decode_chunk(
                cache, kv_lens, tok, prod_d, targ_d, steps,
                temperature=temperature, top_k=top_k, slot_keys=slot_keys)
            self._track_kv(kv_host, len(live))
            clock += dt
            # the device counter is the uploaded one plus the active steps
            produced[live] += actives_np.sum(axis=0)[:len(live)]
            if return_tokens:
                for s, g in enumerate(live):
                    out_tokens[g].extend(
                        toks_np[actives_np[:, s], s].tolist())
            newly = live[(produced[live] >= targets[live])
                         & np.isnan(done_at[live])]
            slot_of = {g: i for i, g in enumerate(live)}
            for g in newly:
                hit = np.nonzero(actives_np[:, slot_of[g]])[0]
                fin = int(hit[-1]) if hit.size else 0
                # completion interpolated at that step's chunk fraction
                done_at[g] = clock - dt + dt * (fin + 1) / steps
        done_at[np.isnan(done_at)] = clock
        if not elastic:
            # padded semantics (paper Eq 18): the whole batch is returned
            # when its longest member completes
            done_at[:] = clock
        res = {
            "completion_seconds": done_at,
            "batch_seconds": clock,
            "produced": produced,
            "prefill_seconds": t_prefill,
            "host_syncs": self.host_syncs - syncs0,
        }
        if return_tokens:
            res["tokens"] = out_tokens
        return res

    # ------------------------------------------------------------------
    def calibration_log(self) -> dict:
        """Measurements for fitting the paper's latency constants. Chunked
        decode entries are normalized to per-step seconds so the k3/k4 fit
        is chunk-size independent.  A capture call's chunk (an eager run
        plus the capture, once per key) is left out: on CUDA the decode
        law is that of the replays."""
        pre = [(e["batch"], e["seq"], e["seconds"])
               for e in self.step_log if e["kind"] == "prefill"]
        dec = [(e["batch"], e["seconds"])
               for e in self.step_log if e["kind"] == "decode"]
        dec += [(e["batch"], e["seconds"] / e["steps"])
                for e in self.step_log if e["kind"] == "decode_chunk"
                and e.get("graph") != "capture"]
        return {"prefill": pre, "decode": dec}
