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
the chunk, so the host waits once per chunk instead of once per token.
Each such wait is counted in ``Engine.host_syncs`` and logged in
``step_log``: one per prefill, one per chunk, one per host-path compaction
and zero per fused compaction.  On CUDA the decode loop and the fused
compaction run under ``torch.cuda.set_sync_debug_mode("error")``, so a
hidden sync there raises instead of passing unseen.

The reference donates the cache to each jitted call; here the caches are
updated in place by prefill and decode, and compaction returns new, smaller
tensors.

Sampling (``temperature > 0``, ``top_k``) and ``serve_continuous`` are not
ported yet (ROADMAP.md, queue 1): greedy decoding only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.kernels.compaction import compact_reference, fused_compact
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    check_supported, decode_step, init_cache, param_specs, prefill)
from repro_torch.models.params import init_params, torch_dtype


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


def _check_greedy(temperature: float, top_k: Optional[int]):
    if temperature > 0.0 or top_k is not None:
        raise NotImplementedError(
            "sampling (temperature > 0 or top_k) is not ported yet "
            "(ROADMAP.md, queue 1, M3); use greedy decoding")


class Engine:
    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, params=None,
                 seed: int = 0, device=None):
        """``device=None`` runs on CUDA and raises if there is none; pass
        ``device="cpu"`` for the plain PyTorch paths.  ``params=None``
        initializes random weights from ``seed`` in ``cfg.dtype``."""
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

    def new_cache(self, batch_bucket: int):
        return init_cache(self.cfg, batch_bucket, self.ecfg.max_seq,
                          torch_dtype(self.ecfg.cache_dtype), self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill_batch(self, prompts: List[np.ndarray]):
        """Pad to buckets, run prefill. Returns (cache, kv_lens, last_logits,
        batch_bucket, wall_seconds)."""
        b = _bucket(len(prompts), self.ecfg.min_bucket, self.ecfg.max_batch)
        max_p = max(len(p) for p in prompts)
        s = min(_bucket(max_p, self.ecfg.prompt_bucket, self.ecfg.max_seq),
                self.ecfg.max_seq)
        tokens = np.zeros((b, s), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p[:s]
            lens[i] = min(len(p), s)
        lens = np.maximum(lens, 1)
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

    @torch.no_grad()
    def decode_chunk(self, cache, kv_lens, tokens, produced, targets,
                     steps: int, temperature: float = 0.0,
                     top_k: Optional[int] = None, slot_keys=None):
        """Run ``steps`` fused decode iterations with one host sync.

        Returns (cache, tok, kv_lens, produced, slot_keys, step_tokens
        [steps,B], step_active [steps,B], wall_seconds).  The carry (cache,
        tok, kv_lens, produced) stays on the device; ``step_tokens`` and
        ``step_active`` are numpy arrays read back in the chunk's one
        transfer.  ``kv_lens`` advances only for slots still below their
        target (all slots in 'uniform' cache-update mode, which needs
        lock-step positions) and is clamped at ``max_seq - 1``, so finished
        slots stop moving their ring pointer and, with the ragged kernel,
        stop paying KV reads.  Greedy only: ``slot_keys`` passes through."""
        _check_greedy(temperature, top_k)
        b = int(tokens.shape[0])
        max_seq = self.ecfg.max_seq
        advance_all = self.cfg.decode_cache_update == "uniform"
        t0 = time.perf_counter()
        with self._no_sync():
            toks = torch.empty((steps, b), dtype=torch.int32,
                               device=self.device)
            actives = torch.empty((steps, b), dtype=torch.int32,
                                  device=self.device)
            nbad = torch.zeros((1,), dtype=torch.int32, device=self.device)
            tok = tokens
            for s in range(steps):
                logits, cache = decode_step(self.cfg, self.params, cache,
                                            tok, kv_lens)
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
                                kv_lens.max().view(1).to(torch.int32)])
        host = packed.cpu().numpy()           # the chunk's one host sync
        dt = time.perf_counter() - t0
        n = steps * b
        toks_np = host[:n].reshape(steps, b)
        actives_np = host[n:2 * n].reshape(steps, b).astype(bool)
        self.host_syncs += 1
        self.sample_fallbacks += int(host[2 * n])
        self.step_log.append(
            {"kind": "decode_chunk", "batch": b, "steps": steps,
             "seq": int(host[2 * n + 1]), "tokens": int(actives_np.sum()),
             "seconds": dt})
        return (cache, tok, kv_lens, produced, slot_keys, toks_np,
                actives_np, dt)

    def compact(self, cache, kv_lens, tokens, keep_idx: np.ndarray,
                slot_keys=None):
        """Gather live slots into a smaller bucket: the HOST reference
        path.  The keep indices live on the host and each cache leaf is
        gathered by plain indexing, so every compaction is one
        host-visible event (counted in ``host_syncs`` and ``step_log``).
        ``compact_fused`` is the device-resident twin the engine runs by
        default.  Entries past the live count repeat slot 0."""
        nb = _bucket(len(keep_idx), self.ecfg.min_bucket, self.ecfg.max_batch)
        idx = np.zeros((nb,), np.int64)
        idx[:len(keep_idx)] = keep_idx
        cache, kv_lens, tokens, keys = compact_reference(
            cache, kv_lens, tokens, self._upload(idx), slot_keys)
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
        (:mod:`repro_torch.kernels.compaction`).  Nothing crosses to the
        host, so ``host_syncs`` per event is zero; only the bucket size
        ``nb`` is a host decision, from counts the chunk boundary already
        read.  Bit-equal to :meth:`compact`."""
        nb = _bucket(n_live, self.ecfg.min_bucket, self.ecfg.max_batch)
        with self._no_sync():
            cache, kv_lens, tokens, keys, _ = fused_compact(
                cache, kv_lens, tokens, slot_keys, produced, targets, nb=nb)
        self.step_log.append(
            {"kind": "compact", "impl": "fused", "batch": nb, "syncs": 0})
        return cache, kv_lens, tokens, nb, keys

    # ------------------------------------------------------------------
    def _track_kv(self, kv_lens, nlive: int) -> int:
        """Record live KV occupancy (sum of kv_lens over occupied slots:
        the real tokens pinned in the cache, not the worst case)."""
        live_kv = int(kv_lens[:nlive].sum())
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
        host syncs).  Greedy only: ``temperature > 0`` or ``top_k`` raise
        (``seed`` is accepted for signature parity and unused).  Returns a
        dict with per-request completion times (seconds of engine wall
        time after batch start) and token counts.
        """
        chunk = int(chunk if chunk is not None else self.ecfg.decode_chunk)
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        temperature = float(self.ecfg.temperature if temperature is None
                            else temperature)
        top_k = self.ecfg.top_k if top_k is None else top_k
        _check_greedy(temperature, top_k)
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
        self._track_kv(kv_lens, nreq)
        slot_keys = None
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
            cache, tok, kv_lens, prod_d, slot_keys, toks_np, actives_np, dt = \
                self.decode_chunk(cache, kv_lens, tok, prod_d, targ_d, steps,
                                  slot_keys=slot_keys)
            self._track_kv(kv_lens, len(live))
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
        is chunk-size independent."""
        pre = [(e["batch"], e["seq"], e["seconds"])
               for e in self.step_log if e["kind"] == "prefill"]
        dec = [(e["batch"], e["seconds"])
               for e in self.step_log if e["kind"] == "decode"]
        dec += [(e["batch"], e["seconds"] / e["steps"])
                for e in self.step_log if e["kind"] == "decode_chunk"]
        return {"prefill": pre, "decode": dec}
