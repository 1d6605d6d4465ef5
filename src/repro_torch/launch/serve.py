"""Serving launcher: the paper's technique as the control plane, the
counterpart of ``repro.launch.serve``.

Runs the batched engine on a Poisson request stream; the AdaptiveController
watches arrivals and completions and sets (n_max, b_max, policy) from the
paper's queueing models (Eqs 10-13, 25, §IV-D).  Straggler mitigation at
the request level = elastic batching + max-token clipping.

On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --smoke --device cpu --requests 32 --lam 0.5
On the card, at full width (random weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.control import AdaptiveController
from repro_torch.core.distributions import LogNormalTokens
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.data.pipeline import make_request_stream
from repro_torch.kernels import resolve_device
from repro_torch.serving.engine import Engine, EngineConfig


def serve(arch: str, *, smoke: bool = False, requests: int = 32,
          lam: float = 0.5, max_batch: int = 8, max_seq: int = 256,
          policy: str = "auto", log_mean: float = 3.0, log_std: float = 0.7,
          device=None) -> dict:
    """Serve ``requests`` Poisson(``lam``) requests with lognormal output
    lengths on ``arch`` (random weights from seed 0), forming each batch
    from what has arrived by the virtual clock, as the reference launcher
    does.  Prints one line per batch and a summary line, in the reference
    launcher's format.  ``device=None`` runs on CUDA and raises if there is
    none.

    Returns a summary: per-request ``waits`` and ``produced`` tokens,
    per-batch ``batch_sizes``, ``policies`` and ``n_max``, the final
    ``recommendation``, the virtual ``clock`` at the end and the engine's
    ``step_log``."""
    if policy not in ("auto", "dynamic", "elastic"):
        raise ValueError(f"policy must be auto, dynamic or elastic, got "
                         f"{policy!r}")
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, decode_cache_update="scatter")
    # the cache holds the model's dtype: the decode kernel takes q and the
    # caches in one dtype (fp32 at smoke size, as in the reference launcher)
    eng = Engine(cfg, EngineConfig(max_batch=max_batch, max_seq=max_seq,
                                   prompt_bucket=16, cache_dtype=cfg.dtype),
                 seed=0, device=device)
    dist = LogNormalTokens(log_mean, log_std, support=max_seq // 2)
    reqs = make_request_stream(requests, lam, dist, vocab=cfg.vocab_size,
                               seed=0)
    # the reference launcher's priors for the latency laws: inputs of the
    # controller, not measurements of this engine (ROADMAP.md M4 replaces
    # them with constants fitted on the card)
    ctrl = AdaptiveController(
        LatencyModel(a=5e-3, c=0.05),
        BatchLatencyModel(k1=5e-3, k2=5e-2, k3=1e-4, k4=5e-3),
        theta=119 / 120, elastic_available=(policy != "dynamic"),
        min_samples=8)

    clock = 0.0
    waits, produced, sizes, policies, n_maxes = [], [], [], [], []
    i = 0
    while i < len(reqs):
        # collect everything that has arrived by `clock` (dynamic batching)
        rec = ctrl.recommendation()
        b_cap = rec.b_max or max_batch
        batch = [reqs[i]]
        ctrl.observe_arrival(reqs[i].arrival)
        clock = max(clock, reqs[i].arrival)
        i += 1
        while i < len(reqs) and reqs[i].arrival <= clock and len(batch) < b_cap:
            ctrl.observe_arrival(reqs[i].arrival)
            batch.append(reqs[i])
            i += 1
        for r in batch:
            waits.append(clock - r.arrival)
        elastic = (rec.policy == "elastic") if policy == "auto" \
            else (policy == "elastic")
        res = eng.generate([r.prompt_tokens for r in batch],
                           [r.target_output_tokens for r in batch],
                           elastic=elastic, n_max=rec.n_max)
        clock += res["batch_seconds"]
        for n in res["produced"]:
            ctrl.observe_completion(int(n))
            produced.append(int(n))
        sizes.append(len(batch))
        policies.append("elastic" if elastic else "dynamic")
        n_maxes.append(rec.n_max)
        print(f"[serve] t={clock:8.2f}s batch={len(batch)} "
              f"policy={policies[-1]} n_max={rec.n_max} "
              f"served={sum(sizes)}/{requests}", flush=True)

    final = ctrl.recommendation()
    print(f"[serve] mean queue wait {np.mean(waits):.3f}s | "
          f"p95 {np.percentile(waits, 95):.3f}s | "
          f"final rec: policy={final.policy} n_max={final.n_max} "
          f"b_max={final.b_max}", flush=True)
    return {"waits": np.asarray(waits), "produced": produced,
            "batch_sizes": sizes, "policies": policies, "n_max": n_maxes,
            "recommendation": final, "clock": clock,
            "step_log": eng.step_log}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--policy", default="auto",
                    choices=["auto", "dynamic", "elastic"])
    ap.add_argument("--log-mean", type=float, default=3.0)
    ap.add_argument("--log-std", type=float, default=0.7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, an error without one)")
    args = ap.parse_args(argv)
    serve(args.arch, smoke=args.smoke, requests=args.requests, lam=args.lam,
          max_batch=args.max_batch, max_seq=args.max_seq, policy=args.policy,
          log_mean=args.log_mean, log_std=args.log_std, device=args.device)


if __name__ == "__main__":
    main()
