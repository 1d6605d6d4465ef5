"""Training launcher with fault tolerance, the counterpart of
``repro.launch.train``.

Supervisor loop: restore the latest checkpoint (and the data index it
recorded) -> step, with a step-timeout check -> periodic async
checkpoints -> on a failure (``RuntimeError``, ``TimeoutError``), restart
from the last complete checkpoint, at most ``--max-restarts`` times.
Parameters are drawn from an explicit ``torch.Generator`` seeded with 0
(the reference draws them from ``PRNGKey(0)``); the batches are ``SyntheticLMDataset``'s, bit for bit the
reference's.  One device: CUDA unless ``--device cpu``.

On the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --smoke --device cpu --steps 50 --global-batch 8 --seq-len 64 \\
      --ckpt-dir build/train_ckpt
On the card, at full width (random weights; ``--dtype bfloat16`` for bf16
parameters):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 20 --global-batch 4 --seq-len 512
``--smoke`` configs have heads of 16 dims, which the attention kernel is
not built for: on the card give them built heads with ``--set``, e.g.
``--set num_heads=16 --set head_dim=128 --set d_model=128 --set d_ff=256``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

# the checkout's build directory: checkpoints stay inside the checkout
_BUILD = Path(__file__).resolve().parents[3] / "build"


def _parse_set(items):
    out = {}
    for item in items:
        key, _, val = item.partition("=")
        if not _:
            raise SystemExit(f"--set takes KEY=VALUE, got {item!r}")
        for conv in (int, float):
            try:
                val = conv(val)
                break
            except ValueError:
                continue
        out[key] = val
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a ModelConfig field (repeatable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=str(_BUILD / "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--step-timeout-s", type=float, default=600.0,
                    help="a step exceeding this aborts the attempt and "
                         "restarts from the latest checkpoint")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--simulate-failure-at", type=int, default=-1,
                    help="test hook: raise at this step on the first attempt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32",
                    help="parameter dtype (the reference launcher's is "
                         "float32); activations follow the config's dtype")
    return ap


def main(argv=None) -> dict:
    """Run the launcher; returns {"losses": {step: loss}, "restored":
    [(step, data index)], "attempts": attempts} for callers that check
    the run (the tests, chip_smoke.py)."""
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.model import param_specs
    from repro_torch.models.params import init_params, torch_dtype
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    over = _parse_set(args.set)
    if over:
        cfg = dataclasses.replace(cfg, **over)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to train on the "
                         "CPU")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=args.lr, warmup_steps=10,
                                         total_steps=args.steps))
    mgr = CheckpointManager(args.ckpt_dir, keep_last=3, async_write=True)
    ds = SyntheticLMDataset(cfg, args.seq_len, args.global_batch, seed=0)
    step_fn = make_train_step(cfg, tcfg)
    result = {"losses": {}, "restored": [], "attempts": 0}

    attempt = 0
    while attempt <= args.max_restarts:
        result["attempts"] = attempt + 1
        try:
            mgr.wait()         # the latest checkpoint may still be in flight
            gen = torch.Generator(device=device).manual_seed(0)
            params = init_params(param_specs(cfg), gen,
                                 torch_dtype(args.dtype), device=device)
            opt = adamw_init(params, tcfg.adamw)
            start_step = 0
            if mgr.latest_step() is not None:
                (params, opt), start_step, extra = mgr.restore((params, opt))
                ds.index = int(extra.get("data_index", start_step))
                result["restored"].append((start_step, ds.index))
                print(f"[train] restored step {start_step} "
                      f"(data index {ds.index})", flush=True)
            for step in range(start_step, args.steps):
                t0 = time.time()
                if attempt == 0 and step == args.simulate_failure_at:
                    raise RuntimeError("injected failure (test hook)")
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in ds.batch().items()}
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])     # waits for the step
                dt = time.time() - t0
                result["losses"][step] = loss
                if dt > args.step_timeout_s:
                    raise TimeoutError(
                        f"step {step} took {dt:.1f}s > timeout "
                        f"(straggler/failure suspected)")
                if step % 10 == 0 or step == args.steps - 1:
                    print(f"[train] step {step} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"({dt * 1e3:.0f} ms)", flush=True)
                if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
                    mgr.save(step + 1, (params, opt),
                             extra={"data_index": ds.index})
            mgr.wait()
            print("[train] done", flush=True)
            return result
        except NotImplementedError:
            raise              # a missing piece of the port is no failure
        except (RuntimeError, TimeoutError) as e:
            attempt += 1
            print(f"[train] attempt failed ({e}); restart {attempt}/"
                  f"{args.max_restarts} from latest checkpoint", flush=True)
    raise SystemExit("[train] exceeded max restarts")


if __name__ == "__main__":
    main()
