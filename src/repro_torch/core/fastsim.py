"""The fast simulators behind the batching-policy core: a port of
``repro.core.fastsim`` onto the card.

The NumPy event loops in :mod:`repro_torch.core.simulate` stay the
reference oracle; this module runs the same recursions fast.  Dispatch is
structural: every :class:`repro_torch.core.policies.BatchPolicy` names its
kernel in ``policy.fast_kernel`` and ``KERNELS`` maps the name to an
implementation; a policy without one (``ContinuousPolicy``) runs the
oracle, as in the reference.

  * ``"mg1"``          Lindley / workload recursion.  tau=None is the
    oracle's closed-form cumulative minimum (host NumPy, as the reference's
    fast path is); with impatience the workload recursion runs as kernel
    S2 (``kernels/impatience_scan``), one lane per cell.
  * ``"batch_scan"``   dynamic / elastic batch formation as a per-request
    scan with an O(1) carry (start, count, token sum, token max): kernel
    S1 (``kernels/batch_scan``), one thread per lane.
  * ``"fixed_cummax"`` closed form: the free-time recursion
    F_k = max(F_{k-1}, A_k) + H_k telescopes to a running maximum (host
    NumPy, as in the reference).
  * ``"multibin"``, ``"wait"``, ``"srpt"``   the batch-event disciplines,
    one step per batch: kernels S3 (``kernels/multibin_scan``), S4
    (``kernels/wait_scan``) and S5 (``kernels/srpt_scan``), one thread per
    lane.  The host supplies each request's bin (S3) or the rank order of a
    stable argsort of the lengths (S5), from the workload's PREDICTED
    column where it has one; the service law always sees the true tokens.

``sweep(policies, lam_grid, ...)`` stacks every (λ, policy) cell whose
policy rides the batching scan as a lane of ONE S1 launch; the other
policies dispatch through ``KERNELS`` per cell, as the reference does.
``sweep_noise`` sweeps the (arrival rate, prediction noise) plane: when
every policy rides SRPT, all its cells are lanes of ONE S5 launch.

The fleet layer (:mod:`repro_torch.core.fleet`) rides the same kernels:
the state-dependent routers' backlog recursion is kernel S6
(``kernels/backlog_scan``, ``backlog_route`` and its availability-masked
twin ``masked_backlog_route``), and ``simulate_fleet_fast`` is the fleet
twin of the oracle's ``fleet.route_oracle``.  Fault traces and traffic
models wrap the unchanged kernels on the host: the traffic warp before a
kernel sees the workload, the fault trace's operational-time transform
around it (``simulate._with_fault_trace``).

Every entry point takes ``device``: None runs on the card and raises
without one; ``"cpu"`` runs the kernels' plain PyTorch versions (the CPU
tests).  All times are float64 tensors: simulated clocks reach about 1e6 s,
where a float32 ulp (about 0.06 s) would swamp the waits.  Every kernel
samples its workload through the policy's ``sample_workload``, the same
rng call order as the oracle and the reference, so equal seeds give equal
trajectories, bit for bit.

Not ported yet: sessions (ROADMAP.md M7c), memory budgets and the tandem
loop (M7d), ``run_controlled`` (M7e), ``lane_scan=`` and ``srpt_loop=``
(M9).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.core.policies import (
    BatchPolicy, DynamicPolicy, ElasticPolicy, FCFSPolicy, FixedPolicy,
    not_ported, policy_from_spec, single_from_batch)
from repro_torch.core.simulate import (
    _warm, _with_fault_trace, check_no_m7_layers, simulate_fixed_batching,
    simulate_policy)
from repro_torch.kernels import resolve_device
from repro_torch.kernels.backlog_scan import backlog_scan
from repro_torch.kernels.batch_scan import NO_CAP, batch_scan
from repro_torch.kernels.impatience_scan import impatience_scan
from repro_torch.kernels.multibin_scan import multibin_scan
from repro_torch.kernels.srpt_scan import srpt_scan
from repro_torch.kernels.wait_scan import wait_scan

KERNELS: Dict[str, Callable] = {}


def kernel(name: str):
    """Register a kernel; ``BatchPolicy.fast_kernel`` names it."""
    def deco(fn):
        KERNELS[name] = fn
        return fn
    return deco


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def _i64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _launch(launch_out, kernel_name, fn, *args):
    """Run the scan wrapper ``fn(*args)``; a ``launch_out`` dict is filled
    with the kernel's name, its arguments and its outputs (the tensors as
    they were passed and returned), for a caller that checks the kernel."""
    out = fn(*args)
    if launch_out is not None:
        launch_out.update(kernel=kernel_name, args=args, out=out)
    return out


def _law(lat):
    """The batch law's constants, as the scan wrappers take them."""
    return lat.k1, lat.k2, lat.k3, lat.k4


def simulate_policy_fast(policy: BatchPolicy, lam: float,
                         dist: Optional[TokenDistribution], lat,
                         num_requests: int = 200_000, seed: int = 0,
                         workload=None, fault_trace=None, traffic=None,
                         sessions=None, memory=None, device=None,
                         launch_out: Optional[dict] = None) -> dict:
    """Fast twin of :func:`repro_torch.core.simulate.simulate_policy`:
    dispatch to the policy's kernel, or run the oracle when the policy has
    none (``fast_kernel=None``).  ``workload`` overrides the policy's own
    sampling, exactly like the oracle's parameter.  A ``launch_out`` dict
    is filled with the one kernel launch's inputs and outputs, where the
    policy's path launches a scan kernel (see :func:`_launch`).

    ``fault_trace`` injects failure epochs exactly like the oracle: the
    transform arithmetic is the SAME host code
    (``simulate._with_fault_trace``), only the inner fault-free run is the
    kernel.  ``traffic`` warps the arrivals on the host before the kernel
    sees the workload; a null model never warps."""
    check_no_m7_layers(sessions=sessions, memory=memory)
    device = resolve_device(device)
    if policy.uses_single_latency and isinstance(lat, BatchLatencyModel):
        lat = single_from_batch(lat)
    if traffic is not None:
        from repro_torch.core.traffic import traffic_from_spec, warp_workload
        tm = traffic_from_spec(traffic)
        if not tm.is_null:
            wl = workload if workload is not None else \
                policy.sample_workload(lam, dist, num_requests, seed)
            workload = warp_workload(wl, tm, seed)
    if policy.fast_kernel is None:
        return simulate_policy(policy, lam, dist, lat,
                               num_requests=num_requests, seed=seed,
                               workload=workload, fault_trace=fault_trace)

    def run(wl):
        return KERNELS[policy.fast_kernel](
            policy, lam, dist, lat, num_requests, seed, workload=wl,
            device=device, launch_out=launch_out)

    if fault_trace is not None and not fault_trace.empty:
        wl = workload if workload is not None else \
            policy.sample_workload(lam, dist, num_requests, seed)
        return _with_fault_trace(run, wl, fault_trace)
    return run(workload)


# ----------------------------------------------------------------------------
# M/G/1 with deterministic impatience tau (kernel S2)
# ----------------------------------------------------------------------------

@kernel("mg1")
def _mg1_kernel(policy, lam, dist, lat, num_requests, seed, workload=None,
                *, device, launch_out=None) -> dict:
    if policy.tau is None:
        # the reference tau=None path is already a closed-form vectorized
        # Lindley recursion — it IS the fast path.
        return simulate_policy(policy, lam, dist, lat,
                               num_requests=num_requests, seed=seed,
                               workload=workload)
    wl = workload if workload is not None else \
        policy.sample_workload(lam, dist, num_requests, seed)
    service = np.asarray(lat.service_time(wl.tokens), np.float64)
    waits, lost = _launch(launch_out, "impatience_scan", impatience_scan,
                          _f64(wl.inter, device)[:, None],
                          _f64(service, device)[:, None],
                          _f64([policy.tau], device))
    waits_w = _warm(waits[:, 0].cpu().numpy())
    lost_w = _warm(lost[:, 0].cpu().numpy())
    served = waits_w[~lost_w]
    return {
        "mean_wait": float(waits_w.mean()),
        "mean_wait_served": float(served.mean()) if served.size else 0.0,
        "loss_frac": float(lost_w.mean()),
        "p95_wait": float(np.percentile(waits_w, 95)),
        "waits": waits_w,
    }


def simulate_mg1_fast(lam: float, dist: TokenDistribution, lat: LatencyModel,
                      n_max: Optional[int] = None, tau: Optional[float] = None,
                      num_requests: int = 200_000, seed: int = 0,
                      device=None) -> dict:
    """Drop-in fast twin of :func:`repro_torch.core.simulate.simulate_mg1`."""
    return simulate_policy_fast(FCFSPolicy(n_max=n_max, tau=tau), lam, dist,
                                lat, num_requests=num_requests, seed=seed,
                                device=device)


# ----------------------------------------------------------------------------
# Dynamic / elastic batching (kernel S1)
# ----------------------------------------------------------------------------

def _batch_lane_stats(starts, closed, arrivals):
    starts = np.asarray(starts)
    nb = int(np.asarray(closed).sum())
    waits = starts - arrivals
    w = _warm(waits)
    return {
        "mean_wait": float(w.mean()),
        "p95_wait": float(np.percentile(w, 95)),
        "mean_batch": float(len(starts) / max(nb, 1)),
        "waits": w,
    }


def _scan_lanes(arr, tok, lanes, lat, device, launch_out=None):
    """Kernel S1 over stacked lanes: arr, tok [n, lanes] numpy, lanes
    minor; ``lanes`` a list of (elastic, b_max).  Returns (starts, closed)
    as [n, lanes] numpy."""
    elastic = torch.tensor([bool(e) for e, _ in lanes], device=device)
    b_max = _f64([NO_CAP if bm is None else float(bm) for _, bm in lanes],
                 device)
    starts, closed = _launch(launch_out, "batch_scan", batch_scan,
                             _f64(arr, device), _f64(tok, device), elastic,
                             b_max, *_law(lat))
    return starts.cpu().numpy(), closed.cpu().numpy()


@kernel("batch_scan")
def _batch_scan_kernel(policy, lam, dist, lat, num_requests, seed,
                       workload=None, *, device, launch_out=None) -> dict:
    wl = workload if workload is not None else \
        policy.sample_workload(lam, dist, num_requests, seed)
    starts, closed = _scan_lanes(wl.arrivals[:, None], wl.tokens[:, None],
                                 [policy.scan_lane()], lat, device,
                                 launch_out)
    return _batch_lane_stats(starts[:, 0], closed[:, 0], wl.arrivals)


def simulate_dynamic_batching_fast(lam: float, dist: TokenDistribution,
                                   lat: BatchLatencyModel,
                                   b_max: Optional[int] = None,
                                   elastic: bool = False,
                                   n_max: Optional[int] = None,
                                   num_requests: int = 200_000,
                                   seed: int = 0, device=None) -> dict:
    """Drop-in fast twin of simulate_dynamic_batching (same seeds =>
    trajectory-identical batch boundaries)."""
    cls = ElasticPolicy if elastic else DynamicPolicy
    return simulate_policy_fast(cls(n_max=n_max, b_max=b_max), lam, dist,
                                lat, num_requests=num_requests, seed=seed,
                                device=device)


# ----------------------------------------------------------------------------
# Fixed batching (closed form — the recursion telescopes to a cummax)
# ----------------------------------------------------------------------------

@kernel("fixed_cummax")
def _fixed_kernel(policy, lam, dist, lat, num_requests, seed,
                  workload=None, *, device, launch_out=None) -> dict:
    if "batch_time" in vars(policy):
        # an instance-level batch_time override cannot be vectorized:
        # the reference runs its oracle loop here, and so does the port
        return simulate_policy(policy, lam, dist, lat,
                               num_requests=num_requests, seed=seed,
                               workload=workload)
    b = policy.b
    wl = workload if workload is not None else \
        policy.sample_workload(lam, dist, num_requests, seed)
    n_served = (len(wl.arrivals) // b) * b    # provided workloads may be
    arrivals = wl.arrivals[:n_served]         # ragged
    tokens = wl.tokens[:n_served]
    arr_kb = arrivals.reshape(-1, b)
    h = np.asarray(lat.batch_time(b, tokens.reshape(-1, b).max(axis=1)),
                   np.float64)
    c = np.cumsum(h)
    # F_k = max(F_{k-1}, A_k) + H_k  =>  F_k - C_k = cummax_j(A_j - C_{j-1})
    free = np.maximum.accumulate(arr_kb[:, -1] - (c - h)) + c
    starts = free - h
    waits = (starts[:, None] - arr_kb).reshape(-1)
    w = _warm(waits)
    return {
        "mean_wait": float(w.mean()),
        "p95_wait": float(np.percentile(w, 95)),
        "waits": w,
    }


def simulate_fixed_batching_fast(lam: float, b: int,
                                 dist: Optional[TokenDistribution],
                                 lat: Optional[BatchLatencyModel] = None,
                                 batch_time: Optional[Callable] = None,
                                 num_requests: int = 200_000,
                                 seed: int = 0, device=None) -> dict:
    """Drop-in fast twin of simulate_fixed_batching. With an arbitrary
    ``batch_time`` callable the per-batch times cannot be vectorized, so that
    case runs the reference loop."""
    if batch_time is not None:
        resolve_device(device)
        return simulate_fixed_batching(lam, b, dist, lat,
                                       batch_time=batch_time,
                                       num_requests=num_requests, seed=seed)
    assert lat is not None
    return simulate_policy_fast(FixedPolicy(b=b), lam, dist, lat,
                                num_requests=num_requests, seed=seed,
                                device=device)


# ----------------------------------------------------------------------------
# Batch-event disciplines (kernels S3-S5): one kernel step per batch
# ----------------------------------------------------------------------------

def _cap(b_max: Optional[int]) -> int:
    """A policy's batch cap as the kernels take it: 0 is none, as the
    oracle's ``if self.b_max:`` reads None and 0 alike."""
    return int(b_max) if b_max else 0


def _event_lane(policy, lam, dist, num_requests, seed, workload, device):
    wl = workload if workload is not None else \
        policy.sample_workload(lam, dist, num_requests, seed)
    return wl, _f64(wl.arrivals, device)[:, None], \
        _f64(wl.tokens, device)[:, None]


def _event_stats(out, arrivals) -> dict:
    starts, first = out
    return _batch_lane_stats(starts[:, 0].cpu().numpy(),
                             first[:, 0].cpu().numpy(), arrivals)


@kernel("multibin")
def _multibin_kernel(policy, lam, dist, lat, num_requests, seed,
                     workload=None, *, device, launch_out=None) -> dict:
    wl, arr, tok = _event_lane(policy, lam, dist, num_requests, seed,
                               workload, device)
    # bins key off the predicted lengths; the kernel's padding the true ones
    bins = _i64(policy.bin_of(wl.predicted_or_true, dist), device)[:, None]
    out = _launch(launch_out, "multibin_scan", multibin_scan, arr, tok, bins,
                  policy.num_bins, _i64([_cap(policy.b_max)], device),
                  *_law(lat))
    return _event_stats(out, wl.arrivals)


@kernel("wait")
def _wait_kernel(policy, lam, dist, lat, num_requests, seed, workload=None,
                 *, device, launch_out=None) -> dict:
    wl, arr, tok = _event_lane(policy, lam, dist, num_requests, seed,
                               workload, device)
    timeout = np.inf if policy.timeout is None else policy.timeout
    out = _launch(launch_out, "wait_scan", wait_scan, arr, tok,
                  _i64([policy.k], device), _f64([timeout], device),
                  _i64([_cap(policy.b_max)], device), *_law(lat))
    return _event_stats(out, wl.arrivals)


@kernel("srpt")
def _srpt_kernel(policy, lam, dist, lat, num_requests, seed, workload=None,
                 *, device, launch_out=None) -> dict:
    wl, arr, tok = _event_lane(policy, lam, dist, num_requests, seed,
                               workload, device)
    # the host's share (the reference's _srpt_rank_arrays): rank order of
    # (predicted length, arrival index) by a stable argsort; the kernel
    # builds its segment tree over the arrivals itself
    order = _i64(np.argsort(wl.predicted_or_true, kind="stable"),
                 device)[:, None]
    out = _launch(launch_out, "srpt_scan", srpt_scan, arr, tok, order,
                  _i64([_cap(policy.b_max)], device), *_law(lat))
    return _event_stats(out, wl.arrivals)


# ----------------------------------------------------------------------------
# Uniform sweep: one S1 launch for every batch_scan lane, kernels for the rest
# ----------------------------------------------------------------------------

def _instances(policies: dict) -> dict:
    return {name: (p if isinstance(p, BatchPolicy) else policy_from_spec(p))
            for name, p in policies.items()}


def scan_lane_inputs(policies: dict, lam_grid, dist,
                     num_requests: int = 100_000, seed: int = 0):
    """The lanes ``sweep`` stacks into its one S1 launch: every (policy, λ)
    cell whose policy rides the batching scan with no ``n_max``.  Returns
    (lanes, arr, tok): a list of (name, lam_index, elastic, b_max) and the
    [n, lanes] float64 arrivals and tokens, lanes minor as S1 takes them
    (one workload per λ, sampled as the oracle samples it)."""
    lam_grid = list(lam_grid)
    lanes = []
    for name, pol in _instances(policies).items():
        lane = pol.scan_lane()
        if lane is not None and pol.n_max is None:
            lanes += [(name, li) + lane for li in range(len(lam_grid))]
    wls = [DynamicPolicy().sample_workload(lam, dist, num_requests, seed)
           for lam in lam_grid] if lanes else []
    arr = np.stack([wls[li].arrivals for _, li, _, _ in lanes], axis=1) \
        if lanes else np.zeros((num_requests, 0))
    tok = np.stack([wls[li].tokens for _, li, _, _ in lanes], axis=1) \
        if lanes else np.zeros((num_requests, 0))
    return lanes, arr, tok


def sweep(policies: dict, lam_grid, dist, lat,
          num_requests: int = 100_000, seed: int = 0, device=None,
          scan_out: Optional[dict] = None) -> dict:
    """Mean wait for each policy over an arrival-rate grid — the uniform
    fast entry point.  ``policies``: name -> BatchPolicy (or legacy spec
    dict).  Policies riding the batching scan (``scan_lane() is not
    None``, no ``n_max``) are stacked as lanes of ONE S1 launch
    (:func:`scan_lane_inputs`); every other policy dispatches through
    ``KERNELS`` per (λ, policy) cell (the oracle when it has no kernel).
    A ``scan_out`` dict is filled with that launch's ``lanes``, its inputs
    ``arr``, ``tok`` and outputs ``starts``, ``closed`` ([n, lanes] numpy),
    and under ``cells`` with each per-cell kernel launch, {(name, lam
    index): ``launch_out``} (see :func:`simulate_policy_fast`), for a caller
    that checks the kernels."""
    device = resolve_device(device)
    lam_grid = list(lam_grid)
    insts = _instances(policies)
    lanes, arr, tok = scan_lane_inputs(insts, lam_grid, dist, num_requests,
                                       seed)
    laned = {name for name, *_ in lanes}
    out = {name: [None] * len(lam_grid) for name in insts}
    cells = {}
    for name, pol in insts.items():
        if name in laned:
            continue
        for li, lam in enumerate(lam_grid):
            cell = {} if scan_out is not None else None
            r = simulate_policy_fast(pol, lam, dist, lat,
                                     num_requests=num_requests, seed=seed,
                                     device=device, launch_out=cell)
            out[name][li] = r["mean_wait"]
            if cell:
                cells[name, li] = cell
    if scan_out is not None:
        scan_out["cells"] = cells
    if lanes:
        starts, closed = _scan_lanes(arr, tok, [(e, b) for *_, e, b in lanes],
                                     lat, device)
        for col, (name, li, _, _) in enumerate(lanes):
            stats = _batch_lane_stats(starts[:, col], closed[:, col],
                                      arr[:, col])
            out[name][li] = stats["mean_wait"]
        if scan_out is not None:
            scan_out.update(lanes=lanes, arr=arr, tok=tok, starts=starts,
                            closed=closed)
    return {k: np.asarray(v) for k, v in out.items()}


def simulate_policy_sweep_fast(lam_grid, dist, lat, policies: dict,
                               num_requests: int = 100_000,
                               seed: int = 0, device=None) -> dict:
    """Drop-in fast twin of simulate_policy_sweep (legacy argument order)."""
    return sweep(policies, lam_grid, dist, lat,
                 num_requests=num_requests, seed=seed, device=device)


# ----------------------------------------------------------------------------
# Noise-robustness sweep over the (arrival rate, prediction error) plane
# ----------------------------------------------------------------------------

def sweep_noise(policy_factory: Callable[[float], BatchPolicy], lam_grid,
                sigma_grid, dist, lat, num_requests: int = 50_000,
                seed: int = 0, srpt_loop: Optional[Callable] = None,
                device=None, launch_out: Optional[dict] = None) -> dict:
    """Mean wait over the (λ, σ) grid: how a length-aware policy's win
    erodes as its predictor degrades.

    ``policy_factory(sigma)`` builds the policy at prediction-noise level
    ``sigma`` (typically with a
    :class:`repro_torch.core.predictors.LogNormalNoisePredictor` of that
    sigma; sigma=0 reproduces the oracle).  The workload stream per λ is
    identical across the σ row — the predictor rng is salted away from the
    workload rng — so the columns differ ONLY by prediction quality.

    When every produced policy rides the ``srpt`` kernel, all (λ, σ) cells
    are lanes of ONE launch of kernel S5 (the reference's
    ``_srpt_loop_vmapped``); a ``launch_out`` dict is then filled with
    that launch's inputs and outputs (see :func:`_launch`) and with
    ``cells``, the (λ index, σ index) of each lane.  Otherwise each cell
    dispatches through :func:`simulate_policy_fast` on its own.
    ``srpt_loop`` (the reference's multi-device lane executor) is not
    ported yet (ROADMAP.md M9).

    Returns ``{"mean_wait": [len(lam_grid), len(sigma_grid)], "lams",
    "sigmas"}``."""
    if srpt_loop is not None:
        not_ported("sweep_noise(srpt_loop=): lanes over a device mesh", "M9")
    device = resolve_device(device)
    lam_grid = [float(l) for l in lam_grid]
    sigma_grid = [float(s) for s in sigma_grid]
    pols = [policy_factory(s) for s in sigma_grid]
    out = np.empty((len(lam_grid), len(sigma_grid)))
    if all(p.fast_kernel == "srpt" for p in pols):
        b_maxes = {p.b_max for p in pols}
        if len(b_maxes) != 1:
            raise ValueError(f"srpt lanes must share one b_max, got "
                             f"{sorted(b_maxes, key=str)}")
        cells, wls = [], []
        for li, lam in enumerate(lam_grid):
            for si, pol in enumerate(pols):
                cells.append((li, si))
                wls.append(pol.sample_workload(lam, dist, num_requests, seed))
        arr = np.stack([wl.arrivals for wl in wls], axis=1)
        tok = np.stack([wl.tokens for wl in wls], axis=1)
        order = np.stack([np.argsort(wl.predicted_or_true, kind="stable")
                          for wl in wls], axis=1)
        b_max = _i64([_cap(b_maxes.pop())] * len(cells), device)
        starts, first = _launch(launch_out, "srpt_scan", srpt_scan,
                                _f64(arr, device), _f64(tok, device),
                                _i64(order, device), b_max, *_law(lat))
        if launch_out is not None:
            launch_out["cells"] = cells
        starts, first = starts.cpu().numpy(), first.cpu().numpy()
        for c, (li, si) in enumerate(cells):
            out[li, si] = _batch_lane_stats(starts[:, c], first[:, c],
                                            arr[:, c])["mean_wait"]
    else:
        for li, lam in enumerate(lam_grid):
            for si, pol in enumerate(pols):
                r = simulate_policy_fast(pol, lam, dist, lat,
                                         num_requests=num_requests,
                                         seed=seed, device=device)
                out[li, si] = r["mean_wait"]
    return {"mean_wait": out, "lams": np.asarray(lam_grid),
            "sigmas": np.asarray(sigma_grid)}


# ----------------------------------------------------------------------------
# Fleet layer: backlog routing (kernel S6), then the kernels per replica
# ----------------------------------------------------------------------------

def backlog_route(arrivals, work, R: int, device=None,
                  launch_out: Optional[dict] = None) -> np.ndarray:
    """Kernel twin of ``fleet._backlog_assign_np`` (replica id per
    request), one lane of kernel S6.  A ``launch_out`` dict is filled with
    the launch's inputs and output (see :func:`_launch`)."""
    device = resolve_device(device)
    arr = _f64(arrivals, device)[:, None]
    w = _f64(work, device)[:, None]
    ids = _launch(launch_out, "backlog_scan", backlog_scan, arr, w, int(R))
    return ids[:, 0].cpu().numpy()


def masked_backlog_route(arrivals, work, up, R: int, device=None,
                         launch_out: Optional[dict] = None) -> np.ndarray:
    """Kernel twin of ``fleet._masked_backlog_assign_np``: replica id per
    request under an availability mask ``up`` [n, R] bool (False = down at
    that arrival), one lane of kernel S6."""
    device = resolve_device(device)
    arr = _f64(arrivals, device)[:, None]
    w = _f64(work, device)[:, None]
    mask = torch.as_tensor(np.asarray(up, bool).astype(np.uint8),
                           device=device)[:, :, None]
    ids = _launch(launch_out, "backlog_scan", backlog_scan, arr, w, int(R),
                  mask)
    return ids[:, 0].cpu().numpy()


def simulate_fleet_fast(router, policy: BatchPolicy, lam: float, R: int,
                        dist: Optional[TokenDistribution], lat,
                        num_requests: int = 100_000, seed: int = 0,
                        traffic=None, sessions=None, memory=None,
                        device=None, launch_out: Optional[dict] = None) -> dict:
    """Fast twin of :func:`repro_torch.core.fleet.route_oracle`: the
    router's split is identical (state-dependent assignment on kernel S6),
    and each replica's sub-workload runs through the policy's
    single-server kernel (the oracle when it has none).  ``traffic``
    modulates the arrival stream before routing, exactly like the oracle
    twin's parameter.  A ``launch_out`` dict is filled with the routing
    launch (see :func:`backlog_route`).  Sessions and memory budgets are
    not ported yet and raise (ROADMAP.md M7c, M7d)."""
    from repro_torch.core.fleet import router_from_spec, run_fleet
    check_no_m7_layers(sessions=sessions, memory=memory)
    device = resolve_device(device)
    router = router_from_spec(router)
    fw = router.fleet_workload(policy, lam, dist, lat, num_requests, seed,
                               R, fast=True, traffic=traffic, device=device,
                               launch_out=launch_out)
    return run_fleet(fw, policy, lat, dist,
                     lambda pol, wl: simulate_policy_fast(
                         pol, lam, dist, lat, workload=wl, device=device))
