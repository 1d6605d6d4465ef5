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
    S2 (``kernels/impatience_scan``), a lane a block.
  * ``"batch_scan"``   dynamic / elastic batch formation as a per-request
    scan with an O(1) carry (start, count, token sum, token max): kernel
    S1 (``kernels/batch_scan``), one thread walking each lane, a lane a
    block.
  * ``"fixed_cummax"`` closed form: the free-time recursion
    F_k = max(F_{k-1}, A_k) + H_k telescopes to a running maximum (host
    NumPy, as in the reference).
  * ``"multibin"``, ``"wait"``, ``"srpt"``   the batch-event disciplines,
    one step per batch: kernels S3 (``kernels/multibin_scan``), one warp
    per lane, S4 (``kernels/wait_scan``), one warp per lane, and S5
    (``kernels/srpt_scan``), one block per lane.  The host supplies each request's bin (S3) or the rank order of a
    stable argsort of the lengths (S5), from the workload's PREDICTED
    column where it has one; the service law always sees the true tokens.

``sweep(policies, lam_grid, ...)`` stacks every (λ, policy) cell whose
policy rides the batching scan as a lane of ONE S1 launch, and every cell
of an FCFS policy with impatience as a lane of ONE S2 launch; the other
policies dispatch through ``KERNELS`` per cell, as the reference does.
``sweep_noise`` sweeps the (arrival rate, prediction noise) plane: when
every policy rides SRPT (or multi-bin, or WAIT), all its cells are lanes
of ONE S5 (or S3, or S4) launch.

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

Re-entrant sessions (``sessions=``) run the feedback fixed point of
:mod:`repro_torch.core.sessions` with these kernels as its inner pass: one
launch of S1, S3, S4 or S5 a pass and a replica, and S6 for the backlog
routers of a fleet.

KV-memory budgets (``memory=``) switch batch service to the prefill/decode
tandem of :mod:`repro_torch.core.memory`: dynamic formation (the
non-elastic ``batch_scan`` lane) runs the tandem as kernel S7
(``kernels/tandem_scan``), with or without a fault trace; elastic and the
batch-event policies (fixed, multi-bin, WAIT, SRPT) run the tandem oracle on
the host, as the reference dispatches them (their per-request releases and
non-contiguous batches have no compiled twin there either).

Closed-loop control (``run_controlled``) runs
:func:`repro_torch.core.control.simulate_controlled` on these kernels: one
``simulate_policy_fast`` a replica a window.

``sweep(lane_scan=)`` and ``sweep_noise(srpt_loop=)`` take a drop-in for
their one S1 or S5 launch: :mod:`repro_torch.core.shardsweep` passes its
executors, which split the lanes over a mesh of devices.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.distributions import TokenDistribution
from repro_torch.core.latency_model import BatchLatencyModel, LatencyModel
from repro_torch.core.policies import (
    BatchPolicy, DynamicPolicy, ElasticPolicy, FCFSPolicy, FixedPolicy,
    policy_from_spec, single_from_batch)
from repro_torch.core.simulate import (
    _warm, _with_fault_trace, simulate_fixed_batching, simulate_policy)
from repro_torch.kernels import resolve_device
from repro_torch.kernels.backlog_scan import backlog_scan
from repro_torch.kernels.batch_scan import NO_CAP, batch_scan
from repro_torch.kernels.impatience_scan import impatience_scan
from repro_torch.kernels.multibin_scan import multibin_scan
from repro_torch.kernels.srpt_scan import srpt_scan
from repro_torch.kernels.tandem_scan import tandem_scan
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
                         sessions=None, prefix_discount: float = 0.0,
                         memory=None, device=None,
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
    sees the workload; a null model never warps.

    ``sessions`` re-enters completed turns exactly like the oracle twin's
    parameter: the same feedback fixed point
    (:func:`repro_torch.core.sessions.simulate_policy_sessions`) runs with
    the kernels as its inner pass, a launch a pass (``launch_out`` is
    then not filled); a null model takes the session-free path.

    ``memory`` switches batch service to the prefill/decode tandem with
    KV-budget admission, exactly like the oracle twin's parameter: the
    dynamic (``batch_scan``, non-elastic) lane launches kernel S7
    (bit-equal trajectories); elastic and the batch-event policies run the
    tandem oracle on the host, the reference's dispatch by policy.  A
    null budget takes the budget-free path."""
    mem = _memory_budget(policy, memory)
    device = resolve_device(device)
    if sessions is not None:
        from repro_torch.core.sessions import (session_from_spec,
                                               simulate_policy_sessions)
        model = session_from_spec(sessions)
        if not model.is_null:
            if mem is not None:
                raise ValueError(
                    "sessions= x memory= is not supported: turn re-entry "
                    "holds KV across think times (a different occupancy "
                    "law); run the tandem on the expanded per-turn stream "
                    "instead")
            if workload is not None:
                raise ValueError("sessions= expands its own workload; "
                                 "pass lam/num_requests/seed instead of "
                                 "workload=")
            return simulate_policy_sessions(
                policy, lam, dist, lat, num_requests, seed, model,
                fault_trace=fault_trace, traffic=traffic,
                prefix_discount=prefix_discount, fast=True, device=device)
    if policy.uses_single_latency and isinstance(lat, BatchLatencyModel):
        lat = single_from_batch(lat)
    if traffic is not None:
        from repro_torch.core.traffic import traffic_from_spec, warp_workload
        tm = traffic_from_spec(traffic)
        if not tm.is_null:
            wl = workload if workload is not None else \
                policy.sample_workload(lam, dist, num_requests, seed)
            workload = warp_workload(wl, tm, seed)
    if mem is not None and not _on_s7(policy):
        # elastic (per-request release times) and the batch-event policies
        # (non-contiguous membership): the tandem oracle, as the reference
        # dispatches them; traffic already applied
        return simulate_policy(policy, lam, dist, lat,
                               num_requests=num_requests, seed=seed,
                               workload=workload, fault_trace=fault_trace,
                               memory=mem)
    if policy.fast_kernel is None:
        return simulate_policy(policy, lam, dist, lat,
                               num_requests=num_requests, seed=seed,
                               workload=workload, fault_trace=fault_trace)

    def run(wl):
        if mem is not None:
            # the batch_scan lane's tandem: one lane of kernel S7
            wl = wl if wl is not None else \
                policy.sample_workload(lam, dist, num_requests, seed)
            return tandem_lanes([(wl, mem, policy.b_max)], lat, device,
                                launch_out)[0]
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
    return _impatience_stats(waits[:, 0].cpu().numpy(),
                             lost[:, 0].cpu().numpy())


def _impatience_stats(waits, lost) -> dict:
    """One S2 lane's statistics from its waits and lost flags (numpy)."""
    waits_w, lost_w = _warm(waits), _warm(lost)
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


def _scan_lanes(arr, tok, lanes, lat, device, launch_out=None, scan=None):
    """Kernel S1 over stacked lanes: arr, tok [n, lanes] numpy, lanes
    minor; ``lanes`` a list of (elastic, b_max).  ``scan`` replaces the
    ``batch_scan`` launch (same arguments).  Returns (starts, closed) as
    [n, lanes] numpy."""
    elastic = torch.tensor([bool(e) for e, _ in lanes], device=device)
    b_max = _f64([NO_CAP if bm is None else float(bm) for _, bm in lanes],
                 device)
    starts, closed = _launch(launch_out, "batch_scan",
                             batch_scan if scan is None else scan,
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
# Prefill/decode tandem under a KV budget (kernel S7)
# ----------------------------------------------------------------------------

def _memory_budget(policy: BatchPolicy, memory):
    """The KV budget ``memory`` names, checked against ``policy``; None for
    no budget or a null one."""
    if memory is None:
        return None
    from repro_torch.core.memory import (check_policy_supports_memory,
                                         memory_from_spec)
    mem = memory_from_spec(memory)
    if mem.is_null:
        return None
    check_policy_supports_memory(policy)
    return mem


def _on_s7(policy: BatchPolicy) -> bool:
    """Whether the policy's tandem runs as kernel S7: dynamic formation,
    the non-elastic ``batch_scan`` lane (elastic and the batch-event
    policies run the tandem oracle)."""
    lane = policy.scan_lane()
    return lane is not None and not lane[0]


def tandem_lanes(cells, lat, device=None,
                 launch_out: Optional[dict] = None) -> list:
    """Kernel S7 over stacked lanes: the memory-gated tandem of dynamic
    formation with padded decode, one lane a cell.  ``cells`` is a list of
    (workload, :class:`~repro_torch.core.memory.MemoryBudget`, b_max)
    (b_max None or 0 for no cap, as the oracle reads it); lanes of fewer
    requests are padded with +inf arrivals.  The footprint prefix sums are
    summed on the host with ``np.cumsum``, in the order of the oracle's
    running total.  Returns each lane's statistics, those of the tandem
    oracle (``waits`` warm-trimmed, ``memory`` the occupancy block); a
    ``launch_out`` dict is filled with the launch (see :func:`_launch`)."""
    from repro_torch.core.memory import occupancy_stats
    device = resolve_device(device)
    L = max([len(wl.arrivals) for wl, _, _ in cells], default=0)
    lanes = len(cells)
    arr = np.full((L, lanes), np.inf)
    tok = np.zeros((L, lanes))
    fp_cum = np.full((L + 1, lanes), np.inf)
    fp_cum[0] = 0.0
    fps = []
    for c, (wl, budget, _) in enumerate(cells):
        n = len(wl.arrivals)
        fp = budget.footprint(wl.tokens)
        if n and float(fp.max()) > budget.capacity:
            raise ValueError(
                f"memory budget {budget.capacity} cannot hold the largest "
                f"single request (footprint {float(fp.max())}); no schedule "
                "exists")
        arr[:n, c], tok[:n, c] = wl.arrivals, wl.tokens
        # +inf past n keeps the admission search off the padding
        fp_cum[1:n + 1, c] = np.cumsum(fp)
        fps.append(fp)
    caps = [float(budget.capacity) for _, budget, _ in cells]
    b_max = [float(bm) if bm else NO_CAP for _, _, bm in cells]
    out = _launch(launch_out, "tandem_scan", tandem_scan, _f64(arr, device),
                  _f64(tok, device), _f64(fp_cum, device), _f64(caps, device),
                  _f64(b_max, device), *_law(lat))
    starts, ends, dends, nbs, blocked, blocked_t, deferred = (
        t.cpu().numpy() for t in out)
    stats = []
    for c, (wl, _, _) in enumerate(cells):
        nb, n = int(nbs[c]), len(wl.arrivals)
        sizes = np.diff(ends[:nb, c], prepend=0)
        starts_req = np.repeat(starts[:nb, c], sizes)  # batches are contiguous
        comps_req = np.repeat(dends[:nb, c], sizes)
        w = _warm(starts_req - wl.arrivals)
        mem = occupancy_stats(starts_req, comps_req, fps[c], caps[c])
        mem["blocked_batches"] = int(blocked[c])
        mem["blocked_time"] = float(blocked_t[c])
        mem["deferred_requests"] = int(deferred[c])
        stats.append({
            "mean_wait": float(w.mean()) if w.size else 0.0,
            "p95_wait": float(np.percentile(w, 95)) if w.size else 0.0,
            "mean_batch": float(n / max(nb, 1)),
            "waits": w,
            "memory": mem,
        })
    return stats


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


def impatience_lane_inputs(policies: dict, lam_grid, dist, lat,
                           num_requests: int = 100_000, seed: int = 0):
    """The lanes ``sweep`` stacks into its one S2 launch: every (policy, λ)
    cell whose policy runs the ``mg1`` kernel with a ``tau``.  Returns
    (lanes, inter, service, tau): a list of (name, lam_index), the [n,
    lanes] float64 inter-arrival and service times, lanes minor as S2 takes
    them (each lane's workload sampled by its own policy, so ``n_max``
    clips per lane, and timed by the single-request law, as
    :func:`simulate_policy_fast` times it), and the [lanes] patience."""
    lanes, inter, service, tau = [], [], [], []
    for name, pol in _instances(policies).items():
        if pol.fast_kernel != "mg1" or pol.tau is None:
            continue
        law = single_from_batch(lat) if pol.uses_single_latency and \
            isinstance(lat, BatchLatencyModel) else lat
        for li, lam in enumerate(lam_grid):
            wl = pol.sample_workload(lam, dist, num_requests, seed)
            lanes.append((name, li))
            inter.append(wl.inter)
            service.append(np.asarray(law.service_time(wl.tokens), np.float64))
            tau.append(float(pol.tau))
    if not lanes:
        empty = np.zeros((num_requests, 0))
        return lanes, empty, empty, np.zeros(0)
    return lanes, np.stack(inter, axis=1), np.stack(service, axis=1), \
        np.asarray(tau, np.float64)


def sweep(policies: dict, lam_grid, dist, lat,
          num_requests: int = 100_000, seed: int = 0, device=None,
          scan_out: Optional[dict] = None,
          lane_scan: Optional[Callable] = None) -> dict:
    """Mean wait for each policy over an arrival-rate grid — the uniform
    fast entry point.  ``policies``: name -> BatchPolicy (or legacy spec
    dict).  Policies riding the batching scan (``scan_lane() is not
    None``, no ``n_max``) are stacked as lanes of ONE S1 launch
    (:func:`scan_lane_inputs`), FCFS policies with impatience as lanes of
    ONE S2 launch (:func:`impatience_lane_inputs`); every other policy
    dispatches through ``KERNELS`` per (λ, policy) cell (the oracle when it
    has no kernel).  A ``scan_out`` dict is filled with the S1 launch's
    ``lanes``, its inputs ``arr``, ``tok`` and outputs ``starts``,
    ``closed`` ([n, lanes] numpy), under ``impatience`` with the S2
    launch's ``launch_out`` (see :func:`simulate_policy_fast`; its tensors
    as passed and returned) and its ``lanes``, and under ``cells`` with
    each per-cell kernel launch, {(name, lam index): ``launch_out``}, for a
    caller that checks the kernels.  ``lane_scan`` replaces the S1 launch
    (the same arguments and per-lane results as ``batch_scan``):
    :func:`repro_torch.core.shardsweep.lane_executor` splits the lanes over
    a mesh of devices."""
    device = resolve_device(device)
    lam_grid = list(lam_grid)
    insts = _instances(policies)
    lanes, arr, tok = scan_lane_inputs(insts, lam_grid, dist, num_requests,
                                       seed)
    imp, inter, service, tau = impatience_lane_inputs(
        insts, lam_grid, dist, lat, num_requests, seed)
    laned = {name for name, *_ in lanes} | {name for name, _ in imp}
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
                                     lat, device, scan=lane_scan)
        for col, (name, li, _, _) in enumerate(lanes):
            stats = _batch_lane_stats(starts[:, col], closed[:, col],
                                      arr[:, col])
            out[name][li] = stats["mean_wait"]
        if scan_out is not None:
            scan_out.update(lanes=lanes, arr=arr, tok=tok, starts=starts,
                            closed=closed)
    if imp:
        s2 = {"lanes": imp}
        waits, lost = _launch(s2, "impatience_scan", impatience_scan,
                              _f64(inter, device), _f64(service, device),
                              _f64(tau, device))
        waits, lost = waits.cpu().numpy(), lost.cpu().numpy()
        for col, (name, li) in enumerate(imp):
            out[name][li] = _impatience_stats(waits[:, col],
                                              lost[:, col])["mean_wait"]
        if scan_out is not None:
            scan_out["impatience"] = s2
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
    ``_srpt_loop_vmapped``); when every one rides ``multibin``, of ONE
    launch of kernel S3, each lane with its own bin row; when every one
    rides ``wait``, of ONE launch of kernel S4, each lane with its own k,
    timeout and b_max (the reference runs multi-bin and WAIT a cell at a
    time).  SRPT and multi-bin policies must then share b_max (and
    num_bins), else this raises.  A ``launch_out`` dict is filled with that
    launch's inputs and outputs (see :func:`_launch`) and with ``cells``,
    the (λ index, σ index) of each lane.  Otherwise each cell dispatches
    through :func:`simulate_policy_fast` on its own.
    ``srpt_loop`` replaces the S5 launch (the same arguments and per-lane
    results as ``srpt_scan``):
    :func:`repro_torch.core.shardsweep.srpt_executor` splits the SRPT lanes
    over a mesh of devices; multi-bin and WAIT keep their one launch.

    Returns ``{"mean_wait": [len(lam_grid), len(sigma_grid)], "lams",
    "sigmas"}``."""
    device = resolve_device(device)
    lam_grid = [float(l) for l in lam_grid]
    sigma_grid = [float(s) for s in sigma_grid]
    pols = [policy_factory(s) for s in sigma_grid]
    out = np.empty((len(lam_grid), len(sigma_grid)))
    kinds = {p.fast_kernel for p in pols}
    if kinds in ({"srpt"}, {"multibin"}, {"wait"}):
        kind = kinds.pop()
        shared = {(p.b_max, getattr(p, "num_bins", None)) for p in pols}
        if kind != "wait" and len(shared) != 1:
            raise ValueError(f"{kind} lanes must share one b_max (and "
                             f"num_bins), got {sorted(shared, key=str)}")
        cells = [(li, si) for li in range(len(lam_grid))
                 for si in range(len(pols))]
        lane_pols = [pols[si] for _, si in cells]
        wls = [pol.sample_workload(lam_grid[li], dist, num_requests, seed)
               for (li, _), pol in zip(cells, lane_pols)]
        arr = np.stack([wl.arrivals for wl in wls], axis=1)
        tok = np.stack([wl.tokens for wl in wls], axis=1)
        args = (_f64(arr, device), _f64(tok, device))
        b_max = _i64([_cap(pol.b_max) for pol in lane_pols], device)
        if kind == "wait":
            starts, first = _launch(
                launch_out, "wait_scan", wait_scan, *args,
                _i64([pol.k for pol in lane_pols], device),
                _f64([np.inf if pol.timeout is None else pol.timeout
                      for pol in lane_pols], device), b_max, *_law(lat))
        else:
            # S5 takes the rank order of the predicted lengths, S3 the bin
            # of each request (both from the PREDICTED column)
            keys = _i64(np.stack([
                pol.bin_of(wl.predicted_or_true, dist) if kind == "multibin"
                else np.argsort(wl.predicted_or_true, kind="stable")
                for pol, wl in zip(lane_pols, wls)], axis=1), device)
            if kind == "multibin":
                starts, first = _launch(launch_out, "multibin_scan",
                                        multibin_scan, *args, keys,
                                        pols[0].num_bins, b_max, *_law(lat))
            else:
                starts, first = _launch(
                    launch_out, "srpt_scan",
                    srpt_scan if srpt_loop is None else srpt_loop, *args,
                    keys, b_max, *_law(lat))
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
                        traffic=None, sessions=None,
                        prefix_discount: float = 0.0, memory=None,
                        device=None, launch_out: Optional[dict] = None) -> dict:
    """Fast twin of :func:`repro_torch.core.fleet.route_oracle`: the
    router's split is identical (state-dependent assignment on kernel S6),
    and each replica's sub-workload runs through the policy's
    single-server kernel (the oracle when it has none).  ``traffic``
    modulates the arrival stream before routing, exactly like the oracle
    twin's parameter.  A ``launch_out`` dict is filled with the routing
    launch (see :func:`backlog_route`).  ``sessions`` /
    ``prefix_discount`` re-enter completed turns through the fleet
    feedback fixed point
    (:func:`repro_torch.core.sessions.simulate_fleet_sessions`) with the
    kernels as the inner pass (``launch_out`` is then not filled).
    ``memory`` gives EACH replica its own KV budget (capacity is
    per-replica HBM, not a fleet pool) through the unchanged single-server
    tandem: for dynamic batching every non-empty replica is a lane of one
    S7 launch (:func:`tandem_lanes`), each lane's statistics those of the
    replica run alone; the other policies run the tandem oracle a replica.
    A session fleet runs without it, as the reference's does (ROADMAP.md
    queue 3)."""
    from repro_torch.core.fleet import router_from_spec, run_fleet
    device = resolve_device(device)
    router = router_from_spec(router)
    if sessions is not None:
        from repro_torch.core.sessions import (session_from_spec,
                                               simulate_fleet_sessions)
        model = session_from_spec(sessions)
        if not model.is_null:
            return simulate_fleet_sessions(
                router, policy, lam, R, dist, lat, num_requests, seed,
                model, prefix_discount=prefix_discount, traffic=traffic,
                fast=True, device=device)
    fw = router.fleet_workload(policy, lam, dist, lat, num_requests, seed,
                               R, fast=True, traffic=traffic, device=device,
                               launch_out=launch_out)
    mem = _memory_budget(policy, memory)
    if mem is not None and _on_s7(policy):
        def run(wls):
            return tandem_lanes([(wl, mem, policy.b_max) for wl in wls],
                                lat, device)
    else:
        def run(wls):
            return [simulate_policy_fast(policy, lam, dist, lat, workload=wl,
                                         memory=memory, device=device)
                    for wl in wls]
    return run_fleet(fw, policy, lat, dist, run)


def run_controlled(policy, lam, dist, lat, **kw):
    """Closed-loop time-sliced control on the fast path: the kernels run
    every window (one launch a replica a window, on ``device=``), the
    controller re-picks replicas / router / bin_edges / shed_prob between
    windows.  Thin wrapper over
    :func:`repro_torch.core.control.simulate_controlled` with
    ``fast=True`` (pass ``fast=False`` there for the oracle twin)."""
    from repro_torch.core.control import simulate_controlled
    kw.setdefault("fast", True)
    return simulate_controlled(policy, lam, dist, lat, **kw)
