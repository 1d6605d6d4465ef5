"""Multi-device grid sweeps: the counterpart of ``repro.core.shardsweep``,
with the sweep lanes split over a 1-D ``"cells"`` mesh of devices.

:mod:`repro_torch.core.fastsim` stacks every (λ, policy) / (λ, σ) grid cell
as a *lane* of one scan-kernel launch ([n, lanes], lanes minor).  This
module splits the lane axis into ``mesh.size`` contiguous shards (the split
of the reference's ``P("cells")``), launches the UNCHANGED kernel on each
shard on its own device (:func:`repro_torch.distributed.sharding.cells_mesh`),
copies the shards back and cuts off the padding.  One process drives every
device; lanes are independent and there is no collective, so each lane's
result is bit-equal to the single-device path.

Two invariants make the equality exact:

  * **Lane padding duplicates real lanes** (``np.arange(Lp) % n``): the lane
    count pads to :func:`pad_lane_count`, a power of two that the mesh
    divides, and a duplicated lane computes the trajectory of the lane it
    copies; it is cut off the output.
  * **Row padding appends inert tail entries** (arrivals +inf, tokens and
    work 0): a scan's output at request i reads only requests 0..i, so
    entries after a lane's true length never change its first n outputs.
    Replica sub-streams of ragged lengths share one launch that way.

Entry points mirror their single-device twins and take ``mesh=None`` (every
visible CUDA device):

  * :func:`sweep`        ``fastsim.sweep`` with the S1 lanes on the mesh
    (:func:`lane_executor`).
  * :func:`sweep_noise`  ``fastsim.sweep_noise`` with the S5 lanes on the
    mesh (:func:`srpt_executor`); multi-bin and WAIT keep their one launch.
  * :func:`fleet_sweep`  ``fleet.sweep`` as a handful of launches for the
    whole (R, λ) grid: every state-dependent cell's routing is a lane of
    one S6 launch (:func:`_stacked_assign`), then every replica sub-stream
    of every cell a lane of one S1 launch per power-of-two row-length
    bucket, aggregated per cell as ``fleet.run_fleet`` does.  Policies
    without a ``batch_scan`` lane, or with ``n_max``, run ``fleet.sweep``.

On a mesh of CPU entries (``cells_mesh(["cpu"] * 4)``) the shards run the
kernels' plain versions one after another; the CPU tests hold that path to
the single-device twins and to the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import fastsim, fleet
from repro_torch.core.fastsim import _batch_lane_stats, _f64, _law
from repro_torch.core.fleet import (
    FleetWorkload, RoutingPolicy, _aggregate, _sub_workload, router_from_spec,
    served_slice)
from repro_torch.core.policies import BatchPolicy
from repro_torch.distributed.sharding import CellsMesh, cells_mesh
from repro_torch.kernels.backlog_scan import backlog_scan
from repro_torch.kernels.batch_scan import NO_CAP, batch_scan
from repro_torch.kernels.srpt_scan import srpt_scan


def pad_lane_count(n: int, ndev: int) -> int:
    """Padded lane count: next power of two >= max(n, 2), rounded up to a
    multiple of ``ndev`` so the lanes split evenly (for the usual
    power-of-two device counts the power of two is already a multiple)."""
    L = max(1 << max(n - 1, 1).bit_length(), 2)
    if L % ndev:
        L = -(-L // ndev) * ndev
    return L


def _device(dev: torch.device):
    """Make ``dev`` the current CUDA device while a shard launches: the
    kernels launch on the current device, into the stream of their
    tensors' device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _on_mesh(mesh: CellsMesh, fn, lane_args, shared):
    """Run the scan wrapper ``fn(*lane_args, *shared)`` with the lanes (the
    last axis of each of ``lane_args``) split over ``mesh``: pad the lanes
    by duplication, launch each contiguous shard on its device, then copy
    the outputs back to the first argument's device and cut the padding.
    ``shared`` (the batch law, R) goes to every shard as it is."""
    home = lane_args[0].device
    n = lane_args[0].shape[-1]
    Lp = pad_lane_count(n, mesh.size)
    if Lp != n:
        idx = torch.as_tensor(np.arange(Lp) % n, device=home)
        lane_args = [a.index_select(-1, idx) for a in lane_args]
    step = Lp // mesh.size
    outs = []
    for k, dev in enumerate(mesh.devices):
        with _device(dev):
            outs.append(fn(*(a[..., k * step:(k + 1) * step].to(dev)
                             for a in lane_args), *shared))
    if torch.is_tensor(outs[0]):
        return torch.cat([o.to(home) for o in outs], dim=-1)[..., :n]
    return tuple(torch.cat([o[j].to(home) for o in outs], dim=-1)[..., :n]
                 for j in range(len(outs[0])))


def lane_executor(mesh: Optional[CellsMesh] = None):
    """The ``lane_scan`` hook of :func:`repro_torch.core.fastsim.sweep`: a
    drop-in for its S1 launch (``batch_scan(arr, tok, elastic, b_max, k1,
    k2, k3, k4)``, [n, lanes] lanes minor) with the lanes on ``mesh``."""
    mesh = cells_mesh() if mesh is None else mesh

    def scan(arr, tok, elastic, b_max, k1, k2, k3, k4):
        return _on_mesh(mesh, batch_scan, [arr, tok, elastic, b_max],
                        (k1, k2, k3, k4))

    return scan


def srpt_executor(mesh: Optional[CellsMesh] = None):
    """The ``srpt_loop`` hook of :func:`repro_torch.core.fastsim.sweep_noise`:
    a drop-in for its S5 launch (``srpt_scan(arr, tok, order, b_max, k1, k2,
    k3, k4)``) with the lanes on ``mesh``."""
    mesh = cells_mesh() if mesh is None else mesh

    def loop(arr, tok, order, b_max, k1, k2, k3, k4):
        return _on_mesh(mesh, srpt_scan, [arr, tok, order, b_max],
                        (k1, k2, k3, k4))

    return loop


def _stacked_assign(router, jobs, mesh: CellsMesh):
    """Route every state-dependent job ``(key, arrivals, work, R)`` as one
    lane of an S6 launch on ``mesh``.  Rows pad with +inf arrivals and 0
    work; the replica axis pads to the jobs' R_max with the masked kernel,
    a lane's padding replicas down at every arrival: ``up ? v : +inf`` never
    lets one win over a real replica's finite backlog, and ties keep the
    lowest index, so each lane's ids equal ``router.assign(..., fast=True)``
    bit for bit (the reference seeds its padding replicas at +inf).
    Returns {key: replica ids}."""
    if not jobs:
        return {}
    r_max = max(R for *_, R in jobs)
    rows = max(len(a) for _, a, _, _ in jobs)
    arr = np.full((rows, len(jobs)), np.inf)
    wrk = np.zeros((rows, len(jobs)))
    up = np.zeros((rows, r_max, len(jobs)), np.uint8)
    for j, (_, a, w, R) in enumerate(jobs):
        arr[:len(a), j] = a
        wrk[:len(w), j] = router._work_units(np.asarray(w, np.float64))
        up[:, :R, j] = 1
    home = mesh.devices[0]
    ids = _on_mesh(mesh, lambda a, w, u, R: backlog_scan(a, w, R, u),
                   [_f64(arr, home), _f64(wrk, home),
                    torch.as_tensor(up, device=home)], (r_max,))
    ids = ids.cpu().numpy()
    return {key: ids[:len(a), j] for j, (key, a, _, _) in enumerate(jobs)}


# ----------------------------------------------------------------------------
# Public entry points (signatures mirror the single-device twins + mesh)
# ----------------------------------------------------------------------------

def sweep(policies: dict, lam_grid, dist, lat, num_requests: int = 100_000,
          seed: int = 0, mesh: Optional[CellsMesh] = None) -> dict:
    """:func:`repro_torch.core.fastsim.sweep` with the (λ, policy) batching
    lanes split over the mesh (the other cells on its first device): the
    same return, bit-equal values."""
    mesh = cells_mesh() if mesh is None else mesh
    return fastsim.sweep(policies, lam_grid, dist, lat,
                         num_requests=num_requests, seed=seed,
                         device=mesh.devices[0],
                         lane_scan=lane_executor(mesh))


def sweep_noise(policy_factory, lam_grid, sigma_grid, dist, lat,
                num_requests: int = 50_000, seed: int = 0,
                mesh: Optional[CellsMesh] = None) -> dict:
    """:func:`repro_torch.core.fastsim.sweep_noise` with the (λ, σ) SRPT
    lanes split over the mesh: the same return, bit-equal values."""
    mesh = cells_mesh() if mesh is None else mesh
    return fastsim.sweep_noise(policy_factory, lam_grid, sigma_grid, dist,
                               lat, num_requests=num_requests, seed=seed,
                               srpt_loop=srpt_executor(mesh),
                               device=mesh.devices[0])


def fleet_sweep(R_grid, lam_grid, router, policy: BatchPolicy, dist, lat,
                num_requests: int = 50_000, seed: int = 0,
                mesh: Optional[CellsMesh] = None) -> dict:
    """The mesh twin of :func:`repro_torch.core.fleet.sweep`: route every
    (R, λ) cell on the host (the same split machinery; the state-dependent
    routers' cells as lanes of one S6 launch), then run every replica
    sub-stream of every cell as a lane of one S1 launch per power-of-two
    row-length bucket, and aggregate per cell as ``fleet.run_fleet`` does.
    Values are bit-equal to ``fleet.sweep``.  Policies without a
    ``batch_scan`` lane (or with an ``n_max`` admission cap) run
    ``fleet.sweep`` on the mesh's first device."""
    mesh = cells_mesh() if mesh is None else mesh
    router = router_from_spec(router)
    R_grid = [int(r) for r in R_grid]
    lam_grid = [float(l) for l in lam_grid]
    lane = policy.scan_lane() if policy.fast_kernel == "batch_scan" else None
    if lane is None or policy.n_max is not None:
        return fleet.sweep(R_grid, lam_grid, router, policy, dist, lat,
                           num_requests=num_requests, seed=seed,
                           device=mesh.devices[0])
    elastic, b_max = lane

    # ---- routing: one workload sample per λ, one stacked S6 launch ----
    # The base fleet_workload samples the SAME (λ, seed) stream for every R
    # and splits it per cell; here the sample is shared across the R column.
    # Routers that override fleet_workload (random's exact per-replica
    # superposition) keep their own per-cell construction.
    fws = {}
    if type(router).fleet_workload is RoutingPolicy.fleet_workload:
        wl_of = {lam: policy.sample_workload(lam, dist, num_requests, seed)
                 for lam in lam_grid}
        work_of = {lam: router.routing_work(wl_of[lam], lat, seed)
                   for lam in lam_grid}
        cells = [(R, lam) for R in R_grid for lam in lam_grid if R > 1]
        if router.state_dependent:
            assigns = _stacked_assign(
                router, [((R, lam), wl_of[lam].arrivals, work_of[lam], R)
                         for R, lam in cells], mesh)
        else:
            assigns = {(R, lam): router.assign(
                wl_of[lam].arrivals, work_of[lam], R, seed, fast=True,
                sessions=wl_of[lam].session) for R, lam in cells}
        for R in R_grid:
            for lam in lam_grid:
                wl = wl_of[lam]
                if R == 1:
                    fws[R, lam] = FleetWorkload(
                        [wl], np.zeros(len(wl.arrivals), np.int64),
                        wl.arrivals, 1)
                    continue
                rep = np.asarray(assigns[R, lam], np.int64)
                subs = [_sub_workload(wl, np.nonzero(rep == r)[0])
                        for r in range(R)]
                fws[R, lam] = FleetWorkload(subs, rep, wl.arrivals, R)
    else:
        for R in R_grid:
            for lam in lam_grid:
                fws[R, lam] = router.fleet_workload(
                    policy, lam, dist, lat, num_requests, seed, R, fast=True,
                    device=mesh.devices[0])

    # ---- one lane per non-empty replica sub-stream ----
    lane_wls = []
    slots_of = {}             # (R, λ) -> per replica: None or lane index
    for key, fw in fws.items():
        slots = []
        for wl in fw.replicas:
            wl = served_slice(policy, wl)
            if len(wl.arrivals) == 0:
                slots.append(None)      # run_fleet's empty-replica None
                continue
            slots.append(len(lane_wls))
            lane_wls.append(wl)
        slots_of[key] = slots

    # ---- one S1 launch per power-of-two row-length bucket ----
    # A bucket's lanes pad to its longest lane with +inf arrivals and 0
    # tokens, inert past each lane's true length, so every lane's prefix
    # equals the lane run alone.  Bucketing keeps the short replica streams
    # of a large R from being stretched to the grid's longest lane.
    buckets = {}
    for j, wl in enumerate(lane_wls):
        rows = max(1 << max(len(wl.arrivals) - 1, 1).bit_length(), 2)
        buckets.setdefault(rows, []).append(j)
    scan = lane_executor(mesh)
    law = _law(lat)
    home = mesh.devices[0]
    cap = NO_CAP if b_max is None else float(b_max)
    stats = [None] * len(lane_wls)
    for _, idxs in sorted(buckets.items()):
        rows = max(len(lane_wls[j].arrivals) for j in idxs)
        arr = np.full((rows, len(idxs)), np.inf)
        tok = np.zeros((rows, len(idxs)))
        for c, j in enumerate(idxs):
            wl = lane_wls[j]
            arr[:len(wl.arrivals), c] = wl.arrivals
            tok[:len(wl.tokens), c] = wl.tokens
        starts, closed = scan(
            _f64(arr, home), _f64(tok, home),
            torch.full((len(idxs),), bool(elastic), device=home),
            torch.full((len(idxs),), cap, dtype=torch.float64, device=home),
            *law)
        starts, closed = starts.cpu().numpy(), closed.cpu().numpy()
        for c, j in enumerate(idxs):
            n = len(lane_wls[j].arrivals)
            stats[j] = _batch_lane_stats(starts[:n, c], closed[:n, c],
                                         lane_wls[j].arrivals)

    out = np.empty((len(R_grid), len(lam_grid)))
    for ri, R in enumerate(R_grid):
        for li, lam in enumerate(lam_grid):
            per = [None if s is None else stats[s]
                   for s in slots_of[R, lam]]
            out[ri, li] = _aggregate(per, fws[R, lam])["mean_wait"]
    return {"mean_wait": out, "R_grid": np.asarray(R_grid),
            "lams": np.asarray(lam_grid)}


__all__ = [
    "cells_mesh", "fleet_sweep", "lane_executor", "pad_lane_count",
    "srpt_executor", "sweep", "sweep_noise",
]
