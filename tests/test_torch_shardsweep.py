"""The port's mesh sweeps (``repro_torch.core.shardsweep``) and sharding
rules (``repro_torch.distributed.sharding``) on the CPU, against the JAX
package.

A mesh of CPU entries (``cells_mesh(["cpu"] * m)``) splits the lanes into m
shards that run the kernels' plain versions one after another.  On meshes
of 1 to 4 entries every sweep must EQUAL (``np.array_equal``) the port's
single-device twin (``fastsim.sweep``, ``fastsim.sweep_noise``,
``fleet.sweep``), which equals the NumPy oracle bit for bit; the fleet
sweep and the sweeps' lanes are also held to the JAX package's NumPy
oracle bit for bit.  The JAX package's compiled ``shardsweep`` is held
within ``SCAN_ATOL`` = 1e-10 s: XLA on the CPU contracts its batch time
into fused multiply-adds, so its means sit up to about 2e-12 s off its own
oracle's (see ``tests/test_torch_simfast.py``).

The reference's scans run under ``jax.experimental.enable_x64``, which JAX
0.9 removed; the module's fixture puts back a shim that calls
``jax.enable_x64(True)``, only when the attribute is missing (the JAX
package is not edited)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import predictors as j_pred  # noqa: E402
from repro.core import shardsweep as j_ss  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402
from repro.distributed import sharding as j_shard  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models.params import Spec as JSpec  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import predictors as t_pred  # noqa: E402
from repro_torch.core import shardsweep as t_ss  # noqa: E402
from repro_torch.distributed import sharding as t_shard  # noqa: E402
from repro_torch.distributed import cells_mesh  # noqa: E402
from repro_torch.kernels.backlog_scan import backlog_scan  # noqa: E402
from repro_torch.kernels.batch_scan import NO_CAP, batch_scan  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

SCAN_ATOL = 1e-10
LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
LAMS = [0.05, 0.1, 0.15]
MESHES = [1, 2, 3, 4]
ROUTERS = ["jsq", "round_robin", "least_work", "random"]
R_GRID = [1, 2, 3, 4]
N_SWEEP, N_NOISE, N_FLEET = 2000, 1500, 1000
NOISE_LAMS, SIGMAS = [0.1, 0.2], [0.0, 0.5, 1.0]


@pytest.fixture(scope="module")
def cache():
    """Results computed once for the module (the reference's under the
    ``enable_x64`` shim): ``cache(key, fn)`` returns ``fn()``'s result,
    computed at the first call with that key."""
    store = {}
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64",
                       lambda: jax.enable_x64(True), raising=False)

        def get(key, fn):
            if key not in store:
                store[key] = fn()
            return store[key]
        yield get


def law(mod):
    return mod.BatchLatencyModel(**LAT)


def sweep_policies(mod):
    # fcfs: a per-cell policy beside the S1 lanes
    return {"dynamic": mod.DynamicPolicy(),
            "elastic": mod.ElasticPolicy(b_max=8), "fcfs": mod.FCFSPolicy()}


def srpt_factory(pol, pred):
    return lambda s: pol.SRPTPolicy(b_max=16,
                                    predictor=pred.LogNormalNoisePredictor(s))


def cpu_mesh(m):
    return cells_mesh(["cpu"] * m)


# ----------------------------------------------------------------------------
# The mesh and the rule tables
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_pad_lane_count_equals_reference(ndev):
    for n in range(1, 41):
        L = t_ss.pad_lane_count(n, ndev)
        assert L == j_ss.pad_lane_count(n, ndev), (n, ndev)
        assert L >= n and L % ndev == 0


def test_rule_tables_equal_reference():
    for name in ("DEFAULT_RULES", "FSDP_RULES", "SEQPAR_RULES",
                 "SWEEP_RULES"):
        assert getattr(t_shard, name) == getattr(j_shard, name), name


MESH_SHAPES = {"data16_model16": {"data": 16, "model": 16},
               "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
               "data8_model16": {"data": 8, "model": 16}}


@pytest.mark.parametrize("mesh_name", sorted(MESH_SHAPES))
@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "FSDP_RULES",
                                   "SEQPAR_RULES"])
def test_logical_to_spec_equals_reference(rules, mesh_name):
    """Every leaf of every config's param specs (the config's own rule
    overrides applied), with and without its shape, on a device-free mesh
    of the reference's (``AbstractMesh``) and the port's (a namespace with
    ``axis_names`` and ``shape``)."""
    shape = MESH_SHAPES[mesh_name]
    j_mesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    t_mesh = type("Mesh", (), {"axis_names": tuple(shape),
                               "shape": dict(shape)})()
    sharded = 0
    for arch in j_configs.ARCH_IDS:
        j_cfg, t_cfg = j_configs.get_config(arch), t_configs.get_config(arch)
        table = dict(getattr(t_shard, rules), **dict(t_cfg.sharding_overrides))
        j_table = dict(getattr(j_shard, rules),
                       **dict(j_cfg.sharding_overrides))
        assert table == j_table
        j_leaves = jax.tree.leaves(j_model.param_specs(j_cfg),
                                   is_leaf=lambda x: isinstance(x, JSpec))
        t_leaves = tree_leaves(t_model.param_specs(t_cfg))
        assert len(j_leaves) == len(t_leaves) > 0, arch
        for js, ts in zip(j_leaves, t_leaves):
            assert (ts.shape, ts.axes) == (js.shape, js.axes), arch
            for shp in (ts.shape, None):
                want = tuple(j_shard.logical_to_spec(js.axes, j_table,
                                                     j_mesh, shp))
                got = t_shard.logical_to_spec(ts.axes, table, t_mesh, shp)
                assert got == want, (arch, ts.axes, shp, got, want)
                sharded += any(e is not None for e in got)
    assert sharded > 0


def test_logical_to_spec_rules_of_the_resolver():
    """The four rules on hand-made cases: axes missing from the mesh drop,
    a dimension that does not divide replicates, the first use of a mesh
    axis wins, trailing Nones trim."""
    mesh = type("Mesh", (), {"axis_names": ("data", "model"),
                             "shape": {"data": 4, "model": 8}})()
    spec = t_shard.logical_to_spec
    rules = t_shard.DEFAULT_RULES
    assert spec(("batch", "embed"), rules, mesh, (8, 64)) == ("data",)
    assert spec(("batch", "heads"), rules, mesh, (6, 12)) == ()
    assert spec(("heads", "kv_heads"), rules, mesh, (16, 16)) == ("model",)
    assert spec(("embed", "ffn"), rules, mesh, (64, 64)) == (None, "model")
    pod = type("Mesh", (), {"axis_names": ("pod", "data"),
                            "shape": {"pod": 2, "data": 4}})()
    assert spec(("batch",), rules, pod, (16,)) == (("pod", "data"),)
    assert spec(("lanes",), t_shard.SWEEP_RULES, cpu_mesh(4), (8,)) == \
        ("cells",)


def test_cells_mesh(monkeypatch):
    m = cpu_mesh(4)
    assert m.size == 4 and m.shape == {"cells": 4}
    assert m.axis_names == ("cells",)
    assert m.devices == (torch.device("cpu"),) * 4
    assert cells_mesh([torch.device("cpu")]) == cpu_mesh(1)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        cells_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        cells_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ss.sweep({"d": t_pol.DynamicPolicy()}, [0.1], t_dist.LogNormalTokens(),
                   law(t_lat), num_requests=50)


# ----------------------------------------------------------------------------
# The scans' padding invariants, on the plain versions
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("elastic,b_max", [(False, None), (True, 8),
                                           (False, 4)])
def test_inf_tails_are_inert_in_the_batching_scan(elastic, b_max):
    """Ragged lanes padded to one length with +inf arrivals and 0 tokens:
    each lane's first n outputs equal the lane run alone."""
    wls = [t_pol.DynamicPolicy().sample_workload(lam, t_dist.LogNormalTokens(),
                                                 n, seed)
           for lam, n, seed in ((0.1, 700, 0), (0.5, 1200, 1), (0.05, 64, 2))]
    rows = max(len(w.arrivals) for w in wls)
    arr = np.full((rows, len(wls)), np.inf)
    tok = np.zeros((rows, len(wls)))
    for j, w in enumerate(wls):
        arr[:len(w.arrivals), j], tok[:len(w.tokens), j] = w.arrivals, w.tokens
    cap = NO_CAP if b_max is None else float(b_max)
    lanes = len(wls)
    s, c = batch_scan(torch.from_numpy(arr), torch.from_numpy(tok),
                      torch.full((lanes,), elastic),
                      torch.full((lanes,), cap, dtype=torch.float64),
                      *LAT.values())
    for j, w in enumerate(wls):
        n = len(w.arrivals)
        s1, c1 = batch_scan(torch.from_numpy(w.arrivals[:, None]),
                            torch.from_numpy(w.tokens[:, None]),
                            torch.tensor([elastic]),
                            torch.tensor([cap], dtype=torch.float64),
                            *LAT.values())
        assert torch.equal(s[:n, j], s1[:, 0]) and torch.equal(c[:n, j],
                                                               c1[:, 0])


def test_masked_padding_replicas_route_as_the_unmasked_scan():
    """Routing lanes of R = 2, 3, 5 and 8 stacked at R_max = 8, padding
    replicas down and rows padded with +inf: each lane's ids equal the
    unmasked scan at its own R and the NumPy recursion."""
    rng = np.random.default_rng(5)
    jobs = []
    for R, n in ((2, 300), (3, 500), (5, 410), (8, 77)):
        a = np.cumsum(rng.exponential(0.3, n))
        w = rng.lognormal(0.0, 1.0, n)
        jobs.append(((R, n), a, w, R))
    router = t_fleet.LeastWorkRouter()
    for m in (1, 3):
        got = t_ss._stacked_assign(router, jobs, cpu_mesh(m))
        for key, a, w, R in jobs:
            alone = backlog_scan(torch.from_numpy(a[:, None]),
                                 torch.from_numpy(w[:, None]), R)[:, 0]
            assert np.array_equal(got[key], alone.numpy()), key
            assert np.array_equal(got[key],
                                  t_fleet._backlog_assign_np(a, w, R)), key


# ----------------------------------------------------------------------------
# The sweeps, on meshes of 1-4 CPU entries
# ----------------------------------------------------------------------------

def _sweeps(cache):
    dist_j, dist_t = j_dist.LogNormalTokens(), t_dist.LogNormalTokens()
    single = cache("sweep single", lambda: t_fast.sweep(
        sweep_policies(t_pol), LAMS, dist_t, law(t_lat),
        num_requests=N_SWEEP, seed=0, device="cpu"))
    ref = cache("sweep ref", lambda: j_ss.sweep(
        sweep_policies(j_pol), LAMS, dist_j, law(j_lat),
        num_requests=N_SWEEP, seed=0))
    return single, ref


@pytest.mark.parametrize("m", MESHES)
def test_sweep_equals_single_device_and_reference(cache, m):
    single, ref = _sweeps(cache)
    got = t_ss.sweep(sweep_policies(t_pol), LAMS, t_dist.LogNormalTokens(),
                     law(t_lat), num_requests=N_SWEEP, seed=0,
                     mesh=cpu_mesh(m))
    assert set(got) == set(single) == set(ref)
    for k in got:
        assert np.array_equal(got[k], single[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=SCAN_ATOL)


def test_sweep_lanes_equal_the_reference_oracle(cache):
    """Each (policy, λ) cell of the mesh sweep equals the JAX package's
    NumPy oracle bit for bit."""
    single, _ = _sweeps(cache)
    for name, pol in sweep_policies(j_pol).items():
        for li, lam in enumerate(LAMS):
            ora = j_sim.simulate_policy(pol, lam, j_dist.LogNormalTokens(),
                                        law(j_lat), num_requests=N_SWEEP,
                                        seed=0)
            assert single[name][li] == ora["mean_wait"], (name, lam)


def _noise(cache):
    single = cache("noise single", lambda: t_fast.sweep_noise(
        srpt_factory(t_pol, t_pred), NOISE_LAMS, SIGMAS,
        t_dist.LogNormalTokens(), law(t_lat), num_requests=N_NOISE, seed=9,
        device="cpu"))
    ref = cache("noise ref", lambda: j_ss.sweep_noise(
        srpt_factory(j_pol, j_pred), NOISE_LAMS, SIGMAS,
        j_dist.LogNormalTokens(), law(j_lat), num_requests=N_NOISE, seed=9))
    return single, ref


@pytest.mark.parametrize("m", MESHES)
def test_sweep_noise_equals_single_device_and_reference(cache, m):
    single, ref = _noise(cache)
    got = t_ss.sweep_noise(srpt_factory(t_pol, t_pred), NOISE_LAMS, SIGMAS,
                           t_dist.LogNormalTokens(), law(t_lat),
                           num_requests=N_NOISE, seed=9, mesh=cpu_mesh(m))
    assert np.array_equal(got["mean_wait"], single["mean_wait"])
    np.testing.assert_allclose(got["mean_wait"], ref["mean_wait"], rtol=0,
                               atol=SCAN_ATOL)
    for k in ("lams", "sigmas"):
        assert np.array_equal(got[k], ref[k]), k
    # every cell equals the reference's NumPy oracle bit for bit
    if m == 2:
        for (li, lam), (si, sg) in itertools.product(enumerate(NOISE_LAMS),
                                                     enumerate(SIGMAS)):
            ora = j_sim.simulate_policy(
                srpt_factory(j_pol, j_pred)(sg), lam,
                j_dist.LogNormalTokens(), law(j_lat), num_requests=N_NOISE,
                seed=9)
            assert got["mean_wait"][li, si] == ora["mean_wait"], (lam, sg)


def fleet_policy(mod):
    return mod.ElasticPolicy(b_max=8)


def _fleet(cache, router):
    single = cache(("fleet single", router), lambda: t_fleet.sweep(
        R_GRID, LAMS[:2], router, fleet_policy(t_pol),
        t_dist.LogNormalTokens(), law(t_lat), num_requests=N_FLEET, seed=1,
        device="cpu"))
    ref = cache(("fleet ref", router), lambda: j_ss.fleet_sweep(
        R_GRID, LAMS[:2], router, fleet_policy(j_pol),
        j_dist.LogNormalTokens(), law(j_lat), num_requests=N_FLEET, seed=1))
    return single, ref


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("router", ROUTERS)
def test_fleet_sweep_equals_single_device_and_reference(cache, router, m):
    single, ref = _fleet(cache, router)
    got = t_ss.fleet_sweep(R_GRID, LAMS[:2], router, fleet_policy(t_pol),
                           t_dist.LogNormalTokens(), law(t_lat),
                           num_requests=N_FLEET, seed=1, mesh=cpu_mesh(m))
    assert np.array_equal(got["mean_wait"], single["mean_wait"])
    np.testing.assert_allclose(got["mean_wait"], ref["mean_wait"], rtol=0,
                               atol=SCAN_ATOL)
    for k in ("R_grid", "lams"):
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("router", ["jsq", "round_robin"])
def test_fleet_sweep_equals_the_reference_oracle(cache, router):
    """Every (R, λ) cell of the fleet sweep equals the JAX package's NumPy
    fleet oracle bit for bit (the mesh sweeps equal these cells, above)."""
    single, _ = _fleet(cache, router)
    for (ri, R), (li, lam) in itertools.product(enumerate(R_GRID),
                                                enumerate(LAMS[:2])):
        ora = j_fleet.route_oracle(router, fleet_policy(j_pol), lam, R,
                                   j_dist.LogNormalTokens(), law(j_lat),
                                   num_requests=N_FLEET, seed=1)
        assert single["mean_wait"][ri, li] == ora["mean_wait"], (R, lam)


@pytest.mark.parametrize("case", ["fcfs_random", "dynamic_n_max"])
def test_fleet_sweep_fallbacks_equal_fleet_sweep(case):
    """FCFS has no batch_scan lane and an ``n_max`` cap has no stacked
    path: both run ``fleet.sweep`` on the mesh's first device."""
    router, pol = {"fcfs_random": ("random", t_pol.FCFSPolicy()),
                   "dynamic_n_max": ("jsq", t_pol.DynamicPolicy(
                       b_max=8, n_max=2000))}[case]
    args = ([1, 2], LAMS, router, pol, t_dist.LogNormalTokens(), law(t_lat))
    a = t_fleet.sweep(*args, num_requests=800, seed=2, device="cpu")
    b = t_ss.fleet_sweep(*args, num_requests=800, seed=2, mesh=cpu_mesh(3))
    for k in ("mean_wait", "R_grid", "lams"):
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("router", ["jsq", "round_robin"])
def test_fleet_sweep_launches(monkeypatch, router, m):
    """One S6 call for the whole grid (a state-dependent router; none for
    round_robin) and one S1 call per power-of-two row-length bucket of the
    non-empty replica sub-streams, each split into m shards."""
    calls = {"batch_scan": [], "backlog_scan": []}
    for name in calls:
        orig = getattr(t_ss, name)

        def counted(*args, _orig=orig, _name=name):
            calls[_name].append(args[0].shape)
            return _orig(*args)
        monkeypatch.setattr(t_ss, name, counted)
    pol = t_pol.DynamicPolicy(b_max=8)
    t_ss.fleet_sweep([1, 2, 4, 8], [0.8], router, pol,
                     t_dist.UniformTokens(1000), law(t_lat),
                     num_requests=1200, seed=3, mesh=cpu_mesh(m))
    buckets = set()
    for R in (1, 2, 4, 8):
        fw = t_fleet.router_from_spec(router).fleet_workload(
            pol, 0.8, t_dist.UniformTokens(1000), law(t_lat), 1200, 3, R,
            fast=True, device="cpu")
        buckets |= {max(1 << max(len(w.arrivals) - 1, 1).bit_length(), 2)
                    for w in fw.replicas if len(w.arrivals)}
    assert len(calls["backlog_scan"]) == (m if router == "jsq" else 0)
    assert len(calls["batch_scan"]) == m * len(buckets)
    # the 15 replica lanes, padded to the mesh, in as few launches
    lanes = sum(s[1] for s in calls["batch_scan"])
    assert lanes >= 15 and len(buckets) <= 5
