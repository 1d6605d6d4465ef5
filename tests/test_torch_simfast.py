"""The port's fast simulators on the CPU: kernels S1 (``batch_scan``) and
S2 (``impatience_scan``) through their plain PyTorch versions (the
batch-event kernels S3-S5 in ``test_torch_batchevent.py``), and
``core.fastsim`` with ``device="cpu"``, against the JAX package's compiled
scans (``repro.core.fastsim``) and against both NumPy oracles.

The reference's scans run under ``jax.experimental.enable_x64``, which
JAX 0.9 removed; the ``x64`` fixture puts back a shim that calls
``jax.enable_x64(True)``, only when the attribute is missing, with
``monkeypatch`` (the JAX package is not edited).

The port is held to the NumPy oracles with ``np.array_equal``, with one
exception: the fixed-batching closed form telescopes the free-time
recursion into a cumulative sum and a running max, which reassociates the
float64 sums, so it agrees with the oracle loop to 1e-9 relative (the
reference's closed form differs from its oracle the same way, and the
port's equals the reference's bit for bit).

Against the reference's compiled batching scan the band is 1e-10 s
(``SCAN_ATOL``), with batch boundaries (``closed``, ``mean_batch``) equal:
XLA on the CPU contracts the scan's batch-time expression into fused
multiply-adds, so its starts sit an ulp off its own oracle's in some steps
(up to 3.6e-12 s at clocks near 1e4 s; at step 244 of an elastic lane,
lambda 0.4, seed 3, the scan gives 718.3030370316952, the fused chain's
rounding, where the oracle and the port give 718.3030370316953).  The port
rounds each product and sum on its own, as the oracle does.  The impatience
scan has no product to contract and equals the reference exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fastsim as j_fast  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import simulate as j_sim  # noqa: E402

from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import simulate as t_sim  # noqa: E402
from repro_torch.kernels.batch_scan import NO_CAP, batch_scan  # noqa: E402
from repro_torch.kernels.impatience_scan import impatience_scan  # noqa: E402
from repro_torch.kernels.multibin_scan import multibin_scan  # noqa: E402
from repro_torch.kernels.srpt_scan import srpt_scan  # noqa: E402
from repro_torch.kernels.wait_scan import wait_scan  # noqa: E402

LAT = dict(k1=0.05, k2=0.5, k3=0.0005, k4=0.02)
FIXED_TOL = 1e-9
SCAN_ATOL = 1e-10


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def pair(name, *args):
    return getattr(j_dist, name)(*args), getattr(t_dist, name)(*args)


def lats():
    return j_lat.BatchLatencyModel(**LAT), t_lat.BatchLatencyModel(**LAT)


def policies(name, **kw):
    return j_pol.REGISTRY[name](**kw), t_pol.REGISTRY[name](**kw)


# ----------------------------------------------------------------------------
# The kernels' plain versions against the reference's lax.scan recursions
# ----------------------------------------------------------------------------

# (elastic, b_max) per lane: padded and elastic, capped and not
LANES = [(False, None), (True, None), (False, 4), (True, 8), (True, 1),
         (False, 16)]


@pytest.mark.parametrize("dist", ["UniformTokens", "LogNormalTokens"])
def test_batch_scan_plain_equals_reference_scan(x64, dist):
    jd, _ = pair(dist)
    n = 6000
    arr, tok = [], []
    for i, lam in enumerate((0.08, 0.3, 0.9, 0.3, 2.0, 0.5)):
        wl = j_pol.DynamicPolicy().sample_workload(lam, jd, n, seed=i)
        arr.append(wl.arrivals)
        tok.append(wl.tokens)
    arr, tok = np.stack(arr), np.stack(tok)
    elastic = np.array([e for e, _ in LANES])
    b_max = np.array([NO_CAP if b is None else float(b) for _, b in LANES])
    with jax.experimental.enable_x64():
        js, jc = j_fast._batching_scan(True)(
            jnp.asarray(arr), jnp.asarray(tok), *(jnp.float64(LAT[k])
                                                  for k in LAT),
            jnp.asarray(elastic), jnp.asarray(b_max))
        js, jc = np.asarray(js), np.asarray(jc)
    # the port takes and returns lanes minor, [n, lanes]
    ts, tc = batch_scan(torch.from_numpy(arr.T), torch.from_numpy(tok.T),
                        torch.from_numpy(elastic), torch.from_numpy(b_max),
                        *LAT.values())
    assert ts.dtype == torch.float64 and tc.dtype == torch.bool
    assert ts.shape == (n, len(LANES))
    ts, tc = ts.T, tc.T
    assert np.array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=SCAN_ATOL)
    # each lane's waits equal both oracles' on the same workload
    lat_j, lat_t = lats()
    for lane, (e, b) in enumerate(LANES):
        name = "elastic" if e else "dynamic"
        jp, tp = policies(name, b_max=b)
        with j_sim.no_warmup(), t_sim.no_warmup():
            jw = j_sim.simulate_policy(
                jp, None, None, lat_j, workload=j_pol.Workload(
                    arrivals=arr[lane], tokens=tok[lane]))["waits"]
            tw = t_sim.simulate_policy(
                tp, None, None, lat_t, workload=t_pol.Workload(
                    arrivals=arr[lane], tokens=tok[lane]))["waits"]
        assert np.array_equal(tw, jw)
        assert np.array_equal(ts[lane].numpy() - arr[lane], tw), (e, b)
    # the scan is causal: a prefix gives the prefix of the outputs
    ps, pc = batch_scan(*(torch.from_numpy(x) for x in (
        arr[:, :777].T, tok[:, :777].T, elastic, b_max)), *LAT.values())
    assert np.array_equal(ps.numpy(), ts[:, :777].T.numpy())
    assert np.array_equal(pc.numpy(), tc[:, :777].T.numpy())


def test_impatience_scan_plain_equals_reference_scan(x64):
    jd, _ = pair("LogNormalTokens", 7.0, 0.7)
    lat = j_lat.PAPER_A100_LLAMA2_7B
    taus = [30.0, 120.0, 1e9]                  # 1e9: nothing is lost
    inter, service = [], []
    for i, n_max in enumerate((None, 1600, None)):
        wl = j_pol.FCFSPolicy(n_max=n_max).sample_workload(1 / 40, jd, 8000,
                                                           seed=i)
        inter.append(wl.inter)
        service.append(np.asarray(lat.service_time(wl.tokens), np.float64))
    inter, service = np.stack(inter), np.stack(service)
    tw, tl = impatience_scan(torch.from_numpy(inter.T),
                             torch.from_numpy(service.T),
                             torch.tensor(taus, dtype=torch.float64))
    assert tw.shape == (8000, len(taus))
    tw, tl = tw.T, tl.T
    for lane, tau in enumerate(taus):
        with jax.experimental.enable_x64():
            jw, jl = j_fast._impatience_scan()(
                jnp.asarray(inter[lane]), jnp.asarray(service[lane]),
                jnp.float64(tau))
            jw, jl = np.asarray(jw), np.asarray(jl)
        assert np.array_equal(tw[lane].numpy(), jw)
        assert np.array_equal(tl[lane].numpy(), jl)
    assert tl[0].any() and not tl[2].any()


@pytest.mark.parametrize("fn", ["batch_scan", "impatience_scan",
                                "multibin_scan", "wait_scan", "srpt_scan"])
def test_scan_wrappers_refuse_bad_inputs(fn):
    a = torch.zeros(40, 3, dtype=torch.float64)      # [n, lanes]
    lanes = torch.zeros(3, dtype=torch.float64)
    flags = torch.zeros(3, dtype=torch.bool)
    k = tuple(LAT.values())

    def rank(x):                                     # [n, lanes] int64
        return torch.zeros(x.shape, dtype=torch.int64)

    call = {"batch_scan": lambda x, y, z: batch_scan(x, y, flags, z, *k),
            "impatience_scan": impatience_scan,
            "multibin_scan": lambda x, y, z: multibin_scan(
                x, y, rank(x), 4, z.long(), *k),
            "wait_scan": lambda x, y, z: wait_scan(x, y, z.long() + 1, z,
                                                   z.long(), *k),
            "srpt_scan": lambda x, y, z: srpt_scan(x, y, rank(x), z.long(),
                                                   *k)}[fn]
    with pytest.raises(TypeError):
        call(a.float(), a, lanes)
    with pytest.raises(ValueError):
        call(a, a[:30], lanes)
    with pytest.raises(ValueError):
        call(a, a, lanes[:2])
    w, f = call(a[:0], a[:0], lanes)
    assert w.shape == (0, 3) and f.shape == (0, 3)
    if fn == "multibin_scan":                        # bins outside [0, 4)
        with pytest.raises(ValueError):
            multibin_scan(a, a, rank(a) + 4, 4, lanes.long(), *k)
        with pytest.raises(ValueError):
            multibin_scan(a, a, rank(a), 65, lanes.long(), *k)
    if fn == "srpt_scan":                            # order outside [0, n)
        with pytest.raises(ValueError):
            srpt_scan(a, a, rank(a) - 1, lanes.long(), *k)


# ----------------------------------------------------------------------------
# The fast path with device="cpu" against the reference's fast path and both
# oracles
# ----------------------------------------------------------------------------

FAST_CASES = [
    ("dynamic", {}, "UniformTokens", (1000,), 0.1),
    ("dynamic", {}, "UniformTokens", (1000,), 0.4),
    ("dynamic", {"b_max": 8}, "UniformTokens", (1000,), 0.4),
    ("dynamic", {"n_max": 500}, "LogNormalTokens", (7.0, 0.7), 0.3),
    ("elastic", {}, "UniformTokens", (1000,), 0.4),
    ("elastic", {"b_max": 4}, "LogNormalTokens", (7.0, 0.7), 0.5),
    ("fcfs", {"tau": 30.0}, "LogNormalTokens", (7.0, 0.7), 1 / 40),
    ("fcfs", {"tau": 120.0, "n_max": 1600}, "LogNormalTokens", (7.0, 0.7),
     1 / 40),
    ("fcfs", {"n_max": 1600}, "LogNormalTokens", (7.0, 0.7), 1 / 40),
    ("fixed", {"b": 4}, "UniformTokens", (1000,), 0.1),
    ("fixed", {"b": 16}, "LogNormalTokens", (7.0, 0.7), 0.2),
]


@pytest.mark.parametrize("name,kw,dist,args,lam", FAST_CASES)
def test_fast_path_equals_reference(x64, name, kw, dist, args, lam):
    jp, tp = policies(name, **kw)
    jd, td = pair(dist, *args)
    jl, tl = lats()
    if name == "fcfs":
        jl, tl = j_lat.PAPER_A100_LLAMA2_7B, t_lat.PAPER_A100_LLAMA2_7B
    n = 8000
    tr = t_fast.simulate_policy_fast(tp, lam, td, tl, num_requests=n, seed=3,
                                     device="cpu")
    jr = j_fast.simulate_policy_fast(jp, lam, jd, jl, num_requests=n, seed=3)
    assert tr.keys() == jr.keys()
    if jp.fast_kernel == "batch_scan":
        np.testing.assert_allclose(tr["waits"], jr["waits"], rtol=0,
                                   atol=SCAN_ATOL)
        assert tr["mean_batch"] == jr["mean_batch"]
    else:
        assert np.array_equal(tr["waits"], jr["waits"])
        for k in tr:
            assert np.all(tr[k] == jr[k]), k
    oracle = t_sim.simulate_policy(tp, lam, td, tl, num_requests=n, seed=3)
    if name == "fixed":
        np.testing.assert_allclose(tr["waits"], oracle["waits"],
                                   rtol=FIXED_TOL, atol=FIXED_TOL)
    else:
        assert np.array_equal(tr["waits"], oracle["waits"])
        assert tr.get("mean_batch") == oracle.get("mean_batch")
    assert np.array_equal(
        oracle["waits"],
        j_sim.simulate_policy(jp, lam, jd, jl, num_requests=n,
                              seed=3)["waits"])


def test_continuous_fast_path_is_the_oracle():
    jd, td = pair("UniformTokens", 200)
    jl, tl = lats()
    jp, tp = policies("continuous", slots=4, chunk=8)
    tr = t_fast.simulate_policy_fast(tp, 0.3, td, tl, num_requests=3000,
                                     seed=1, device="cpu")
    jr = j_sim.simulate_policy(jp, 0.3, jd, jl, num_requests=3000, seed=1)
    assert np.array_equal(tr["waits"], jr["waits"])


def test_legacy_fast_wrappers_equal_reference(x64):
    jd, td = pair("UniformTokens", 1000)
    jl, tl = lats()
    tr = t_fast.simulate_dynamic_batching_fast(0.3, td, tl, elastic=True,
                                               b_max=8, num_requests=5000,
                                               seed=2, device="cpu")
    jr = j_fast.simulate_dynamic_batching_fast(0.3, jd, jl, elastic=True,
                                               b_max=8, num_requests=5000,
                                               seed=2)
    np.testing.assert_allclose(tr["waits"], jr["waits"], rtol=0,
                               atol=SCAN_ATOL)
    assert np.array_equal(tr["waits"], t_sim.simulate_dynamic_batching(
        0.3, td, tl, elastic=True, b_max=8, num_requests=5000,
        seed=2)["waits"])
    bt = lambda ns: 0.4 + 0.002 * float(np.max(ns))  # noqa: E731
    tr = t_fast.simulate_fixed_batching_fast(0.3, 4, td, batch_time=bt,
                                             num_requests=5000, seed=1,
                                             device="cpu")
    jr = j_fast.simulate_fixed_batching_fast(0.3, 4, jd, batch_time=bt,
                                             num_requests=5000, seed=1)
    assert np.array_equal(tr["waits"], jr["waits"])
    ld, tld = pair("LogNormalTokens", 7.0, 0.7)
    tr = t_fast.simulate_mg1_fast(0.02, tld, t_lat.PAPER_A100_LLAMA2_7B,
                                  tau=60.0, num_requests=5000, seed=1,
                                  device="cpu")
    jr = j_fast.simulate_mg1_fast(0.02, ld, j_lat.PAPER_A100_LLAMA2_7B,
                                  tau=60.0, num_requests=5000, seed=1)
    assert np.array_equal(tr["waits"], jr["waits"])


def test_policy_sweep_matches_reference(x64):
    """The reference's ``test_policy_sweep_matches_reference`` set: the scan
    lanes ride one plain S1 call."""
    policies_ = {
        "dyn": dict(kind="dynamic"),
        "dyn8": dict(kind="dynamic", b_max=8),
        "ela": dict(kind="elastic"),
        "fix4": dict(kind="fixed", b=4),
    }
    jd, td = pair("UniformTokens", 1000)
    jl, tl = lats()
    lam = [0.1, 0.4]
    tf = t_fast.simulate_policy_sweep_fast(lam, td, tl, policies_,
                                           num_requests=20_000, seed=0,
                                           device="cpu")
    jf = j_fast.simulate_policy_sweep_fast(lam, jd, jl, policies_,
                                           num_requests=20_000, seed=0)
    js = j_sim.simulate_policy_sweep(lam, jd, jl, policies_,
                                     num_requests=20_000, seed=0)
    ts = t_sim.simulate_policy_sweep(lam, td, tl, policies_,
                                     num_requests=20_000, seed=0)
    assert tf.keys() == jf.keys() == js.keys()
    for name in policies_:
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=SCAN_ATOL)
        assert np.array_equal(ts[name], js[name]), name
        if name == "fix4":
            np.testing.assert_allclose(tf[name], ts[name], rtol=FIXED_TOL)
        else:
            assert np.array_equal(tf[name], ts[name]), name


def test_sweep_mixed_policies_equal_reference(x64):
    """fcfs and n_max-clipped lanes go per cell through ``KERNELS``, the
    continuous policy through the oracle; the scan lanes through one call."""
    pols = {"fcfs": j_pol.FCFSPolicy(tau=40.0), "ela_n": j_pol.ElasticPolicy(
        n_max=400), "cont": j_pol.ContinuousPolicy(slots=4, chunk=8),
        "dyn4": j_pol.DynamicPolicy(b_max=4)}
    tpols = {"fcfs": t_pol.FCFSPolicy(tau=40.0), "ela_n": t_pol.ElasticPolicy(
        n_max=400), "cont": t_pol.ContinuousPolicy(slots=4, chunk=8),
        "dyn4": t_pol.DynamicPolicy(b_max=4)}
    jd, td = pair("UniformTokens", 200)
    jl, tl = lats()
    tf = t_fast.sweep(tpols, [0.2, 0.6], td, tl, num_requests=3000, seed=5,
                      device="cpu")
    jf = j_fast.sweep(pols, [0.2, 0.6], jd, jl, num_requests=3000, seed=5)
    to = t_sim.simulate_policy_sweep([0.2, 0.6], td, tl, tpols,
                                     num_requests=3000, seed=5)
    for name in pols:
        assert np.array_equal(tf[name], to[name]), name
        np.testing.assert_allclose(tf[name], jf[name], rtol=0, atol=SCAN_ATOL)
    assert np.array_equal(tf["fcfs"], jf["fcfs"])


def test_sweep_hands_back_its_scan_launch():
    """``scan_out`` holds the one S1 call's lanes, inputs and outputs
    ([n, lanes]); each column is the oracle's run of that cell."""
    tpols = {"dyn": t_pol.DynamicPolicy(), "ela8": t_pol.ElasticPolicy(
        b_max=8), "fix4": t_pol.FixedPolicy(b=4)}
    _, td = pair("UniformTokens", 1000)
    _, tl = lats()
    lams = [0.2, 0.7]
    got = {}
    tf = t_fast.sweep(tpols, lams, td, tl, num_requests=3000, seed=2,
                      device="cpu", scan_out=got)
    assert [(name, li) for name, li, _, _ in got["lanes"]] == \
        [("dyn", 0), ("dyn", 1), ("ela8", 0), ("ela8", 1)]
    assert got["arr"].shape == got["starts"].shape == (3000, 4)
    assert got["closed"].dtype == bool and got["closed"][0].all()
    for col, (name, li, elastic, b_max) in enumerate(got["lanes"]):
        assert (elastic, b_max) == tpols[name].scan_lane()
        with t_sim.no_warmup():
            ora = t_sim.simulate_policy(tpols[name], lams[li], td, tl,
                                        num_requests=3000, seed=2)
        wl = tpols[name].sample_workload(lams[li], td, 3000, 2)
        assert np.array_equal(got["arr"][:, col], wl.arrivals)
        assert np.array_equal(got["tok"][:, col], wl.tokens)
        assert np.array_equal(got["starts"][:, col] - got["arr"][:, col],
                              ora["waits"]), (name, li)
        assert 3000 / got["closed"][:, col].sum() == ora["mean_batch"]
    assert np.isfinite(tf["fix4"]).all()


# ----------------------------------------------------------------------------
# Devices
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["simulate_policy_fast", "sweep",
                                   "simulate_mg1_fast",
                                   "simulate_dynamic_batching_fast",
                                   "simulate_fixed_batching_fast",
                                   "continuous"])
def test_fast_entry_points_need_a_gpu_unless_cpu_is_asked(entry,
                                                          monkeypatch):
    _, td = pair("UniformTokens", 100)
    _, tl = lats()
    call = {
        "simulate_policy_fast": lambda **kw: t_fast.simulate_policy_fast(
            t_pol.ElasticPolicy(), 0.3, td, tl, num_requests=500, **kw),
        "sweep": lambda **kw: t_fast.sweep(
            {"d": t_pol.DynamicPolicy()}, [0.3], td, tl, num_requests=500,
            **kw),
        "simulate_mg1_fast": lambda **kw: t_fast.simulate_mg1_fast(
            0.02, td, t_lat.PAPER_A100_LLAMA2_7B, tau=30.0,
            num_requests=500, **kw),
        "simulate_dynamic_batching_fast":
            lambda **kw: t_fast.simulate_dynamic_batching_fast(
                0.3, td, tl, num_requests=500, **kw),
        "simulate_fixed_batching_fast":
            lambda **kw: t_fast.simulate_fixed_batching_fast(
                0.3, 4, td, tl, num_requests=500, **kw),
        "continuous": lambda **kw: t_fast.simulate_policy_fast(
            t_pol.ContinuousPolicy(slots=2), 0.3, td, tl, num_requests=500,
            **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    assert out is not None


def test_fast_path_m7_layers_raise():
    _, td = pair("UniformTokens", 100)
    _, tl = lats()
    for layer, item in (("sessions", "M7c"), ("memory", "M7d")):
        with pytest.raises(NotImplementedError, match=item):
            t_fast.simulate_policy_fast(t_pol.DynamicPolicy(), 0.3, td, tl,
                                        num_requests=100, device="cpu",
                                        **{layer: object()})
