"""What the S3 and S6 wrappers lay out for their kernels, on the CPU, and
``sweep_noise``'s multi-bin cells as the lanes of one S3 launch.

On the card ``multibin_scan`` groups each lane's requests by bin
(``multibin_scan.ops.group_by_bin`` / ``layout``) and ``backlog_scan``
packs each request's up-flags into one word (``backlog_scan.ops.pack_up``)
and picks the kernel template of its replica count (``template_of``).
These are plain torch, so they are held here: the grouping is stable, its
offsets count each bin, its permutation is one; the packed mask
round-trips, bit 63 included; R rounds up to its template.

``sweep_noise`` with every cell multi-bin stacks the cells as lanes of one
``multibin_scan`` call; on ``device="cpu"`` (the plain version) its waits
equal the per-cell path bit for bit and the JAX package's ``sweep_noise``
within 1e-10 s (XLA on the CPU contracts the reference's batch time into
fused multiply-adds; see ``tests/test_torch_simfast.py``).  The reference
runs under ``jax.experimental.enable_x64``, which JAX 0.9 removed; the
``x64`` fixture puts back a shim with ``monkeypatch`` (the JAX package is
not edited)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

from repro.core import distributions as j_dist  # noqa: E402
from repro.core import fastsim as j_fast  # noqa: E402
from repro.core import latency_model as j_lat  # noqa: E402
from repro.core import policies as j_pol  # noqa: E402
from repro.core import predictors as j_pred  # noqa: E402

from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import distributions as t_dist  # noqa: E402
from repro_torch.core import fastsim as t_fast  # noqa: E402
from repro_torch.core import latency_model as t_lat  # noqa: E402
from repro_torch.core import policies as t_pol  # noqa: E402
from repro_torch.core import predictors as t_pred  # noqa: E402
from repro_torch.kernels.backlog_scan.ops import (  # noqa: E402
    MAX_REPLICAS, TEMPLATES, pack_up, template_of)
from repro_torch.kernels.multibin_scan import multibin_scan  # noqa: E402
from repro_torch.kernels.multibin_scan.ops import (  # noqa: E402
    group_by_bin, layout)

SCAN_ATOL = 1e-10
HT = dict(k1=0.05, k2=0.5, k3=2e-4, k4=0.002)         # Fig 6b constants


@pytest.fixture
def x64(monkeypatch):
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)


def _bins(n, lanes, num_bins, seed, empty=()):
    """[n, lanes] bins in [0, num_bins), each lane its own mix, with the
    bins in ``empty`` left without members."""
    rng = np.random.default_rng(seed)
    live = np.array([b for b in range(num_bins) if b not in empty])
    return live[rng.integers(0, len(live), (n, lanes))]


# ----------------------------------------------------------------------------
# S3: the grouping by bin
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,lanes,num_bins,empty", [
    (1, 1, 1, ()), (2, 3, 4, ()), (37, 2, 4, (1,)), (500, 3, 33, (0, 32)),
    (2000, 2, 64, (5, 63)), (64, 4, 64, ())])
def test_group_by_bin_is_stable_with_offsets_and_a_permutation(
        n, lanes, num_bins, empty):
    bins = torch.from_numpy(_bins(n, lanes, num_bins, seed=n + num_bins,
                                  empty=empty))
    perm, offs = group_by_bin(bins, num_bins)
    assert perm.shape == (lanes, n) and perm.dtype == torch.int64
    assert offs.shape == (lanes, num_bins + 1) and offs.dtype == torch.int64
    for lane in range(lanes):
        p = perm[lane]
        # a permutation: its inverse takes every position back
        inv = torch.empty_like(p).scatter_(0, p, torch.arange(n))
        assert torch.equal(p[inv], torch.arange(n))
        assert torch.equal(torch.sort(p).values, torch.arange(n))
        col = bins[:, lane]
        o = offs[lane]
        assert int(o[0]) == 0 and int(o[-1]) == n
        for b in range(num_bins):
            members = p[o[b]:o[b + 1]]
            # bin b's members, all of them, in arrival (request) order
            assert torch.equal(members, torch.nonzero(col == b).flatten())
            if b in empty:
                assert len(members) == 0


def test_layout_gathers_in_grouped_order():
    n, lanes, num_bins = 300, 3, 5
    rng = np.random.default_rng(3)
    arr = np.cumsum(rng.exponential(1.0, (n, lanes)), axis=0)
    tok = rng.integers(1, 40, (n, lanes)).astype(np.float64)
    bins = _bins(n, lanes, num_bins, seed=4, empty=(2,))
    ta, tt, tb = (torch.from_numpy(x) for x in (arr, tok, bins))
    a, t, perm, offs = layout(ta, tt, tb, num_bins)
    ref_perm, ref_offs = group_by_bin(tb, num_bins)
    # the kernel reads them as dense [lanes, n] and [lanes, num_bins + 1]
    assert all(x.is_contiguous() for x in (a, t, perm, offs))
    assert perm.dtype == offs.dtype == torch.int32
    assert torch.equal(perm.long(), ref_perm)
    assert torch.equal(offs.long(), ref_offs)
    for lane in range(lanes):
        p = ref_perm[lane]
        assert torch.equal(a[lane], ta[p, lane])
        assert torch.equal(t[lane], tt[p, lane])
        for b in range(num_bins):         # each bin's arrivals stay sorted
            seg = a[lane, offs[lane, b]:offs[lane, b + 1]]
            assert bool((seg[1:] >= seg[:-1]).all())


def test_multibin_scan_refuses_more_requests_than_int32_positions(monkeypatch):
    from repro_torch.kernels.multibin_scan import ops
    a = torch.zeros(40, 2, dtype=torch.float64)
    i = torch.zeros(40, 2, dtype=torch.int64)
    cap = torch.zeros(2, dtype=torch.int64)
    monkeypatch.setattr(ops, "MAX_N", 39)
    with pytest.raises(ValueError, match="requests a lane"):
        multibin_scan(a, a, i, 4, cap, *HT.values())


# ----------------------------------------------------------------------------
# S6: the packed mask and the templates
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 3, 8, 9, 33, 63, 64])
def test_pack_up_round_trips(R):
    rng = np.random.default_rng(R)
    up = (rng.random((50, R, 3)) < 0.5).astype(np.uint8)
    up[0] = 1                              # every replica up
    up[1] = 0                              # every replica down
    up[2, R - 1] = 7                       # nonzero is up
    bits = pack_up(torch.from_numpy(up))
    assert bits.shape == (50, 3) and bits.dtype == torch.int64
    r = torch.arange(R)
    back = (bits[:, None, :] >> r[None, :, None]) & 1
    assert torch.equal(back.bool(), torch.from_numpy(up != 0))
    assert bool((bits[1] == 0).all())
    if R == 64:                            # the top replica is the sign bit
        assert bool((bits[0] == -1).all())
        assert bool((bits[2] < 0).all())


def test_template_of_rounds_up():
    want = {**{R: R for R in range(2, 9)}, **{R: 16 for R in range(9, 17)},
            **{R: 32 for R in range(17, 33)},
            **{R: 64 for R in range(33, 65)}}
    assert {R: template_of(R) for R in range(2, MAX_REPLICAS + 1)} == want
    assert set(want.values()) == set(TEMPLATES)


# ----------------------------------------------------------------------------
# sweep_noise: multi-bin cells as the lanes of one S3 launch
# ----------------------------------------------------------------------------

def _factory(pol_mod, pred_mod, **kw):
    return lambda s: pol_mod.get_policy(
        "multibin", predictor=pred_mod.LogNormalNoisePredictor(s), **kw)


@pytest.mark.parametrize("kw", [{"num_bins": 4}, {"num_bins": 3, "b_max": 8}])
def test_sweep_noise_multibin_lanes_equal_cells_and_reference(x64, kw):
    lams, sigmas, n = [0.6, 1.0], [0.0, 0.5, 1.5], 2000
    td, jd = t_dist.LogNormalTokens(7.0, 0.7), j_dist.LogNormalTokens(7.0, 0.7)
    tl, jl = t_lat.BatchLatencyModel(**HT), j_lat.BatchLatencyModel(**HT)
    got = {}
    before = K.LAUNCHES["multibin_scan"]
    lanes = t_fast.sweep_noise(_factory(t_pol, t_pred, **kw), lams, sigmas,
                               td, tl, num_requests=n, seed=15,
                               device="cpu", launch_out=got)
    assert K.LAUNCHES["multibin_scan"] == before      # the plain version
    assert got["kernel"] == "multibin_scan"
    assert got["args"][0].shape == (n, len(lams) * len(sigmas))
    assert got["args"][3] == kw["num_bins"]
    assert got["cells"] == [(li, si) for li in range(len(lams))
                            for si in range(len(sigmas))]
    factory = _factory(t_pol, t_pred, **kw)
    for li, lam in enumerate(lams):
        for si, s in enumerate(sigmas):
            cell = t_fast.simulate_policy_fast(factory(s), lam, td, tl,
                                               num_requests=n, seed=15,
                                               device="cpu")
            assert lanes["mean_wait"][li, si] == cell["mean_wait"], (li, si)
    ref = j_fast.sweep_noise(_factory(j_pol, j_pred, **kw), lams, sigmas, jd,
                             jl, num_requests=n, seed=15)
    np.testing.assert_allclose(lanes["mean_wait"], ref["mean_wait"], rtol=0,
                               atol=SCAN_ATOL)


def test_sweep_noise_multibin_lanes_must_share_bins_and_cap():
    td, tl = t_dist.LogNormalTokens(7.0, 0.7), t_lat.BatchLatencyModel(**HT)
    for vary in ("num_bins", "b_max"):
        def factory(s, vary=vary):
            kw = {"num_bins": 4, "b_max": 8}
            kw[vary] += int(s > 0)
            return t_pol.get_policy(
                "multibin", predictor=t_pred.LogNormalNoisePredictor(s), **kw)
        with pytest.raises(ValueError, match="must share"):
            t_fast.sweep_noise(factory, [0.5], [0.0, 0.5], td, tl,
                               num_requests=100, device="cpu")
