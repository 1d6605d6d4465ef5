"""SRPT batch formation (kernel S5, ``kernels/srpt_scan``) on the CPU, at
the edges of the kernel's fanout-32 tree, against the JAX package's NumPy
oracle (``repro.core.policies._SRPTFormation`` with
``BatchLatencyModel.batch_time``).

On a CPU tensor the wrapper runs the kernel's plain version, so these
cases hold the semantics the kernel is held to on the card
(``tests/test_torch_gpu.py::test_srpt_scan_wide_tree_bit_equal`` runs the
same cases through the kernel): n either side of a full word of 32 ranks
and of a full level-1 word of 1,024, every arrival at one instant,
arrivals out of time order, caps of n and more, a NaN arrival in one lane
and one cap per lane.  Starts and batch-head flags are bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.latency_model import BatchLatencyModel  # noqa: E402
from repro.core.policies import _SRPTFormation  # noqa: E402

from repro_torch.kernels.srpt_scan import srpt_scan  # noqa: E402

LAT = (0.05, 0.5, 2e-4, 0.002)


def _inputs(n, lanes, seed, distinct=False):
    """Sorted arrivals [n, lanes] from t=0, at loads from idle to
    saturated, and token counts: integers with repeats (ties in the rank
    order), or all distinct."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, (n, lanes)) / np.geomspace(0.05, 3.0, lanes)
    gaps[0] = 0.0
    arr = np.cumsum(gaps, axis=0)
    if distinct:
        tok = np.stack([rng.permutation(n) for _ in range(lanes)], axis=1)
        return arr, tok.astype(np.float64) * 3.0 + 1.0
    return arr, rng.integers(1, 40, (n, lanes)).astype(np.float64) * 50.0


def _oracle(arr, tok, b_max, stop_when_idle=False):
    """One lane through the reference oracle, which takes its requests in
    time order (so the lane is sorted by arrival first and mapped back;
    with tokens distinct the rank order does not depend on it).  With
    ``stop_when_idle`` the run ends at the first batch that starts on an
    idle server, as a lane with an unserved NaN arrival does.  Returns
    (starts, first, served)."""
    by_time = np.argsort(arr, kind="stable")
    lat = BatchLatencyModel(*LAT)
    fs = _SRPTFormation(arr[by_time], tok[by_time],
                        b_max if b_max > 0 else None)
    n = len(arr)
    starts, first, served = np.zeros(n), np.zeros(n, bool), np.zeros(n, bool)
    t_free = 0.0
    while (nb := fs.next_batch(t_free)) is not None:
        start, idx = nb
        if stop_when_idle and start > t_free:
            break
        req = by_time[idx]
        starts[req], first[req[0]], served[req] = start, True, True
        t_free = start + lat.batch_time(len(idx), tok[req].max())
    return starts, first, served


def _run(arr, tok, b_max):
    order = np.argsort(tok, axis=0, kind="stable")
    starts, first = srpt_scan(*(torch.from_numpy(np.asarray(a)) for a in (
        arr, tok, order.astype(np.int64), np.asarray(b_max, np.int64))), *LAT)
    assert starts.shape == first.shape == arr.shape
    return starts.numpy(), first.numpy()


def _equal_to_oracle(arr, tok, b_max, starts, first, lanes):
    for lane in lanes:
        ora_s, ora_f, served = _oracle(arr[:, lane], tok[:, lane],
                                       int(b_max[lane]))
        assert served.all()
        assert np.array_equal(starts[:, lane], ora_s), lane
        assert np.array_equal(first[:, lane], ora_f), lane


@pytest.mark.parametrize("b_max", [0, 1, 8])
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 1023, 1024, 1025])
def test_srpt_plain_at_the_tree_word_edges(n, b_max):
    arr, tok = _inputs(n, 3, seed=n)
    caps = [b_max] * 3
    starts, first = _run(arr, tok, caps)
    _equal_to_oracle(arr, tok, caps, starts, first, range(3))
    assert first[0].all()                   # request 0 heads the first batch


def test_srpt_plain_all_arrivals_equal():
    arr, tok = _inputs(3001, 3, seed=1)
    arr[:] = 5.0
    caps = [8, 0, 3]
    starts, first = _run(arr, tok, caps)
    _equal_to_oracle(arr, tok, caps, starts, first, range(3))
    # no cap: the idle server starts the lowest rank alone at 5, then takes
    # every other request in one batch
    assert first[:, 1].sum() == 2 and (starts[:, 1] == 5.0).sum() == 1
    assert starts[np.argsort(tok[:, 1], kind="stable")[0], 1] == 5.0


def test_srpt_plain_unsorted_arrivals():
    arr, tok = _inputs(3001, 3, seed=2, distinct=True)
    arr = np.random.default_rng(2).permutation(arr)
    arr[::7] = arr[3::7]                    # runs of equal arrivals
    caps = [8, 0, 3]
    starts, first = _run(arr, tok, caps)
    _equal_to_oracle(arr, tok, caps, starts, first, range(3))


def test_srpt_plain_caps_of_n_and_more_are_no_cap():
    n = 2001
    arr, tok = _inputs(n, 1, seed=3)
    arr, tok = np.repeat(arr, 3, axis=1), np.repeat(tok, 3, axis=1)
    starts, first = _run(arr, tok, [n, n + 5, 0])
    _equal_to_oracle(arr, tok, [n, n + 5, 0], starts, first, range(3))
    assert np.array_equal(starts[:, 0], starts[:, 2])
    assert np.array_equal(starts[:, 1], starts[:, 2])


def test_srpt_plain_nan_arrival_in_one_lane():
    """An unserved NaN arrival ends its lane at the first batch that would
    start on an idle server; the other lanes are untouched."""
    n = 2001
    arr, tok = _inputs(n, 3, seed=4, distinct=True)
    arr[n // 2, 2] = np.nan
    starts, first = _run(arr, tok, [8, 0, 3])
    _equal_to_oracle(arr, tok, [8, 0, 3], starts, first, range(2))
    inf = arr[:, 2].copy()
    inf[n // 2] = np.inf
    ora_s, ora_f, served = _oracle(inf, tok[:, 2], 3, stop_when_idle=True)
    assert 0 < served.sum() < n and not served[n // 2]
    assert np.array_equal(starts[served, 2], ora_s[served])
    assert np.array_equal(first[:, 2], ora_f)


def test_srpt_plain_one_cap_per_lane():
    arr, tok = _inputs(4001, 6, seed=5)
    caps = [1, 2, 16, 0, 33, 1000]
    starts, first = _run(arr, tok, caps)
    _equal_to_oracle(arr, tok, caps, starts, first, range(6))
    # a cap of 1 serves every request alone
    assert first[:, 0].all()
