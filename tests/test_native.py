"""Native (C++) graph-ops parity vs NumPy references."""
import numpy as np
import pytest

from neuralgraphpde import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def test_sort_by_receiver_matches_numpy():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 100, 5000).astype(np.int32)
    perm = native.sort_by_receiver(r, 100)
    want = np.argsort(r, kind="stable")
    assert np.array_equal(perm, want)


def test_csr_offsets():
    rng = np.random.default_rng(1)
    r = np.sort(rng.integers(0, 50, 1000)).astype(np.int32)
    off = native.csr_offsets(r, 50)
    counts = np.bincount(r, minlength=50)
    want = np.concatenate([[0], np.cumsum(counts)])
    assert np.array_equal(off, want)


def test_greedy_partition_balanced():
    rng = np.random.default_rng(3)
    n, e, p = 1000, 20000, 8
    r = rng.integers(0, n, e).astype(np.int32)
    part = native.greedy_partition(r, n, p)
    assert part.shape == (n,)
    assert part.min() >= 0 and part.max() < p
    # edge load balance within 20%
    edge_load = np.bincount(part[r], minlength=p)
    assert edge_load.max() <= 1.2 * edge_load.mean()


def test_radius_graph_matches_scipy():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 1, size=(300, 2)).astype(np.float32)
    s, r = native.radius_graph_2d(pts, 0.1)
    got = set(zip(s.tolist(), r.tolist()))

    tree = cKDTree(pts)
    pairs = tree.query_pairs(0.1, output_type="ndarray")
    want = set()
    for i, j in pairs:
        want.add((int(i), int(j)))
        want.add((int(j), int(i)))
    assert got == want
