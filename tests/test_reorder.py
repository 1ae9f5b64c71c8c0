"""Node reordering (RCM / Morton): permutation semantics, bandwidth
reduction, and the payoff — a shuffled mesh becomes near-diagonal."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde.graph import delaunay_graph, grid_graph_2d
from neuralgraphpde.graph.reorder import (
    bandwidth,
    morton_order,
    permute_nodes,
    rcm_order,
    rcm_reorder,
    reorder_graph,
    spatial_reorder,
    unpermute_nodes,
)
from neuralgraphpde.graph.transforms import edges_numpy
from neuralgraphpde.ops.bsr import banded_spmm, build_banded
from neuralgraphpde.ops.spmm import spmm_xla


@pytest.fixture(autouse=True)
def _small_reorder_block(monkeypatch):
    """The meshes here are a few hundred nodes: test the auto-reorder gate
    with blocks to match."""
    monkeypatch.setattr(importlib.import_module("neuralgraphpde.ops.spmm"),
                        "REORDER_BLOCK", 64)


def _shuffled_delaunay(n=400, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2)).astype(np.float32)
    # random node ids destroy any incidental spatial locality
    return delaunay_graph(pts, ndata={"x": pts})


def test_rcm_is_permutation_and_reduces_bandwidth():
    g = _shuffled_delaunay()
    s, r = edges_numpy(g)
    order = rcm_order(s, r, g.num_nodes)
    assert sorted(order.tolist()) == list(range(g.num_nodes))
    inv = np.empty_like(order)
    inv[order] = np.arange(g.num_nodes)
    bw_before = bandwidth(s, r)
    bw_after = bandwidth(inv[s], inv[r])
    assert bw_after < bw_before / 2  # planar mesh: RCM wins big


def test_morton_reduces_bandwidth():
    g = _shuffled_delaunay(seed=1)
    s, r = edges_numpy(g)
    order = morton_order(np.asarray(g.ndata["x"]))
    inv = np.empty_like(order)
    inv[order] = np.arange(g.num_nodes)
    assert bandwidth(inv[s], inv[r]) < bandwidth(s, r)


def test_reorder_graph_spmm_equivalent():
    g = _shuffled_delaunay(seed=2)
    g2, order = rcm_reorder(g)
    x = np.random.default_rng(3).normal(
        size=(g.num_nodes, 8)).astype(np.float32)
    want = np.asarray(spmm_xla(g, jnp.asarray(x)))
    got_perm = spmm_xla(g2, jnp.asarray(permute_nodes(x, order)))
    got = np.asarray(unpermute_nodes(got_perm, order))
    assert np.allclose(got, want, atol=1e-4)
    # ndata rows traveled with the nodes
    assert np.allclose(np.asarray(g2.ndata["x"]),
                       np.asarray(g.ndata["x"])[order])


def test_permute_unpermute_roundtrip():
    order = np.random.default_rng(4).permutation(37)
    x = np.random.default_rng(5).normal(size=(37, 3)).astype(np.float32)
    assert np.allclose(unpermute_nodes(permute_nodes(x, order), order), x)
    xj = jnp.asarray(x)
    assert np.allclose(
        np.asarray(unpermute_nodes(permute_nodes(xj, order), order)), x)


def test_rcm_makes_mesh_banded_eligible():
    # raw random-id Delaunay mesh: not band-structured at tb=32
    g = _shuffled_delaunay(n=600, seed=6)
    s, r = edges_numpy(g)
    assert build_banded(s, r, g.num_nodes, tb=32, max_bands=8) is None
    # after RCM it fits in a handful of block diagonals
    g2, _ = rcm_reorder(g)
    s2, r2 = edges_numpy(g2)
    bm = build_banded(s2, r2, g.num_nodes, tb=32)
    assert bm is not None
    # and the block product agrees with the scatter reference
    x = jnp.asarray(np.random.default_rng(7).normal(
        size=(g.num_nodes, 8)).astype(np.float32))
    assert np.allclose(np.asarray(banded_spmm(bm, x)),
                       np.asarray(spmm_xla(g2, x)), atol=1e-4)


def test_spatial_reorder_uses_ndata_x():
    g = grid_graph_2d(16, 16, ndata={
        "x": np.stack(np.meshgrid(np.arange(16.0), np.arange(16.0),
                                  indexing="ij"), -1).reshape(-1, 2)})
    g2, order = spatial_reorder(g)
    assert sorted(order.tolist()) == list(range(g.num_nodes))
    s2, r2 = edges_numpy(g2)
    assert g2.num_edges == g.num_edges
    # Z-curve keeps neighbors within a quadrant span (far below n=256)
    assert bandwidth(s2, r2) < g.num_nodes // 2


def test_precompute_auto_reorder_unlocks_banded():
    """precompute(auto_reorder=True) on a scrambled-label mesh must relabel
    (cache['node_order']) to a near-diagonal ordering, and stay equivalent
    to the original graph modulo the recorded permutation."""
    from neuralgraphpde.ops.spmm import precompute, spmm

    g = _shuffled_delaunay(n=600, seed=3)
    gp = precompute(g, dense=False, auto_reorder=True)
    assert "node_order" in gp.cache
    order = np.asarray(gp.cache["node_order"])

    x = np.random.default_rng(0).normal(size=(g.num_nodes, 8)) \
        .astype(np.float32)
    want = np.asarray(spmm_xla(g, jnp.asarray(x)))
    got = unpermute_nodes(
        np.asarray(spmm(gp, jnp.asarray(permute_nodes(x, order)))), order)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_precompute_auto_reorder_leaves_random_graph_alone():
    """Uniform random graphs have no narrow ordering — auto_reorder must be
    a no-op (the gather path stays in charge), not a silent quality
    loss."""
    from neuralgraphpde import rand_graph
    from neuralgraphpde.ops.spmm import precompute

    g = rand_graph(600, 600 * 8, seed=1)
    gp = precompute(g, dense=False, auto_reorder=True)
    assert "node_order" not in gp.cache
    assert "dia" not in gp.cache


def test_precompute_auto_reorder_skips_structured_mesh():
    """An already-DIA grid must not be renumbered."""
    from neuralgraphpde.ops.spmm import precompute

    g = grid_graph_2d(32, 32, diagonals=True)
    gp = precompute(g, dense=False, auto_reorder=True)
    assert "node_order" not in gp.cache
    assert "dia" in gp.cache


def test_precompute_auto_reorder_realigns_edge_weights():
    """auto_reorder re-sorts edges by the new receiver labels; supplied
    edge weights arrive in the ORIGINAL edge order and must be realigned
    before they are baked into in_degree (they once silently applied to the
    wrong edges)."""
    from neuralgraphpde.graph.transforms import degree
    from neuralgraphpde.ops.spmm import precompute

    g = _shuffled_delaunay(n=600, seed=5)
    rng = np.random.default_rng(11)
    ew = rng.uniform(0.5, 1.5, size=(g.num_edges,)).astype(np.float32)
    gp = precompute(g, dense=False, auto_reorder=True,
                    edge_weight=jnp.asarray(ew))
    assert "node_order" in gp.cache
    order = np.asarray(gp.cache["node_order"])

    # weighted in-degree must equal the original graph's, permuted
    want_deg = np.asarray(degree(g, jnp.float32, direction="in",
                                 edge_weight=jnp.asarray(ew)))
    got_deg = np.asarray(gp.cache["in_degree"])
    np.testing.assert_allclose(got_deg, permute_nodes(want_deg, order),
                               rtol=1e-5)


def test_precompute_auto_reorder_orig_edge_pos_composed():
    """cache['orig_edge_pos'] must survive the auto_reorder edge
    permutation: the slot it names for original edge i must connect
    (relabeled) s_i -> r_i, so runtime GCN edge weights scatter onto the
    right edges."""
    from neuralgraphpde.ops.spmm import precompute

    g = _shuffled_delaunay(n=600, seed=7)
    s, r = edges_numpy(g)
    orig_edges = g.num_edges
    gp = precompute(g, dense=False, auto_reorder=True,
                    add_self_loops=True)
    assert "node_order" in gp.cache and "orig_edge_pos" in gp.cache
    order = np.asarray(gp.cache["node_order"])
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    pos = np.asarray(gp.cache["orig_edge_pos"])
    s2, r2 = edges_numpy(gp)
    np.testing.assert_array_equal(s2[pos], inv[s[:orig_edges]])
    np.testing.assert_array_equal(r2[pos], inv[r[:orig_edges]])
