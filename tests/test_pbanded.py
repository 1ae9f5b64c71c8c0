"""Packed (row-list) block bands (``ops.bsr.PackedBanded``): the builder
and its XLA product against the scatter reference. No dispatch path reads
this format (gather + sorted segment sum was faster on the H200, PERF.md);
it stays a library function until a cleanup removes it.
"""
import jax
import jax.numpy as jnp
import numpy as np

from neuralgraphpde.graph.builders import delaunay_graph
from neuralgraphpde.graph.gnngraph import GnnGraph
from neuralgraphpde.graph.reorder import rcm_order
from neuralgraphpde.ops.bsr import (
    build_packed_banded,
    packed_banded_spmm,
    transpose_packed_banded,
)
from neuralgraphpde.ops.spmm import spmm_xla


def _rcm_delaunay(n=700, seed=2):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2)).astype(np.float32)
    g = delaunay_graph(pts)
    s = np.asarray(g.senders).astype(np.int64)
    r = np.asarray(g.receivers).astype(np.int64)
    order = rcm_order(s, r, g.num_nodes)
    inv = np.empty(g.num_nodes, np.int64)
    inv[order] = np.arange(g.num_nodes)
    return inv[s], inv[r], g.num_nodes, rng


def test_builder_matches_scatter_reference():
    s, r, n, rng = _rcm_delaunay()
    ew = rng.uniform(0.5, 1.5, size=len(s)).astype(np.float32)
    pb = build_packed_banded(s, r, n, tb=128, edge_weight=ew)
    assert pb is not None
    x = jnp.asarray(rng.normal(size=(n, 16)).astype(np.float32))
    g = GnnGraph.from_coo(s.astype(np.int32), r.astype(np.int32),
                          num_nodes=n)
    want = np.asarray(spmm_xla(g, x, jnp.asarray(ew)))
    got = np.asarray(packed_banded_spmm(pb, x))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # transpose = reversed edges
    pbt = transpose_packed_banded(s, r, n, tb=128, edge_weight=ew)
    gt = GnnGraph.from_coo(r.astype(np.int32), s.astype(np.int32),
                           num_nodes=n)
    np.testing.assert_allclose(np.asarray(packed_banded_spmm(pbt, x)),
                               np.asarray(spmm_xla(gt, x, jnp.asarray(ew))),
                               atol=1e-4)


def test_rectangular_blocks_match():
    """Tall 512x128 blocks must agree with the scatter reference."""
    s, r, n, rng = _rcm_delaunay(n=3000, seed=4)
    ew = rng.uniform(0.5, 1.5, size=len(s)).astype(np.float32)
    pb = build_packed_banded(s, r, n, tb=128, tb_rows=512, edge_weight=ew)
    assert pb is not None and pb.row_height == 512
    x = jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))
    g = GnnGraph.from_coo(s.astype(np.int32), r.astype(np.int32),
                          num_nodes=n)
    want = np.asarray(spmm_xla(g, x, jnp.asarray(ew)))
    got = np.asarray(packed_banded_spmm(pb, x))
    np.testing.assert_allclose(got, want, atol=1e-4)
