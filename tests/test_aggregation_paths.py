"""The XLA aggregation paths ``precompute`` selects — DIA stencil, DIA plus
COO remainder, gather + sorted segment sum on an RCM-relabeled mesh and on
a random graph — against a numpy reference, for sum, max and min, with and
without edge weights, in float32 and bfloat16."""
import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import add_self_loops, precompute, rand_graph
from neuralgraphpde.graph.builders import delaunay_graph, grid_graph_2d
from neuralgraphpde.ops import aggregate_neighbors, spmm

spmm_mod = importlib.import_module("neuralgraphpde.ops.spmm")

GRAPHS = ["grid", "reordered_delaunay", "random", "periodic_hybrid"]


def _graph(kind):
    if kind == "grid":
        g = precompute(add_self_loops(grid_graph_2d(48, 40, diagonals=True)),
                       dense=False)
        assert "dia" in g.cache and "dia_rem" not in g.cache
    elif kind == "reordered_delaunay":
        pts = np.random.default_rng(0).uniform(size=(1200, 2))
        # a mesh this small needs smaller blocks in the auto-reorder gate
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(spmm_mod, "REORDER_BLOCK", 64)
            g = precompute(delaunay_graph(pts), dense=False,
                           auto_reorder=True)
        assert "node_order" in g.cache and "dia" not in g.cache
    elif kind == "random":
        g = precompute(rand_graph(900, 7200, seed=1), dense=False)
        assert "dia" not in g.cache
    else:
        g = precompute(grid_graph_2d(64, 48, periodic=True), dense=False)
        assert "dia" in g.cache and "dia_rem" in g.cache
    return g


_CACHE = {}


def _cached(kind):
    if kind not in _CACHE:
        _CACHE[kind] = _graph(kind)
    return _CACHE[kind]


def _reference(s, r, n, x, w, red):
    xj = x[s] * (1.0 if w is None else w[:, None])
    if red == "sum":
        out = np.zeros((n, x.shape[1]))
        np.add.at(out, r, xj)
    elif red == "max":
        out = np.full((n, x.shape[1]), -np.inf)
        np.maximum.at(out, r, xj)
    else:
        out = np.full((n, x.shape[1]), np.inf)
        np.minimum.at(out, r, xj)
    return out


@pytest.mark.parametrize("red", ["sum", "max", "min"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", GRAPHS)
def test_path_matches_numpy(kind, dtype, weighted, red):
    g = _cached(kind)
    rng = np.random.default_rng(
        zlib.crc32(f"{kind}/{dtype}/{weighted}/{red}".encode()))
    x = jnp.asarray(rng.normal(size=(g.num_nodes, 8)), dtype)
    w = (jnp.asarray(rng.uniform(0.5, 1.5, size=g.num_edges), dtype)
         if weighted else None)
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    x64 = np.asarray(x, np.float64)
    w64 = None if w is None else np.asarray(w, np.float64)
    want = _reference(s, r, g.num_nodes, x64, w64, red)
    if red == "sum":
        got = spmm(g, x, edge_weight=w)
    else:
        msgs = x[g.senders]
        if w is not None:
            msgs = msgs * w[:, None]
        got = aggregate_neighbors(g, red, msgs)
    assert got.dtype == x.dtype and got.shape == want.shape
    got = np.asarray(got, np.float64)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    scale = np.max(np.abs(want[finite]))
    # f32: summation order only; bf16: inputs and sums rounded to 8 bits
    tol = 1e-5 if dtype == "float32" else 3e-2
    assert np.max(np.abs(got[finite] - want[finite])) <= tol * scale
