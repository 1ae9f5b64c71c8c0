"""The dispatch point (``ops.spmm``): which path runs for each mode and
cached structure, which structure ``precompute`` builds, and that every
gate tests a cached value, not the presence of its key."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import (GCNConv, add_self_loops, precompute, rand_graph,
                            setup, update_graph)
from neuralgraphpde.graph.builders import delaunay_graph, grid_graph_2d
from neuralgraphpde.ops.spmm import set_spmm_mode

spmm_mod = importlib.import_module("neuralgraphpde.ops.spmm")

# formats only the removed hand-written kernels read; nothing may build them
REMOVED_FORMATS = {"tcsr", "tcsr_rev", "tcsr_edges", "tcsr_groups",
                   "tcsr_groups_rev", "banded", "banded_rev", "banded_norm",
                   "banded_norm_rev", "pbanded", "pbanded_rev",
                   "pbanded_norm", "pbanded_norm_rev", "bsr", "dia_rev",
                   "dia_norm", "dia_norm_rev"}


@pytest.mark.parametrize("mode", ["pallas", "bsr", "tcsr", "banded"])
def test_removed_mode_names_rejected(mode):
    with pytest.raises(ValueError):
        set_spmm_mode(mode)


@pytest.mark.parametrize("mode", ["auto", "xla", "dense"])
def test_kept_mode_names_accepted(mode):
    set_spmm_mode(mode)
    try:
        assert spmm_mod.get_spmm_mode() == mode
    finally:
        set_spmm_mode("auto")


def _graph(kind):
    if kind == "grid":
        return add_self_loops(grid_graph_2d(40, 32, diagonals=True)), {}
    if kind == "reordered_delaunay":
        pts = np.random.default_rng(0).uniform(size=(1200, 2))
        return delaunay_graph(pts), {"auto_reorder": True}
    if kind == "random":
        return rand_graph(900, 7200, seed=1), {}
    return grid_graph_2d(48, 40, periodic=True), {}


@pytest.mark.parametrize("add_loops", [False, True])
@pytest.mark.parametrize("kind", ["grid", "reordered_delaunay", "random",
                                  "periodic_hybrid"])
def test_precompute_builds_only_read_structure(monkeypatch, kind, add_loops):
    """No removed format is built; the stencil storage only on stencil
    graphs, its remainder only where diagonals do not cover every edge."""
    monkeypatch.setattr(spmm_mod, "REORDER_BLOCK", 64)
    g, kw = _graph(kind)
    gp = precompute(g, dense=False, add_self_loops=add_loops, **kw)
    assert not REMOVED_FORMATS & set(gp.cache), sorted(gp.cache)
    assert ("dia" in gp.cache) is (kind in ("grid", "periodic_hybrid"))
    assert ("dia_rem" in gp.cache) is (kind == "periodic_hybrid")
    assert gp.receivers_sorted and "csr_offsets" in gp.cache


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("case,want", [
    ("dense", "spmm_dense"), ("dia", "spmm_dia"), ("plain", "spmm_xla"),
    ("weighted_dia", "spmm_xla"), ("xla_mode_dia", "spmm_xla"),
    ("dense_mode_dia", "spmm_xla"), ("adj_none", "spmm_dia"),
    ("dia_none", "spmm_xla")])
def test_spmm_path_choice(monkeypatch, case, want):
    g = grid_graph_2d(24, 20, diagonals=True)
    gp = precompute(g, dense=(case == "dense"),
                    dia=case != "plain")
    if case == "adj_none":  # a gate must test the value, not the key
        gp = gp.copy(cache={**gp.cache, "adj": None})
    if case == "dia_none":
        gp = gp.copy(cache={**gp.cache, "dia": None})
    x = jnp.asarray(np.random.default_rng(2).normal(size=(g.num_nodes, 4)),
                    jnp.float32)
    ref = spmm_mod.spmm_xla(g, x)
    calls = {n: _spy(monkeypatch, spmm_mod, n)
             for n in ("spmm_dense", "spmm_dia", "spmm_xla")}
    w = jnp.ones((g.num_edges,)) if case == "weighted_dia" else None
    set_spmm_mode({"xla_mode_dia": "xla",
                   "dense_mode_dia": "dense"}.get(case, "auto"))
    try:
        y = spmm_mod.spmm(gp, x, edge_weight=w)
    finally:
        set_spmm_mode("auto")
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref), atol=1e-5)
    assert [n for n, c in calls.items() if c] == [want]


def test_gcnconv_structure_gates_test_values():
    """GCNConv's rebuild warning (cached structure dropped by runtime
    self-loops) fires for a cached value and not for a ``None`` entry."""
    import warnings

    g = precompute(grid_graph_2d(24, 20, diagonals=True), dense=False)
    layer = GCNConv(4, 4)  # default add_self_loops=True
    ps, st = setup(jax.random.PRNGKey(0), layer)
    x = jnp.ones((g.num_nodes, 4), jnp.float32)
    for cache, want in (({**g.cache}, True),
                        ({**g.cache, "dia": None}, False)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            layer(x, ps, update_graph(st, g.copy(cache=cache)))
        assert any("precompute" in str(wi.message) for wi in w) is want


def test_precompute_self_loops_keeps_gcn_fast(recwarn):
    """precompute(add_self_loops=True) + default GCNConv: no warning, no
    cache drop, weighted + unweighted forwards match the scatter reference."""
    import warnings

    from neuralgraphpde import GnnGraph

    rng = np.random.default_rng(1)
    n, e = 40, 160
    g0 = GnnGraph.from_coo(rng.integers(0, n, e), rng.integers(0, n, e),
                           num_nodes=n)
    g = precompute(g0, add_self_loops=True, dense=True)
    assert g.cache.get("self_looped") and g.num_edges == e + n

    layer = GCNConv(8, 8)  # defaults: add_self_loops=True
    ps, st = setup(jax.random.PRNGKey(0), layer)
    st = update_graph(st, g)
    x = jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any cache-drop warning -> failure
        y_fast, _ = layer(x, ps, st)

    # reference: raw graph, the layer adds loops itself, scatter path
    st_ref = update_graph(st, g0)
    set_spmm_mode("xla")
    try:
        y_ref, _ = layer(x, ps, st_ref)
    finally:
        set_spmm_mode("auto")
    np.testing.assert_allclose(np.asarray(y_fast), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)

    # original-edge-count runtime weights get unit-padded for the loops
    w = jnp.abs(jnp.asarray(rng.normal(size=(e,)).astype(np.float32))) + 0.1
    y_w, _ = layer(x, ps, st, edge_weight=w)
    set_spmm_mode("xla")
    try:
        y_w_ref, _ = layer(x, ps, st_ref, edge_weight=w)
    finally:
        set_spmm_mode("auto")
    np.testing.assert_allclose(np.asarray(y_w), np.asarray(y_w_ref),
                               rtol=1e-5, atol=1e-5)
