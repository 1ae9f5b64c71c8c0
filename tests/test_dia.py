"""DIA (scalar-diagonal / stencil) SpMM: build, transpose, the XLA stencil
and its remainder split — vs the scatter reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import (GCNConv, GnnGraph, add_self_loops, precompute,
                            rand_graph, setup, update_graph)
from neuralgraphpde.graph.builders import grid_graph_2d
from neuralgraphpde.ops.dia import build_dia, dia_spmm, transpose_dia
from neuralgraphpde.ops.spmm import set_spmm_mode, spmm_xla


def _grid(nx=20, ny=12):
    g = grid_graph_2d(nx, ny, diagonals=True)
    return g, np.asarray(g.senders), np.asarray(g.receivers)


def test_build_and_xla_spmm_matches_scatter():
    g, s, r = _grid()
    dm = build_dia(s, r, g.num_nodes)
    # 8-neighborhood grid without self-loops: 8 scalar offsets
    assert dm is not None and len(dm.offsets) == 8
    x = jnp.asarray(np.random.default_rng(0)
                    .normal(size=(g.num_nodes, 7)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(dia_spmm(dm, x)),
                               np.asarray(spmm_xla(g, x)), atol=1e-4)


def test_weighted_build():
    g, s, r = _grid()
    w = np.random.default_rng(1).random(g.num_edges).astype(np.float32)
    dm = build_dia(s, r, g.num_nodes, edge_weight=w)
    x = jnp.asarray(np.random.default_rng(1)
                    .normal(size=(g.num_nodes, 3)).astype(np.float32))
    want = spmm_xla(g, x, edge_weight=jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(dia_spmm(dm, x)),
                               np.asarray(want), atol=1e-4)


def test_transpose_matches_reverse_build():
    g, s, r = _grid()
    w = np.random.default_rng(2).random(g.num_edges).astype(np.float32)
    dm = build_dia(s, r, g.num_nodes, edge_weight=w)
    dm_rev = build_dia(r, s, g.num_nodes, edge_weight=w)
    dm_t = transpose_dia(dm)
    assert dm_t.offsets == dm_rev.offsets
    np.testing.assert_allclose(np.asarray(dm_t.values),
                               np.asarray(dm_rev.values), atol=1e-6)


def test_unstructured_graph_gates_out():
    g = rand_graph(200, 1500, seed=3)
    assert build_dia(np.asarray(g.senders), np.asarray(g.receivers),
                     g.num_nodes) is None


@pytest.mark.parametrize("act", ["tanh", "relu", None])
def test_gcnconv_on_dia_matches_xla(act):
    """GCNConv on a precompute'd stencil graph (auto: the DIA stencil)
    matches the gather path (xla mode), forward and gradient."""
    g = add_self_loops(grid_graph_2d(16, 12, diagonals=True))
    gp = precompute(g, add_self_loops=False, dense=False)
    assert "dia" in gp.cache
    layer = GCNConv(12, 12, act, add_self_loops=False)
    ps, st = setup(jax.random.PRNGKey(0), layer)
    st = update_graph(st, gp)
    x = jnp.asarray(np.random.default_rng(6)
                    .normal(size=(g.num_nodes, 12)).astype(np.float32))

    def loss(ps, x):
        y, _ = layer(x, ps, st)
        return jnp.sum(y ** 2), y

    set_spmm_mode("xla")
    try:
        (lx, yx), gx = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(ps, x)
    finally:
        set_spmm_mode("auto")
    (lb, yb), gb = jax.value_and_grad(loss, argnums=(0, 1),
                                      has_aux=True)(ps, x)
    np.testing.assert_allclose(np.asarray(yb), np.asarray(yx), atol=2e-5,
                               rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(gx),
                    jax.tree_util.tree_leaves(gb)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_dia_spmm_gradient_is_transpose(weighted):
    """Autodiff of the shifted-slice stencil equals the stencil of the
    transpose (``transpose_dia``): <A x, y> = <x, Aᵀ y>."""
    g, s, r = _grid(24, 18)
    w = (np.random.default_rng(7).random(g.num_edges).astype(np.float32)
         if weighted else None)
    dm = build_dia(s, r, g.num_nodes, edge_weight=w)
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(g.num_nodes, 5)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(g.num_nodes, 5)).astype(np.float32))
    gx = jax.grad(lambda v: jnp.vdot(dia_spmm(dm, v), y))(x)
    np.testing.assert_allclose(np.asarray(gx),
                               np.asarray(dia_spmm(transpose_dia(dm), y)),
                               atol=1e-5)


# ---------------------------------------------------------------- hybrid DIA
def _periodic_grid(nx=40, ny=32):
    g = grid_graph_2d(nx, ny, periodic=True)
    return g, np.asarray(g.senders), np.asarray(g.receivers)


def test_hybrid_build_on_periodic_grid():
    from neuralgraphpde.ops.dia import build_dia_hybrid

    g, s, r = _periodic_grid()
    # full DIA refuses nothing here (few offsets) but the wrap offsets blow
    # the kernel bandwidth gate — the hybrid keeps the interior stencil and
    # spills the wrap edges
    hyb = build_dia_hybrid(s, r, g.num_nodes, bw_limit=64)
    assert hyb is not None
    dm, rs, rr, rw = hyb
    assert max(abs(d) for d in dm.offsets) <= 64
    # remainder = the wrap edges: 2 per boundary node per wrapped dimension
    assert 0 < len(rs) < 0.1 * g.num_edges
    # split is exact: DIA part + remainder == full scatter
    x = jnp.asarray(np.random.default_rng(2)
                    .normal(size=(g.num_nodes, 5)).astype(np.float32))
    from neuralgraphpde.ops.dia import dia_remainder_spmm

    got = dia_spmm(dm, x) + dia_remainder_spmm(
        (jnp.asarray(rs), jnp.asarray(rr), jnp.asarray(rw)), x, g.num_nodes)
    np.testing.assert_allclose(np.asarray(got), np.asarray(spmm_xla(g, x)),
                               atol=1e-4)


def test_hybrid_rejects_unstructured():
    from neuralgraphpde.ops.dia import build_dia_hybrid

    rng = np.random.default_rng(3)
    n, e = 4096, 40960
    s = rng.integers(0, n, e).astype(np.int64)
    r = rng.integers(0, n, e).astype(np.int64)
    assert build_dia_hybrid(s, r, n) is None


def test_hybrid_precompute_dispatch_and_grad():
    """precompute on a periodic grid engages the hybrid (dia + dia_rem) and
    spmm matches the scatter path, forward + gradient."""
    from neuralgraphpde.ops.spmm import precompute as _pre
    from neuralgraphpde.ops.spmm import spmm

    g, s, r = _periodic_grid(64, 48)
    gp = _pre(g, dense=False)
    assert "dia" in gp.cache and "dia_rem" in gp.cache

    x = jnp.asarray(np.random.default_rng(4)
                    .normal(size=(g.num_nodes, 6)).astype(np.float32))

    def f(x, graph):
        return jnp.sum(spmm(graph, x) ** 2)

    lx, gx = jax.value_and_grad(f)(x, g)  # no cache: XLA scatter
    lp, gp_ = jax.value_and_grad(f)(x, gp)
    np.testing.assert_allclose(float(lp), float(lx), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(gp_), np.asarray(gx), atol=2e-3,
                               rtol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dia_spmm_dtype_contract(dtype):
    """The stencil accumulates in float32 and returns the input dtype."""
    g, s, r = _grid(16, 16)
    dm = build_dia(s, r, g.num_nodes)
    x = jnp.asarray(np.random.default_rng(11).normal(
        size=(g.num_nodes, 8)), dtype)
    y = dia_spmm(dm, x)
    assert y.dtype == jnp.dtype(dtype)
    want = np.asarray(spmm_xla(g, x.astype(jnp.float32)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.max(np.abs(np.asarray(y, np.float32) - want)) <= \
        tol * np.max(np.abs(want))
