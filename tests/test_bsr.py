"""Block-sparse SpMM tests: parity with scatter reference, dispatch, grads."""
import jax
import jax.numpy as jnp
import numpy as np

from neuralgraphpde import grid_graph_2d, rand_graph
from neuralgraphpde.ops.bsr import bsr_spmm, build_bsr
from neuralgraphpde.ops.spmm import spmm_xla


def test_bsr_matches_reference():
    rng = np.random.default_rng(0)
    n, e = 100, 800
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    bsr = build_bsr(s, r, n, tb=16)
    got = np.asarray(bsr_spmm(bsr, jnp.asarray(x)))
    want = np.zeros((n, 16), np.float32)
    for k in range(e):
        want[r[k]] += x[s[k]]
    assert np.allclose(got, want, atol=1e-4)


def test_bsr_weighted():
    rng = np.random.default_rng(1)
    n, e = 64, 400
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    bsr = build_bsr(s, r, n, tb=16, edge_weight=w)
    got = np.asarray(bsr_spmm(bsr, jnp.asarray(x)))
    want = np.zeros((n, 8), np.float32)
    for k in range(e):
        want[r[k]] += w[k] * x[s[k]]
    assert np.allclose(got, want, atol=1e-4)


def test_bsr_density_gate_and_dispatch():
    from neuralgraphpde.ops import precompute, spmm

    # spatial mesh: the grid is scalar-diagonal -> the DIA stencil, and no
    # block format is built
    g = grid_graph_2d(32, 32)
    gp = precompute(g, dense=False)
    assert "dia" in gp.cache
    assert not ({"bsr", "banded", "pbanded"} & set(gp.cache))
    x = jnp.asarray(np.random.default_rng(2).normal(size=(1024, 8))
                    .astype(np.float32))
    want = np.asarray(spmm_xla(g, x))
    got = np.asarray(spmm(gp, x))
    assert np.allclose(got, want, atol=1e-4)

    # random graph: no structure is attached, the gather path runs
    gr = rand_graph(256, 8000, seed=3)
    gr2 = precompute(gr, dense=False)
    assert not ({"bsr", "banded", "dia"} & set(gr2.cache))


def test_bsr_gradient():
    g = grid_graph_2d(8, 8)
    bsr = build_bsr(np.asarray(g.senders), np.asarray(g.receivers),
                    g.num_nodes, tb=16)
    x = jnp.asarray(np.random.default_rng(4).normal(size=(64, 4))
                    .astype(np.float32))

    def loss_bsr(x):
        return jnp.sum(bsr_spmm(bsr, x) ** 2)

    def loss_ref(x):
        return jnp.sum(spmm_xla(g, x) ** 2)

    ga = jax.grad(loss_bsr)(x)
    gb = jax.grad(loss_ref)(x)
    assert np.allclose(np.asarray(ga), np.asarray(gb), atol=1e-3)


def test_banded_matches_reference():
    from neuralgraphpde.ops.bsr import banded_spmm, build_banded

    g = grid_graph_2d(20, 20)
    s = np.asarray(g.senders)
    r = np.asarray(g.receivers)
    n = g.num_nodes
    bm = build_banded(s, r, n, tb=32)
    assert bm is not None
    x = jnp.asarray(np.random.default_rng(5).normal(size=(n, 8))
                    .astype(np.float32))
    got = np.asarray(banded_spmm(bm, x))
    want = np.asarray(spmm_xla(g, x))
    assert np.allclose(got, want, atol=1e-4)


def test_banded_refuses_unstructured():
    from neuralgraphpde.ops.bsr import build_banded

    gr = rand_graph(512, 4000, seed=6)
    bm = build_banded(np.asarray(gr.senders), np.asarray(gr.receivers),
                      512, tb=32, max_bands=8)
    assert bm is None


def test_banded_gradient():
    from neuralgraphpde.ops.bsr import banded_spmm, build_banded

    g = grid_graph_2d(16, 16)
    bm = build_banded(np.asarray(g.senders), np.asarray(g.receivers),
                      g.num_nodes, tb=16)
    assert bm is not None
    x = jnp.asarray(np.random.default_rng(6).normal(size=(256, 4))
                    .astype(np.float32))
    ga = jax.grad(lambda x: jnp.sum(banded_spmm(bm, x) ** 2))(x)
    gb = jax.grad(lambda x: jnp.sum(spmm_xla(g, x) ** 2))(x)
    assert np.allclose(np.asarray(ga), np.asarray(gb), atol=1e-3)


def test_banded_bf16_blocks():
    """bf16-stored bands compute in bf16 with f32 accumulation; output
    dtype follows x; error stays at bf16 level."""
    from neuralgraphpde.ops.bsr import banded_spmm, build_banded

    g = grid_graph_2d(20, 20)
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    x = jnp.asarray(np.random.default_rng(7).normal(size=(g.num_nodes, 8))
                    .astype(np.float32))
    bm16 = build_banded(s, r, g.num_nodes, tb=32, dtype=jnp.bfloat16)
    assert bm16 is not None and bm16.bands.dtype == jnp.bfloat16
    y16 = banded_spmm(bm16, x)
    assert y16.dtype == x.dtype
    want = np.asarray(spmm_xla(g, x))
    rel = (np.linalg.norm(np.asarray(y16) - want) / np.linalg.norm(want))
    assert rel < 2e-2  # bf16 mantissa, f32 accumulate


def test_bsr_bf16_blocks():
    from neuralgraphpde.ops.bsr import bsr_spmm, build_bsr

    g = grid_graph_2d(16, 16)
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    x = jnp.asarray(np.random.default_rng(8).normal(size=(g.num_nodes, 8))
                    .astype(np.float32))
    bsr = build_bsr(s, r, g.num_nodes, tb=16, dtype=jnp.bfloat16)
    y = bsr_spmm(bsr, x)
    assert y.dtype == x.dtype
    want = np.asarray(spmm_xla(g, x))
    rel = np.linalg.norm(np.asarray(y) - want) / np.linalg.norm(want)
    assert rel < 2e-2


def test_gcn_warns_when_self_loops_drop_cache():
    import warnings

    from neuralgraphpde import GCNConv, precompute, setup, update_graph

    g = precompute(grid_graph_2d(8, 8))
    layer = GCNConv(4, 4)  # default add_self_loops=True
    ps, st = setup(jax.random.PRNGKey(0), layer)
    st = update_graph(st, g)
    x = jnp.zeros((g.num_nodes, 4), jnp.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        layer(x, ps, st)
    assert any("precompute" in str(wi.message) for wi in w)
