"""Fused ϕ-then-sum (``nn.conv._phi_aggregate``): the penultimate-width
reduce against the exact ϕ-then-segment-reduce reference, forward and
gradients, through the public layer API, in the default and the xla mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import (ExplicitEdgeConv, MPPDEConv, VMHConv, precompute,
                            rand_graph, setup, update_graph)
from neuralgraphpde.nn import conv
from neuralgraphpde.nn.basic import MLP, Dense
from neuralgraphpde.ops.spmm import set_spmm_mode

PATHS = ["auto", "xla"]


def _mk_graph(rng, n=50, e=300, pos_dim=2, gdata=None):
    g = rand_graph(n, e, seed=int(rng.integers(1 << 30)))
    nd = {"x": jnp.asarray(rng.normal(size=(n, pos_dim)).astype(np.float32))}
    g = g.replace(ndata=nd, gdata=gdata or {})
    return precompute(g, dense=False)


def _run_both(request, path, layer, x, extra_graph=None, seed=0):
    """Exact unfused reference vs the fused path in mode ``path``: returns
    ``((y_ref, grads_ref), (y, grads))``."""
    rng = np.random.default_rng(seed)
    g = extra_graph if extra_graph is not None else _mk_graph(rng)
    ps, st = setup(jax.random.PRNGKey(seed), layer)
    st = update_graph(st, g)

    def loss(ps, x):
        y, _ = layer(x, ps, st)
        return jnp.sum(y ** 2), y

    grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "fused_phi_plan", lambda *a: None)
        (_, y_ref), g_ref = grad(ps, x)
    used = []
    orig = conv.edge_mlp_sum
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "edge_mlp_sum",
                   lambda *a, **k: used.append(1) or orig(*a, **k))
        set_spmm_mode(path)
        try:
            (_, y), g_got = grad(ps, x)
        finally:
            set_spmm_mode("auto")
    assert used, "the fused path did not run"
    return (np.asarray(y_ref), g_ref), (np.asarray(y), g_got)


def _tree_close(a, b, atol):
    fa, _ = jax.tree_util.tree_flatten(a)
    fb, _ = jax.tree_util.tree_flatten(b)
    assert len(fa) == len(fb)
    for la, lb in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(la), np.asarray(lb), atol=atol,
                                   rtol=1e-4)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_vmh_fused_matches_xla(request, path, aggr):
    rng = np.random.default_rng(0)
    layer = VMHConv(MLP((1 + 1 + 2, 16, 16, 8), "tanh"), MLP((1 + 8, 16, 1)),
                    aggr=aggr)
    x = jnp.asarray(rng.normal(size=(50, 1)).astype(np.float32))
    (yx, gx), (yp, gp) = _run_both(request, path, layer, x)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)
    _tree_close(gp, gx, atol=1e-3)


@pytest.mark.parametrize("path", PATHS)
def test_explicit_edge_fused_matches_xla(request, path):
    rng = np.random.default_rng(1)
    layer = ExplicitEdgeConv(MLP((3 + 3 + 2, 16, 8), "relu"), aggr="mean")
    x = jnp.asarray(rng.normal(size=(50, 3)).astype(np.float32))
    (yx, gx), (yp, gp) = _run_both(request, path, layer, x, seed=1)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)
    _tree_close(gp, gx, atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("path", PATHS)
def test_mppde_fused_matches_xla(request, path):
    rng = np.random.default_rng(2)
    n, e = 48, 288
    gdata = {"theta": jnp.asarray(rng.normal(size=(1, 3)).astype(np.float32))}
    g = _mk_graph(rng, n=n, e=e, gdata=gdata)
    hidden = 8
    fin = hidden * 2 + 2 + 3  # hi, hj, di-dj(pos), theta
    layer = MPPDEConv(MLP((fin, 16, 16, hidden), "tanh"),
                      MLP((hidden * 2 + 3, 16, hidden)), aggr="mean")
    x = jnp.asarray(rng.normal(size=(n, hidden)).astype(np.float32))
    (yx, gx), (yp, gp) = _run_both(request, path, layer, x, extra_graph=g,
                                   seed=2)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)
    _tree_close(gp, gx, atol=1e-3)


@pytest.mark.parametrize("path", PATHS)
def test_fused_final_activation_no_commute(request, path):
    """ϕ ending in a nonlinear layer is summed whole (no linear split)."""
    rng = np.random.default_rng(3)
    layer = ExplicitEdgeConv(
        MLP((3 + 3 + 2, 16, 8), "tanh", final_activation="tanh"),
        aggr="sum")
    x = jnp.asarray(rng.normal(size=(50, 3)).astype(np.float32))
    (yx, gx), (yp, gp) = _run_both(request, path, layer, x, seed=3)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)
    _tree_close(gp, gx, atol=1e-3)


@pytest.mark.parametrize("path", PATHS)
def test_fused_bare_dense_phi(request, path):
    """ϕ = single Dense (unnamed params)."""
    rng = np.random.default_rng(4)
    layer = ExplicitEdgeConv(Dense(3 + 3 + 2, 8, "tanh"), aggr="sum")
    x = jnp.asarray(rng.normal(size=(50, 3)).astype(np.float32))
    (yx, gx), (yp, gp) = _run_both(request, path, layer, x, seed=4)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)
    _tree_close(gp, gx, atol=1e-3)


@pytest.mark.parametrize("path", PATHS)
def test_fused_isolated_receivers_mean(request, path):
    """Zero-degree nodes must aggregate to 0 under mean, not the bias (the
    linear-commute edge case)."""
    rng = np.random.default_rng(5)
    n = 24
    # all edges point at nodes 0..7; nodes 8+ have no in-edges
    s = rng.integers(0, n, 100).astype(np.int32)
    r = rng.integers(0, 8, 100).astype(np.int32)
    from neuralgraphpde import GnnGraph

    g = GnnGraph.from_coo(s, r, num_nodes=n)
    g = g.replace(ndata={"x": jnp.asarray(
        rng.normal(size=(n, 2)).astype(np.float32))})
    g = precompute(g, dense=False)
    layer = VMHConv(MLP((1 + 1 + 2, 16, 4), "tanh"), MLP((1 + 4, 8, 1)),
                    aggr="mean")
    x = jnp.asarray(rng.normal(size=(n, 1)).astype(np.float32))
    (yx, _), (yp, _) = _run_both(request, path, layer, x, extra_graph=g,
                                 seed=5)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("path", PATHS)
def test_fused_backward_inside_checkpoint_adjoint(request, path):
    """The checkpoint-replay adjoint vjps through the RHS — the fused path
    must give the same parameter gradients as the exact path when ϕ runs
    inside a NeuralGraphODE solve."""
    from neuralgraphpde import NeuralGraphODE

    rng = np.random.default_rng(7)
    g = _mk_graph(rng, n=40, e=240)
    core = VMHConv(MLP((1 + 1 + 2, 12, 12, 6), "tanh"), MLP((1 + 6, 12, 1)))
    node = NeuralGraphODE(core, tspan=(0.0, 0.1), saveat=(0.0, 0.05, 0.1),
                          adjoint="checkpoint", checkpoint_steps=16)
    x = jnp.asarray(rng.normal(size=(40, 1)).astype(np.float32))
    (yx, gx), (yp, gp) = _run_both(request, path, node, x, extra_graph=g,
                                   seed=7)
    np.testing.assert_allclose(yp, yx, atol=1e-4, rtol=1e-4)
    _tree_close(gp, gx, atol=1e-4)


def test_unsorted_graph_takes_exact_path(monkeypatch):
    """The fused path needs receiver-sorted edges; an unsorted graph runs
    ϕ-then-segment-reduce."""
    rng = np.random.default_rng(8)
    g = rand_graph(30, 120, seed=8)
    assert not g.receivers_sorted
    g = g.replace(ndata={"x": jnp.asarray(
        rng.normal(size=(30, 2)).astype(np.float32))})
    used = []
    monkeypatch.setattr(conv, "edge_mlp_sum",
                        lambda *a, **k: used.append(1))
    layer = VMHConv(MLP((4, 8, 4), "tanh"), MLP((5, 8, 1)))
    ps, st = setup(jax.random.PRNGKey(0), layer)
    y, _ = layer(jnp.ones((30, 1)), ps, update_graph(st, g))
    assert not used and y.shape == (30, 1)
