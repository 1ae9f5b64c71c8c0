"""``nn.conv.edge_mlp_sum`` — ϕ's Dense layers over all edges, then a
sorted segment sum — against a numpy evaluation: activations, per-edge
weights, empty receivers, input widths, batching, and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde.nn.conv import edge_mlp_sum

NP_ACTS = {"tanh": np.tanh, "relu": lambda v: np.maximum(v, 0.0),
           "sigmoid": lambda v: 1.0 / (1.0 + np.exp(-v)),
           None: lambda v: v}


def _problem(fin=4, widths=(24, 24), n=70, e=500, seed=0, empty=(5, 6)):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e)
    r = np.sort(r[~np.isin(r, empty)]).astype(np.int32)
    dims = (fin,) + widths
    ws = [rng.normal(size=(a, b)) / np.sqrt(a)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(size=(1, b)) for b in dims[1:]]
    feats = rng.normal(size=(len(r), fin))
    wts = rng.uniform(0.5, 1.5, size=len(r))
    return feats, ws, bs, r, n, wts


def _numpy(acts, feats, ws, bs, r, n, wts):
    h = feats
    for w, b, a in zip(ws, bs, acts):
        h = NP_ACTS[a](h @ w + b)
    if wts is not None:
        h = h * wts[:, None]
    out = np.zeros((n, h.shape[1]))
    np.add.at(out, r, h)
    return out


def _j(a):
    return jnp.asarray(a, jnp.float32)


@pytest.mark.parametrize("acts", [("tanh", "tanh"), ("relu", None),
                                  ("sigmoid", "tanh")])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fin", [2, 4, 16])
def test_matches_numpy(acts, weighted, fin):
    feats, ws, bs, r, n, wts = _problem(fin=fin)
    w = wts if weighted else None
    with jax.default_matmul_precision("highest"):
        got = edge_mlp_sum(acts, _j(feats), [_j(v) for v in ws],
                           [_j(v) for v in bs], jnp.asarray(r), n,
                           None if w is None else _j(w))
    want = _numpy(acts, feats, ws, bs, r, n, w)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)
    # receivers with no edges sum to exactly zero
    assert not np.any(np.asarray(got)[[5, 6]])


def test_under_vmap():
    """Batches of simulations share the graph (the VMH training path)."""
    feats, ws, bs, r, n, _ = _problem(seed=2)
    fb = _j(np.stack([feats, -feats, 2 * feats]))
    acts = ("tanh", "tanh")
    with jax.default_matmul_precision("highest"):
        got = jax.vmap(lambda f: edge_mlp_sum(
            acts, f, [_j(v) for v in ws], [_j(v) for v in bs],
            jnp.asarray(r), n))(fb)
    for i, f in enumerate((feats, -feats, 2 * feats)):
        np.testing.assert_allclose(np.asarray(got[i]),
                                   _numpy(acts, f, ws, bs, r, n, None),
                                   atol=1e-4)


def test_gradient_matches_finite_differences():
    feats, ws, bs, r, n, wts = _problem(fin=3, widths=(8, 6), n=20, e=80,
                                        seed=3, empty=())
    acts = ("tanh", "sigmoid")
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda a: jnp.asarray(a, jnp.float64)

        def loss(f):
            return jnp.sum(jnp.sin(edge_mlp_sum(
                acts, f, [f64(v) for v in ws], [f64(v) for v in bs],
                jnp.asarray(r), n, f64(wts))))

        g = np.asarray(jax.grad(loss)(f64(feats)))
        eps = 1e-6
        for (i, j) in [(0, 0), (7, 2), (41, 1)]:
            fp, fm = feats.copy(), feats.copy()
            fp[i, j] += eps
            fm[i, j] -= eps
            fd = (float(loss(f64(fp))) - float(loss(f64(fm)))) / (2 * eps)
            assert abs(g[i, j] - fd) < 1e-6 * max(1.0, abs(fd))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("aggr", ["sum", "mean"])
@pytest.mark.parametrize("layer_kind", ["vmh", "explicit_edge"])
def test_layer_on_weighted_precompute_matches_message_path(
        monkeypatch, aggr, layer_kind):
    """``precompute(edge_weight=w)`` stores a weighted ``in_degree``; the
    fused ϕ path's ``deg·b`` term and mean must still count edges, as the
    message path (ϕ on every edge, then ``segment_reduce``) does."""
    import importlib

    from neuralgraphpde import (MLP, ExplicitEdgeConv, VMHConv, precompute,
                                rand_graph, setup)

    conv = importlib.import_module("neuralgraphpde.nn.conv")
    rng = np.random.default_rng(4)
    n = 60
    pos = rng.normal(size=(n, 2)).astype(np.float32)
    g = rand_graph(n, 400, seed=4, ndata={"x": pos})
    w = rng.uniform(0.2, 3.0, size=g.num_edges).astype(np.float32)
    gp = precompute(g, dense=False, edge_weight=jnp.asarray(w))
    assert not np.allclose(np.asarray(gp.cache["in_degree"]),
                           np.bincount(np.asarray(g.receivers), minlength=n))
    h = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    # ϕ ends in a linear Dense with a bias: the post-reduce split runs
    if layer_kind == "vmh":
        layer = VMHConv(MLP((3 + 3 + 2, 12, 5), activation="tanh"),
                        MLP((3 + 5, 8, 3), activation="tanh"), aggr=aggr)
    else:
        layer = ExplicitEdgeConv(MLP((3 + 3 + 2, 12, 5), activation="tanh"),
                                 aggr=aggr)
    ps, st = setup(jax.random.PRNGKey(3), layer)
    # biases start at zero; make them count
    ps = jax.tree_util.tree_map(
        lambda a: a + 0.3 * jnp.asarray(rng.normal(size=a.shape), a.dtype), ps)
    st = {**st, "graph": gp}
    phi_ps = ps["phi"] if layer_kind == "vmh" else ps
    assert conv.fused_phi_plan(layer.phi, phi_ps, aggr)[3] is not None
    with jax.default_matmul_precision("highest"):
        got, _ = layer(h, ps, st)
        monkeypatch.setattr(conv, "fused_phi_plan", lambda *a: None)
        want, _ = layer(h, ps, st)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
