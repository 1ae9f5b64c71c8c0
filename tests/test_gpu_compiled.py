"""Card tier: the aggregation paths and the GCN layer compiled for the GPU,
against float64 numpy references. Skips without a GPU; ``chip_smoke.py``
runs this file on the card (``NGPDE_TEST_ON_GPU=1 pytest -m gpu``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import (GCNConv, add_self_loops, precompute, rand_graph,
                            setup, update_graph)
from neuralgraphpde.graph.builders import grid_graph_2d
from neuralgraphpde.ops import spmm

pytestmark = pytest.mark.gpu


def _numpy_spmm(g, x):
    s, r = np.asarray(g.senders), np.asarray(g.receivers)
    out = np.zeros((g.num_nodes, x.shape[1]))
    np.add.at(out, r, np.asarray(x, np.float64)[s])
    return out


@pytest.mark.parametrize("kind", ["grid", "periodic", "random"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_spmm_compiled(gpu_device, kind, dtype, tol):
    g0 = {"grid": lambda: grid_graph_2d(256, 256, diagonals=True),
          "periodic": lambda: grid_graph_2d(256, 192, periodic=True),
          "random": lambda: rand_graph(1 << 16, 1 << 20, seed=0)}[kind]()
    g = precompute(g0, dense=False)
    assert ("dia" in g.cache) is (kind != "random")
    x = jnp.asarray(np.random.default_rng(0).normal(size=(g.num_nodes, 64)),
                    dtype)
    got = jax.jit(spmm)(g, x)
    assert got.dtype == jnp.dtype(dtype)
    want = _numpy_spmm(g, x)
    err = np.max(np.abs(np.asarray(got, np.float64) - want))
    assert err <= tol * np.max(np.abs(want)), err


def test_gcnconv_compiled_highest(gpu_device):
    """At ``highest`` precision the GCN layer on the card matches a float64
    evaluation to float32 rounding."""
    g = precompute(add_self_loops(grid_graph_2d(128, 96, diagonals=True)),
                   dense=False)
    layer = GCNConv(128, 128, "tanh", add_self_loops=False)
    ps, st = setup(jax.random.PRNGKey(0), layer)
    st = update_graph(st, g)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(g.num_nodes, 128)),
                    jnp.float32)
    with jax.default_matmul_precision("highest"):
        y = jax.jit(lambda x, st: layer(x, ps, st)[0])(x, st)
    deg = np.asarray(g.cache["in_degree"], np.float64)
    c = 1.0 / np.sqrt(deg)
    h = _numpy_spmm(g, np.asarray(x, np.float64) * c[:, None]) * c[:, None]
    want = np.tanh(h @ np.asarray(ps["weight"], np.float64)
                   + np.asarray(ps["bias"], np.float64))
    assert np.max(np.abs(np.asarray(y, np.float64) - want)) < 1e-4
