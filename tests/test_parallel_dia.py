"""Per-partition DIA (stencil) path inside shard_map: strip-partitioned
grid meshes keep their scalar-diagonal structure per partition, so the
sharded SpMM / GCN forward ride the XLA stencil — parity vs the
single-device scatter reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import add_self_loops, rand_graph
from neuralgraphpde.graph.builders import grid_graph_2d
from neuralgraphpde.ops.spmm import spmm_xla
from neuralgraphpde.parallel import (make_mesh, pad_node_features,
                                     partition_graph, shard_node_features,
                                     sharded_spmm)
from neuralgraphpde.parallel.halo import sharded_gcn_forward


@pytest.fixture(scope="module")
def mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _grid_pg(ndev, nx=64, ny=16):
    # ny strips of nx rows: partition blocks are contiguous row ranges —
    # the diagonal offsets survive partitioning
    g = grid_graph_2d(nx, ny, diagonals=True)
    pg = partition_graph(g, ndev, halo=True)
    assert pg.dia_values is not None, "partition DIA did not engage"
    return g, pg


def test_partition_dia_structure(mesh):
    g, pg = _grid_pg(8)
    K = len(pg.dia_offsets)
    assert pg.dia_values.shape[0] == 8 and pg.dia_values.shape[2] == K
    # symmetric union: offsets closed under negation
    assert sorted(-d for d in pg.dia_offsets) == sorted(pg.dia_offsets)
    # every interior edge is represented exactly once
    total = float(jnp.sum(pg.dia_values))
    interior = float(jnp.sum(pg.mask_int))
    assert total == interior


def test_sharded_spmm_dia_matches_single_device(mesh):
    g, pg = _grid_pg(8)
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(g.num_nodes, 12)).astype(np.float32)
    want = np.asarray(spmm_xla(g, jnp.asarray(x_np)))
    x = shard_node_features(pad_node_features(x_np, pg), pg, mesh)
    got = np.asarray(sharded_spmm(pg, x, mesh))[: g.num_nodes]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sharded_spmm_dia_gradient_matches_single_device(mesh):
    """The VJP of the per-partition stencil (autodiff through the shifted
    slices and the halo exchange) equals the scatter reference's."""
    g, pg = _grid_pg(8)
    rng = np.random.default_rng(1)
    x_np = rng.normal(size=(g.num_nodes, 8)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.tanh(spmm_xla(g, v)) ** 2))(
            jnp.asarray(x_np)))
    x = shard_node_features(pad_node_features(x_np, pg), pg, mesh)
    got = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.tanh(sharded_spmm(pg, v, mesh)) ** 2))(x))
    np.testing.assert_allclose(got[: g.num_nodes], want, atol=1e-4)


def test_sharded_gcn_dia_matches_single_device(mesh):
    from neuralgraphpde import GCNConv, precompute, setup, update_graph

    g = add_self_loops(grid_graph_2d(64, 16, diagonals=True))
    pg = partition_graph(g, 8, halo=True)
    assert pg.dia_values is not None
    rng = np.random.default_rng(2)
    in_d, out_d = 6, 5
    x_np = rng.normal(size=(g.num_nodes, in_d)).astype(np.float32)

    layer = GCNConv(in_d, out_d, "tanh", add_self_loops=False)
    ps, st = setup(jax.random.PRNGKey(0), layer)
    st = update_graph(st, g)
    want, _ = layer(jnp.asarray(x_np), ps, st)

    mesh8 = make_mesh(8)
    x = shard_node_features(pad_node_features(x_np, pg), pg, mesh8)
    got = sharded_gcn_forward(pg, x, ps["weight"], ps.get("bias"), mesh8,
                              activation=jnp.tanh)
    np.testing.assert_allclose(np.asarray(got)[: g.num_nodes],
                               np.asarray(want), atol=1e-4, rtol=1e-4)


def test_random_graph_gates_out(mesh):
    g = rand_graph(128, 4000, seed=3)
    pg = partition_graph(g, 8, halo=True)
    assert pg.dia_values is None
