"""Per-partition fused ϕ-then-sum inside shard_map: ShardedVMHConv /
ShardedMPPDEConv with a Dense-stack ϕ must ride
``_sharded_propagate_fused`` (``edge_mlp_sum`` + the post-reduce epilogue
per partition, on the 8-device CPU mesh) and match the single-device
layers forward AND in gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import MLP, setup, rand_graph
from neuralgraphpde.parallel import (
    make_mesh, pad_node_features, partition_graph, shard_node_features,
)
from neuralgraphpde.ops.spmm import set_spmm_mode

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= NDEV, "conftest must provide 8 cpu devices"
    return make_mesh(NDEV)


def _count_fused_calls(monkeypatch):
    """Instrument the fused entry so the test can assert it ENGAGED (a
    silent fallback to the message path would still pass parity)."""
    from neuralgraphpde.parallel import halo

    calls = []
    orig = halo._sharded_propagate_fused

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(halo, "_sharded_propagate_fused", spy)
    return calls


def test_sharded_vmh_fused_matches_single_device(mesh, monkeypatch):
    from neuralgraphpde import VMHConv
    from neuralgraphpde.parallel import ShardedVMHConv

    calls = _count_fused_calls(monkeypatch)
    rng = np.random.default_rng(7)
    n = 48
    pos = rng.normal(size=(n, 2)).astype(np.float32)
    g = rand_graph(n, 256, seed=7, ndata={"x": pos})
    h = rng.normal(size=(n, 3)).astype(np.float32)

    # ϕ ends in a linear Dense -> exercises the post-reduce commute too
    phi = MLP((3 + 3 + 2, 12, 6), activation="tanh")
    gamma = MLP((3 + 6, 8, 3), activation="tanh")
    l = VMHConv(phi, gamma, initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(5), l)

    def loss_single(ps, h):
        y, _ = l(h, ps, st)
        return jnp.sum(y ** 2)

    set_spmm_mode("xla")
    try:
        want, gws = jax.value_and_grad(loss_single)(ps, jnp.asarray(h))
    finally:
        set_spmm_mode("auto")

    pg = partition_graph(g, NDEV, halo=True)
    ld = ShardedVMHConv(phi, gamma, mesh=mesh, initialgraph=lambda: pg)
    std = ld.initialstates(jax.random.PRNGKey(5))
    hp = shard_node_features(pad_node_features(h, pg), pg, mesh)

    def loss_dist(ps, hp):
        y, _ = ld(hp, ps, std)
        return jnp.sum(y[:n] ** 2)

    got, gds = jax.value_and_grad(loss_dist)(ps, hp)

    assert calls, "fused per-partition path did not engage"
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(gws),
                    jax.tree_util.tree_leaves(gds)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-4,
                                   rtol=2e-3)


def test_sharded_mppde_fused_matches_single_device(mesh, monkeypatch):
    from neuralgraphpde import MPPDEConv
    from neuralgraphpde.parallel import ShardedMPPDEConv

    calls = _count_fused_calls(monkeypatch)
    rng = np.random.default_rng(9)
    n = 40
    u = rng.normal(size=(n, 2)).astype(np.float32)
    pos = rng.normal(size=(n, 1)).astype(np.float32)
    theta = rng.normal(size=(1, 3)).astype(np.float32)
    g = rand_graph(n, 200, seed=9, ndata={"u": u, "x": pos},
                   gdata={"theta": theta})
    h = rng.normal(size=(n, 4)).astype(np.float32)

    phi = MLP((4 + 4 + 3 + 3, 10, 5), activation="relu")
    psi = MLP((4 + 5 + 3, 10, 4), activation="tanh")
    l = MPPDEConv(phi, psi, initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(2), l)

    def loss_single(ps, h):
        y, _ = l(h, ps, st)
        return jnp.sum(y ** 2)

    set_spmm_mode("xla")
    try:
        want, gws = jax.value_and_grad(loss_single)(ps, jnp.asarray(h))
    finally:
        set_spmm_mode("auto")

    pg = partition_graph(g, NDEV, halo=True)
    ld = ShardedMPPDEConv(phi, psi, mesh=mesh, initialgraph=lambda: pg)
    std = ld.initialstates(jax.random.PRNGKey(2))
    hp = shard_node_features(pad_node_features(h, pg), pg, mesh)

    def loss_dist(ps, hp):
        y, _ = ld(hp, ps, std)
        return jnp.sum(y[:n] ** 2)

    got, gds = jax.value_and_grad(loss_dist)(ps, hp)

    assert calls, "fused per-partition path did not engage"
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(gws),
                    jax.tree_util.tree_leaves(gds)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-4,
                                   rtol=2e-3)
